"""Framework exceptions (counterpart of the JAX package's exceptions.py)."""


class ConfigurationError(Exception):
    """Raised when the YAML config or CLI flag combination is invalid."""


class InitializationError(Exception):
    """Raised when a dataset cannot be assembled (e.g. a UID is missing
    from the patient key)."""
