"""Framework exceptions (counterpart of the JAX package's exceptions.py)."""


class ConfigurationError(Exception):
    """Raised when the YAML config or CLI flag combination is invalid."""

