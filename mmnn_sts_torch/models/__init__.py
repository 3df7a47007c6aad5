from .registry import build_image_model, build_model  # noqa: F401
