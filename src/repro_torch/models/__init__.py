from .registry import get_model, MODEL_FAMILIES  # noqa: F401
