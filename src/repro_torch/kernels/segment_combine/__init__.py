from .ops import combine  # noqa: F401
