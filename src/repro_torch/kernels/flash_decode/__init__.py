from .ops import decode_attention  # noqa: F401
