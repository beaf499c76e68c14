from .ops import count_ids  # noqa: F401
