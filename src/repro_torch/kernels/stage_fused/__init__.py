from .ops import FUSED_READ_OPS, fused_reduce, fused_stage  # noqa: F401
