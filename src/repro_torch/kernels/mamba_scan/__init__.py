from .ops import mamba_ssd  # noqa: F401
