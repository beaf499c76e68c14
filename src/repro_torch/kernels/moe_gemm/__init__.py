from .ops import gathered_swiglu, grouped_gemm  # noqa: F401
