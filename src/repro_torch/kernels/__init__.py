"""Hand-written CUDA kernels, one family per directory, each with a plain
PyTorch version beside it (`ref.py`):

  histogram       — Phase-1 contention histogram (weighted or not)
  segment_combine — Phase-4 merge-able ⊗-combine (add/min/max/or/write)
  stage_fused     — Phases 3+4 for a fused-able lambda, off the CSR pairs
  moe_gemm        — grouped (block-diagonal) GEMM over rows sorted by expert
  flash_attention — GQA attention, causal or not (`attention`)
  flash_decode    — single-token attention over a KV cache (`decode_attention`)
  mamba_scan      — Mamba2 SSD chunk scan (`mamba_ssd`)

A wrapper launches its kernel for a CUDA tensor and runs the plain version
for a CPU tensor. `launches()` / `reset_launches()` read and clear the
per-kernel launch counts.
"""
from ._lib import KERNELS, launches, reset_launches  # noqa: F401
from .flash_attention.ops import attention  # noqa: F401
from .flash_decode.ops import decode_attention  # noqa: F401
from .mamba_scan.ops import mamba_ssd  # noqa: F401
