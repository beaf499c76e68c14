"""The per-architecture workload shapes, the port of the JAX package's
`launch/specs.py` (its table and applicability rule; the JAX
ShapeDtypeStruct stand-ins have no use in an eager port).

Shapes:
    train_4k     seq 4096,   global_batch 256   (training)
    prefill_32k  seq 32768,  global_batch 32    (inference prefill)
    decode_32k   seq 32768,  global_batch 128   (one token + 32k KV cache)
    long_500k    seq 524288, global_batch 1     (long-context decode;
                 sub-quadratic archs only — zamba2, xlstm)
"""
from __future__ import annotations

from typing import Dict, Tuple

from ..models.config import ModelConfig

SHAPES: Dict[str, Dict[str, int]] = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32_768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32_768, batch=128, kind="decode"),
    "long_500k": dict(seq=524_288, batch=1, kind="decode"),
}


def shape_applicable(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    """long_500k needs sub-quadratic context handling."""
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, ("skipped: pure full-attention arch — a 500k-entry "
                       "KV cache per layer is out of serving scope; run on "
                       "SSM/hybrid archs only")
    return True, ""
