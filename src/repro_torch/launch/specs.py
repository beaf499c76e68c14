"""Per-(architecture x shape) input specs, the port of the JAX package's
`launch/specs.py`: meta-device tensors in place of its ShapeDtypeStruct
stand-ins — every model input's shape and dtype with no storage, which
the step builders (`launch.steps`), the dry run and the sharding rules
read.

Shapes:
    train_4k     seq 4096,   global_batch 256   (training)
    prefill_32k  seq 32768,  global_batch 32    (inference prefill)
    decode_32k   seq 32768,  global_batch 128   (one token + 32k KV cache)
    long_500k    seq 524288, global_batch 1     (long-context decode;
                 sub-quadratic archs only — zamba2, xlstm)

[vlm]/[audio] archs take precomputed frame/patch embeddings (the modality
frontend stub) in place of token ids; qwen2-vl also takes (3, B, S)
M-RoPE position ids. A shape is one of `SHAPES`' names or a dict of the
same keys (`seq`, `batch`, `kind`): a workload cut to one card's size.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple, Union

import torch

from ..models.config import ModelConfig

SHAPES: Dict[str, Dict[str, int]] = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32_768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32_768, batch=128, kind="decode"),
    "long_500k": dict(seq=524_288, batch=1, kind="decode"),
}

Shape = Union[str, Dict[str, Any]]


def shape_info(shape: Shape) -> Dict[str, Any]:
    """`SHAPES[shape]`, or `shape` itself when it is a dict."""
    return dict(shape) if isinstance(shape, dict) else SHAPES[shape]


def shape_applicable(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    """long_500k needs sub-quadratic context handling."""
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, ("skipped: pure full-attention arch — a 500k-entry "
                       "KV cache per layer is out of serving scope; run on "
                       "SSM/hybrid archs only")
    return True, ""


def input_specs(cfg: ModelConfig, shape: Shape, device="meta"
                ) -> Dict[str, Any]:
    """{"kind", "batch", "seq", "inputs": {name: tensor}} (+ "cache_len"
    at decode) for the workload shape, the tensors on `device` (meta: no
    storage): "tokens" int32 (B, S) or "embeds" bf16 (B, S, d),
    "positions" int32 (3, B, S) for M-RoPE, "targets" int32 (B, S) at
    training; at decode one token a row against an S-long cache."""
    info = shape_info(shape)
    B, S, kind = info["batch"], info["seq"], info["kind"]
    out: Dict[str, Any] = {"kind": kind, "batch": B, "seq": S}

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=device)

    def token_inputs(b, s):
        if cfg.modality_stub:
            d: Dict[str, Any] = {
                "embeds": empty((b, s, cfg.d_model), torch.bfloat16)}
        else:
            d = {"tokens": empty((b, s), torch.int32)}
        if cfg.rope_kind == "mrope":
            d["positions"] = empty((3, b, s), torch.int32)
        return d

    if kind == "train":
        batch = token_inputs(B, S)
        batch["targets"] = empty((B, S), torch.int32)
        out["inputs"] = batch
    elif kind == "prefill":
        out["inputs"] = token_inputs(B, S)
    else:  # decode: one new token against an S-long cache
        out["inputs"] = token_inputs(B, 1)
        out["cache_len"] = S
    return out
