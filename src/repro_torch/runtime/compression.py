"""int8 block-quantized gradient compression with error feedback, the port
of the JAX package's `runtime/compression.py` on a dict of named tensors.

DP gradient all-reduce at pod scale is bandwidth-bound; int8 quantization
cuts the wire volume 4× (vs f32 moments' inputs / 2× vs bf16). Error
feedback (residual carried to the next step) keeps SGD-style convergence:
    q_t = Q(g_t + e_{t-1});  e_t = (g_t + e_{t-1}) − q_t
Block scale = max-abs per 256-value block / 127 (at least 1e-12), values
rounded half to even and clipped to ±127, so one outlier only damages its
own block. The port writes the residual in place (the JAX package returns
a new state).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

BLOCK = 256


class CompressionState(NamedTuple):
    residual: Dict[str, torch.Tensor]  # float32 error-feedback buffers


def init_compression_state(grads: Dict[str, torch.Tensor]
                           ) -> CompressionState:
    return CompressionState(residual={
        k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
        for k, g in grads.items()})


def _quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8 (blocks, BLOCK), scale float32 (blocks, 1)) of x's values,
    zero-padded to whole blocks."""
    flat = x.reshape(-1).to(torch.float32)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % BLOCK))
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape)


@torch.no_grad()
def compress_gradients(grads: Dict[str, torch.Tensor],
                       state: CompressionState):
    """Returns ({name: (q, scale)}, state) with the state's residuals
    written in place. The caller all-reduces the int8 payload (+ float32
    scales, 1/256 the volume)."""
    payload = {}
    for k, g in grads.items():
        r = state.residual[k]
        x = g.to(torch.float32) + r
        q, scale = _quant(x)
        payload[k] = (q, scale)
        r.copy_(x - _dequant(q, scale, g.shape))
    return payload, state


def decompress(payload, like: Dict[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
    """The dequantized tensors, each of `like`'s shape and dtype."""
    return {k: _dequant(*payload[k], p.shape).to(p.dtype)
            for k, p in like.items()}


def wire_bytes(payload) -> int:
    """Bytes an all-reduce of the compressed payload would move per hop."""
    return sum(q.numel() + s.numel() * 4 for q, s in payload.values())
