"""Shared neural building blocks, the port of the JAX package's
`models/layers.py`.

Weights keep the JAX layout: a projection is `x @ w` with w (d_in, d_out),
so a JAX parameter pytree carries across without transposes
(`model.from_jax_params`). Norms and rotary embeddings compute in float32,
as the JAX package does, or in float64 for float64 inputs (the float64
reference `chip_smoke.py` holds the card's float32 run against).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def compute_float(dtype: torch.dtype) -> torch.dtype:
    """The type a norm, a rotation or a state computes in: float32, or
    float64 for float64 inputs."""
    return torch.promote_types(dtype, torch.float32)


def truncated_normal(shape, std: float, dtype: torch.dtype, device,
                     generator: torch.Generator) -> torch.Tensor:
    """A standard normal cut at ±2, times `std`, drawn in float32 from
    `generator` and cast to `dtype` (the JAX package's draw, with torch's
    random numbers)."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * std).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    ct = compute_float(x.dtype)
    xf = x.to(ct)
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(ct)).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings: standard and M-RoPE (qwen2-vl §3.1)
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=dtype,
                                         device=device) / head_dim))


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, hd) rotated by angles (B, S, hd/2): the first and second
    halves of hd are the pairs."""
    cos = angles.cos()[:, :, None, :]
    sin = angles.sin()[:, :, None, :]
    x1, x2 = x.to(angles.dtype).chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) int."""
    ct = compute_float(x.dtype)
    freqs = rope_freqs(x.shape[-1], theta, x.device, ct)
    return _rotate(x, positions[..., None].to(ct) * freqs)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: Tuple[int, int, int]) -> torch.Tensor:
    """Multimodal RoPE: positions3 (3, B, S) = (temporal, height, width)
    ids; the hd/2 frequency slots are split into three sections, each
    rotated by its own position stream (arXiv:2409.12191)."""
    hd = x.shape[-1]
    ct = compute_float(x.dtype)
    freqs = rope_freqs(hd, theta, x.device, ct)
    sec = torch.cat([torch.full((s,), i, dtype=torch.long, device=x.device)
                     for i, s in enumerate(sections)])[: hd // 2]
    # per frequency slot, the position stream of its section
    pos_per_slot = positions3.to(ct)[sec]  # (hd/2, B, S)
    return _rotate(x, pos_per_slot.movedim(0, -1) * freqs)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------
class MLP(torch.nn.Module):
    def __init__(self, d: int, f: int, dtype, device, generator):
        super().__init__()
        self.w_gate = torch.nn.Parameter(
            truncated_normal((d, f), d ** -0.5, dtype, device, generator))
        self.w_up = torch.nn.Parameter(
            truncated_normal((d, f), d ** -0.5, dtype, device, generator))
        self.w_down = torch.nn.Parameter(
            truncated_normal((f, d), f ** -0.5, dtype, device, generator))


def mlp(params: MLP, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ params.w_gate) * (x @ params.w_up)
    return h @ params.w_down


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------
def embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return F.embedding(ids, table)


def unembed(table_or_head: torch.Tensor, x: torch.Tensor, tied: bool
            ) -> torch.Tensor:
    if tied:
        return x @ table_or_head.T
    return x @ table_or_head
