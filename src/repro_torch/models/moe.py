"""MoE block with TD-Orch push-pull dispatch, the port of the JAX package's
`models/moe.py` (granite-moe) on one device.

Routing skew across experts is the paper's data-hot-spot problem verbatim
(tokens = lambda-tasks, experts = data chunks). The dispatch engine is
selectable per config — "tdorch" (push-pull), "push" (classic expert
parallelism with capacity drops), "pull" (replicate all experts), "dense"
(the single-shard oracle) — each on `repro_torch.core.spmd`, whose grouped
SwiGLU runs the grouped GEMM kernel (B4; bf16 operands for the bf16
models) and whose Phase 1 runs the histogram kernel (B1) on the card.

The JAX package's mesh branches (the sequence-split `shard_map` island and
the decode-time psum over a "model" axis) need a model-level mesh, which
the port's `Model` does not have yet (ROADMAP A12): passing a mesh raises.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..core.spmd import (MoEDispatchConfig, moe_direct_pull, moe_direct_push,
                         moe_push_pull, moe_reference)
from .config import ModelConfig
from .layers import compute_float, truncated_normal


class MoE(torch.nn.Module):
    """The router (float32 whatever the model's dtype, as the JAX package
    keeps it) and the stacked expert weights w_in (E, d, 2f), gate half
    first, and w_out (E, f, d), over the padded expert count."""

    def __init__(self, cfg: ModelConfig, dtype, device, generator):
        super().__init__()
        m = cfg.moe
        d, f, E = cfg.d_model, m.d_ff_expert, m.padded
        P = torch.nn.Parameter
        self.router = P(truncated_normal((d, E), d ** -0.5, torch.float32,
                                         device, generator))
        self.w_in = P(truncated_normal((E, d, 2 * f), d ** -0.5, dtype,
                                       device, generator))
        self.w_out = P(truncated_normal((E, f, d), f ** -0.5, dtype, device,
                                        generator))


def init_moe(cfg: ModelConfig, dtype, device, generator) -> MoE:
    return MoE(cfg, dtype, device, generator)


def _route(params: MoE, cfg: ModelConfig, x2d: torch.Tensor):
    """Top-k routing with softmax-over-selected gates and the switch aux
    loss. Logits and probabilities in float32 (float64 for a float64
    model); the padded experts never win. Ties go to the lower expert
    index, as `lax.top_k` breaks them (a stable descending sort: `torch.
    topk` promises no order among equal values). Returns (top_i (T, k)
    int32, gates (T, k) in x's dtype, aux)."""
    m = cfg.moe
    ct = compute_float(x2d.dtype)
    logits = x2d.to(ct) @ params.router.to(ct)  # (T, E_pad)
    if m.padded != m.num_experts:  # dummy padding experts never win
        logits[:, m.num_experts:] = -1e30
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :m.top_k], top_i[:, :m.top_k]
    gates = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
    # standard switch-style aux loss: E · Σ_e f_e · P_e (the counts by an
    # add of ones: exact in any order, and no host sync for a size)
    flat = top_i.reshape(-1)
    f_e = torch.zeros(m.padded, dtype=ct, device=x2d.device).index_add_(
        0, flat, torch.ones(flat.shape, dtype=ct, device=x2d.device)) \
        / top_i.numel()
    aux = m.num_experts * (f_e * probs.mean(0)).sum()
    return top_i.to(torch.int32), gates.to(x2d.dtype), aux


def _dispatch_cfg(cfg: ModelConfig) -> MoEDispatchConfig:
    m = cfg.moe
    return MoEDispatchConfig(
        num_experts=m.padded,
        top_k=m.top_k,
        capacity_factor=m.capacity_factor,
        num_hot=m.num_hot if m.dispatch == "tdorch" else 0,
        gemm_impl=m.gemm_impl,
    )


def _dispatch_local(params: MoE, cfg: ModelConfig, x2d, top_i, gates):
    """The configured dispatch engine on one device: (T, d) in x's
    dtype."""
    d_cfg = _dispatch_cfg(cfg)
    kind = cfg.moe.dispatch
    if kind == "dense":
        return moe_reference(x2d, top_i, gates, params.w_in, params.w_out)
    engines = {"tdorch": moe_push_pull, "push": moe_direct_push,
               "pull": moe_direct_pull}
    if kind not in engines:
        raise ValueError(f"unknown dispatch {kind!r}")
    y, _ = engines[kind](x2d, top_i, gates, params.w_in, params.w_out, d_cfg)
    return y


def moe_block(params: MoE, cfg: ModelConfig, x: torch.Tensor, mesh=None,
              decode: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss), one device. `decode` changes nothing
    here: it picks the psum branch of a mesh, which waits for A12."""
    if mesh is not None:
        raise NotImplementedError(
            "the MoE block's mesh branches (sequence-split dispatch, decode "
            "psum) need a model-level mesh: ROADMAP item A12")
    B, S, d = x.shape
    x2d = x.reshape(B * S, d)
    top_i, gates, aux = _route(params, cfg, x2d)
    y = _dispatch_local(params, cfg, x2d, top_i, gates)
    return y.reshape(B, S, d), aux

