"""MoE block with TD-Orch push-pull dispatch, the port of the JAX package's
`models/moe.py` (granite-moe).

Routing skew across experts is the paper's data-hot-spot problem verbatim
(tokens = lambda-tasks, experts = data chunks). The dispatch engine is
selectable per config — "tdorch" (push-pull), "push" (classic expert
parallelism with capacity drops), "pull" (replicate all experts), "dense"
(the single-shard oracle) — each on `repro_torch.core.spmd`, whose grouped
SwiGLU runs the grouped GEMM kernel (B4; bf16 operands for the bf16
models) and whose Phase 1 runs the histogram kernel (B1) on the card.

On a model-level mesh (`launch.mesh.Mesh`, executing: each data group a
`core.shardexec.StackedMesh` of the "model" axis's shards on the one
device) the block runs the JAX package's two mesh branches, each data
group on its own stacked mesh, in turn:

* sequence split (train and prefill, S divisible by the model axis ep):
  shard s of a group takes tokens [s·S/ep, (s+1)·S/ep) of each of the
  group's rows, flattened row-major — the layout `shard_map`'s
  `P(batch_axes, "model", None)` gives, which decides which assignments
  the capacity drops (`bucket_routing` keeps by position). Each shard
  routes its own tokens; the dispatch engine runs on the mesh with each
  shard's E_pad/ep experts.
* decode psum (decode, or S not divisible by ep): the tokens are
  replicated; each shard computes its own experts' assignments (the
  foreign ones sorted past the groups' sum, where the grouped GEMM gives
  0), weights each by its gate and the shards' outputs are summed by the
  mesh's psum — one grouped compute over all shards' local experts, as the
  push path's.

aux is the mean of the shards' own switch losses (the JAX package's
`lax.pmean` over "model"), not the loss over all tokens: the two differ.
Over several data groups it is the mean over every group's shards. The
JAX package returns aux with `out_specs=P()` and `check_vma=False`, so
there each data group's devices hold their own group's mean (a host read
gives the first device's) while its gradient is that of the mean over all
shards; the port's aux is that mean, consistent with its gradient.
Gradients need no code of their own: they flow through the stacked
mesh's transposes and sums.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..core.spmd import (MoEDispatchConfig, grouped_swiglu, moe_direct_pull,
                         moe_direct_push, moe_push_pull, moe_reference)
from ..core.torchexec import sort_by_group
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


def _dispatch_cfg(cfg: ModelConfig, mesh=None) -> MoEDispatchConfig:
    m = cfg.moe
    return MoEDispatchConfig(
        num_experts=m.padded,
        top_k=m.top_k,
        capacity_factor=m.capacity_factor,
        num_hot=m.num_hot if m.dispatch == "tdorch" else 0,
        mesh=mesh,
        gemm_impl=m.gemm_impl,
    )


def _dispatch_local(cfg: ModelConfig, x2d, top_i, gates, w_in, w_out,
                    mesh=None):
    """The configured dispatch engine: (T, d) in x's dtype on one device;
    on a `core.shardexec` mesh every argument and the result carry its
    shard dimension, and w_in / w_out are the shards' (S, E_pad/ep, ...)
    experts."""
    kind = cfg.moe.dispatch
    if kind == "dense":
        if mesh is not None:
            raise ValueError("the dense dispatch is the one-device oracle; "
                             "it takes no mesh")
        return moe_reference(x2d, top_i, gates, w_in, w_out)
    engines = {"tdorch": moe_push_pull, "push": moe_direct_push,
               "pull": moe_direct_pull}
    if kind not in engines:
        raise ValueError(f"unknown dispatch {kind!r}")
    y, _ = engines[kind](x2d, top_i, gates, w_in, w_out,
                         _dispatch_cfg(cfg, mesh))
    return y


def moe_block(params: MoE, cfg: ModelConfig, x: torch.Tensor, mesh=None,
              decode: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss). Without a mesh, or with a "model"
    axis of 1, one dispatch over all B·S tokens; else the mesh branches
    (module docstring), the batch rows split in order over the mesh's data
    groups."""
    B, S, d = x.shape
    ep = 1 if mesh is None else mesh.shape.get("model", 1)
    if ep == 1:
        x2d = x.reshape(B * S, d)
        top_i, gates, aux = _route(params, cfg, x2d)
        y = _dispatch_local(cfg, x2d, top_i, gates, params.w_in,
                            params.w_out)
        return y.reshape(B, S, d), aux
    groups = _data_groups(mesh, B)
    branch = _moe_decode_psum if decode or S % ep else _moe_sequence_split
    ys, auxes = zip(*(branch(params, cfg, xb, g) for xb, g in zip(
        x.chunk(len(groups)), groups)))
    return torch.cat(ys), torch.stack(auxes).mean()


def _data_groups(mesh, B: int):
    """The mesh's data groups (one stacked mesh of the "model" axis each),
    which split the batch rows in order."""
    if not mesh.executes:
        raise ValueError("an abstract mesh does not execute: build the "
                         "model on launch.mesh.make_host_mesh")
    if B % len(mesh.groups):
        raise ValueError(f"batch {B} over {len(mesh.groups)} data groups")
    return mesh.groups


def _moe_sequence_split(params: MoE, cfg: ModelConfig, xb: torch.Tensor,
                        mesh):
    """One data group's rows xb (B_l, S, d) on its stacked mesh of ep
    shards: shard s routes and dispatches tokens [s·S/ep, (s+1)·S/ep) of
    every row. Returns (y (B_l, S, d), the mean of the shards' aux)."""
    Bl, S, d = xb.shape
    ep = mesh.P
    xs = xb.reshape(Bl, ep, S // ep, d).transpose(0, 1).reshape(ep, -1, d)
    top_i, gates, aux = zip(*(_route(params, cfg, xs[s])
                              for s in range(ep)))
    # the shards' experts: (ep, E_pad/ep, ...) views of the tables
    y = _dispatch_local(cfg, xs, torch.stack(top_i), torch.stack(gates),
                        params.w_in.unflatten(0, (ep, -1)),
                        params.w_out.unflatten(0, (ep, -1)), mesh=mesh)
    y = y.reshape(ep, Bl, S // ep, d).transpose(0, 1).reshape(Bl, S, d)
    return y, torch.stack(aux).mean()


def _moe_decode_psum(params: MoE, cfg: ModelConfig, xb: torch.Tensor, mesh):
    """One data group's rows xb (B_l, S, d), replicated on its ep shards:
    each shard computes its own experts' assignments, weighted by their
    gates, and the mesh's psum adds the shards' outputs. The routing is the
    same on every shard, so it runs once (the shards' aux, and their mean,
    are that one's)."""
    Bl, S, d = xb.shape
    ep, dev = mesh.P, xb.device
    x2d = xb.reshape(Bl * S, d)
    top_i, gates, aux = _route(params, cfg, x2d)
    T, k = top_i.shape
    e_local = cfg.moe.padded // ep
    flat_e = top_i.reshape(1, T * k).long()
    me = mesh.axis_index().long()[:, None]  # (ep, 1)
    local = flat_e - me * e_local
    mine = (local >= 0) & (local < e_local)
    # shard s's experts are groups s·e_local ... of the stacked tables; the
    # foreign assignments sort past the groups' sum
    order, sizes = sort_by_group(
        torch.where(mine, flat_e, ep * e_local).reshape(-1), ep * e_local)
    token_of = torch.arange(T, device=dev).repeat_interleave(k)
    rows = (torch.arange(ep, device=dev)[:, None] * T + token_of).reshape(
        -1)[order]
    out = grouped_swiglu(x2d[rows % T], params.w_in, params.w_out, sizes,
                         impl=cfg.moe.gemm_impl)
    g = torch.where(mine, gates.reshape(1, T * k), 0.0).reshape(-1)[order]
    y = torch.zeros((ep * T, d), dtype=xb.dtype, device=dev).index_add_(
        0, rows, out * g[:, None])
    return mesh.psum(y.view(ep, T, d))[0].reshape(Bl, S, d), aux

