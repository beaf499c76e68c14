"""TD-Orch's SPMD realization on torch: the MoE expert dispatch over a mesh,
the counterpart of the JAX package's `core/spmd.py`.

The same four phases as `engine.py`, in collective form:

  Phase 1 (contention detection): per-shard histogram of the routed experts
    plus one `psum` (`torchexec.detect_contention`).
  Phase 2 (co-location):
    push — cold experts' tokens route to their owner shard through a
    sorted, capacity-bounded all-to-all (static buffers play the meta-task
    level cap C);
    pull — the ≤H hottest experts' *weights* are replicated to every shard
    by a masked `psum`.
  Phase 3: grouped expert compute (`grouped_swiglu`: the grouped GEMM
    kernel on the card, its plain version on the CPU).
  Phase 4: weighted adds combined per token (`add_rows`: in a fixed order).

`moe_push_pull` is TD-Orch's dispatch; `moe_direct_push` (classic expert
parallelism, capacity drops) and `moe_direct_pull` (replicate every
expert) are the §2.3 baselines; `moe_reference` is the dense oracle.

The JAX package writes these per shard and wraps them in `shard_map` over a
named axis. Here `MoEDispatchConfig.mesh` is a mesh of `core.shardexec`
(`StackedMesh` / `GroupMesh`): every per-shard argument and result carries
the mesh's leading shard dimension S, and the expert weights are the local
shards' (S, E/ep, ...). ``mesh=None`` means one device (the JAX package's
``axis_name=None``): arguments carry no shard dimension.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..kernels.moe_gemm.ops import grouped_gemm
from .shardexec import StackedMesh
from .torchexec import (Routing, bucket_routing, detect_contention,
                        gather_from_buckets, inverse_permutation,
                        scatter_to_buckets, select_hot, sort_by_group)


# ---------------------------------------------------------------------------
# the weighted combine (Phase 4) and grouped expert compute (Phase 3)
# ---------------------------------------------------------------------------
def add_rows(y: torch.Tensor, rows: torch.Tensor,
             vals: torch.Tensor) -> torch.Tensor:
    """y[rows[i]] += vals[i], in place: each row's terms summed in their
    order in `rows` (in float32 for a bf16 y), then added to it once — the
    same bits on every run and on every mesh, where `index_add_`'s atomics
    on the card add in any order (a training run's drops and losses then
    differ from run to run)."""
    return y.index_put_((rows,), vals, accumulate=True)



def grouped_swiglu(xs: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor,
                   group_sizes: torch.Tensor, impl: str = "ragged",
                   capacity_mult: float = 2.0) -> torch.Tensor:
    """Grouped SwiGLU FFN: xs (M, d) sorted by group; w_in (G, d, 2f),
    w_out (G, f, d); gate half first.

    impl="ragged": the grouped GEMM (`kernels.moe_gemm.grouped_gemm`: the
    CUDA kernel for tensors on the card, its plain version on the CPU);
    rows beyond the groups' sum give zeros.

    impl="binned": capacity-binned batched GEMM (Switch-style): rows
    scatter into (G, cap, d) bins, cap = max(8, capacity_mult·M/G); rows
    beyond a bin's capacity give zeros."""
    sizes = group_sizes.to(torch.int32)
    if impl == "ragged":
        h = grouped_gemm(xs.contiguous(), w_in, sizes)
        f = h.shape[1] // 2
        act = torch.nn.functional.silu(h[:, :f]) * h[:, f:]
        return grouped_gemm(act.contiguous(), w_out, sizes)
    if impl != "binned":
        raise ValueError(f"unknown grouped_swiglu impl {impl!r}")
    M, d = xs.shape
    G = w_in.shape[0]
    cap = max(8, int(capacity_mult * M / G))
    ends = torch.cumsum(sizes.long(), 0)
    rows = torch.arange(M, device=xs.device)
    gid = torch.searchsorted(ends, rows, right=True).clamp(max=G - 1)
    pos = rows - (ends - sizes.long())[gid]
    keep = (pos < cap) & (rows < ends[-1])
    bins = torch.zeros((G * cap + 1, d), dtype=xs.dtype, device=xs.device)
    slot = torch.where(keep, gid * cap + pos, torch.full_like(rows, G * cap))
    bins[slot] = xs
    h = torch.bmm(bins[:-1].view(G, cap, d), w_in)
    f = h.shape[-1] // 2
    act = torch.nn.functional.silu(h[..., :f]) * h[..., f:]
    out = torch.bmm(act, w_out).reshape(G * cap, d)
    return torch.where(keep[:, None], out[slot.clamp(max=G * cap - 1)], 0.0)


# ---------------------------------------------------------------------------
# MoE dispatch engines
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MoEDispatchConfig:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    num_hot: int = 0  # H: experts served by pull/replication (0 = pure push)
    hot_min_count: int = 1
    mesh: Optional[object] = None  # a core.shardexec mesh; None: one device
    gemm_impl: str = "ragged"  # ragged | binned (see grouped_swiglu)

    @property
    def ep_size(self) -> int:
        """Expert-parallel shards: the mesh's machines (1 without one)."""
        return 1 if self.mesh is None else self.mesh.P


class MoEAux(NamedTuple):
    dropped_assignments: torch.Tensor  # scalar, or (S,) on a mesh
    expert_counts: torch.Tensor  # (E,) global demand, or (S, E)
    hot_ids: torch.Tensor  # (H,) or (0,)


def _capacity(cfg: MoEDispatchConfig, num_tokens: int) -> int:
    # per-destination-shard send capacity of the all-to-all buffers
    per_shard = num_tokens * cfg.top_k / max(cfg.ep_size, 1)
    return max(8, int(per_shard * cfg.capacity_factor))


def _on_mesh(cfg: MoEDispatchConfig, device, *args):
    """(mesh, args with a shard dimension): without a mesh, a stacked mesh
    of one shard on `device` runs the same body."""
    if cfg.mesh is not None:
        return cfg.mesh, args
    return StackedMesh(1, device), tuple(a[None] for a in args)


def _unstack(cfg: MoEDispatchConfig, y, aux: MoEAux):
    if cfg.mesh is not None:
        return y, aux
    return y[0], MoEAux(dropped_assignments=aux.dropped_assignments[0],
                        expert_counts=aux.expert_counts[0],
                        hot_ids=aux.hot_ids)


def _kept_mask(routing: Routing) -> torch.Tensor:
    """Per-assignment (original order) mask of slots that fit capacity."""
    return torch.take_along_dim(routing.keep,
                                inverse_permutation(routing.order), dim=-1)


def _flatten(x: torch.Tensor) -> torch.Tensor:
    return x.reshape((-1,) + x.shape[2:])


def moe_push_pull(x, topk_idx, topk_gate, w_in, w_out,
                  cfg: MoEDispatchConfig):
    """TD-Orch push-pull MoE dispatch.

    x (T, d) tokens, topk_idx / topk_gate (T, k), w_in (E/ep, d, 2f) and
    w_out (E/ep, f, d) the local experts — each with a leading shard
    dimension S on a mesh. Cold experts: tokens pushed to the owner shard
    (all-to-all), computed there, pushed back, combined. Hot experts:
    weights pulled (replicated by a masked psum) and their tokens computed
    locally — no token crosses the network for a hot expert, and no
    capacity drop can hit it (§3.3's decision rule with C → capacity).
    Returns (y, MoEAux)."""
    mesh, (x, topk_idx, topk_gate, w_in, w_out) = _on_mesh(
        cfg, x.device, x, topk_idx, topk_gate, w_in, w_out)
    S, T, d = x.shape
    k = topk_idx.shape[-1]
    E, ep = cfg.num_experts, mesh.P
    e_local = E // ep
    dev = x.device
    me = mesh.axis_index().long()  # (S,)
    A = T * k
    flat_e = topk_idx.reshape(S, A).long()
    flat_g = topk_gate.reshape(S, A)
    token_of = torch.arange(T, device=dev).repeat_interleave(k)  # (A,)
    tok_flat = (torch.arange(S, device=dev)[:, None] * T
                + token_of).reshape(-1)  # token row in (S·T, d)
    x_flat = _flatten(x)

    # ---------------- Phase 1: contention detection -----------------------
    counts = detect_contention(flat_e, E, mesh)  # (S, E), rows equal

    y = torch.zeros((S * T, d), dtype=x.dtype, device=dev)

    # ---------------- pull path: hot experts ------------------------------
    if cfg.num_hot > 0:
        H = cfg.num_hot
        hot_ids, lookup, _ = select_hot(counts[0], H, cfg.hot_min_count)
        # every shard contributes the hot experts it owns into a zero
        # buffer; the psum is the C-ary broadcast tree
        local_rank = lookup[me[:, None] * e_local
                            + torch.arange(e_local, device=dev)]  # (S, e)
        contrib = local_rank >= 0
        slot = torch.where(contrib, local_rank.long(),
                           torch.full_like(local_rank, H, dtype=torch.long))
        hot_w_in = _pull(w_in, slot, H, mesh)
        hot_w_out = _pull(w_out, slot, H, mesh)
        # the hot assignments of every local shard, grouped by hot expert:
        # one grouped compute over all of them (the weights are the same on
        # every shard)
        assign_rank = lookup[flat_e]  # (S, A), -1 = cold
        is_hot = assign_rank >= 0
        key = torch.where(is_hot, assign_rank,
                          torch.full_like(assign_rank, H)).reshape(-1)
        order, sizes = sort_by_group(key, H)
        rows = tok_flat[order]
        out = grouped_swiglu(x_flat[rows], hot_w_in, hot_w_out, sizes,
                             impl=cfg.gemm_impl)
        gates = torch.where(is_hot, flat_g, 0.0).reshape(-1)[order]
        add_rows(y, rows, out * gates[:, None])
    else:
        hot_ids = torch.zeros((0,), dtype=torch.int64, device=dev)
        is_hot = torch.zeros((S, A), dtype=torch.bool, device=dev)

    # ---------------- push path: cold experts -----------------------------
    cap = _capacity(cfg, T)
    routing = bucket_routing(flat_e // e_local, ep, cap, ~is_hot)
    send_x = scatter_to_buckets(x_flat[tok_flat].view(S, A, d), routing, ep,
                                cap)  # (S, ep, cap, d)
    send_e = scatter_to_buckets(flat_e, routing, ep, cap, fill=-1)
    recv_x = mesh.all_to_all(send_x).reshape(S * ep * cap, d)
    recv_e = mesh.all_to_all(send_e).reshape(S, ep * cap)
    del send_x
    # received rows grouped by (shard, local expert): one grouped compute
    # over all local shards' experts, whose weights stack to (S·e, ...)
    r_valid = recv_e >= 0
    r_local = torch.where(r_valid, recv_e - me[:, None] * e_local,
                          torch.full_like(recv_e, e_local)).clamp(0, e_local)
    group = torch.where(r_local < e_local,
                        torch.arange(S, device=dev)[:, None] * e_local
                        + r_local, torch.full_like(r_local, S * e_local))
    order2, sizes2 = sort_by_group(group.reshape(-1), S * e_local)
    out2 = grouped_swiglu(recv_x[order2], _flatten(w_in), _flatten(w_out),
                          sizes2, impl=cfg.gemm_impl)
    out2 = out2[inverse_permutation(order2)].view(S, ep, cap, d)
    back = mesh.all_to_all(out2)
    del out2
    y_assign = gather_from_buckets(back, routing, A)  # (S, A, d)
    kept = _kept_mask(routing)
    cold_gate = torch.where(is_hot | ~kept, 0.0, flat_g)
    add_rows(y, tok_flat, (y_assign * cold_gate[..., None]).reshape(S * A, d))

    dropped = mesh.psum(((~is_hot) & ~kept).sum(1))
    y, aux = y.view(S, T, d), MoEAux(dropped_assignments=dropped,
                                     expert_counts=counts, hot_ids=hot_ids)
    return _unstack(cfg, y, aux)


def _pull(w: torch.Tensor, slot: torch.Tensor, H: int, mesh) -> torch.Tensor:
    """(S, e, ...) local expert weights -> (H, ...) hot experts' weights on
    every shard: each shard adds the hot experts it owns into a zero buffer
    (`slot` == H: not hot), then the buffers are summed over the mesh. The
    sum is invariant and every shard computes its own tokens with it, so it
    passes through `pvary`: its gradient is summed over the shards before
    it returns to the owners."""
    S = w.shape[0]
    buf = torch.zeros((S, H + 1) + w.shape[2:], dtype=w.dtype,
                      device=w.device)
    buf.scatter_add_(1, slot.reshape(slot.shape + (1,) * (w.ndim - 2))
                     .expand_as(w), w)
    return mesh.pvary(mesh.psum(buf[:, :H])[0])[0].contiguous()


def moe_direct_push(x, topk_idx, topk_gate, w_in, w_out,
                    cfg: MoEDispatchConfig):
    """§2.3 Direct Push baseline = classic expert parallelism: every token
    crosses to its expert's owner; hot experts overflow capacity and DROP."""
    cold_cfg = dataclasses.replace(cfg, num_hot=0)
    return moe_push_pull(x, topk_idx, topk_gate, w_in, w_out, cold_cfg)


def moe_direct_pull(x, topk_idx, topk_gate, w_in, w_out,
                    cfg: MoEDispatchConfig):
    """§2.3 Direct Pull baseline: replicate EVERY expert's weights to every
    shard (all-gather) and compute locally — no drops, but weight traffic
    is paid regardless of demand (prohibitive as E grows)."""
    mesh, (x, topk_idx, topk_gate, w_in, w_out) = _on_mesh(
        cfg, x.device, x, topk_idx, topk_gate, w_in, w_out)
    S, T, d = x.shape
    k = topk_idx.shape[-1]
    E = cfg.num_experts
    dev = x.device
    # every shard's experts, used by this shard's own tokens: pvary, so
    # the gradient is summed over the shards before each takes its slice
    all_w_in = mesh.pvary(mesh.all_gather(w_in)[0])[0].contiguous()
    all_w_out = mesh.pvary(mesh.all_gather(w_out)[0])[0].contiguous()
    A = T * k
    flat_e = topk_idx.reshape(S, A).long()
    token_of = torch.arange(T, device=dev).repeat_interleave(k)
    tok_flat = (torch.arange(S, device=dev)[:, None] * T
                + token_of).reshape(-1)
    order, sizes = sort_by_group(flat_e.reshape(-1), E)
    rows = tok_flat[order]
    out = grouped_swiglu(_flatten(x)[rows], all_w_in, all_w_out, sizes,
                         impl=cfg.gemm_impl)
    y = add_rows(torch.zeros((S * T, d), dtype=x.dtype, device=dev), rows,
                 out * topk_gate.reshape(-1)[order][:, None])
    counts = detect_contention(flat_e, E, mesh)
    aux = MoEAux(dropped_assignments=torch.zeros(S, dtype=torch.int64,
                                                 device=dev),
                 expert_counts=counts,
                 hot_ids=torch.zeros((0,), dtype=torch.int64, device=dev))
    return _unstack(cfg, y.view(S, T, d), aux)


# ---------------------------------------------------------------------------
# dense reference (oracle; no distribution, no capacity)
# ---------------------------------------------------------------------------
def moe_reference(x, topk_idx, topk_gate, w_in_full, w_out_full):
    """Exact dense MoE on one device: every assignment computed, no drops.
    Oracle for engine equivalence (w_*_full hold all E experts)."""
    T, d = x.shape
    k = topk_idx.shape[1]
    E = w_in_full.shape[0]
    token_of = torch.arange(T, device=x.device).repeat_interleave(k)
    order, sizes = sort_by_group(topk_idx.reshape(-1).long(), E)
    rows = token_of[order]
    out = grouped_swiglu(x[rows], w_in_full, w_out_full, sizes)
    return add_rows(torch.zeros((T, d), dtype=x.dtype, device=x.device),
                    rows, out * topk_gate.reshape(-1)[order][:, None])
