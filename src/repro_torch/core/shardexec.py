"""Mesh-sharded stage execution on torch — the simulator's machines made
real, as in the JAX package's `core/shardexec.py`.

Each shard of a mesh IS one machine: it holds only the `DataStore` chunks it
homes (plus the session's `ReplicaSet` entries) and only the tasks the cost
model placed on it (`exec_site`), and runs the four phases locally with
collective exchanges in between:

  Phase 1 (contention detection): per-shard histogram of the requested
    chunk keys plus one `psum` (`torchexec.detect_contention`, the call the
    MoE dispatch makes too).
  Phase 2 (co-location): each (task, key) pair sends a request to the key's
    owner through a bucketed all-to-all (every destination bucket holds the
    shard's power-of-two padded pair count, so nothing overflows); owners
    reply with the chunk rows, a second all-to-all brings them home. Pairs
    whose chunk is in the replica slab read the local copy.
  Phase 3: the stage lambda runs over the shards' gathered views.
  Phase 4: write-backs ⊗-combine locally per written key (the segment
    combine kernel), ride one more all-to-all to the owners, each owner
    ⊗-combines what it received (the kernel again) and ⊙-applies to its
    slab; written chunks that are replicated write through to every holder
    (a masked `psum`).

The mesh is a small object with `P`, `S`, `axis_index()`, `all_to_all`,
`psum`, `all_gather` and `pvary`, in two realizations that run the one
stage body (and the MoE layer's mesh branches, `models/moe.py`). Each
counts its collectives by kind ("all-to-all", "all-reduce",
"all-gather": `calls`, and `result_bytes`, the bytes of one shard's
result, as an HLO module states a collective's result on a device), which
`launch.collectives.collective_stats` turns into wire bytes; a collective
run in the backward counts as well.

Under autograd the collectives follow the transpose rules `shard_map`
gives the JAX package's for varying and invariant values: an
all-to-all's backward is the same exchange on the gradient; a `psum`
(varying in, invariant out) passes the gradient through, as each shard's
cotangent of an invariant value is already the whole one; an
`all_gather` with an invariant result hands each shard its own slice of
the gradient; `pvary` (invariant in, varying out: `pbroadcast`) is the
identity whose backward sums the gradient over the mesh. A replicated
value that meets shard-local work goes through `pvary` first, so its
gradient gathers every shard's share once.

* `StackedMesh` — all P shards in one process on one device. Every
  shard-local tensor carries a leading dimension S = P; an all-to-all is a
  transpose of the first two dimensions, a `psum` a sum over the first,
  `pvary` an expand over it. Autograd of these ops is already the sum over
  the shards the rules above ask for (the transposes and sums count as
  collectives; `pvary`'s sum, which no device would run as one, does not).
  This is how one card runs P machines, as the JAX package's tests run a
  mesh of P host devices in one process.
* `GroupMesh` — one process a machine over a `torch.distributed` process
  group (the default world group, or one given: a model axis inside a
  ("data", "model") mesh), S = 1: the collectives are `all_to_all_single`,
  `all_reduce` and `all_gather` on the tensors' own device (gloo takes CUDA
  tensors as well as CPU ones), each a `torch.autograd.Function` with the
  backward above. Collectives a process holding every shard does not need
  — `pvary`'s backward sums, the global norm's sum over the model axis —
  are counted by name in `boundary` too.

`get_mesh(P, device)` returns the group mesh when a process group is
initialized, the stacked mesh otherwise. Replicated quantities (the
layout's owner and slot maps, the replica slab) carry no shard dimension:
each process holds one copy.

Every cost-model input is still produced host-side by the oracle's code,
so per-phase words/rounds stay bit-identical across backends; the
measured `ShardStageStats` equal the JAX package's on the same batch.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from . import execution
from .datastore import stable_bucket_slots
from .torchexec import (LambdaFailed, _as_update_rows, _call_user,
                        _segment_combine, bucket_routing, detect_contention,
                        gather_from_buckets, scatter_to_buckets)

_IMAX = 2**31 - 1


COLLECTIVE_KINDS = ("all-to-all", "all-reduce", "all-gather")


class _Counted:
    """The collective counters both meshes keep."""

    def reset_counts(self) -> None:
        self.a2a_bytes = 0
        self.calls = dict.fromkeys(COLLECTIVE_KINDS, 0)
        self.result_bytes = dict.fromkeys(COLLECTIVE_KINDS, 0)
        # {name: [calls, result bytes]} of the collectives a process that
        # holds every shard does not run (also counted under their kind)
        self.boundary: Dict[str, list] = {}

    def _note(self, kind: str, shard_result: int,
              boundary: Optional[str] = None) -> None:
        self.calls[kind] += 1
        self.result_bytes[kind] += int(shard_result)
        if boundary is not None:
            ent = self.boundary.setdefault(boundary, [0, 0])
            ent[0] += 1
            ent[1] += int(shard_result)

    def _note_backward(self, out: torch.Tensor, kind: str,
                       shard_result: int) -> torch.Tensor:
        """Count the collective's transpose — the same kind on the
        gradient — when autograd runs it."""
        if out.requires_grad:
            out.register_hook(lambda g: self._note(kind, shard_result))
        return out


def _bucket(n: int) -> int:
    """Per-shard task and pair counts pad to the next power of two (floored
    at 16): the JAX package's plan-scope bucket rule, which its sharded
    stage uses for its buffers. Kept so the buffers' capacities are the
    same on both packages."""
    if n <= 16:
        return 16
    return 1 << (int(n) - 1).bit_length()


class ShardStageError(RuntimeError):
    """The stage lambda could not run on the shards' tensors, or returned
    update rows that do not apply to the store's width — the
    fallback-eligible failures. Host-side placement and layout errors, a
    kernel that fails to build or launch and a collective that fails are
    not wrapped: they raise."""


# ---------------------------------------------------------------------------
# the mesh (machines == shards)
# ---------------------------------------------------------------------------
class StackedMesh(_Counted):
    """All P shards in this process, on `device`: shard-local tensors carry
    a leading shard dimension S = P. `a2a_bytes` counts the bytes of every
    all-to-all's send buffer (all shards')."""

    kind = "stacked"

    def __init__(self, P: int, device):
        self.P = self.S = int(P)
        self.device = torch.device(device)
        self.reset_counts()

    @property
    def shards(self) -> np.ndarray:
        """The machines whose shards this process holds."""
        return np.arange(self.P)

    def axis_index(self) -> torch.Tensor:
        """(S,) int32: the machine of each local shard."""
        return torch.arange(self.P, dtype=torch.int32, device=self.device)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """(S, P, ...) -> (S, P, ...): row [s, p] of the result is what
        shard p sent to shard s."""
        self.a2a_bytes += x.numel() * x.element_size()
        n = x[0].numel() * x.element_size()
        self._note("all-to-all", n)
        return self._note_backward(x.transpose(0, 1).contiguous(),
                                   "all-to-all", n)

    def psum(self, x: torch.Tensor, boundary: Optional[str] = None
             ) -> torch.Tensor:
        """(S, ...) -> (S, ...): every row the sum over the mesh."""
        n = x[0].numel() * x.element_size()
        self._note("all-reduce", n, boundary)
        return self._note_backward(
            x.sum(0, keepdim=True, dtype=x.dtype).expand_as(x),
            "all-reduce", n)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(S, n, ...) -> (S, P·n, ...): every row all shards' rows."""
        self._note("all-gather", self.P * x[0].numel() * x.element_size())
        return x.reshape((1, -1) + x.shape[2:]).expand(
            (self.S, self.P * x.shape[1]) + x.shape[2:])

    def pvary(self, x: torch.Tensor) -> torch.Tensor:
        """An invariant (replicated) x -> (S, ...): every local shard's
        view of it. An expand: autograd sums the shards' gradients."""
        return x[None].expand((self.S,) + x.shape)

    def gather_shards(self, x: torch.Tensor) -> torch.Tensor:
        """(S, ...) local shards' rows -> (P, ...) every shard's rows, the
        same in every process: here the rows themselves (this process
        holds every shard; no collective)."""
        return x

    def mean_shards(self, a: torch.Tensor) -> torch.Tensor:
        """(S, ...) the local shards' values -> their mean over the mesh
        (`lax.pmean`), invariant."""
        return a.mean(0)


def _same_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _AllToAll(torch.autograd.Function):
    """The group's all-to-all of one shard's (P, ...) send rows; its
    transpose is the same exchange on the gradient."""

    @staticmethod
    def forward(ctx, mesh, send):
        ctx.mesh = mesh
        return mesh._exchange(send)

    @staticmethod
    def backward(ctx, g):
        ctx.mesh._note("all-to-all", _same_bytes(g))
        return None, ctx.mesh._exchange(g)


class _Psum(torch.autograd.Function):
    """The group's sum, varying in, invariant out: the gradient of an
    invariant result is already whole on every rank, so it passes
    through."""

    @staticmethod
    def forward(ctx, mesh, x):
        y = x.clone(memory_format=torch.contiguous_format)
        mesh._dist.all_reduce(y, group=mesh.group)
        return y

    @staticmethod
    def backward(ctx, g):
        return None, g


class _AllGather(torch.autograd.Function):
    """The group's gather along dim 0, invariant out: each rank's
    gradient is its own slice of the (whole, invariant) gradient — not a
    reduce-scatter, which would count it once a rank."""

    @staticmethod
    def forward(ctx, mesh, x):
        ctx.mesh, ctx.n = mesh, x.shape[0]
        send = x.contiguous()
        parts = [torch.empty_like(send) for _ in range(mesh.P)]
        mesh._dist.all_gather(parts, send, group=mesh.group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        r, n = ctx.mesh.rank, ctx.n
        return None, g[r * n:(r + 1) * n]


class _PVary(torch.autograd.Function):
    """Invariant in, varying out (`pbroadcast`): the identity, whose
    backward sums the rank-local gradients over the group."""

    @staticmethod
    def forward(ctx, mesh, x):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        mesh._note("all-reduce", _same_bytes(g), "pvary backward")
        y = g.clone(memory_format=torch.contiguous_format)
        mesh._dist.all_reduce(y, group=mesh.group)
        return None, y


class GroupMesh(_Counted):
    """One machine a process over a `torch.distributed` process group —
    `group`, or the initialized default (world) group when None — with S
    = 1: shard-local tensors carry a leading dimension of 1. `rank` is the
    process's rank inside the group, which is its machine."""

    kind = "group"

    def __init__(self, P: int, device, group=None):
        import torch.distributed as dist

        self._dist = dist
        self.group = group
        world = dist.get_world_size(group)
        if world != P:
            raise RuntimeError(
                f"backend='torch_spmd' runs one machine a process: the store "
                f"has P={P} machines but the process group has {world} "
                f"ranks. Initialize the group with world_size={P}, or call "
                "torch.distributed.destroy_process_group() to run the "
                "stacked mesh (all machines in one process)")
        self.P, self.S = int(P), 1
        self.rank = dist.get_rank(group)
        self.device = torch.device(device)
        self.reset_counts()

    @property
    def shards(self) -> np.ndarray:
        return np.array([self.rank])

    def axis_index(self) -> torch.Tensor:
        return torch.tensor([self.rank], dtype=torch.int32,
                            device=self.device)

    def _exchange(self, send: torch.Tensor) -> torch.Tensor:
        send = send.contiguous()
        recv = torch.empty_like(send)
        self._dist.all_to_all_single(recv, send, group=self.group)
        return recv

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        self.a2a_bytes += x.numel() * x.element_size()
        self._note("all-to-all", x[0].numel() * x.element_size())
        return _AllToAll.apply(self, x[0])[None]

    def psum(self, x: torch.Tensor, boundary: Optional[str] = None
             ) -> torch.Tensor:
        self._note("all-reduce", x[0].numel() * x.element_size(), boundary)
        return _Psum.apply(self, x)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        self._note("all-gather", self.P * x[0].numel() * x.element_size())
        return _AllGather.apply(self, x[0])[None]

    def pvary(self, x: torch.Tensor) -> torch.Tensor:
        return _PVary.apply(self, x)[None]

    def gather_shards(self, x: torch.Tensor) -> torch.Tensor:
        return self.all_gather(x[:, None])[0]

    def mean_shards(self, a: torch.Tensor) -> torch.Tensor:
        return self.psum(a)[0] / self.P


def get_mesh_kind() -> str:
    """"group" inside an initialized process group, else "stacked"."""
    import torch.distributed as dist

    return "group" if dist.is_available() and dist.is_initialized() \
        else "stacked"


def get_mesh(P: int, device):
    """The group mesh when a `torch.distributed` process group is
    initialized (its world size must be P), else the stacked mesh of P
    shards on `device`."""
    if get_mesh_kind() == "group":
        return GroupMesh(P, device)
    return StackedMesh(P, device)


def everywhere(mesh, x: torch.Tensor) -> torch.Tensor:
    """(S, ...) shard rows -> (P, ...): every machine's rows, in every
    process (a view on the stacked mesh, an all-gather on a group)."""
    return mesh.all_gather(x[:, None])[0]


# ---------------------------------------------------------------------------
# per-stage measured shard statistics
# ---------------------------------------------------------------------------
class ShardStageStats(NamedTuple):
    """What the sharded execution *measured* (per shard), as opposed to what
    the cost model charged: `tasks` per shard (== the cost model's Phase-3
    work placement), fetch/combine rows moved by the all-to-alls,
    replica-local reads, and the summed Phase-1 demand routed to each
    shard's owned chunks."""

    tasks: np.ndarray  # (P,) tasks executed on each shard
    pairs: np.ndarray  # (P,) active (task, key) pairs resident per shard
    fetch_sent: np.ndarray  # (P,) value requests sent into the a2a
    fetch_recv: np.ndarray  # (P,) requests received (owner-side demand)
    replica_local: np.ndarray  # (P,) pairs served from the replica slab
    writers: np.ndarray  # (P,) writing tasks per shard
    combine_sent: np.ndarray  # (P,) combined rows sent to owners
    combine_recv: np.ndarray  # (P,) combined rows received by owners
    owned_demand: np.ndarray  # (P,) global Phase-1 demand on owned chunks

    def work_ratio(self) -> float:
        """Measured max/mean task placement over shards (Definition 1)."""
        mean = float(self.tasks.mean()) if self.tasks.size else 0.0
        return float(self.tasks.max(initial=0.0) / max(mean, 1e-12))


# ---------------------------------------------------------------------------
# device residency (slabs per shard + replicated hot rows)
# ---------------------------------------------------------------------------
def _cache_key(mesh, np_dtype) -> tuple:
    return (str(mesh.device), str(np_dtype), mesh.kind,
            tuple(mesh.shards.tolist()))


def _slabs_for(store, mesh, np_dtype) -> torch.Tensor:
    """The sharded residency: (S, K_max, w), local shard s holding the chunk
    rows its machine homes (padding rows are zeros nobody addresses).
    Cached on the store and pinned to `store.version`: any host mutation,
    a migration's or a recovery's included, invalidates it."""
    lay = store.shard_layout()
    cache = store.__dict__.setdefault("_torch_spmd_slabs", {})
    key = _cache_key(mesh, np_dtype)
    ent = cache.get(key)
    if ent is not None and ent[0] == store.version:
        return ent[1]
    keys = lay.slab_keys[mesh.shards]  # (S, K_max)
    host = np.zeros(keys.shape + (store.value_width,), dtype=np_dtype)
    live = keys < store.num_keys
    host[live] = store.values[keys[live]]
    dev = torch.from_numpy(host).to(mesh.device)
    cache[key] = (store.version, dev)
    return dev


def _pin_slabs(store, mesh, np_dtype, dev) -> None:
    store.__dict__.setdefault("_torch_spmd_slabs", {})[
        _cache_key(mesh, np_dtype)] = (store.version, dev)


def _layout_maps(store, mesh):
    """(owner_ext, slot_ext) int64 on the device, (K+1,) each (index K is
    the sentinel: owner P, slot K_max). Cached per layout object: a rehome
    replaces the store's layout."""
    lay = store.shard_layout()
    ent = store.__dict__.get("_torch_spmd_maps")
    if ent is not None and ent[0] is lay and ent[1] == str(mesh.device):
        return ent[2]
    owner = np.append(lay.owner.astype(np.int64), store.P)
    slot = np.append(lay.local_slot.astype(np.int64), lay.slab_rows)
    maps = (torch.from_numpy(owner).to(mesh.device),
            torch.from_numpy(slot).to(mesh.device))
    store.__dict__["_torch_spmd_maps"] = (lay, str(mesh.device), maps)
    return maps


def _full_replicas(replicas) -> Optional[np.ndarray]:
    """The chunks every machine holds (only they join the replica slab: a
    partial holders bitmap falls back to the owner fetch — values are the
    same either way), or None."""
    if replicas is None or replicas.hot_ids.size == 0:
        return None
    ids = np.asarray(replicas.hot_ids, dtype=np.int64)[
        replicas.holders.all(axis=1)]
    return ids if ids.size else None


def _replica_arrays(store, replicas, mesh, np_dtype):
    """Replica residency, one copy a process: (rep_ids (H,), lookup_ext
    (K+1,), rep_slab (H, w)) with H pow2-padded (sentinel id = num_keys),
    or None when nothing is fully replicated. Cached per directory object
    and store version."""
    ids = _full_replicas(replicas)
    if ids is None:
        return None
    K = store.num_keys
    sig = (id(replicas), ids.size)
    cache = store.__dict__.setdefault("_torch_spmd_replicas", {})
    key = _cache_key(mesh, np_dtype)
    ent = cache.get(key)
    if ent is not None and ent[0] == store.version and ent[1] == sig:
        return ent[2]
    H = _bucket(ids.size)
    rep_ids = np.full(H, K, dtype=np.int64)
    rep_ids[:ids.size] = ids
    lookup = np.full(K + 1, -1, dtype=np.int64)
    lookup[ids] = np.arange(ids.size)
    rep_slab = np.zeros((H, store.value_width), dtype=np_dtype)
    rep_slab[:ids.size] = store.values[ids]
    out = tuple(torch.from_numpy(a).to(mesh.device)
                for a in (rep_ids, lookup, rep_slab))
    cache[key] = (store.version, sig, out)
    return out


def _pin_replicas(store, replicas, mesh, np_dtype, arrays) -> None:
    ids = _full_replicas(replicas)
    sig = (id(replicas), 0 if ids is None else ids.size)
    store.__dict__.setdefault("_torch_spmd_replicas", {})[
        _cache_key(mesh, np_dtype)] = (store.version, sig, arrays)


# ---------------------------------------------------------------------------
# the per-shard stage body (written once over the shard dimension S)
# ---------------------------------------------------------------------------
def _shard_offsets(S: int, n: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int64, device=device)[:, None] * n


def _flat_segments(seg: torch.Tensor, n: int) -> torch.Tensor:
    """(S, m) per-shard segment ids in [0, n] (n: writes nothing) -> flat
    int32 ids into S·n segments, shard s's offset by s·n; the sentinel
    becomes S·n."""
    S = seg.shape[0]
    flat = torch.where(seg < n, seg + _shard_offsets(S, n, seg.device),
                       torch.full_like(seg, S * n))
    return flat.reshape(-1).to(torch.int32).contiguous()


def _winners(seg_flat, num_segments: int, order, rowid):
    """Definition 2 case (iv)'s winner of each segment: the lowest `order`,
    ties to the lowest global task row `rowid`. Returns (winning order,
    winning rowid) per segment (int32, _IMAX where empty)."""
    idx = seg_flat.long()
    big = torch.full((num_segments + 1,), _IMAX, dtype=torch.int32,
                     device=order.device)
    win_o = big.clone().scatter_reduce_(0, idx, order, "amin")
    tie = (idx < num_segments) & (order == win_o[idx])
    win_r = big.scatter_reduce_(
        0, torch.where(tie, idx, torch.full_like(idx, num_segments)), rowid,
        "amin")
    return win_o[:num_segments], win_r[:num_segments]


def _rank_order(order: torch.Tensor, rowid: torch.Tensor) -> torch.Tensor:
    """int32 rank of each row by (order, global row): the write combine's
    order key on the owner side, where rows of one segment come from
    several shards and their position is not their global order. Ranks
    are distinct, so the combine's own tie-break by position never fires."""
    key = order.reshape(-1).long() * 2**32 + rowid.reshape(-1).long()
    perm = torch.sort(key).indices
    rank = torch.empty_like(perm)
    rank[perm] = torch.arange(perm.numel(), device=perm.device)
    return rank.to(torch.int32)


def _apply_to_slab(slab, combined, touched, merge_name):
    t = touched[..., None]
    if merge_name == "add":
        new = slab + combined
    elif merge_name == "min":
        new = torch.minimum(slab, combined)
    elif merge_name in ("max", "or"):
        new = torch.maximum(slab, combined)
    elif merge_name == "write":
        new = combined.expand_as(slab)
    else:
        raise KeyError(f"merge op {merge_name!r} has no sharded apply")
    return torch.where(t, new, slab)


class StageOut(NamedTuple):
    result: Optional[torch.Tensor]  # (S, T, ...) or None
    update: Optional[torch.Tensor]  # (S, T, uw) when asked for, else None
    update_width: int  # 0: the lambda returned no update to combine
    new_slabs: torch.Tensor  # (S, K_max, w)
    rep_new: Optional[torch.Tensor]  # (H, w) post-write replica slab
    stats: torch.Tensor  # (S, 9) int64, the ShardStageStats fields


def stage_body(mesh, slabs, ctx, valid, wk, order, grow, pkey, prow, pcol,
               mask, owner_ext, slot_ext, reps, *, f, fwd_mask: bool,
               ragged: bool, merge_name: str, combine: bool,
               want_update: bool, want_result: bool, K: int) -> StageOut:
    """One stage on every local shard. Shard-local arguments lead with S:
    slabs (S, K_max, w); ctx (S, T, ...); valid (S, T) bool; wk / order /
    grow (S, T) (write key, int32 priority, global task row); pkey (S, Np)
    (flat stages: Np == T, pair == task); ragged stages add prow / pcol
    (S, Np) and mask (S, T, A). owner_ext / slot_ext (K+1,) and `reps`
    ((rep_ids, rep_lookup_ext, rep_slab) or None) are replicated."""
    S, K_max, w = slabs.shape
    T, Np, P = valid.shape[1], pkey.shape[1], mesh.P
    dev, dt = slabs.device, slabs.dtype
    me = mesh.axis_index()
    H = 0 if reps is None else reps[0].shape[0]

    # ---- Phase 1: contention detection (histogram + psum) -----------------
    active = pkey >= 0 if ragged else valid & (pkey >= 0)
    sent_key = torch.where(active, pkey, torch.full_like(pkey, K)).long()
    gcounts = detect_contention(sent_key, K + 1, mesh)[0, :K].long()
    by_owner = torch.zeros(P + 1, dtype=torch.int64, device=dev).index_add_(
        0, owner_ext[:K], gcounts)
    owned_demand = by_owner[me.long()]

    # ---- Phase 2: co-location (replica-local read or a2a fetch) -----------
    if H:
        rep_slot = reps[1][sent_key]
        rep_hit = active & (rep_slot >= 0)
    else:
        rep_hit = torch.zeros_like(active)
    need = active & ~rep_hit
    dest = torch.where(need, owner_ext[sent_key], torch.full_like(sent_key, P))
    routing = bucket_routing(dest, P, Np, need)
    req = scatter_to_buckets(slot_ext[sent_key], routing, P, Np, fill=-1)
    recv = mesh.all_to_all(req).reshape(S, P * Np)
    del req
    r_ok = recv >= 0
    reply = slabs.reshape(S * K_max, w).index_select(
        0, (_shard_offsets(S, K_max, dev) + recv.clamp(0, K_max - 1))
        .reshape(-1))
    reply.masked_fill_(~r_ok.reshape(-1, 1), 0)
    back = mesh.all_to_all(reply.view(S, P, Np, w))
    del reply
    fetched = gather_from_buckets(back, routing, Np)  # (S, Np, w)
    del back
    if H:
        fetched = torch.where(rep_hit[..., None],
                              reps[2][rep_slot.clamp(0, H - 1)], fetched)

    # ---- Phase 3: local execution (the lambda sees S·T task rows) ---------
    ctx_flat = ctx.reshape((S * T,) + ctx.shape[2:])
    if ragged:
        A = mask.shape[2]
        live = prow < T
        slot = ((_shard_offsets(S, T, dev) + prow) * A + pcol)[live]
        gathered = torch.zeros((S * T * A, w), dtype=dt, device=dev)
        gathered[slot] = fetched[live]
        args = (ctx_flat, gathered.view(S * T, A, w), mask.reshape(S * T, A))
    else:
        gathered = fetched.masked_fill(~active[..., None], 0)
        args = (ctx_flat, gathered.reshape(S * T, w), active.reshape(-1))
    del fetched
    try:
        out = _call_user(f, dev, *(args if fwd_mask else args[:2]))
    except LambdaFailed as exc:
        raise ShardStageError(f"sharded stage lambda failed: {exc}") from exc
    out = dict(out) if out is not None else {}
    res = out.get("result") if want_result else None
    if res is not None:
        res = torch.as_tensor(res, device=dev)
        res = res.reshape((S, T) + res.shape[1:])
    upd_raw = out.get("update")
    u = None
    if upd_raw is not None and (combine or want_update):
        u = _as_update_rows(upd_raw, S * T, dt, dev)
    uw = 0 if u is None else u.shape[1]

    # ---- Phase 4: local ⊗-combine, a2a to owners, owner-side ⊗ and ⊙ -----
    writer = valid & (wk >= 0)
    n_sent = n_recv = torch.zeros(S, dtype=torch.int64, device=dev)
    new_slab, touched = slabs, None
    if combine and u is not None:
        if uw not in (1, w):
            raise ShardStageError(f"update rows of width {uw} do not apply "
                                  f"to values of width {w}")
        wkey = torch.where(writer, wk, torch.full_like(wk, K)).long()
        skey = torch.sort(wkey, dim=-1).values
        first = torch.ones_like(skey, dtype=torch.bool)
        first[:, 1:] = skey[:, 1:] != skey[:, :-1]
        ukeys = torch.full_like(skey, K).scatter_(
            1, torch.cumsum(first, -1) - 1, skey)  # sorted unique, K-padded
        seg = torch.where(writer, torch.searchsorted(ukeys, wkey),
                          torch.full_like(wkey, T))
        seg_flat = _flat_segments(seg, T)
        order_flat = order.reshape(-1).contiguous()
        combined = _segment_combine(u, seg_flat, S * T, merge_name,
                                    order_flat).view(S, T, uw)
        uactive = ukeys < K
        routing2 = bucket_routing(owner_ext[ukeys], P, T, uactive)
        r_rows = mesh.all_to_all(scatter_to_buckets(
            combined, routing2, P, T)).reshape(S * P * T, uw)
        r_slot = mesh.all_to_all(scatter_to_buckets(
            slot_ext[ukeys], routing2, P, T, fill=-1)).reshape(S, P * T)
        r_live = r_slot >= 0
        seg2 = _flat_segments(torch.where(r_live, r_slot,
                                          torch.full_like(r_slot, K_max)),
                              K_max)
        order2 = None
        if merge_name == "write":
            pay_o, pay_r = _winners(seg_flat, S * T, order_flat,
                                    grow.reshape(-1))
            r_ord = mesh.all_to_all(scatter_to_buckets(
                pay_o.view(S, T), routing2, P, T, fill=_IMAX))
            r_row = mesh.all_to_all(scatter_to_buckets(
                pay_r.view(S, T), routing2, P, T, fill=_IMAX))
            order2 = _rank_order(r_ord, r_row)
        comb2 = _segment_combine(r_rows, seg2, S * K_max, merge_name,
                                 order2).view(S, K_max, uw)
        touched = torch.zeros(S * K_max + 1, dtype=torch.bool, device=dev)
        touched[seg2.long()] = True
        touched = touched[:-1].view(S, K_max)
        new_slab = _apply_to_slab(slabs, comb2, touched, merge_name)
        n_sent = uactive.sum(1)
        n_recv = r_live.sum(1)

    # ---- replica write-through: owners broadcast post-apply rows ----------
    rep_new = None if reps is None else reps[2]
    if H and touched is not None:
        rep_ids = reps[0]
        rep_local = slot_ext[rep_ids].clamp(0, K_max - 1)
        mine = (rep_ids < K)[None, :] & (owner_ext[rep_ids][None, :]
                                         == me[:, None])
        rep_touch = mine & touched[:, rep_local]
        contrib = torch.where(rep_touch[..., None], new_slab[:, rep_local],
                              torch.zeros((), dtype=dt, device=dev))
        tmask = mesh.psum(rep_touch.to(torch.int32))[0] > 0
        rep_new = torch.where(tmask[:, None], mesh.psum(contrib)[0], reps[2])

    stats = torch.stack([
        valid.sum(1), active.sum(1), need.sum(1), r_ok.sum(1),
        rep_hit.sum(1), writer.sum(1), n_sent, n_recv, owned_demand], 1)
    upd = u.view(S, T, uw) if want_update and u is not None else None
    return StageOut(result=res, update=upd,
                    update_width=uw if combine else 0,
                    new_slabs=new_slab, rep_new=rep_new, stats=stats)


# ---------------------------------------------------------------------------
# host-side stage driver
# ---------------------------------------------------------------------------
class ShardPlacement(NamedTuple):
    """Host layout of one batch over the mesh: task t lives on
    `shard[t]` at slot `slot[t]` of a (P, T_cap) block."""

    shard: np.ndarray
    slot: np.ndarray
    T_cap: int


def place_tasks(exec_site: np.ndarray, P: int) -> ShardPlacement:
    exec_site = np.asarray(exec_site, dtype=np.int64)
    slot, counts = stable_bucket_slots(exec_site, P)
    return ShardPlacement(shard=exec_site, slot=slot,
                          T_cap=_bucket(int(counts.max(initial=1))))


def run_sharded_stage(backend, tasks, store, f, merge,
                      want_result: bool, combine: bool, want_update: bool,
                      exec_site: Optional[np.ndarray],
                      replicas) -> Dict[str, object]:
    """Execute one stage's numerics over the backend's mesh. Returns the
    backend-facing dict: host `result`/`update` rows (in original task
    order), the apply carry (`new_slabs`, `rep_arrays`), the measured
    `ShardStageStats` and the update width."""
    P = store.P
    mesh = backend.mesh(P)
    rows = mesh.shards
    lay = store.shard_layout()
    np_dtype = backend._np_dtype
    n = tasks.n
    site = tasks.origin if exec_site is None else exec_site
    pl = place_tasks(site, P)
    T = pl.T_cap

    def up(a):  # this process's shards of a (P, ...) host array
        return torch.from_numpy(np.ascontiguousarray(a[rows])).to(
            mesh.device)

    ctx_np = np.asarray(tasks.contexts).astype(np_dtype, copy=False)
    # rank-preserving: 1-D contexts reach the lambda as 1-D, as the oracle
    # passes them
    ctx = np.zeros((P, T) + ctx_np.shape[1:], dtype=np_dtype)
    ctx[pl.shard, pl.slot] = ctx_np
    valid = np.zeros((P, T), dtype=bool)
    valid[pl.shard, pl.slot] = True
    wk = np.full((P, T), -1, dtype=np.int64)
    wk[pl.shard, pl.slot] = tasks.write_keys
    order = np.zeros((P, T), dtype=np.int32)
    order[pl.shard, pl.slot] = np.clip(tasks.priority, -2**31, 2**31 - 1)
    grow = np.full((P, T), n, dtype=np.int32)
    grow[pl.shard, pl.slot] = np.arange(n, dtype=np.int32)

    ragged = tasks.max_arity > 1
    prow = pcol = mask = None
    if ragged:
        A = int(tasks.max_arity)
        pair_shard = pl.shard[tasks.pair_task]
        pair_col = np.arange(tasks.nnz, dtype=np.int64) \
            - tasks.read_indptr[:-1][tasks.pair_task]
        pslot, pcounts = stable_bucket_slots(pair_shard, P)
        Np = _bucket(int(pcounts.max(initial=1)))
        pkey = np.full((P, Np), -1, dtype=np.int64)
        pkey[pair_shard, pslot] = tasks.read_indices
        prow_np = np.full((P, Np), T, dtype=np.int64)
        prow_np[pair_shard, pslot] = pl.slot[tasks.pair_task]
        pcol_np = np.zeros((P, Np), dtype=np.int64)
        pcol_np[pair_shard, pslot] = pair_col
        mask_np = np.zeros((P, T, A), dtype=bool)
        mask_np[pair_shard, pl.slot[tasks.pair_task], pair_col] = True
        prow, pcol, mask = up(prow_np), up(pcol_np), up(mask_np)
    else:
        pkey = np.full((P, T), -1, dtype=np.int64)
        pkey[pl.shard, pl.slot] = tasks.read_keys

    owner_ext, slot_ext = _layout_maps(store, mesh)
    reps = _replica_arrays(store, replicas, mesh, np_dtype)
    slabs = _slabs_for(store, mesh, np_dtype)
    a2a_before = mesh.a2a_bytes
    so = stage_body(
        mesh, slabs, up(ctx), up(valid), up(wk), up(order), up(grow),
        up(pkey), prow, pcol, mask, owner_ext, slot_ext, reps, f=f,
        fwd_mask=execution._accepts_mask(f), ragged=ragged,
        merge_name=merge.name if merge is not None else "add",
        combine=combine, want_update=want_update, want_result=want_result,
        K=store.num_keys)
    backend.a2a_bytes += mesh.a2a_bytes - a2a_before

    stats_np = everywhere(mesh, so.stats).cpu().numpy()
    stats = ShardStageStats(*(stats_np[:, i].astype(np.int64)
                              for i in range(stats_np.shape[1])))
    out: Dict[str, object] = {"result": None, "update": None,
                              "new_slabs": so.new_slabs, "stats": stats,
                              "rep_arrays": None,
                              "update_width": so.update_width}
    if reps is not None:
        out["rep_arrays"] = (reps[0], reps[1], so.rep_new)
    shard_t = torch.from_numpy(pl.shard).to(mesh.device)
    slot_t = torch.from_numpy(pl.slot).to(mesh.device)
    if so.result is not None:
        out["result"] = backend._to_host(
            everywhere(mesh, so.result)[shard_t, slot_t])
    if so.update is not None:
        out["update"] = backend._to_host(
            everywhere(mesh, so.update)[shard_t, slot_t])
    return out


def gather_slab_rows(store, mesh, new_slabs, keys: np.ndarray) -> np.ndarray:
    """The post-apply rows for `keys`, read out of the sharded slabs: the
    rows of the local shards, summed over the group when this process does
    not hold every shard (each row has one owner: the sum is exact)."""
    lay = store.shard_layout()
    local = lay.owner[keys] - int(mesh.shards[0])
    mine = (local >= 0) & (local < mesh.S)
    rows = torch.zeros((keys.size, store.value_width), dtype=new_slabs.dtype,
                       device=new_slabs.device)
    sel = torch.from_numpy(np.flatnonzero(mine)).to(new_slabs.device)
    rows[sel] = new_slabs[torch.from_numpy(local[mine]).to(new_slabs.device),
                          torch.from_numpy(lay.local_slot[keys][mine]).to(
                              new_slabs.device)]
    if mesh.S < mesh.P:
        rows = mesh.psum(rows[None])[0]
    return rows.cpu().numpy()
