"""Device side of the four phases, on torch tensors (the counterpart of the
JAX package's `core/jaxexec.py`).

`core/backend.py`'s `TorchBackend` drives the simulator's numeric pass
through these: the Phase-1 contention histogram (`kernels.histogram`), the
Phase-3 gather + lambda, the Phase-4 merge-able segment-combine
(`kernels.segment_combine`, every merge including the ordered "write"), the
ragged fused stage (`kernels.stage_fused`), the ⊙-apply onto the
device-resident store copy, and the DistEdgeMap's per-destination combines
(`combine_dense`, `sorted_segment_sum`). The mesh-sharded stage
(`core/shardexec.py`) and the SPMD MoE dispatch (`core/spmd.py`) share
`detect_contention` (the histogram plus a sum over the mesh) and the
capacity-bounded bucket routing (`bucket_routing`, `scatter_to_buckets`,
`gather_from_buckets`), which take an optional leading shard dimension.

PyTorch runs eagerly, so nothing here pads to static shapes: writer lists
hold exactly the writers and `num_segments` is the real segment count. A
segment id equal to `num_segments` still means "this row writes nothing".

The only `try` on this path wraps the call of user code (`_call_user`):
a stage lambda or `finish` epilogue that torch cannot run raises
`LambdaFailed`, which the backend answers with its per-lambda host path.
Kernel builds, launches and wrapper checks are never inside it, and a
device error (out of memory, a kernel fault) passes through it.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..kernels.histogram.ops import count_ids
from ..kernels.segment_combine.ops import combine as _kernel_combine
from ..kernels.stage_fused.ops import fused_stage as _fused_stage

# errors of the device, never of the user's code: they propagate
_DEVICE_ERRORS = tuple(e for e in (torch.cuda.OutOfMemoryError,
                                   getattr(torch, "AcceleratorError", None))
                       if e is not None)


class LambdaFailed(Exception):
    """A stage lambda or `finish` epilogue raised on torch tensors."""


def _call_user(fn, device: torch.device, *args):
    """Call user code on tensors of `device`; raise `LambdaFailed` if the
    code itself fails. On the card, the kernels launched before are
    synchronized first: a fault of theirs is reported asynchronously, at
    the next launch, and must raise here, outside the try. A device error
    inside the call propagates too (a sticky fault raises again at the
    second synchronize)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    try:
        return fn(*args)
    except _DEVICE_ERRORS:
        raise
    except Exception as exc:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        raise LambdaFailed(f"{fn!r} cannot run on torch tensors: "
                           f"{exc!r}") from exc


# ---------------------------------------------------------------------------
# Phase 1: contention histogram (kernels.histogram)
# ---------------------------------------------------------------------------
def contention_counts(ids: torch.Tensor, num_bins: int,
                      weights: torch.Tensor | None = None) -> torch.Tensor:
    """Per-id demand histogram: (num_bins,) int32 counts (weighted: counts
    in the weights' dtype); out-of-range ids are dropped. Both forms run
    the histogram kernel on the card."""
    return count_ids(ids.reshape(-1), num_bins, weights=weights)


def detect_contention(item_ids: torch.Tensor, num_items: int, mesh=None,
                      weights: torch.Tensor | None = None) -> torch.Tensor:
    """Global reference count per data item (§3.1), the one Phase-1
    primitive of every realization. With `mesh` None: the histogram of all
    of `item_ids`, (num_items,). With a mesh (`core.shardexec`): `item_ids`
    is (S, ...) — shard s's ids in row s — and the result (S, num_items)
    holds in every row the counts summed over the mesh: one histogram
    launch over all S shards (shard s's ids offset by s·num_items, ids
    outside [0, num_items) dropped first), then `mesh.psum`."""
    if mesh is None:
        return contention_counts(
            item_ids.reshape(-1).to(torch.int32).contiguous(), num_items,
            weights)
    S = item_ids.shape[0]
    if S * num_items >= 2**31:
        raise ValueError(f"{S} shards x {num_items} items exceed the "
                         "histogram's int32 bins")
    ids = item_ids.reshape(S, -1)
    off = torch.arange(S, dtype=torch.int32, device=ids.device)[:, None] \
        * num_items
    inside = (ids >= 0) & (ids < num_items)
    flat = torch.where(inside, ids.to(torch.int32) + off,
                       torch.full_like(off, -1)).reshape(-1)
    w = None if weights is None else weights.reshape(-1).contiguous()
    counts = contention_counts(flat.contiguous(), S * num_items, w)
    return mesh.psum(counts.view(S, num_items))


def select_hot(counts: torch.Tensor, num_hot: int, min_count=1):
    """Top-`num_hot` items by demand, thresholded. Returns (hot_ids (H,),
    rank lookup (E,) with -1 = cold, valid (H,)). Ties break to the lowest
    index, as `lax.top_k` does: a stable descending sort, because
    `torch.topk` promises no order among equal values."""
    num_items = counts.shape[0]
    order = torch.sort(counts, descending=True, stable=True).indices
    hot_ids = order[:num_hot]
    valid = counts[hot_ids] >= min_count
    lookup = torch.full((num_items,), -1, dtype=torch.int32,
                        device=counts.device)
    ranks = torch.arange(num_hot, dtype=torch.int32, device=counts.device)
    lookup[hot_ids] = torch.where(valid, ranks, torch.full_like(ranks, -1))
    return hot_ids, lookup, valid


# ---------------------------------------------------------------------------
# Phase 2: routing permutation
# ---------------------------------------------------------------------------
def stable_argsort(keys: torch.Tensor) -> torch.Tensor:
    """Stable argsort — the same permutation as numpy's stable argsort
    (stability pins the order of equal keys, so the two agree exactly)."""
    return torch.sort(keys, stable=True).indices


def sort_by_group(ids: torch.Tensor, num_groups: int):
    """Stable sort of assignments by group id along the last dimension;
    returns (order, int32 group sizes (..., num_groups)). An id equal to
    `num_groups` is the sentinel group: it sorts last and is not counted."""
    order = torch.sort(ids, dim=-1, stable=True).indices
    sizes = _bincount_last(ids, num_groups + 1)[..., :num_groups]
    return order, sizes


def inverse_permutation(order: torch.Tensor) -> torch.Tensor:
    """The inverse of a permutation along the last dimension."""
    n = order.shape[-1]
    ar = torch.arange(n, dtype=order.dtype, device=order.device)
    return torch.empty_like(order).scatter_(-1, order, ar.expand_as(order))


def _bincount_last(ids: torch.Tensor, num_bins: int) -> torch.Tensor:
    """int32 counts of `ids` in [0, num_bins) along the last dimension:
    bucket sizes of the routing, not a Phase-1 histogram."""
    ok = (ids >= 0) & (ids < num_bins)
    out = torch.zeros(ids.shape[:-1] + (num_bins + 1,), dtype=torch.int32,
                      device=ids.device)
    idx = torch.where(ok, ids, torch.full_like(ids, num_bins)).long()
    out.scatter_add_(-1, idx, ok.to(torch.int32))
    return out[..., :num_bins]


# ---------------------------------------------------------------------------
# capacity-bounded bucket routing (the all-to-all send buffers)
# ---------------------------------------------------------------------------
class Routing(NamedTuple):
    """Per assignment, in sorted order (all (..., n)): the sort `order`,
    the destination bucket `dest` (num_buckets for inactive ones), the
    position `pos` in the bucket, and `keep` (active and under capacity)."""

    order: torch.Tensor
    dest: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor


def bucket_routing(dest: torch.Tensor, num_buckets: int, capacity: int,
                   active: torch.Tensor) -> Routing:
    """Stable-sort assignments by destination bucket along the last
    dimension and give each its slot; slots at or beyond `capacity` are
    dropped (push-side overflow). Leading dimensions are independent
    batches (the shards of a stacked mesh)."""
    key = torch.where(active, dest, torch.full_like(dest, num_buckets))
    key_sorted, order = torch.sort(key, dim=-1, stable=True)
    counts = _bincount_last(key_sorted, num_buckets + 1)
    starts = torch.cumsum(counts, dim=-1, dtype=torch.int32) - counts
    n = dest.shape[-1]
    pos = torch.arange(n, dtype=torch.int32, device=dest.device) \
        - starts.gather(-1, key_sorted.long())
    keep = (key_sorted < num_buckets) & (pos < capacity)
    return Routing(order=order, dest=key_sorted, pos=pos, keep=keep)


def _bucket_index(routing: Routing, num_buckets: int, capacity: int):
    """Flat index of each sorted assignment's slot in a
    (batch..., num_buckets, capacity) buffer (clamped where not kept)."""
    batch = routing.dest.shape[:-1]
    base = torch.arange(math.prod(batch), device=routing.dest.device).reshape(
        batch + (1,)) * (num_buckets * capacity)
    slot = routing.dest.clamp(max=num_buckets - 1).long() * capacity \
        + routing.pos.clamp(0, capacity - 1).long()
    return (base + slot).reshape(-1)


def _flat_rows(order: torch.Tensor) -> torch.Tensor:
    """Flat row index (into the rows with every leading dimension folded)
    of each entry of `order`, an index along the last dimension."""
    batch, n = order.shape[:-1], order.shape[-1]
    base = torch.arange(math.prod(batch), device=order.device).reshape(
        batch + (1,)) * n
    return (base + order.long()).reshape(-1)


def scatter_to_buckets(rows: torch.Tensor, routing: Routing,
                       num_buckets: int, capacity: int, fill=0):
    """(..., n, *d) rows -> (..., num_buckets, capacity, *d) send buffer;
    slots nobody fills hold `fill`. The kept rows are read by one flat
    index (under autograd it keeps that index, not the rows)."""
    batch = routing.order.shape[:-1]
    nd = len(batch)
    d_shape = rows.shape[nd + 1:]
    keep = routing.keep.reshape(-1)
    buf = torch.full((num_buckets * capacity * math.prod(batch),) + d_shape,
                     fill, dtype=rows.dtype, device=rows.device)
    idx = _bucket_index(routing, num_buckets, capacity)[keep]
    buf[idx] = rows.reshape((-1,) + d_shape)[_flat_rows(routing.order)[keep]]
    return buf.view(batch + (num_buckets, capacity) + d_shape)


def gather_from_buckets(buf: torch.Tensor, routing: Routing,
                        num_assign: int) -> torch.Tensor:
    """Inverse of `scatter_to_buckets`: (..., B, cap, *d) -> (..., n, *d)
    in original assignment order (dropped slots read back as zeros), by
    one flat index."""
    batch = routing.order.shape[:-1]
    nd = len(batch)
    nbk, cap = buf.shape[nd], buf.shape[nd + 1]
    d_shape = buf.shape[nd + 2:]
    if routing.order.shape[-1] != num_assign:
        raise ValueError(f"routing has {routing.order.shape[-1]} "
                         f"assignments, not {num_assign}")
    # assignment j (original order) sits at sorted position inv[j]
    at = _flat_rows(inverse_permutation(routing.order))
    src = _bucket_index(routing, nbk, cap)[at]
    keep = routing.keep.reshape(-1)[at]
    got = buf.reshape((-1,) + d_shape).index_select(0, src)
    got = got.masked_fill_(~keep.reshape((-1,) + (1,) * len(d_shape)), 0)
    return got.view(routing.order.shape + d_shape)


# ---------------------------------------------------------------------------
# Phase 4: merge-able segment combine (kernels.segment_combine)
# ---------------------------------------------------------------------------
def _segment_combine(updates, seg, num_segments: int, merge_name: str, order):
    """⊗-combine `updates` rows per segment; seg == num_segments drops the
    row. ``write`` keeps, per segment, the row of lowest `order`, ties to
    the lowest row (Definition 2 case iv, exactly the numpy oracle)."""
    return _kernel_combine(updates, seg, num_segments, op=merge_name,
                           order=order if merge_name == "write" else None)


def _as_update_rows(upd, n: int, dtype, device):
    """Normalize a lambda's "update" output to contiguous (n, w) rows (the
    same atleast_2d/transpose coercion the numpy apply path performs)."""
    u = torch.as_tensor(upd, dtype=dtype, device=device)
    if u.ndim < 2:
        u = u.reshape(1, -1)
    if u.shape[0] != n:
        u = u.T
    return u.contiguous()


def _finish_stage(out, n: int, values, w_idx, seg, order, *, num_segments,
                  merge_name: str, combine: bool, want_update: bool,
                  want_result: bool):
    """Shared tail of the flat and padded stages: coerce the lambda output,
    ⊗-combine the writer rows (compacted through `w_idx` so combine cost
    scales with writers, not batch size), and drop what the host did not
    ask for."""
    out = dict(out) if out is not None else {}
    upd = out.get("update")
    combined = None
    if combine and upd is not None:
        u = _as_update_rows(upd, n, values.dtype, values.device)
        combined = _segment_combine(u[w_idx], seg, num_segments, merge_name,
                                    order)
    return {"result": out.get("result") if want_result else None,
            "update": upd if want_update else None,
            "combined": combined}


# ---------------------------------------------------------------------------
# Phase 3 + 4: gather → lambda → writer ⊗-combine
# ---------------------------------------------------------------------------
def run_stage_flat(values, keys, contexts, w_idx, seg, order, *, f,
                   fwd_mask: bool, num_segments: int, merge_name: str,
                   combine: bool, want_update: bool, want_result: bool = True):
    """Arity-≤1 stage numerics: gather each task's chunk (zeros where it
    reads nothing), run the lambda, ⊗-combine its writers' updates.
    `w_idx` lists the writer task rows, `seg[j]` writer j's segment,
    `order[j]` its priority for "write" merges."""
    has = keys >= 0
    gathered = torch.where(has[:, None], values[keys.clamp(min=0)],
                           torch.zeros((), dtype=values.dtype,
                                       device=values.device))
    out = _call_user(f, values.device, contexts, gathered, has) if fwd_mask \
        else _call_user(f, values.device, contexts, gathered)
    return _finish_stage(out, keys.shape[0], values, w_idx, seg, order,
                         num_segments=num_segments, merge_name=merge_name,
                         combine=combine, want_update=want_update,
                         want_result=want_result)


def padded_gather(values, read_indices, row, col, mask):
    """The padded `(n, A, w)` view of a ragged batch: slot (row[j], col[j])
    holds `values[read_indices[j]]`, every other slot 0. Made in one
    allocation — a row index per slot (pad slots point at row 0), one
    `index_select`, then the pad slots zeroed in place — so no (nnz, w)
    temporary exists beside it (at an MoE layer's width that temporary is
    as large as the view)."""
    n, A = mask.shape
    src = torch.zeros(n * A, dtype=torch.int64, device=values.device)
    src[row * A + col] = read_indices
    gathered = values.index_select(0, src).view(n, A, values.shape[1])
    return gathered.masked_fill_(~mask[..., None], 0)


def run_stage_ragged(values, read_indices, row, col, mask, contexts, w_idx,
                     seg, order, *, f, fwd_mask: bool, num_segments: int,
                     merge_name: str, combine: bool, want_update: bool,
                     want_result: bool = True):
    """Ragged (multi-get) stage numerics for a generic lambda: the padded
    `(n, max_arity, w)` gather plus validity mask, then lambda + writer
    ⊗-combine as in `run_stage_flat`."""
    gathered = padded_gather(values, read_indices, row, col, mask)
    out = _call_user(f, values.device, contexts, gathered, mask) \
        if fwd_mask else _call_user(f, values.device, contexts, gathered)
    return _finish_stage(out, mask.shape[0], values, w_idx, seg, order,
                         num_segments=num_segments, merge_name=merge_name,
                         combine=combine, want_update=want_update,
                         want_result=want_result)


def run_stage_fused(values, indptr, indices, contexts, seg, order, *,
                    num_segments: int, read_op: str, finish,
                    merge_name: str, combine: bool, want_update: bool,
                    want_result: bool = True, max_arity: int | None = None):
    """Ragged-native stage numerics for a fused-able lambda
    (`core/fusedlam.FusedStageLambda`): the stage_fused gather-reduce
    kernel walks the CSR pair list, `finish` runs as torch ops on its
    (n, w) output, and the writer ⊗-combine runs the segment-combine
    kernel over per-task `seg` (== `num_segments`: writes nothing).
    `max_arity` is the batch's: min/max reads fold the oracle's padding
    into the tasks below it."""
    fin = None if finish is None else (
        lambda ctx, red: _call_user(finish, values.device, ctx, red))
    upd, combined = _fused_stage(
        values, indptr, indices, contexts, seg, order,
        num_segments=num_segments, read_op=read_op, finish=fin,
        merge_name=merge_name, combine=combine, max_arity=max_arity)
    return {"result": upd if want_result else None,
            "update": upd if want_update else None,
            "combined": combined}


def combine_dense(values, seg, *, num_segments: int, merge_name: str):
    """Dense segment combine over the full key range — the DistEdgeMap
    per-destination-vertex write-combine in one segment-combine call (the
    kernel on the card). "write" keeps, per segment, its lowest row."""
    order = torch.zeros(values.shape[0], dtype=torch.int32,
                        device=values.device)
    return _segment_combine(values, seg, num_segments, merge_name, order)


def sorted_segment_sum(values, order, seg_ends):
    """Segment sum via a cached routing permutation: permute rows into
    segment-contiguous order, prefix-sum, difference at segment ends. No
    scatter at all — the route for workloads that reduce one key set
    stage after stage (PageRank re-reduces the same edges every round).
    `seg_ends[i]` is the last permuted row of segment i. Accuracy: sums are
    differences of a prefix sum in the values' dtype, so a segment's
    absolute error grows with the prefix's magnitude, not its own."""
    cs = torch.cumsum(values.index_select(0, order), dim=0)
    ends = cs.index_select(0, seg_ends)
    return torch.cat([ends[:1], ends[1:] - ends[:-1]])


# ---------------------------------------------------------------------------
# Phase 4 ⊙: apply onto the device-resident store copy
# ---------------------------------------------------------------------------
def apply_rows(values, uniq, combined, *, merge_name: str):
    """⊙-apply combined updates to the device-resident store copy, in place
    (the cache entry is re-pinned to the new store version right after, so
    no copy of the whole table is needed). `uniq` is the sorted, unique
    written-key list; `combined` rows align with it."""
    cur = values[uniq]
    if merge_name == "add":
        new = cur + combined
    elif merge_name == "min":
        new = torch.minimum(cur, combined)
    elif merge_name in ("max", "or"):
        new = torch.maximum(cur, combined)
    elif merge_name == "write":
        new = combined
    else:
        raise KeyError(f"merge op {merge_name!r} has no torch apply")
    values[uniq] = new
    return values
