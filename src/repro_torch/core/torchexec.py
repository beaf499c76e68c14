"""Device side of the four phases, on torch tensors (the counterpart of the
JAX package's `core/jaxexec.py`, limited to what one single-device stage
needs).

`core/backend.py`'s `TorchBackend` drives the simulator's numeric pass
through these: the Phase-1 contention histogram (`kernels.histogram`), the
Phase-3 gather + lambda, the Phase-4 merge-able segment-combine
(`kernels.segment_combine`, every merge including the ordered "write"), the
ragged fused stage (`kernels.stage_fused`), the ⊙-apply onto the
device-resident store copy, and the DistEdgeMap's per-destination combines
(`combine_dense`, `sorted_segment_sum`).

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
