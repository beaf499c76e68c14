"""Merge-able write-back operators (§3.4, Definition 2).

An operation ⊕ is merge-able iff there exist ⊙ and ⊗ with
    x ⊕ y₁ ⊕ … ⊕ yₙ = x ⊙ (y₁ ⊗ … ⊗ yₙ).
⊗ ("combine") pre-aggregates updates anywhere in the network — at execution
sites, at transit machines on the reverse meta-task tree, at forest nodes —
and ⊙ ("apply") touches the authoritative chunk exactly once. This is the
property that lets Phase 4 write-backs ride the tree without blowing up the
root's inbound traffic.

Updates are (rows, width) arrays. `combine_segments` performs the ⊗ reduction
over groups given by a segment id (rows pre-sorted not required).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class MergeOp:
    name: str
    # ⊗ : segment-combine updates. (values, segment_ids, num_segments, order)
    # `order` breaks ties deterministically (task priority / timestamp).
    combine_segments: Callable[[np.ndarray, np.ndarray, int, np.ndarray], np.ndarray]
    # ⊙ : apply combined update to stored value. (old, update) -> new
    apply: Callable[[np.ndarray, np.ndarray], np.ndarray]
    # identity element for ⊗ (used to mask absent segments)
    identity: float


def _seg_ufunc(ufunc, init):
    def combine(values, seg, nseg, order):
        out = np.full((nseg,) + values.shape[1:], init, dtype=values.dtype)
        ufunc.at(out, seg, values)
        return out

    return combine


def _seg_first_by_order(values, seg, nseg, order):
    """Deterministic 'one write wins': smallest `order` in each segment wins
    (Definition 2 case (iv): e.g. smallest timestamp / transaction id)."""
    # lexsort: primary seg, secondary order; first row of each segment wins.
    perm = np.lexsort((order, seg))
    seg_sorted = seg[perm]
    first = np.ones(len(perm), dtype=bool)
    first[1:] = seg_sorted[1:] != seg_sorted[:-1]
    out = np.zeros((nseg,) + values.shape[1:], dtype=values.dtype)
    out[seg_sorted[first]] = values[perm[first]]
    return out


_FMAX = np.finfo(np.float64).max


MERGE_OPS: Dict[str, MergeOp] = {
    # set-associative ⊕: ⊙ and ⊗ are both ⊕ (Definition 2 case (ii))
    "add": MergeOp(
        "add", _seg_ufunc(np.add, 0.0), lambda old, upd: old + upd, 0.0
    ),
    "min": MergeOp(
        "min", _seg_ufunc(np.minimum, _FMAX), np.minimum, _FMAX
    ),
    "max": MergeOp(
        "max", _seg_ufunc(np.maximum, -_FMAX), np.maximum, -_FMAX
    ),
    # idempotent ⊕ (case (i)): logical-or style flag writes
    "or": MergeOp(
        "or", _seg_ufunc(np.maximum, 0.0), np.maximum, 0.0
    ),
    # deterministic overwrite (case (iv)): lowest task priority wins
    "write": MergeOp(
        "write", _seg_first_by_order, lambda old, upd: upd, 0.0
    ),
}


def get_merge_op(name_or_op) -> MergeOp:
    if isinstance(name_or_op, MergeOp):
        return name_or_op
    try:
        return MERGE_OPS[name_or_op]
    except KeyError:
        raise KeyError(
            f"unknown merge op {name_or_op!r}; available: {sorted(MERGE_OPS)}"
        ) from None
