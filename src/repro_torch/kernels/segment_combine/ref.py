"""Plain PyTorch version of the Phase-4 merge-able ⊗-combine.

Sort-based, so it neither shares code with the CUDA kernel nor calls the
library's scatter reductions: the in-range rows are stably sorted by
segment, and each segment's result is read off its run — a float64 sum of
the run for ``add`` (`torch.segment_reduce`: a prefix-sum difference would
carry the magnitude of every earlier segment into a small segment's
error), a per-column sort for ``min``/``max``/``or``, and for
``write`` the first row of the run after a stable sort by order (lowest
order, then lowest row, wins).

As the numpy oracle's ``np.minimum.at`` / ``np.maximum.at``: a NaN in a
segment's column makes that column NaN, and the merge identity folds into
every hit segment (a min segment of +inf updates holds ``finfo.max``).
"""
from __future__ import annotations

import torch

MERGES = ("add", "min", "max", "or", "write")


def identity(op: str, dtype: torch.dtype) -> float:
    """The value an empty segment holds: 0 for add/or/write, +max for min,
    -max for max (of `dtype`)."""
    if op == "min":
        return torch.finfo(dtype).max
    if op == "max":
        return -torch.finfo(dtype).max
    return 0.0


def _runs(sorted_seg: torch.Tensor):
    """(first, last) index of each run of equal values in a sorted vector."""
    change = sorted_seg[1:] != sorted_seg[:-1]
    first = torch.ones_like(sorted_seg, dtype=torch.bool)
    first[1:] = change
    last = torch.ones_like(sorted_seg, dtype=torch.bool)
    last[:-1] = change
    return torch.nonzero(first).reshape(-1), torch.nonzero(last).reshape(-1)


def combine_ref(values: torch.Tensor, seg: torch.Tensor, num_segments: int,
                *, op: str = "add", order: torch.Tensor | None = None,
                fold: bool = True) -> torch.Tensor:
    """(N, W) values, (N,) seg -> (num_segments, W). Rows with seg outside
    [0, num_segments) are dropped; empty segments hold `identity(op)`, and
    with `fold` hit min/max/or segments fold it in too (`fold=False` gives
    the bare min/max of a segment's rows). NaN propagates through
    min/max/or."""
    if op not in MERGES:
        raise KeyError(f"no segment combine for merge op {op!r}")
    n, w = values.shape
    out = torch.full((num_segments, w), identity(op, values.dtype),
                     dtype=values.dtype, device=values.device)
    rows = torch.nonzero((seg >= 0) & (seg < num_segments)).reshape(-1)
    if rows.numel() == 0:
        return out
    if op == "write":
        # stable sorts: by order first, then by segment — within a run the
        # lowest order comes first, and equal orders keep row order
        by_order = rows[torch.sort(order[rows], stable=True).indices]
        ranked = by_order[torch.sort(seg[by_order].long(),
                                     stable=True).indices]
        sorted_seg = seg[ranked].long()
        first, _ = _runs(sorted_seg)
        out[sorted_seg[first]] = values[ranked[first]]
        return out
    ranked = rows[torch.sort(seg[rows].long(), stable=True).indices]
    sorted_seg = seg[ranked].long()
    _, last = _runs(sorted_seg)
    if op == "add":
        lengths = torch.diff(last, prepend=last.new_full((1,), -1))
        sums = torch.segment_reduce(values[ranked].to(torch.float64), "sum",
                                    lengths=lengths, axis=0)
        out[sorted_seg[last]] = sums.to(values.dtype)
        return out
    # work column-major: torch sorts fastest along a contiguous last
    # dimension
    vt = values[ranked].T.contiguous()  # (W, rows)
    # every column sorted by value, then stably by segment: each run of a
    # column then holds that segment's values in ascending order, NaN last,
    # so its last element is its max, NaN included; min is -max(-v)
    if op == "min":
        vt = vt.neg_()
    by_value = torch.sort(vt, dim=1, stable=True).indices
    regroup = torch.sort(sorted_seg[by_value], dim=1, stable=True).indices
    ordered = vt.gather(1, by_value.gather(1, regroup))
    top = ordered[:, last].T
    if op == "min":
        top = top.neg_()
    if fold or op == "or":  # clamp keeps NaN
        bound = identity(op, values.dtype)
        top = top.clamp(max=bound) if op == "min" else top.clamp(min=bound)
    out[sorted_seg[last]] = top
    return out
