"""Plain PyTorch version of the Phase-1 contention histogram.

Sort-based, so it neither shares code with the CUDA kernel nor calls the
library's scatter or bincount: sort the in-range ids, and a bin's count is
the length (or the weight sum) of its run.
"""
from __future__ import annotations

import torch


def _run_ends(sorted_ids: torch.Tensor) -> torch.Tensor:
    """Index of the last element of each run of equal values."""
    last = torch.ones_like(sorted_ids, dtype=torch.bool)
    last[:-1] = sorted_ids[1:] != sorted_ids[:-1]
    return torch.nonzero(last).reshape(-1)


def histogram_ref(ids: torch.Tensor, num_bins: int,
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    """(num_bins,) counts of `ids` in [0, num_bins); other ids are dropped.
    Unweighted counts are int32; weighted counts take the weights' dtype."""
    ids = ids.reshape(-1)
    dtype = torch.int32 if weights is None else weights.dtype
    out = torch.zeros(num_bins, dtype=dtype, device=ids.device)
    keep = (ids >= 0) & (ids < num_bins)
    sorted_ids, perm = torch.sort(ids[keep].long(), stable=True)
    if sorted_ids.numel() == 0:
        return out
    ends = _run_ends(sorted_ids)
    if weights is None:
        totals = ends + 1
    else:
        w = weights.reshape(-1)[keep][perm]
        acc = torch.float64 if w.is_floating_point() else torch.int64
        totals = torch.cumsum(w.to(acc), 0)[ends]
    totals = totals.clone()
    totals[1:] -= totals[:-1].clone()
    out[sorted_ids[ends]] = totals.to(dtype)
    return out
