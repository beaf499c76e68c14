"""Phase-1 contention histogram: `count_ids` launches the CUDA kernel
(`csrc/histogram.cu`) for a CUDA tensor and runs the plain version
(`ref.py`) for a CPU tensor."""
from __future__ import annotations

import torch

from .. import _lib
from .ref import histogram_ref


def count_ids(ids: torch.Tensor, num_bins: int, *,
              weights: torch.Tensor | None = None) -> torch.Tensor:
    """(num_bins,) int32 counts of `ids` in [0, num_bins); out-of-range ids
    are dropped. With int32 `weights`, each id adds its weight instead of 1.
    On the card `ids` (and `weights`) must be contiguous 1-D int32."""
    if not _lib.on_cuda(ids):
        return histogram_ref(ids, num_bins, weights)
    dev = ids.device
    _lib.require(ids, "ids", (torch.int32,), 1, dev)
    if weights is not None:
        _lib.require(weights, "weights", (torch.int32,), 1, dev)
        if weights.shape != ids.shape:
            raise ValueError(f"weights shape {tuple(weights.shape)} != ids "
                             f"shape {tuple(ids.shape)}")
    if not 0 <= num_bins < 2**31:
        raise ValueError(f"num_bins={num_bins} must be in [0, 2**31)")
    out = torch.zeros(num_bins, dtype=torch.int32, device=dev)
    if ids.numel() == 0 or num_bins == 0:
        return out
    rc = _lib.load().tdorch_histogram(
        dev.index or 0, ids.data_ptr(), _lib.ptr(weights), ids.numel(),
        num_bins, out.data_ptr(), _lib.stream(ids))
    _lib.check(rc, "histogram")
    _lib.count("histogram")
    return out


def shared_bins() -> int:
    """The largest bin count the kernel keeps in shared memory; above it
    the kernel adds into global memory."""
    return int(_lib.load().tdorch_histogram_shared_bins())
