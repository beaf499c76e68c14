"""Phase-1 contention histogram: `count_ids` launches the CUDA kernel
(`csrc/histogram.cu`) for a CUDA tensor and runs the plain version
(`ref.py`) for a CPU tensor. `route` decides which of the kernel's two
routes a call takes, and its grid."""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import _lib
from .ref import histogram_ref

SHARED_IDS_PER_THREAD = 16  # shared route: ids a thread before its merge
_ROUTE_CODE = {"shared": 0, "global": 1}


class Limits(NamedTuple):
    """What decides the route, as `tdorch_histogram_limits` reports it:
    the device's shared memory a block may opt in to, an SM's, and what the
    card keeps back a block (bytes); its SMs and an SM's resident threads;
    and the kernel's threads a block."""
    block_shared: int
    sm_shared: int
    reserved_shared: int
    sms: int
    sm_threads: int
    block_threads: int


def route(n: int, num_bins: int, limits: Limits) -> tuple:
    """("shared" or "global", blocks) for `n` ids into `num_bins` bins.
    The shared route keeps a block's copy of every bin in shared memory and
    merges its non-zero bins into global memory at the end, so it costs
    about blocks x bins besides the ids: it is taken where the bins fit a
    block's opt-in shared memory and that merge is below the ids' count.
    Its grid: an SM's worth of blocks as the bins and threads allow, fewer
    where the ids do not fill them. The global route takes one id a
    thread, on at most the SMs' resident blocks. Either route strides over
    the ids, so the grid moves the time, never the counts."""
    per_sm = limits.sm_threads // limits.block_threads
    if num_bins < n:  # otherwise even one block's merge outweighs the ids
        smem = 4 * num_bins
        fit = min(per_sm, limits.sm_shared // (smem + limits.reserved_shared))
        if smem <= limits.block_shared and fit > 0:
            want = -(-n // (limits.block_threads * SHARED_IDS_PER_THREAD))
            blocks = max(1, min(want, limits.sms * fit))
            if blocks * num_bins < n:
                return "shared", blocks
    want = -(-n // limits.block_threads)
    return "global", max(1, min(want, limits.sms * per_sm))


@functools.lru_cache(maxsize=None)
def device_limits(index: int) -> Limits:
    """The route's limits on CUDA device `index`, read once."""
    buf = (ctypes.c_int * len(Limits._fields))()
    _lib.check(_lib.load().tdorch_histogram_limits(index, buf), "histogram")
    return Limits(*buf)


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
    n = ids.numel()
    if n == 0 or num_bins == 0:
        return torch.zeros(num_bins, dtype=torch.int32, device=dev)
    out = ids.new_empty(num_bins)
    index = dev.index or 0
    kind, blocks = route(n, num_bins, device_limits(index))
    rc = _lib.load().tdorch_histogram(
        index, ids.data_ptr(), _lib.ptr(weights), n, num_bins,
        _ROUTE_CODE[kind], blocks, out.data_ptr(), _lib.stream(ids))
    _lib.check(rc, "histogram")
    _lib.count("histogram", lambda: (n, _lib.nbytes(ids, weights, out)))
    return out
