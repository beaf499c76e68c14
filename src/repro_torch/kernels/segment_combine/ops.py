"""Phase-4 ⊗-combine for every merge: `combine` launches the CUDA kernel
(`csrc/segment_combine.cu`) for a CUDA tensor and runs the plain version
(`ref.py`) for a CPU tensor."""
from __future__ import annotations

import torch

from .. import _lib
from .ref import MERGES, combine_ref, identity

_OP_CODE = {"add": 0, "min": 1, "max": 2, "or": 3}
_FLOATS = (torch.float32, torch.float64)


def combine(values: torch.Tensor, seg: torch.Tensor, num_segments: int, *,
            op: str = "add", order: torch.Tensor | None = None
            ) -> torch.Tensor:
    """Segment-⊗: (N, W) values, (N,) seg -> (num_segments, W). Rows with
    seg outside [0, num_segments) are dropped; empty segments hold the merge
    identity (0, +max, -max, 0; 0 for write). ``write`` needs `order`: the
    row of lowest order wins, ties to the lowest row. On the card, values
    must be contiguous float32/float64 and seg/order contiguous int32."""
    if op not in MERGES:
        raise KeyError(f"no segment combine for merge op {op!r}")
    if op == "write" and order is None:
        raise ValueError("the write merge needs `order`")
    if not _lib.on_cuda(values):
        return combine_ref(values, seg, num_segments, op=op, order=order)
    dev = values.device
    _lib.require(values, "values", _FLOATS, 2, dev)
    _lib.require(seg, "seg", (torch.int32,), 1, dev)
    n, w = values.shape
    if seg.shape[0] != n:
        raise ValueError(f"seg has {seg.shape[0]} entries for {n} rows")
    if not 0 <= num_segments < 2**31 or w >= 2**31:
        raise ValueError(f"num_segments={num_segments}, width={w} must be "
                         "below 2**31")
    is_f64 = int(values.dtype == torch.float64)
    lib = _lib.load()
    if op == "write":
        _lib.require(order, "order", (torch.int32,), 1, dev)
        if order.shape[0] != n:
            raise ValueError(f"order has {order.shape[0]} entries for {n} "
                             "rows")
        if n >= 2**32:
            raise ValueError("the write merge packs row ids into 32 bits")
        out = torch.empty((num_segments, w), dtype=values.dtype, device=dev)
        if num_segments == 0 or w == 0:
            return out
        winner = torch.full((num_segments,), -1, dtype=torch.int64,
                            device=dev)  # all ones: no winner yet
        rc = lib.tdorch_segment_write(
            dev.index or 0, values.data_ptr(), is_f64, seg.data_ptr(),
            order.data_ptr(), n, w, num_segments, winner.data_ptr(),
            out.data_ptr(), _lib.stream(values))
    else:
        out = torch.full((num_segments, w), identity(op, values.dtype),
                         dtype=values.dtype, device=dev)
        if n == 0 or num_segments == 0 or w == 0:
            return out
        rc = lib.tdorch_segment_combine(
            dev.index or 0, values.data_ptr(), is_f64, seg.data_ptr(), n, w,
            num_segments, _OP_CODE[op], out.data_ptr(), _lib.stream(values))
    _lib.check(rc, "segment_combine")
    _lib.count("segment_combine", lambda: (
        n * w, _lib.nbytes(values, seg, order, out)))
    return out
