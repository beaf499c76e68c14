"""The ragged fused stage (TD-Orch Phases 3+4 for a fused-able lambda).

`fused_reduce` is the kernel: it launches `csrc/stage_fused.cu` for a CUDA
tensor (the plain version, `ref.py`, for a CPU tensor). `fused_stage` runs
a whole stage off the CSR pair list: `fused_reduce`, then the `finish`
epilogue as torch ops, then the writer ⊗-combine through the
segment-combine kernel. There is no size gate: on the card the kernels
always run.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _lib
from ..segment_combine.ops import combine as _combine
from .ref import max_step, reduce_pairs_ref

FUSED_READ_OPS = ("add", "min", "max", "first")
FUSED_MERGES = ("add", "min", "max", "or", "write")
_READ_CODE = {op: i for i, op in enumerate(FUSED_READ_OPS)}
# The layouts `tdorch_fused_reduce` compiles; it refuses any other with an
# error (raised by `_lib.check`), so these cannot drift from the kernel.
NARROW_VECTORS = 32  # a row of at most this many vectors: one per lane
WIDE_COLS = 4  # wide rows: vectors a lane a column pass


class Layout(NamedTuple):
    """How the kernel covers a row: `vec` values a load (16 bytes' worth,
    or 1), `group` lanes a task (32 / group tasks a warp), `cols` vectors a
    lane a column pass (1 for narrow rows, `WIDE_COLS` for wide ones)."""
    vec: int
    group: int
    cols: int


def layout(w: int, itemsize: int, aligned: bool) -> Layout:
    """The kernel's layout for rows of `w` values of `itemsize` bytes.
    16-byte loads and stores need w a multiple of the vector and 16-byte
    aligned rows (`aligned`: both bases); otherwise the kernel moves one
    value at a time. A row of at most 32 vectors (512 bytes in 16-byte
    vectors) is narrow: the next power of two of its vector count in lanes,
    one vector each. A wider row takes the whole warp, `WIDE_COLS` vectors
    a lane a column pass."""
    per16 = 16 // itemsize
    vec = per16 if aligned and w % per16 == 0 else 1
    nvec = max(w // vec, 1)
    if nvec > NARROW_VECTORS:
        return Layout(vec, 32, WIDE_COLS)
    return Layout(vec, 1 << (nvec - 1).bit_length(), 1)


def fused_reduce(values: torch.Tensor, indptr: torch.Tensor,
                 indices: torch.Tensor, *, read_op: str,
                 max_arity: int | None = None) -> torch.Tensor:
    """(n, w) per-task `read_op` reduction of `values[indices]` over each
    task's CSR slice ``indptr[t]:indptr[t+1]``; arity-0 tasks give 0.
    min/max propagate NaN and fold ±float32max/2 into the tasks whose arity
    is below `max_arity`, the batch's (read off `indptr` when None, a
    device sync on the card), as the oracle's padded view does. On the card
    `values` must be contiguous float32/float64 and `indptr`/`indices`
    contiguous int32; `layout` picks how the kernel covers a row."""
    if read_op not in FUSED_READ_OPS:
        raise KeyError(f"fused read op {read_op!r} not in {FUSED_READ_OPS}")
    if not _lib.on_cuda(values):
        return reduce_pairs_ref(values, indptr, indices, read_op=read_op,
                                max_arity=max_arity)
    dev = values.device
    _lib.require(values, "values", (torch.float32, torch.float64), 2, dev)
    _lib.require(indptr, "indptr", (torch.int32,), 1, dev)
    _lib.require(indices, "indices", (torch.int32,), 1, dev)
    if indptr.shape[0] < 1:
        raise ValueError("indptr needs n + 1 >= 1 entries")
    n, w = indptr.shape[0] - 1, values.shape[1]
    out = torch.empty((n, w), dtype=values.dtype, device=dev)
    if n == 0 or w == 0:
        return out
    if read_op in ("min", "max") and max_arity is None:
        max_arity = max_step(indptr)
    lay = layout(w, values.element_size(),
                 values.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    rc = _lib.load().tdorch_fused_reduce(
        dev.index or 0, values.data_ptr(), int(values.dtype == torch.float64),
        w, indptr.data_ptr(), indices.data_ptr(), n, _READ_CODE[read_op],
        min(max_arity or 0, 2**31 - 1), lay.vec, lay.group.bit_length() - 1,
        lay.cols, out.data_ptr(), _lib.stream(values))
    _lib.check(rc, "stage_fused")
    _lib.count("stage_fused", lambda: (
        indices.numel() * w, _lib.nbytes(values, indptr, indices, out)))
    return out


def fused_stage(values, indptr, indices, contexts, seg, order, *,
                num_segments: int, read_op: str, finish=None,
                merge_name: str = "add", combine: bool = True,
                max_arity: int | None = None):
    """Fused ragged stage: ``(updates (n, w_out), combined
    (num_segments, w_out))`` (combined None when `combine` is False).
    `seg` is per task, with ``seg == num_segments`` meaning "writes
    nothing"; `order` breaks "write" races (lowest order, then lowest
    row); `max_arity` is the batch's (see `fused_reduce`). Callers check
    indices against the value table: the kernel gathers without bounds
    checks."""
    if combine and merge_name not in FUSED_MERGES:
        raise KeyError(f"merge op {merge_name!r} has no fused combine")
    red = fused_reduce(values, indptr, indices, read_op=read_op,
                       max_arity=max_arity)
    upd = red if finish is None else torch.as_tensor(
        finish(contexts, red), dtype=values.dtype, device=values.device)
    if not combine:
        return upd, None
    upd = upd.reshape(upd.shape[0], -1).contiguous()
    return upd, _combine(upd, seg, num_segments, op=merge_name,
                         order=order if merge_name == "write" else None)
