"""Plain PyTorch version of the ragged fused stage.

The same CSR-native contract as the CUDA kernel (`csrc/stage_fused.cu`):
per-task `read_op` reduction of the gathered pair values, optional `finish`
epilogue, writer-segment ⊗-combine — with no `(n, max_arity, w)` padding.
A task's pairs are contiguous in CSR order, so ``add`` is a float64 prefix
sum read at the row pointers, and ``min``/``max`` are the segment-combine
plain version over the pairs' task ids (NaN propagates).

``min``/``max`` fold ±`BIG` into a task whose arity is below the batch's
max arity, exactly as the numpy oracle does: it reduces the padded
`(n, max_arity, w)` view whose empty slots hold ±BIG
(`core/fusedlam.FusedStageLambda.reduce_padded`), so a task at the max
arity reads its pairs alone.
"""
from __future__ import annotations

import torch

from ..segment_combine.ref import combine_ref

# a finite fill that survives float32 (the float64 max would overflow)
BIG = float(torch.finfo(torch.float32).max) / 2


def max_step(indptr: torch.Tensor) -> int:
    """The largest arity of a CSR row-pointer vector (0 when empty)."""
    if indptr.numel() < 2:
        return 0
    return int((indptr[1:] - indptr[:-1]).max())


def reduce_pairs_ref(values: torch.Tensor, indptr: torch.Tensor,
                     indices: torch.Tensor, *, read_op: str,
                     max_arity: int | None = None) -> torch.Tensor:
    """(n, w) per-task reduction of `values[indices]` over each task's CSR
    slice. Arity-0 tasks reduce to 0 for every op — matching the zero-filled
    padded gather the oracle hands generic lambdas. `max_arity` is the
    batch's (the largest step of `indptr` when None); min/max fold ±BIG
    into the tasks below it."""
    indptr = indptr.long()
    n, w = indptr.numel() - 1, values.shape[1]
    arity = indptr[1:] - indptr[:-1]
    has = arity > 0
    out = torch.zeros((n, w), dtype=values.dtype, device=values.device)
    if indices.numel() == 0:
        return out
    if read_op == "first":
        out[has] = values[indices[indptr[:-1][has]].long()]
        return out
    pv = values[indices.long()]
    if read_op == "add":
        # column-major prefix sums: torch scans fastest along the last dim
        cs = torch.cumsum(pv.to(torch.float64).T.contiguous(), 1)
        cs = torch.cat([torch.zeros((w, 1), dtype=torch.float64,
                                    device=values.device), cs], 1)
        return (cs[:, indptr[1:]] - cs[:, indptr[:-1]]).T.to(values.dtype)
    if read_op not in ("min", "max"):
        raise KeyError(f"fused read op {read_op!r}")
    pair_task = torch.repeat_interleave(
        torch.arange(n, dtype=torch.int32, device=values.device), arity)
    red = combine_ref(pv, pair_task, n, op=read_op, fold=False)
    if max_arity is None:
        max_arity = max_step(indptr)
    short = has & (arity < max_arity)
    red[short] = red[short].clamp(max=BIG) if read_op == "min" \
        else red[short].clamp(min=-BIG)
    out[has] = red[has]
    return out


def fused_stage_ref(values, indptr, indices, contexts, seg, order, *,
                    num_segments: int, read_op: str, finish=None,
                    merge_name: str = "add", combine: bool = True,
                    max_arity: int | None = None):
    """Returns ``(updates (n, w_out), combined (num_segments, w_out))``
    (combined is None when `combine` is False). A task whose ``seg ==
    num_segments`` is dropped from the combine."""
    red = reduce_pairs_ref(values, indptr, indices, read_op=read_op,
                           max_arity=max_arity)
    upd = red if finish is None else torch.as_tensor(
        finish(contexts, red), dtype=values.dtype, device=values.device)
    if not combine:
        return upd, None
    return upd, combine_ref(upd.reshape(upd.shape[0], -1), seg, num_segments,
                            op=merge_name,
                            order=order if merge_name == "write" else None)
