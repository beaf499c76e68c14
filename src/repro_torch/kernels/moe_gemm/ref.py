"""Plain PyTorch version of the grouped (block-diagonal) GEMM, the
counterpart of `lax.ragged_dot`: one matrix product per group over its
slice of rows, in float32 (float64 for float64 operands); and of its
backward, the two products autodiff of `lax.ragged_dot` gives."""
from __future__ import annotations

import torch


def _compute_dtype(*ts: torch.Tensor) -> torch.dtype:
    """float32, or float64 where an operand is float64."""
    return (torch.float64 if any(t.dtype == torch.float64 for t in ts)
            else torch.float32)


def _spans(group_sizes: torch.Tensor, M: int):
    """(group, first row, end row) of each nonempty group: negative sizes
    count as 0, rows past M are cut."""
    start = 0
    for g, size in enumerate(group_sizes.tolist()):
        end = min(start + max(int(size), 0), M)
        if end > start:
            yield g, start, end
        start = end


def grouped_gemm_ref(x: torch.Tensor, w: torch.Tensor,
                     group_sizes: torch.Tensor) -> torch.Tensor:
    """x: (M, K), rows sorted by group; w: (G, K, N); group_sizes: (G,)
    integers (group g owns the next group_sizes[g] rows; negative sizes
    count as 0, rows past M are cut). Returns (M, N) in x's dtype, computed
    from float32 operands (float64 ones for float64 x or w); rows at or
    beyond the groups' sum are 0."""
    M, N = x.shape[0], w.shape[2]
    ct = _compute_dtype(x, w)
    out = torch.zeros((M, N), dtype=ct, device=x.device)
    xf, wf = x.to(ct), w.to(ct)
    for g, start, end in _spans(group_sizes, M):
        out[start:end] = xf[start:end] @ wf[g]
    return out.to(x.dtype)


def grouped_gemm_bwd_ref(x: torch.Tensor, w: torch.Tensor,
                         group_sizes: torch.Tensor, dy: torch.Tensor):
    """The backward of `grouped_gemm_ref` for dy (M, N): (dx, dw) with
    dx[r] = dy[r] · w[g(r)]ᵀ (M, K) in x's dtype and dw[g] = x_gᵀ · dy_g
    (G, K, N) in w's dtype and layout (dense), summed over group g's rows
    only. Both are computed from float32 operands (float64 ones for
    float64 x, w or dy), with the forward's edge rules: rows at or beyond
    the groups' sum give zero dx and add nothing to any dw, and an empty
    group's dw is 0."""
    M, K = x.shape
    G, _, N = w.shape
    ct = _compute_dtype(x, w, dy)
    xf, wf, df = x.to(ct), w.to(ct), dy.to(ct)
    dx = torch.zeros((M, K), dtype=ct, device=x.device)
    dw = torch.zeros((G, K, N), dtype=ct, device=x.device)
    for g, start, end in _spans(group_sizes, M):
        dx[start:end] = df[start:end] @ wf[g].T
        dw[g] = xf[start:end].T @ df[start:end]
    return dx.to(x.dtype), dw.to(w.dtype)
