"""Plain PyTorch version of the grouped (block-diagonal) GEMM, the
counterpart of `lax.ragged_dot`: one matrix product per group over its
slice of rows, in float32."""
from __future__ import annotations

import torch


def grouped_gemm_ref(x: torch.Tensor, w: torch.Tensor,
                     group_sizes: torch.Tensor) -> torch.Tensor:
    """x: (M, K), rows sorted by group; w: (G, K, N); group_sizes: (G,)
    integers (group g owns the next group_sizes[g] rows; negative sizes
    count as 0, rows past M are cut). Returns (M, N) in x's dtype, computed
    from float32 operands; rows at or beyond the groups' sum are 0."""
    M, N = x.shape[0], w.shape[2]
    out = torch.zeros((M, N), dtype=torch.float32, device=x.device)
    xf, wf = x.to(torch.float32), w.to(torch.float32)
    start = 0
    for g, size in enumerate(group_sizes.tolist()):
        end = min(start + max(int(size), 0), M)
        if end > start:
            out[start:end] = xf[start:end] @ wf[g]
        start = end
    return out.to(x.dtype)
