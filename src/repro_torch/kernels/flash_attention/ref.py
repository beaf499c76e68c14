"""Plain PyTorch version of GQA flash attention, the counterpart of the JAX
package's `flash_attention/ref.py`: query head h reads KV head h // G,
scores scaled by hd**-0.5, softmax in float32, and under `causal` the
scores of keys after the query's own position are -2.0e38.

Causal attention is defined here for S == T only. The JAX package's two
paths disagree when S != T: its Pallas kernel masks col > row (aligned at
the top left), its oracle keeps `tril(k=T-S)` (aligned at the bottom
right). So causal S != T raises `ValueError`; non-causal S != T is fine.

The scores are formed for a block of query rows at a time, so the plain
version runs at long sequence lengths without a full (S, T) score tensor
(under `causal`, a block reads only the keys up to its last row)."""
from __future__ import annotations

import torch

NEG_INF = -2.0e38
SCORE_BUDGET = 1 << 26  # score elements a block of query rows may hold


def attention_shapes(q, k, v, causal: bool):
    """(B, S, H, hd, T, KV, G) of an attention call; raises on shapes that
    do not fit together, and on causal S != T."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"q must be (B, S, H, hd) and k/v (B, T, KV, hd), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, hd = q.shape
    _, T, KV, _ = k.shape
    if k.shape != (B, T, KV, hd) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if KV == 0 or H % KV:
        raise ValueError(f"{H} query heads do not split over {KV} KV heads")
    if causal and S != T:
        raise ValueError(
            f"causal attention needs S == T (got S={S}, T={T}): the "
            "reference's kernel and oracle align the mask differently "
            "when they differ")
    if T == 0:
        raise ValueError("no keys (T = 0)")
    return B, S, H, hd, T, KV, H // KV


def attention_ref(q, k, v, causal: bool = True):
    """q: (B, S, H, hd); k/v: (B, T, KV, hd) with H % KV == 0. Returns
    (B, S, H, hd) in q's dtype, computed in float32 (float64 for float64
    inputs)."""
    B, S, H, hd, T, KV, G = attention_shapes(q, k, v, causal)
    ct = torch.float64 if q.dtype == torch.float64 else torch.float32
    kt = k.to(ct).permute(0, 2, 1, 3).contiguous()  # (B, KV, T, hd)
    vt = v.to(ct).permute(0, 2, 1, 3).contiguous()
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    rows = max(1, SCORE_BUDGET // (B * H * T))
    for r0 in range(0, S, rows):
        r1 = min(S, r0 + rows)
        n, t1 = r1 - r0, (r1 if causal else T)
        # the G query heads of a KV head side by side: (B, KV, G * n, hd)
        qb = q[:, r0:r1].to(ct).reshape(B, n, KV, G, hd).permute(
            0, 2, 3, 1, 4).reshape(B, KV, G * n, hd)
        s = torch.matmul(qb, kt[:, :, :t1].transpose(-1, -2)) * hd ** -0.5
        if causal:
            row = r0 + torch.arange(G * n, device=q.device) % n
            col = torch.arange(t1, device=q.device)
            s = s.masked_fill(row[:, None] < col[None, :], NEG_INF)
        o = torch.matmul(torch.softmax(s, dim=-1), vt[:, :, :t1])
        out[:, r0:r1] = o.reshape(B, KV, G, n, hd).permute(
            0, 3, 1, 2, 4).reshape(B, n, H, hd).to(q.dtype)
    return out
