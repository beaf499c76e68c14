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
(under `causal`, a block reads only the keys up to its last row). The
backward (`attention_bwd_ref`) works the same way.

The backward is the JAX package's `_flash_bwd_rule` (`models/attention.py`)
in float32 (float64 for float64 inputs), from the forward's output and its
row log-sum-exp `lse` (B, H, S):
    P = exp(s − lse),  D = rowsum(dO ⊙ O),  dS = P ⊙ (dO · vᵀ − D),
    dq = dS · k · hd^-0.5,  dk = dSᵀ · q · hd^-0.5,  dv = Pᵀ · dO,
dk and dv summed over the G query heads of each KV head."""
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


def _compute_type(q) -> torch.dtype:
    return torch.float64 if q.dtype == torch.float64 else torch.float32


def _heads_side_by_side(t, r0, r1, KV, G, ct):
    """Rows r0:r1 of a (B, S, H, hd) tensor as (B, KV, G·n, hd) in `ct`:
    the G query heads of a KV head side by side."""
    B, _, _, hd = t.shape
    n = r1 - r0
    return t[:, r0:r1].to(ct).reshape(B, n, KV, G, hd).permute(
        0, 2, 3, 1, 4).reshape(B, KV, G * n, hd)


def _back_to_rows(t, B, n, H, hd):
    """(B, KV, G·n, hd) -> (B, n, H, hd), the inverse of the above."""
    KV = t.shape[1]
    return t.reshape(B, KV, H // KV, n, hd).permute(0, 3, 1, 2, 4).reshape(
        B, n, H, hd)


def _scores(qb, kt, r0, n, t1, causal, hd):
    """Scaled scores of a block of rows, -2.0e38 above the diagonal under
    `causal`, and that mask (or None)."""
    s = torch.matmul(qb, kt[:, :, :t1].transpose(-1, -2)) * hd ** -0.5
    if not causal:
        return s, None
    row = r0 + torch.arange(qb.shape[2], device=qb.device) % n
    col = torch.arange(t1, device=qb.device)
    above = row[:, None] < col[None, :]
    return s.masked_fill(above, NEG_INF), above


def attention_ref(q, k, v, causal: bool = True, return_lse: bool = False):
    """q: (B, S, H, hd); k/v: (B, T, KV, hd) with H % KV == 0. Returns
    (B, S, H, hd) in q's dtype, computed in float32 (float64 for float64
    inputs). With `return_lse`, (out, lse): lse (B, H, S) in the compute
    type, each row's log-sum-exp of its scaled scores (the backward's
    input)."""
    B, S, H, hd, T, KV, G = attention_shapes(q, k, v, causal)
    ct = _compute_type(q)
    kt = k.to(ct).permute(0, 2, 1, 3).contiguous()  # (B, KV, T, hd)
    vt = v.to(ct).permute(0, 2, 1, 3).contiguous()
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=ct, device=q.device) \
        if return_lse else None
    rows = max(1, SCORE_BUDGET // (B * H * T))
    for r0 in range(0, S, rows):
        r1 = min(S, r0 + rows)
        n, t1 = r1 - r0, (r1 if causal else T)
        qb = _heads_side_by_side(q, r0, r1, KV, G, ct)
        s, _ = _scores(qb, kt, r0, n, t1, causal, hd)
        o = torch.matmul(torch.softmax(s, dim=-1), vt[:, :, :t1])
        out[:, r0:r1] = _back_to_rows(o, B, n, H, hd).to(q.dtype)
        if return_lse:
            lse[:, :, r0:r1] = torch.logsumexp(s, dim=-1).reshape(B, H, n)
    return (out, lse) if return_lse else out


def attention_bwd_ref(q, k, v, out, lse, dout, causal: bool = True,
                      terms: str | None = None):
    """The backward of `attention_ref`: q, out, dout (B, S, H, hd); k/v (B,
    T, KV, hd); lse (B, H, S) the forward's row log-sum-exp. Returns (dq,
    dk, dv) in the inputs' dtypes, computed in float32 (float64 for
    float64 inputs) from the operands as given. With `terms`, also the
    magnitudes of their sums in the compute type, Σ|terms| for a tolerance
    to scale with: (|dS|·|k|, |dS|ᵀ·|q|, Pᵀ·|dO|) scaled as dq, dk, dv.
    |dS| is taken as P ⊙ (|dO|·|v|ᵀ + Σ|dO ⊙ O|) with terms="products",
    the magnitudes of the products that dP and D sum (they can cancel), for
    a gate on errors in those sums; and as P ⊙ (|dP| + |D|) with
    terms="values", the magnitudes of dS's own operands, for a gate on
    roundings of P and dS where dP and D are summed near exactly (bf16
    operands: exact products, float32 sums)."""
    if terms not in (None, "products", "values"):
        raise ValueError(f"terms must be None, 'products' or 'values', got "
                         f"{terms!r}")
    B, S, H, hd, T, KV, G = attention_shapes(q, k, v, causal)
    ct = _compute_type(q)
    scale = hd ** -0.5
    kt = k.to(ct).permute(0, 2, 1, 3).contiguous()  # (B, KV, T, hd)
    vt = v.to(ct).permute(0, 2, 1, 3).contiguous()
    dq = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    dk = torch.zeros((B, KV, T, hd), dtype=ct, device=q.device)
    dv = torch.zeros_like(dk)
    if terms:
        mq = torch.empty((B, S, H, hd), dtype=ct, device=q.device)
        mk, mv = torch.zeros_like(dk), torch.zeros_like(dk)
    rows = max(1, SCORE_BUDGET // (B * H * T))
    for r0 in range(0, S, rows):
        r1 = min(S, r0 + rows)
        n, t1 = r1 - r0, (r1 if causal else T)
        qb = _heads_side_by_side(q, r0, r1, KV, G, ct)
        dob = _heads_side_by_side(dout, r0, r1, KV, G, ct)
        ob = _heads_side_by_side(out, r0, r1, KV, G, ct)
        lb = lse[:, :, r0:r1].to(ct).reshape(B, KV, G * n)
        D = (dob * ob).sum(-1)  # (B, KV, G·n)
        s, above = _scores(qb, kt, r0, n, t1, causal, hd)
        p = torch.exp(s - lb[..., None])
        if above is not None:
            p = p.masked_fill(above, 0.0)
        dp = torch.matmul(dob, vt[:, :, :t1].transpose(-1, -2))
        ds = p * (dp - D[..., None])
        dq[:, r0:r1] = _back_to_rows(
            torch.matmul(ds, kt[:, :, :t1]) * scale, B, n, H, hd).to(q.dtype)
        dk[:, :, :t1] += torch.matmul(ds.transpose(-1, -2), qb) * scale
        dv[:, :, :t1] += torch.matmul(p.transpose(-1, -2), dob)
        if terms == "products":
            a = p * (torch.matmul(dob.abs(), vt[:, :, :t1].abs().transpose(
                -1, -2)) + (dob * ob).abs().sum(-1)[..., None])
        elif terms == "values":
            a = p * (dp.abs() + D.abs()[..., None])
        if terms:
            mq[:, r0:r1] = _back_to_rows(
                torch.matmul(a, kt[:, :, :t1].abs()) * scale, B, n, H, hd)
            mk[:, :, :t1] += torch.matmul(a.transpose(-1, -2),
                                          qb.abs()) * scale
            mv[:, :, :t1] += torch.matmul(p.transpose(-1, -2), dob.abs())
    grads = (dq, dk.permute(0, 2, 1, 3).to(k.dtype),
             dv.permute(0, 2, 1, 3).to(v.dtype))
    if not terms:
        return grads
    return grads, (mq, mk.permute(0, 2, 1, 3), mv.permute(0, 2, 1, 3))
