"""Plain PyTorch version of the Mamba2 SSD chunk scan (one group of B/C,
without the D·x skip term), written as the chunked form of the JAX
package's `models/mamba.py` (the JAX kernel family's own `ref.py` is a
float64 numpy loop, and its off-TPU path is the interpret-mode kernel):

    h_t = exp(dt_t·A) · h_{t-1} + dt_t · (x_t ⊗ B_t),    y_t = h_t · C_t

Within a chunk, with l the inclusive cumulative sum of dt·A:
    y_t = Σ_{s≤t} (C_t·B_s) exp(l_t − l_s) dt_s x_s + exp(l_t) h_prev·C_t
    h   = exp(l_end) h_prev + Σ_s exp(l_end − l_s) dt_s x_s ⊗ B_s

exp(l_t − l_s) overflows for s > t when |dt·A| is large; the decay is
formed as exp of a difference set to −inf above the diagonal, so it is 0
there and never multiplies an inf.

`ssd_scan_bwd_ref` is the scan's reverse pass, written out (not autograd
of the forward), chunk by chunk with H the state entering the chunk, G
the gradient of the state leaving it (dh_final for the last chunk, else
0), L = l_end and, for s <= t, E[t,s] = exp(l_t − l_s):
    W = (C·Bᵀ) ∘ E ∘ dt_s (the forward's M),  P = dy·xᵀ,  Q = P ∘ E ∘ dt_s,
    Z = P ∘ (C·Bᵀ) ∘ E,  w_s = exp(L − l_s)·dt_s
    dx  = Wᵀ·dy + w ∘ (B·Gᵀ)
    dC  = Σ_heads Q·B + exp(l) ∘ (dy·H)
    dB  = Σ_heads Qᵀ·C + w ∘ (x·G)
    ddt = colsum(Z) + exp(L − l) ∘ ((x·G)·B) + A·Σ_{t≥u} dl_t
    dl_t = Σ_s Z[t,s]·dt_s − dt_t·colsum(Z)_t + exp(l_t)·(dy·H)_t·C_t − R_t
           (+ Σ_s R_s + exp(L)·⟨G, H⟩ at the chunk's last step),
    R_s = w_s·(x·G)_s·B_s,  dA = Σ dt_u·Σ_{t≥u} dl_t,
and the previous chunk's G = exp(L)·G + Σ_t exp(l_t)·dy_t ⊗ C_t."""
from __future__ import annotations

import torch


def ssd_shapes(x, dt, A, Bc, Cc, chunk: int):
    """(B, S, nh, hd, ds, c) of a scan call, with c = min(chunk, S); raises
    on shapes that do not fit together or a chunk that does not divide S
    (as the JAX kernel asserts)."""
    if x.ndim != 4:
        raise ValueError(f"x must be (B, S, nh, hd), got {tuple(x.shape)}")
    B, S, nh, hd = x.shape
    if Bc.ndim != 3 or Bc.shape[:2] != (B, S) or Cc.shape != Bc.shape:
        raise ValueError(f"Bc {tuple(Bc.shape)} / Cc {tuple(Cc.shape)} must "
                         f"be (B, S, ds) = ({B}, {S}, ds)")
    if dt.shape != (B, S, nh) or A.shape != (nh,):
        raise ValueError(f"dt {tuple(dt.shape)} must be {(B, S, nh)} and A "
                         f"{tuple(A.shape)} must be ({nh},)")
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    c = min(chunk, S)
    if S and S % c:
        raise ValueError(f"chunk {c} does not divide the sequence ({S})")
    return B, S, nh, hd, Bc.shape[2], c


def _chunks(x, dt, A, Bc, Cc, c: int, ct):
    """The inputs cut into chunks of c steps in the compute type `ct`, with
    the heads ahead of the steps: x (B, NC, nh, c, hd), dt (B, NC, nh, c),
    B/C (B, NC, c, ds), and l, the inclusive cumulative sum of dt·A within
    each chunk (B, NC, nh, c)."""
    B, S, nh, hd = x.shape
    ds, NC = Bc.shape[2], S // c
    xc = x.to(ct).reshape(B, NC, c, nh, hd).permute(0, 1, 3, 2, 4)
    dtc = dt.to(ct).reshape(B, NC, c, nh).permute(0, 1, 3, 2)
    Bcc = Bc.to(ct).reshape(B, NC, c, ds)
    Ccc = Cc.to(ct).reshape(B, NC, c, ds)
    l = torch.cumsum(dtc * A.to(ct)[:, None], dim=-1)
    return xc, dtc, Bcc, Ccc, l


def _decay(l, c: int):
    """E[..., t, s] = exp(l_t − l_s) for s <= t, else 0 (no exp of the
    upper triangle, which may overflow)."""
    above = ~torch.tril(torch.ones((c, c), dtype=torch.bool,
                                   device=l.device))
    return torch.exp((l[..., :, None] - l[..., None, :]).masked_fill(
        above, float("-inf")))


def ssd_scan_fwd_ref(x, dt, A, Bc, Cc, *, chunk: int = 128):
    """`ssd_scan_ref` with the chunk states: (y, h, H), y (B, S, nh, hd) in
    x's dtype, h (B, nh, hd, ds) the state after the last step and H (B,
    nh, S / c, hd, ds) the state entering each chunk of c = min(chunk, S)
    steps, both in the compute type (float32, float64 for float64 x)."""
    B, S, nh, hd, ds, c = ssd_shapes(x, dt, A, Bc, Cc, chunk)
    ct = torch.float64 if x.dtype == torch.float64 else torch.float32
    if S == 0:
        return (torch.empty_like(x),
                torch.zeros((B, nh, hd, ds), dtype=ct, device=x.device),
                torch.zeros((B, nh, 0, hd, ds), dtype=ct, device=x.device))
    NC = S // c
    xc, dtc, Bcc, Ccc, l = _chunks(x, dt, A, Bc, Cc, c, ct)
    CB = torch.matmul(Ccc, Bcc.transpose(-1, -2))  # (B, NC, c, c)
    M = CB[:, :, None] * _decay(l, c) * dtc[..., None, :]
    y = torch.matmul(M, xc)  # (B, NC, nh, c, hd)

    decay_end = torch.exp(l[..., -1:] - l)  # (B, NC, nh, c)
    Sk = torch.matmul((xc * (dtc * decay_end)[..., None]).transpose(-1, -2),
                      Bcc[:, :, None])  # (B, NC, nh, hd, ds)
    a_chunk = torch.exp(l[..., -1])  # (B, NC, nh)
    h = torch.zeros((B, nh, hd, ds), dtype=ct, device=x.device)
    H = torch.empty((B, nh, NC, hd, ds), dtype=ct, device=x.device)
    for n in range(NC):  # the state entering chunk n, then chunk n's update
        H[:, :, n] = h
        y[:, n] += torch.exp(l[:, n])[..., None] * torch.matmul(
            Ccc[:, n, None], h.transpose(-1, -2))
        h = a_chunk[:, n, :, None, None] * h + Sk[:, n]
    y = y.permute(0, 1, 3, 2, 4).reshape(B, S, nh, hd).to(x.dtype)
    return y, h, H


def ssd_scan_ref(x, dt, A, Bc, Cc, *, chunk: int = 128,
                 return_state: bool = False):
    """x: (B, S, nh, hd); dt: (B, S, nh); A: (nh,); Bc/Cc: (B, S, ds) ->
    y: (B, S, nh, hd) in x's dtype, computed in float32 (float64 for
    float64 x). With `return_state`, (y, h): h (B, nh, hd, ds) the state
    after the last step, in the compute type."""
    y, h, _ = ssd_scan_fwd_ref(x, dt, A, Bc, Cc, chunk=chunk)
    return (y, h) if return_state else y


def ssd_scan_bwd_ref(x, dt, A, Bc, Cc, dy, dh_final=None, *,
                     chunk: int = 128, states=None, terms: bool = False,
                     dA_steps: bool = False):
    """The scan's gradients (dx, ddt, dA, dBc, dCc) from dy (B, S, nh, hd)
    and dh_final (B, nh, hd, ds) or None (no gradient reaches the final
    state), each in its input's dtype, computed in float32 (float64 for
    float64 x) by the reverse pass of the module docstring. `states`: the
    forward's H (B, nh, S / c, hd, ds), recomputed when None.

    With `terms`, the same pass on |x|, |B|, |C|, |dy|, |dh_final| and |A|
    with every difference taken as a sum: each output's Σ|terms|, which
    bounds what rounding in the terms can do to it (the card's gate).

    With `dA_steps`, dA comes unsummed as (B, S / c, nh, c): step t's part
    of its chunk, (dl_t (+ the chunk's end term at its last step)) times
    Σ_{u≤t} dt_u, whose sum over rows, chunks and steps is dA (with
    `terms`, the magnitudes whose sum is dA's Σ|terms|)."""
    B, S, nh, hd, ds, c = ssd_shapes(x, dt, A, Bc, Cc, chunk)
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} must be shaped as x "
                         f"{tuple(x.shape)}")
    if dh_final is not None and dh_final.shape != (B, nh, hd, ds):
        raise ValueError(f"dh_final {tuple(dh_final.shape)} must be "
                         f"{(B, nh, hd, ds)}")
    ct = torch.float64 if x.dtype == torch.float64 else torch.float32
    if S == 0:
        return (torch.zeros_like(x), torch.zeros_like(dt),
                torch.zeros_like(A), torch.zeros_like(Bc),
                torch.zeros_like(Cc))
    if terms:
        x, Bc, Cc, dy = x.abs(), Bc.abs(), Cc.abs(), dy.abs()
        dh_final = None if dh_final is None else dh_final.abs()
        states = None
    if states is None:
        states = ssd_scan_fwd_ref(x, dt, A, Bc, Cc, chunk=c)[2]
    NC = S // c
    sign = 1.0 if terms else -1.0
    xc, dtc, Bcc, Ccc, l = _chunks(x, dt, A, Bc, Cc, c, ct)
    dyc = dy.to(ct).reshape(B, NC, c, nh, hd).permute(0, 1, 3, 2, 4)
    H = states.to(ct).transpose(1, 2)  # (B, NC, nh, hd, ds)
    L = l[..., -1]  # (B, NC, nh)
    el, w_end = torch.exp(l), torch.exp(L[..., None] - l)

    # G_k, the gradient of the state leaving chunk k, in reverse
    D = torch.matmul((dyc * el[..., None]).transpose(-1, -2),
                     Ccc[:, :, None])  # (B, NC, nh, hd, ds)
    G = torch.empty_like(D)
    g = (torch.zeros((B, nh, hd, ds), dtype=ct, device=x.device)
         if dh_final is None else dh_final.to(ct))
    for n in reversed(range(NC)):
        G[:, n] = g
        g = torch.exp(L[:, n])[..., None, None] * g + D[:, n]

    E = _decay(l, c)  # (B, NC, nh, c, c), [t, s]
    CB = torch.matmul(Ccc, Bcc.transpose(-1, -2))[:, :, None]
    P = torch.matmul(dyc, xc.transpose(-1, -2))
    W = CB * E * dtc[..., None, :]
    Q = P * E * dtc[..., None, :]
    Z = P * CB * E
    del E, CB, P
    w = w_end * dtc  # (B, NC, nh, c)
    XG = torch.matmul(xc, G)  # (B, NC, nh, c, ds)
    dyH = torch.matmul(dyc, H)
    dx = torch.matmul(W.transpose(-1, -2), dyc) + w[..., None] * torch.matmul(
        Bcc[:, :, None], G.transpose(-1, -2))
    dC = (torch.matmul(Q, Bcc[:, :, None]) + el[..., None] * dyH).sum(2)
    dB = (torch.matmul(Q.transpose(-1, -2), Ccc[:, :, None])
          + w[..., None] * XG).sum(2)
    del W, Q
    colz = Z.sum(-2)  # over t, at s
    xgb = (XG * Bcc[:, :, None]).sum(-1)
    R = w * xgb
    dl = ((Z * dtc[..., None, :]).sum(-1) + sign * dtc * colz
          + el * (dyH * Ccc[:, :, None]).sum(-1) + sign * R)
    end = R.sum(-1) + torch.exp(L) * (G * H).sum((-1, -2))  # (B, NC, nh)
    suffix = torch.flip(torch.cumsum(torch.flip(dl, (-1,)), -1), (-1,)) \
        + end[..., None]
    a = A.to(ct).abs() if terms else A.to(ct)
    ddt = colz + w_end * xgb + a[:, None] * suffix
    if dA_steps:
        dl[..., -1] += end
        dA = dl * torch.cumsum(dtc, -1)
    else:
        dA = (dtc * suffix).sum((0, 1, 3))

    dx = dx.permute(0, 1, 3, 2, 4).reshape(B, S, nh, hd)
    ddt = ddt.permute(0, 1, 3, 2).reshape(B, S, nh)
    return (dx.to(x.dtype), ddt.to(dt.dtype), dA.to(A.dtype),
            dB.reshape(B, S, ds).to(Bc.dtype),
            dC.reshape(B, S, ds).to(Cc.dtype))
