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
there and never multiplies an inf."""
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


def ssd_scan_ref(x, dt, A, Bc, Cc, *, chunk: int = 128,
                 return_state: bool = False):
    """x: (B, S, nh, hd); dt: (B, S, nh); A: (nh,); Bc/Cc: (B, S, ds) ->
    y: (B, S, nh, hd) in x's dtype, computed in float32 (float64 for
    float64 x). With `return_state`, (y, h): h (B, nh, hd, ds) the state
    after the last step, in the compute type."""
    B, S, nh, hd, ds, c = ssd_shapes(x, dt, A, Bc, Cc, chunk)
    ct = torch.float64 if x.dtype == torch.float64 else torch.float32
    if S == 0:
        y = torch.empty_like(x)
        return (y, torch.zeros((B, nh, hd, ds), dtype=ct, device=x.device)) \
            if return_state else y
    NC = S // c
    # (B, NC, nh, c, .) with the heads ahead of the chunk's steps
    xc = x.to(ct).reshape(B, NC, c, nh, hd).permute(0, 1, 3, 2, 4)
    dtc = dt.to(ct).reshape(B, NC, c, nh).permute(0, 1, 3, 2)
    Bcc = Bc.to(ct).reshape(B, NC, c, ds)
    Ccc = Cc.to(ct).reshape(B, NC, c, ds)
    l = torch.cumsum(dtc * A.to(ct)[:, None], dim=-1)  # (B, NC, nh, c)

    above = ~torch.tril(torch.ones((c, c), dtype=torch.bool,
                                   device=x.device))
    diff = (l[..., :, None] - l[..., None, :]).masked_fill(above,
                                                           float("-inf"))
    CB = torch.matmul(Ccc, Bcc.transpose(-1, -2))  # (B, NC, c, c)
    M = CB[:, :, None] * torch.exp(diff) * dtc[..., None, :]
    y = torch.matmul(M, xc)  # (B, NC, nh, c, hd)

    decay_end = torch.exp(l[..., -1:] - l)  # (B, NC, nh, c)
    Sk = torch.matmul((xc * (dtc * decay_end)[..., None]).transpose(-1, -2),
                      Bcc[:, :, None])  # (B, NC, nh, hd, ds)
    a_chunk = torch.exp(l[..., -1])  # (B, NC, nh)
    h = torch.zeros((B, nh, hd, ds), dtype=ct, device=x.device)
    for n in range(NC):  # the state entering chunk n, then chunk n's update
        y[:, n] += torch.exp(l[:, n])[..., None] * torch.matmul(
            Ccc[:, n, None], h.transpose(-1, -2))
        h = a_chunk[:, n, :, None, None] * h + Sk[:, n]
    y = y.permute(0, 1, 3, 2, 4).reshape(B, S, nh, hd).to(x.dtype)
    return (y, h) if return_state else y
