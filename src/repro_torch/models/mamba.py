"""Mamba2 (SSD) block, the port of the JAX package's `models/mamba.py`:
the chunked form for prefill, the recurrent step for decode (zamba2's
backbone).

Recurrence (per head h, scalar decay a_t = exp(dt_t · A_h)):
    h_t = a_t · h_{t-1} + dt_t · (B_t ⊗ x_t)        state: (hd, ds)
    y_t = C_t · h_t + D_h · x_t
The JAX package writes the chunked scan (intra-chunk products, chunk
states, the scan over chunks) in XLA ops; the port runs it as one call of
the Hopper port of its Pallas kernel `ssd_scan` (`repro_torch.kernels.
mamba_ssd`, B7), which also returns the final state that seeds decode.
The scan runs in float32 (float64 for a float64 model) whatever the
config's `intra_dtype`: zamba2's is float32, where the JAX package lifts x,
B and C to float32 too. The one-step recurrence of decode is plain torch:
no TPU kernel covers it.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .. import kernels
from .config import ModelConfig
from .layers import compute_float, rmsnorm, truncated_normal


class MambaState(NamedTuple):
    conv: torch.Tensor  # (B, d_conv-1, conv_channels) trailing inputs
    ssm: torch.Tensor  # (B, nh, hd, ds), float32


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim
    conv_ch = d_in + 2 * s.d_state
    return s, d_in, nh, conv_ch


class Mamba(torch.nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device, generator):
        super().__init__()
        s, d_in, nh, conv_ch = _dims(cfg)
        d = cfg.d_model
        P = torch.nn.Parameter

        def w(shape, std):
            return P(truncated_normal(shape, std, dtype, device, generator))

        # fused in_proj: [z (d_in), xBC (conv_ch), dt (nh)]
        self.in_proj = w((d, d_in + conv_ch + nh), d ** -0.5)
        self.conv_w = w((s.d_conv, conv_ch), 0.1)
        self.conv_b = P(torch.zeros((conv_ch,), dtype=dtype, device=device))
        f32 = dict(dtype=torch.float32, device=device)
        self.A_log = P(torch.zeros((nh,), **f32))  # A = -exp(A_log)
        self.D = P(torch.ones((nh,), **f32))
        self.dt_bias = P(torch.zeros((nh,), **f32))
        self.out_norm = P(torch.ones((d_in,), dtype=dtype, device=device))
        self.out_proj = w((d_in, d), d_in ** -0.5)


def init_mamba(cfg: ModelConfig, dtype, device, generator) -> Mamba:
    return Mamba(cfg, dtype, device, generator)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 init: torch.Tensor | None):
    """Depthwise causal conv, kernel (K, C). init: (B, K-1, C) history.
    Returns the activations and the last K-1 inputs (a copy)."""
    K = w.shape[0]
    pad = init if init is not None else xbc.new_zeros(
        (xbc.shape[0], K - 1, xbc.shape[2]))
    xp = torch.cat([pad, xbc], dim=1)
    out = sum(xp[:, i:i + xbc.shape[1]] * w[i] for i in range(K))
    return F.silu(out + b), xp[:, -(K - 1):].clone()


def _split_proj(params: Mamba, cfg: ModelConfig, x):
    s, d_in, nh, conv_ch = _dims(cfg)
    zxbcdt = x @ params.in_proj
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in:d_in + conv_ch]
    ct = compute_float(x.dtype)
    dt = F.softplus(zxbcdt[..., d_in + conv_ch:].to(ct)
                    + params.dt_bias)  # (B, S, nh)
    return z, xbc, dt


def mamba_chunked(params: Mamba, cfg: ModelConfig, x: torch.Tensor
                  ) -> Tuple[torch.Tensor, MambaState]:
    """Full-sequence forward; S must be a multiple of min(chunk, S)."""
    s, d_in, nh, conv_ch = _dims(cfg)
    B, S, _ = x.shape
    c = min(s.chunk, S)
    if S % c:
        raise ValueError(f"seq {S} not divisible by chunk {c}")
    hd, ds = s.head_dim, s.d_state
    ct = compute_float(x.dtype)

    z, xbc, dt = _split_proj(params, cfg, x)
    xbc, conv_tail = _causal_conv(xbc, params.conv_w, params.conv_b, None)
    xs = xbc[..., :d_in].reshape(B, S, nh, hd).to(ct).contiguous()
    Bc = xbc[..., d_in:d_in + ds].to(ct).contiguous()  # one group
    Cc = xbc[..., d_in + ds:].to(ct).contiguous()
    A = -torch.exp(params.A_log)  # (nh,)
    y, h_last = kernels.mamba_ssd(xs, dt, A, Bc, Cc, chunk=c,
                                  return_state=True)
    y = y + params.D[None, None, :, None] * xs
    y = y.reshape(B, S, d_in).to(x.dtype)
    # gate + norm + out (Mamba2 places the norm after gating)
    y = rmsnorm(y * F.silu(z), params.out_norm, cfg.norm_eps)
    return y @ params.out_proj, MambaState(conv=conv_tail, ssm=h_last)


def mamba_decode(params: Mamba, cfg: ModelConfig, x: torch.Tensor,
                 state: MambaState) -> Tuple[torch.Tensor, MambaState]:
    """Single-token recurrent step; x (B, 1, d). State is O(1) in context
    length. Returns new state tensors; `state` is not written."""
    s, d_in, nh, conv_ch = _dims(cfg)
    B = x.shape[0]
    hd, ds = s.head_dim, s.d_state
    ct = compute_float(x.dtype)
    z, xbc, dt = _split_proj(params, cfg, x)
    xbc, conv_tail = _causal_conv(xbc, params.conv_w, params.conv_b,
                                  state.conv)
    xs = xbc[:, 0, :d_in].reshape(B, nh, hd).to(ct)
    Bc = xbc[:, 0, d_in:d_in + ds].to(ct)
    Cc = xbc[:, 0, d_in + ds:].to(ct)
    dt0 = dt[:, 0]  # (B, nh)
    a = torch.exp(dt0 * -torch.exp(params.A_log))  # (B, nh)
    upd = (xs * dt0[..., None])[..., None] * Bc[:, None, None, :]
    h = a[:, :, None, None] * state.ssm + upd
    y = torch.einsum("bhpd,bd->bhp", h, Cc) + params.D[None, :, None] * xs
    y = y.reshape(B, 1, d_in).to(x.dtype)
    y = rmsnorm(y * F.silu(z), params.out_norm, cfg.norm_eps)
    return y @ params.out_proj, MambaState(conv=conv_tail, ssm=h)
