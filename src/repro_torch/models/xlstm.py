"""xLSTM blocks (arXiv:2405.04517), the port of the JAX package's
`models/xlstm.py`: mLSTM (matrix memory, chunkwise-parallel) and sLSTM
(scalar memory, true recurrence), both with exponential gating and
max-stabilizers. Attention-free, so xlstm-350m's decode state is O(1) in
context length.

mLSTM cell (per head):
    m_t = max(f̃_t + m_{t-1}, ĩ_t)
    C_t = e^{f̃_t+m_{t-1}-m_t} C_{t-1} + e^{ĩ_t-m_t} v_t k_tᵀ
    n_t = e^{f̃_t+m_{t-1}-m_t} n_{t-1} + e^{ĩ_t-m_t} k_t
    h_t = (C_t q_t) / max(|n_tᵀ q_t|, 1)

The JAX package computes these with `jnp` ops and `lax.scan`; no Pallas
kernel is involved, so the port writes them in torch ops. Layout: heads
ahead of time inside the chunked scan, (B, NC, H, c, hd), so each of the
JAX package's einsums is a batched matmul; the three-operand ones are
written as a scale and then a matmul (without `opt_einsum`, `torch.einsum`
contracts left to right and could build a (…, s, d, e) outer product). The
carry over chunks is a loop that computes each chunk's summary (C, n) and
its queries' share of the carried memory as it goes: at xlstm-350m's head
dim of 512 and batch 8 x 4,096, the stacked summaries and incoming states
would be 1.07 GB each. The sLSTM recurrence is a loop over time with the
input GEMM hoisted out of it, as in the JAX package; each step's four
recurrent head products are one batched matmul.

States and gates compute in float32 (float64 for a float64 model): the
stabilizers m start at −inf in the chunked scan and in `slstm_forward`,
and every −inf meets a finite value in a max before it reaches an exp.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import compute_float, rmsnorm, truncated_normal

CONV_K = 4  # the mLSTM's causal depthwise conv kernel


class MLSTMState(NamedTuple):
    C: torch.Tensor  # (B, H, hd, hd) stabilized matrix memory
    n: torch.Tensor  # (B, H, hd)
    m: torch.Tensor  # (B, H) running max-stabilizer


class SLSTMState(NamedTuple):
    c: torch.Tensor  # (B, d)
    n: torch.Tensor  # (B, d)
    m: torch.Tensor  # (B, d)
    h: torch.Tensor  # (B, d) previous hidden (recurrent input)


def mlstm_dims(cfg: ModelConfig):
    """(d_up, heads, head dim) of the mLSTM."""
    d_up = int(cfg.d_model * cfg.xlstm.proj_factor)
    nh = cfg.n_heads
    return d_up, nh, d_up // nh


# ---------------------------------------------------------------------------
# mLSTM block
# ---------------------------------------------------------------------------
class MLSTM(torch.nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device, generator):
        super().__init__()
        d = cfg.d_model
        d_up, nh, _ = mlstm_dims(cfg)
        std, su = d ** -0.5, d_up ** -0.5
        P = torch.nn.Parameter

        def w(shape, s):
            return P(truncated_normal(shape, s, dtype, device, generator))

        self.up = w((d, 2 * d_up), std)
        self.conv_w = w((CONV_K, d_up), 0.1)
        self.conv_b = P(torch.zeros((d_up,), dtype=dtype, device=device))
        self.wq = w((d_up, d_up), su)
        self.wk = w((d_up, d_up), su)
        self.wv = w((d_up, d_up), su)
        self.w_gates = w((d_up, 2 * nh), su)
        self.b_gates = P(torch.cat([
            torch.zeros((nh,), device=device),
            torch.full((nh,), 3.0, device=device)]))  # float32
        self.out_norm = P(torch.ones((d_up,), dtype=dtype, device=device))
        self.down = w((d_up, d), su)


def init_mlstm(cfg: ModelConfig, dtype, device, generator) -> MLSTM:
    return MLSTM(cfg, dtype, device, generator)


def _mlstm_qkv(params: MLSTM, cfg: ModelConfig, x, conv_init):
    """x: (B, S, d) -> q, k, v (B, S, H, hd), gate pre-activations (B, S,
    H) in float32, z, and the new conv tail (the last CONV_K - 1 inputs)."""
    d_up, nh, hd = mlstm_dims(cfg)
    B, S, _ = x.shape
    u, z = (x @ params.up).chunk(2, dim=-1)
    # causal depthwise conv feeding q/k (xLSTM Fig. 10 block structure)
    K = params.conv_w.shape[0]
    pad = conv_init if conv_init is not None else u.new_zeros(
        (B, K - 1, d_up))
    up = torch.cat([pad, u], dim=1)
    conv = sum(up[:, i:i + S] * params.conv_w[i] for i in range(K))
    conv = F.silu(conv + params.conv_b)
    q = (conv @ params.wq).reshape(B, S, nh, hd)
    k = (conv @ params.wk).reshape(B, S, nh, hd) * (hd ** -0.5)
    v = (u @ params.wv).reshape(B, S, nh, hd)
    ct = compute_float(x.dtype)
    gates = (u @ params.w_gates).to(ct) + params.b_gates.to(ct)
    gates = gates.reshape(B, S, 2, nh)
    return (q, k, v, gates[:, :, 0], gates[:, :, 1], z,
            up[:, -(K - 1):].clone())


def _heads(t: torch.Tensor, NC: int, c: int, ct) -> torch.Tensor:
    """(B, S, H, ...) -> (B, NC, H, c, ...) in `ct`."""
    B = t.shape[0]
    t = t.to(ct).reshape(B, NC, c, *t.shape[2:])
    return t.transpose(2, 3)


def mlstm_chunked(params: MLSTM, cfg: ModelConfig, x: torch.Tensor
                  ) -> Tuple[torch.Tensor, Tuple[MLSTMState, torch.Tensor]]:
    """Chunkwise mLSTM over the whole sequence: the intra-chunk quadratic
    work batched over chunks, the (C, n, m) carry a loop over chunks.
    Returns (out (B, S, d), (final MLSTMState, conv tail)). S must be a
    multiple of min(chunk, S)."""
    d_up, nh, hd = mlstm_dims(cfg)
    B, S, _ = x.shape
    c = min(cfg.xlstm.chunk, S)
    if S % c:
        raise ValueError(f"seq {S} not divisible by chunk {c}")
    NC = S // c
    ct = compute_float(x.dtype)
    q, k, v, i_pre, f_pre, z, conv_tail = _mlstm_qkv(params, cfg, x, None)
    qh, kh, vh = (_heads(t, NC, c, ct) for t in (q, k, v))  # (B,NC,H,c,hd)
    ik = _heads(i_pre, NC, c, ct)  # (B, NC, H, c)
    fk = _heads(F.logsigmoid(f_pre), NC, c, ct)

    # ---- intra-chunk, batched over chunks ---------------------------------
    b = torch.cumsum(fk, dim=-1)  # inclusive forget cumsum (B, NC, H, c)
    w = b[..., :, None] - b[..., None, :] + ik[..., None, :]  # (.., t, s)
    tri = torch.ones((c, c), dtype=torch.bool, device=x.device).tril()
    w = w.masked_fill(~tri, float("-inf"))
    m_intra = w.amax(dim=-1)  # (B, NC, H, c): s = t is always in
    wstab = torch.exp(w - m_intra[..., None])
    num_i = ((qh @ kh.transpose(-1, -2)) * wstab) @ vh  # (B, NC, H, c, hd)
    n_i = wstab @ kh
    # chunk summaries' stabilized weights, local stabilizer m_loc
    b_end = b[..., -1]  # (B, NC, H)
    w_end = b_end[..., None] - b + ik  # (B, NC, H, c)
    m_loc = w_end.amax(dim=-1)
    s_stab = torch.exp(w_end - m_loc[..., None])

    # ---- carry over chunks: each chunk's incoming (C, n, m) ---------------
    C = x.new_zeros((B, nh, hd, hd), dtype=ct)
    n = x.new_zeros((B, nh, hd), dtype=ct)
    m = torch.full((B, nh), float("-inf"), dtype=ct, device=x.device)
    q_carry = torch.empty_like(num_i)  # q · C_incoming, chunk by chunk
    n_carry = x.new_empty((B, NC, nh, hd), dtype=ct)
    m_carry = x.new_empty((B, NC, nh), dtype=ct)
    for j in range(NC):
        q_carry[:, j] = qh[:, j] @ C.transpose(-1, -2)
        n_carry[:, j] = n
        m_carry[:, j] = m
        sv = vh[:, j] * s_stab[:, j, ..., None]  # (B, H, c, hd)
        sc = sv.transpose(-1, -2) @ kh[:, j]  # Σ_s s·v kᵀ: (B, H, hd, hd)
        sn = (s_stab[:, j, :, None, :] @ kh[:, j])[..., 0, :]  # (B, H, hd)
        m1 = torch.maximum(b_end[:, j] + m, m_loc[:, j])
        d_old = torch.exp(b_end[:, j] + m - m1)
        d_new = torch.exp(m_loc[:, j] - m1)
        C = d_old[..., None, None] * C + d_new[..., None, None] * sc
        n = d_old[..., None] * n + d_new[..., None] * sn
        m = m1

    # ---- inter-chunk contribution, batched over chunks --------------------
    carry_log = b + m_carry[..., None]  # (B, NC, H, c)
    m_t = torch.maximum(m_intra, carry_log)
    scale_i = torch.exp(m_intra - m_t)[..., None]
    cstab = torch.exp(carry_log - m_t)[..., None]
    num = num_i * scale_i + cstab * q_carry
    n_t = n_i * scale_i + cstab * n_carry[..., None, :]
    den = (qh * n_t).sum(-1).abs().clamp(min=1.0)
    h = (num / den[..., None]).transpose(2, 3).reshape(B, S, d_up).to(
        x.dtype)
    h = rmsnorm(h, params.out_norm, cfg.norm_eps) * F.silu(z)
    return h @ params.down, (MLSTMState(C=C, n=n, m=m), conv_tail)


def mlstm_decode(params: MLSTM, cfg: ModelConfig, x: torch.Tensor,
                 state: MLSTMState, conv_tail: torch.Tensor):
    """One token; x (B, 1, d). Returns (out, new MLSTMState, new conv
    tail): new tensors, `state` is not written."""
    d_up, nh, hd = mlstm_dims(cfg)
    B = x.shape[0]
    ct = compute_float(x.dtype)
    q, k, v, i_pre, f_pre, z, new_tail = _mlstm_qkv(params, cfg, x,
                                                    conv_tail)
    qk, kk, vk = (t[:, 0].to(ct) for t in (q, k, v))  # (B, H, hd)
    ik, fk = i_pre[:, 0], F.logsigmoid(f_pre[:, 0])  # (B, H)
    m_t = torch.maximum(fk + state.m, ik)
    fs = torch.exp(fk + state.m - m_t)
    is_ = torch.exp(ik - m_t)
    C = fs[..., None, None] * state.C \
        + is_[..., None, None] * (vk[..., :, None] * kk[..., None, :])
    n = fs[..., None] * state.n + is_[..., None] * kk
    num = (C @ qk[..., None])[..., 0]
    den = (n * qk).sum(-1).abs().clamp(min=1.0)
    h = (num / den[..., None]).reshape(B, 1, d_up).to(x.dtype)
    h = rmsnorm(h, params.out_norm, cfg.norm_eps) * F.silu(z)
    return h @ params.down, MLSTMState(C=C, n=n, m=m_t), new_tail


# ---------------------------------------------------------------------------
# sLSTM block (true recurrence; a loop over time)
# ---------------------------------------------------------------------------
class SLSTM(torch.nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device, generator):
        super().__init__()
        d, nh = cfg.d_model, cfg.n_heads
        hd = d // nh
        f = int(d * cfg.xlstm.ff_factor)
        std = d ** -0.5
        P = torch.nn.Parameter
        self.w_in = P(truncated_normal((d, 4 * d), std, dtype, device,
                                       generator))
        # per-head recurrent kernels (block-diagonal R, one (hd, hd) a gate)
        self.r = P(truncated_normal((4, nh, hd, hd), hd ** -0.5,
                                    torch.float32, device, generator))
        self.b = P(torch.cat([torch.zeros((3 * d,), device=device),
                              torch.full((d,), 3.0, device=device)]))
        self.ffn_up = P(truncated_normal((d, 2 * f), std, dtype, device,
                                         generator))
        self.ffn_down = P(truncated_normal((f, d), f ** -0.5, dtype, device,
                                           generator))
        self.norm_ffn = P(torch.ones((d,), dtype=dtype, device=device))


def init_slstm(cfg: ModelConfig, dtype, device, generator) -> SLSTM:
    return SLSTM(cfg, dtype, device, generator)


def _recurrent_kernels(params: SLSTM, ct) -> torch.Tensor:
    """r (4, H, hd, hd) as (H, 4·hd, hd): one batched matmul over heads
    gives all four gates' recurrent products of a step."""
    g, nh, hd, _ = params.r.shape
    return params.r.to(ct).transpose(0, 1).reshape(nh, g * hd, hd)


def _slstm_cell(params: SLSTM, cfg: ModelConfig, xt, st: SLSTMState,
                wx=None, r=None) -> Tuple[torch.Tensor, SLSTMState]:
    """One timestep; xt (B, d). `wx` is the precomputed input projection
    and `r` the recurrent kernels as `_recurrent_kernels` lays them out
    (the time loop hoists both)."""
    d, nh = cfg.d_model, cfg.n_heads
    hd = d // nh
    ct = compute_float(st.h.dtype)
    if wx is None:
        wx = (xt @ params.w_in).to(ct) + params.b.to(ct)
    if r is None:
        r = _recurrent_kernels(params, ct)
    B = wx.shape[0]
    h_heads = st.h.to(ct).reshape(B, nh, hd).permute(1, 2, 0)  # (H, hd, B)
    rh = (r @ h_heads).reshape(nh, 4, hd, B).permute(1, 3, 0, 2)
    pre = wx.reshape(B, 4, d).transpose(0, 1) + rh.reshape(4, B, d)
    zt, it, ot, ft = pre.unbind(0)
    z = torch.tanh(zt)
    o = torch.sigmoid(ot)
    f_log = F.logsigmoid(ft)
    m_t = torch.maximum(f_log + st.m, it)
    i_s = torch.exp(it - m_t)
    f_s = torch.exp(f_log + st.m - m_t)
    c = f_s * st.c + i_s * z
    n = f_s * st.n + i_s
    h = o * (c / n.clamp(min=1e-6))
    return h, SLSTMState(c=c, n=n, m=m_t, h=h)


def _slstm_ffn(params: SLSTM, cfg: ModelConfig, h: torch.Tensor):
    """The post-up FFN (GeLU-gated, xLSTM block design; GeLU by its tanh
    form, as `jax.nn.gelu` computes it)."""
    y = rmsnorm(h, params.norm_ffn, cfg.norm_eps)
    u, g = (y @ params.ffn_up).chunk(2, dim=-1)
    return (F.gelu(g, approximate="tanh") * u) @ params.ffn_down


def slstm_forward(params: SLSTM, cfg: ModelConfig, x: torch.Tensor
                  ) -> Tuple[torch.Tensor, SLSTMState]:
    B, S, d = x.shape
    ct = compute_float(x.dtype)
    zeros = x.new_zeros((B, d), dtype=ct)
    st = SLSTMState(c=zeros, n=zeros, m=torch.full_like(zeros, float("-inf")),
                    h=zeros)
    # hoist the input GEMM out of the recurrence (S× fewer weight reads)
    wx_all = (x @ params.w_in).to(ct) + params.b.to(ct)
    r = _recurrent_kernels(params, ct)
    hs = []
    for t in range(S):
        h, st = _slstm_cell(params, cfg, None, st, wx=wx_all[:, t], r=r)
        hs.append(h)
    h = torch.stack(hs, dim=1).to(x.dtype)
    return _slstm_ffn(params, cfg, h), st


def slstm_decode(params: SLSTM, cfg: ModelConfig, x: torch.Tensor,
                 st: SLSTMState) -> Tuple[torch.Tensor, SLSTMState]:
    h, st1 = _slstm_cell(params, cfg, x[:, 0], st)
    return _slstm_ffn(params, cfg, h[:, None].to(x.dtype)), st1
