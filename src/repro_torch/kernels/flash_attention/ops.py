"""GQA flash attention: `attention` launches a CUDA kernel for a CUDA
tensor — `csrc/flash_attention_sm90.cu` (wgmma + TMA) for bfloat16,
`csrc/flash_attention_tf32.cu` (3xTF32 on the tensor cores) for float32 —
and runs the plain version (`ref.py`) for a CPU tensor.

Under autograd (grad mode on and an input that requires grad) `attention`
is a `torch.autograd.Function`: the forward also writes each row's
log-sum-exp and keeps it with q, k, v and the output, and the backward
launches three kernels — for bfloat16 `fa_bwd_pre_sm90`, `fa_bwd_dkdv_sm90`
and `fa_bwd_dq_sm90` of `csrc/flash_attention_bwd_sm90.cu` (wgmma + TMA,
counted once as "flash_attention_bwd_bf16"), for float32
`fa_bwd_pre_tf32`, `fa_bwd_dkdv_tf32` and `fa_bwd_dq_tf32` of
`csrc/flash_attention_bwd_tf32_sm90.cu` (3xTF32 on TF32 wgmma + TMA,
"flash_attention_bwd_tf32") — or runs `attention_bwd_ref` on the CPU.
Otherwise (serving) the forward asks for no log-sum-exp and keeps
nothing."""
from __future__ import annotations

import torch

from .. import _lib
from .ref import attention_bwd_ref, attention_ref, attention_shapes

HEAD_DIMS = (32, 64, 128)
_MAX_GRID_YZ = 65535


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True) -> torch.Tensor:
    """q: (B, S, H, hd); k/v: (B, T, KV, hd) with H % KV == 0 ->
    (B, S, H, hd) in q's dtype. Scores scaled by hd**-0.5, softmax in
    float32, query head h reads KV head h // (H // KV). Under `causal` key
    c > query r scores -2.0e38, and S must equal T (`ValueError`
    otherwise: the JAX package's kernel and oracle disagree there). On the
    card q, k, v must be contiguous, 16-byte aligned float32 or bfloat16
    of one dtype, with hd in {32, 64, 128}: bfloat16 launches the
    wgmma kernel (counted as "flash_attention_sm90"), float32 the 3xTF32
    one ("flash_attention_tf32"), whose float32 accuracy does not depend
    on `torch.backends.cuda.matmul.allow_tf32`. Differentiable in q, k
    and v (see the module docstring)."""
    attention_shapes(q, k, v, causal)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Attention.apply(q, k, v, causal)
    return _forward(q, k, v, causal, False)[0]


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = _forward(q, k, v, causal, True)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, out, lse, dout.contiguous(),
                               ctx.causal)
        return dq, dk, dv, None


def _forward(q, k, v, causal: bool, with_lse: bool):
    """(out, lse or None): the kernel on the card, the plain version on
    the CPU; lse (B, H, S) float32 (float64 on a float64 CPU run)."""
    B, S, H, hd, T, KV, G = attention_shapes(q, k, v, causal)
    if not _lib.on_cuda(q):
        if with_lse:
            return attention_ref(q, k, v, causal=causal, return_lse=True)
        return attention_ref(q, k, v, causal=causal), None
    dev = q.device
    _check(q, k, v)
    if max(B, H) > _MAX_GRID_YZ or max(B * S * H, B * T * KV) * hd >= 2**62:
        raise ValueError(f"shape B={B}, S={S}, H={H}, T={T} is beyond the "
                         "kernel's grid")
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=dev)
           if with_lse else None)
    name = ("flash_attention_sm90" if q.dtype == torch.bfloat16
            else "flash_attention_tf32")
    rc = getattr(_lib.load(), f"tdorch_{name}")(
        dev.index or 0, q.data_ptr(), k.data_ptr(), v.data_ptr(), B, S, T, H,
        KV, hd, hd ** -0.5, int(bool(causal)), out.data_ptr(),
        _lib.ptr(lse), _lib.stream(q))
    _lib.check(rc, name)
    _lib.count(name, lambda: (_attention_ops(B, S, H, hd, T, causal),
                              _lib.nbytes(q, k, v, out, lse)))
    return out, lse


def _backward(q, k, v, out, lse, dout, causal: bool):
    """(dq, dk, dv): the three backward kernels on the card (one count:
    `flash_attention_bwd_sm90.cu` for bfloat16,
    `flash_attention_bwd_tf32_sm90.cu` for float32, which also takes
    scratch for k's and v's TF32 lo halves), `attention_bwd_ref` on the
    CPU."""
    B, S, H, hd, T, KV, G = attention_shapes(q, k, v, causal)
    if not _lib.on_cuda(q):
        return attention_bwd_ref(q, k, v, out, lse, dout, causal=causal)
    dev = q.device
    _check(q, k, v)
    for name, t in (("out", out), ("dout", dout)):
        _lib.require(t, name, (q.dtype,), 4, dev)
        if t.shape != q.shape or t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned, shaped as q")
    _lib.require(lse, "lse", (torch.float32,), 3, dev)
    if lse.shape != (B, H, S):
        raise ValueError(f"lse must be {(B, H, S)}, got {tuple(lse.shape)}")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    D = torch.empty((B, H, S), dtype=torch.float32, device=dev)
    bf16 = q.dtype == torch.bfloat16
    name = "flash_attention_bwd_bf16" if bf16 else "flash_attention_bwd_tf32"
    # float32: k - trunc_tf32(k) and v's, which TMA reads beside k and v
    lo = () if bf16 else (torch.empty_like(k), torch.empty_like(v))
    rc = getattr(_lib.load(), f"tdorch_{name}")(
        dev.index or 0, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), dout.data_ptr(), lse.data_ptr(), B, S, T, H, KV, hd,
        hd ** -0.5, int(bool(causal)), D.data_ptr(),
        *(t.data_ptr() for t in lo), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), _lib.stream(q))
    _lib.check(rc, name)
    _lib.count(name, lambda: (
        2.5 * _attention_ops(B, S, H, hd, T, causal),
        _lib.nbytes(q, k, v, out, lse, dout, D, *lo, dq, dk, dv)))
    return dq, dk, dv


def _attention_ops(B, S, H, hd, T, causal: bool) -> int:
    """The forward's operations: Q·Kᵀ and P·V over the causal half (with
    the diagonal) or all S·T scores; the backward does 2.5 times as many
    (Sᵀ and dPᵀ again, dq, dk and dv)."""
    return 4 * hd * B * H * (S * (S + 1) // 2 if causal else S * T)


def _check(q, k, v) -> None:
    """The checks of q, k, v before a launch: device, dtype, contiguity,
    head dim, 16-byte alignment."""
    dev = q.device
    _lib.require(q, "q", (torch.float32, torch.bfloat16), 4, dev)
    _lib.require(k, "k", (q.dtype,), 4, dev)
    _lib.require(v, "v", (q.dtype,), 4, dev)
    hd = q.shape[-1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} is not one of {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
