"""GQA flash attention: `attention` launches a CUDA kernel for a CUDA
tensor — `csrc/flash_attention_sm90.cu` (wgmma + TMA) for bfloat16,
`csrc/flash_attention_tf32.cu` (3xTF32 on the tensor cores) for float32 —
and runs the plain version (`ref.py`) for a CPU tensor."""
from __future__ import annotations

import torch

from .. import _lib
from .ref import attention_ref, attention_shapes

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
    on `torch.backends.cuda.matmul.allow_tf32`."""
    B, S, H, hd, T, KV, G = attention_shapes(q, k, v, causal)
    if not _lib.on_cuda(q):
        return attention_ref(q, k, v, causal=causal)
    dev = q.device
    _lib.require(q, "q", (torch.float32, torch.bfloat16), 4, dev)
    _lib.require(k, "k", (q.dtype,), 4, dev)
    _lib.require(v, "v", (q.dtype,), 4, dev)
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} is not one of {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if max(B, H) > _MAX_GRID_YZ or max(B * S * H, B * T * KV) * hd >= 2**62:
        raise ValueError(f"shape B={B}, S={S}, H={H}, T={T} is beyond the "
                         "kernel's grid")
    out = torch.empty_like(q)
    name = ("flash_attention_sm90" if q.dtype == torch.bfloat16
            else "flash_attention_tf32")
    rc = getattr(_lib.load(), f"tdorch_{name}")(
        dev.index or 0, q.data_ptr(), k.data_ptr(), v.data_ptr(), B, S, T, H,
        KV, hd, hd ** -0.5, int(bool(causal)), out.data_ptr(),
        _lib.stream(q))
    _lib.check(rc, name)
    _lib.count(name)
    return out
