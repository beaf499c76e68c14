"""Mamba2 SSD chunk scan: `mamba_ssd` launches the CUDA kernel
(`csrc/mamba_scan.cu`) for a CUDA tensor and runs the plain version
(`ref.py`) for a CPU tensor."""
from __future__ import annotations

import torch

from .. import _lib
from .ref import ssd_scan_ref, ssd_shapes

MAX_WIDTH = 64      # head_dim and d_state the kernel takes
MAX_CHUNK = 128     # csrc/mamba_scan.cu's kMaxChunk
_MAX_GRID_Y = 65535


def kernel_chunk(chunk: int) -> int:
    """The chunk the kernel runs for a requested (already divisor-checked)
    chunk: itself up to 128 steps, else its largest divisor <= 128, which
    divides the sequence too. The scan's value does not depend on it."""
    return max(c for c in range(1, min(chunk, MAX_CHUNK) + 1)
               if chunk % c == 0)


def mamba_ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              Bc: torch.Tensor, Cc: torch.Tensor, *,
              chunk: int = 128, return_state: bool = False):
    """x: (B, S, nh, hd); dt: (B, S, nh); A: (nh,); Bc/Cc: (B, S, ds) ->
    y: (B, S, nh, hd) in x's dtype: the SSD scan without the D·x term.
    With `return_state`, (y, h): h (B, nh, hd, ds) float32 (float64 for a
    float64 plain run), the state after the last step, which seeds the
    recurrent decode.
    min(chunk, S) must divide S. On the card x, Bc, Cc must be contiguous
    float32 or bfloat16 of one dtype, dt and A contiguous float32, and
    hd, ds <= 64. The kernels keep each chunk's state in a float32
    scratch of (B, nh, S / chunk, hd, ds), allocated here with one of the
    chunks' cumulative log-decays l (B, nh, S / chunk, 128). On the card
    it has no backward yet: an input that requires grad under grad mode
    raises `NotImplementedError` (ROADMAP A11e)."""
    B, S, nh, hd, ds, c = ssd_shapes(x, dt, A, Bc, Cc, chunk)
    if not _lib.on_cuda(x):
        return ssd_scan_ref(x, dt, A, Bc, Cc, chunk=chunk,
                            return_state=return_state)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, Bc, Cc)):
        raise NotImplementedError(
            "mamba_ssd has no backward kernel on the card yet (ROADMAP "
            "item A11e); the plain version trains on the CPU")
    dev = x.device
    _lib.require(x, "x", (torch.float32, torch.bfloat16), 4, dev)
    _lib.require(Bc, "Bc", (x.dtype,), 3, dev)
    _lib.require(Cc, "Cc", (x.dtype,), 3, dev)
    _lib.require(dt, "dt", (torch.float32,), 3, dev)
    _lib.require(A, "A", (torch.float32,), 1, dev)
    if hd > MAX_WIDTH or ds > MAX_WIDTH:
        raise ValueError(f"head_dim {hd} / d_state {ds}: the kernel takes "
                         f"at most {MAX_WIDTH}")
    if max(B, nh) > _MAX_GRID_Y or B * S * nh * hd >= 2**62:
        raise ValueError(f"shape B={B}, S={S}, nh={nh} is beyond the "
                         "kernel's grid")
    y = torch.empty_like(x)
    final = (torch.zeros((B, nh, hd, ds), dtype=torch.float32, device=dev)
             if return_state else None)
    if y.numel() == 0:
        return (y, final) if return_state else y
    kc = kernel_chunk(c)
    nc = -(-S // kc)
    states = torch.empty((B, nh, nc, hd, ds), dtype=torch.float32,
                         device=dev)
    l = torch.empty((B, nh, nc, MAX_CHUNK), dtype=torch.float32, device=dev)
    rc = _lib.load().tdorch_ssd_scan(
        dev.index or 0, x.data_ptr(), dt.data_ptr(), A.data_ptr(),
        Bc.data_ptr(), Cc.data_ptr(), B, S, nh, hd, ds, kc,
        int(x.dtype == torch.bfloat16), states.data_ptr(), l.data_ptr(),
        _lib.ptr(final), y.data_ptr(), _lib.stream(x))
    _lib.check(rc, "mamba_scan")
    _lib.count("mamba_scan")
    return (y, final) if return_state else y
