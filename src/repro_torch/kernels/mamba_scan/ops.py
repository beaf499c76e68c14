"""Mamba2 SSD chunk scan: `mamba_ssd` launches the CUDA kernels
(`csrc/mamba_scan.cu`; under autograd the backward's,
`csrc/mamba_scan_bwd_sm90.cu` or `csrc/mamba_scan_bwd.cu` by `bwd_route`)
for a CUDA tensor and runs the plain versions (`ref.py`) for a CPU
tensor."""
from __future__ import annotations

import torch

from .. import _lib
from .ref import ssd_scan_bwd_ref, ssd_scan_fwd_ref, ssd_shapes

MAX_WIDTH = 64      # head_dim and d_state the kernel takes
MAX_CHUNK = 128     # csrc/mamba_scan.cu's kMaxChunk
HEADS_PER_BLOCK = 32  # the "mma" backward's blocks take up to 32 heads
# the "sm90" backward's units (b, chunk, group) take up to 16 heads: 256
# units at zamba2's training shape, ~2 for each of an H100's 132 SMs
SM90_HEADS_PER_BLOCK = 16
BWD_COUNTERS = {"sm90": "mamba_scan_bwd", "mma": "mamba_scan_bwd_mma"}
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
    chunks' cumulative log-decays l (B, nh, S / chunk, 128).

    Differentiable in x, dt, A, Bc and Cc (and through h): under grad mode
    with an input that requires grad it is a `torch.autograd.Function`
    whose forward keeps its inputs and that scratch (the states entering
    each chunk, and l), and whose backward launches the three kernels of
    `csrc/mamba_scan_bwd_sm90.cu` for float32 operands TMA can describe
    (counted once as "mamba_scan_bwd"), those of `csrc/mamba_scan_bwd.cu`
    for the rest ("mamba_scan_bwd_mma"; `bwd_route`), or runs
    `ssd_scan_bwd_ref` on the CPU. On the card a
    bfloat16 scan under grad raises `NotImplementedError` (ROADMAP A11f);
    the models lift the scan's inputs to float32. Otherwise (serving) the
    forward keeps nothing."""
    ssd_shapes(x, dt, A, Bc, Cc, chunk)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, Bc, Cc)):
        if _lib.on_cuda(x) and x.dtype == torch.bfloat16:
            raise NotImplementedError(
                "mamba_ssd has no bfloat16 backward kernel on the card "
                "(ROADMAP item A11f); lift x, Bc and Cc to float32")
        y, h = _SSDScan.apply(x, dt, A, Bc, Cc, chunk)
        return (y, h) if return_state else y
    y, h, _, _ = _forward(x, dt, A, Bc, Cc, chunk, return_state, False)
    return (y, h) if return_state else y


class _SSDScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, Bc, Cc, chunk):
        y, h, states, l = _forward(x, dt, A, Bc, Cc, chunk, True, True)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, Bc, Cc, states, l)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, dt, A, Bc, Cc, states, l = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        dh = None if dh is None else dh.contiguous()
        return (*_backward(x, dt, A, Bc, Cc, dy, dh, states, l, ctx.chunk),
                None)


def _forward(x, dt, A, Bc, Cc, chunk: int, return_state: bool, keep: bool):
    """(y, h, states, l): the kernels on the card, the plain version on
    the CPU. h, the state after the last step, is None on the card unless
    asked for (`return_state`) or kept. With `keep` (the autograd forward)
    `states` — the states entering each chunk, (B, nh, NC, hd, ds) — and,
    on the card, `l` — the chunks' cumulative log-decays, (B, nh, NC, 128)
    — are returned for the backward (the CPU returns l as None: its
    backward forms l again from dt and A); else both are None."""
    B, S, nh, hd, ds, c = ssd_shapes(x, dt, A, Bc, Cc, chunk)
    if not _lib.on_cuda(x):
        y, h, states = ssd_scan_fwd_ref(x, dt, A, Bc, Cc, chunk=chunk)
        return y, h, states if keep else None, None
    dev = x.device
    _check(x, dt, A, Bc, Cc, (torch.float32, torch.bfloat16))
    y = torch.empty_like(x)
    final = (torch.zeros((B, nh, hd, ds), dtype=torch.float32, device=dev)
             if return_state or keep else None)
    kc = kernel_chunk(c)
    nc = -(-S // kc)
    states = torch.empty((B, nh, nc, hd, ds), dtype=torch.float32,
                         device=dev)
    l = torch.empty((B, nh, nc, MAX_CHUNK), dtype=torch.float32, device=dev)
    if y.numel() == 0:
        return y, final, states, l
    rc = _lib.load().tdorch_ssd_scan(
        dev.index or 0, x.data_ptr(), dt.data_ptr(), A.data_ptr(),
        Bc.data_ptr(), Cc.data_ptr(), B, S, nh, hd, ds, kc,
        int(x.dtype == torch.bfloat16), states.data_ptr(), l.data_ptr(),
        _lib.ptr(final), y.data_ptr(), _lib.stream(x))
    _lib.check(rc, "mamba_scan")
    _lib.count("mamba_scan", lambda: (
        _scan_ops(B, S, nh, hd, ds, kc),
        _lib.nbytes(x, dt, A, Bc, Cc, states, l, final, y)))
    return (y, final, states, l) if keep else (y, final, None, None)


def bwd_route(x, dy, Bc, Cc, states) -> str:
    """The backward's kernels for these operands, from their shapes and
    addresses alone: "sm90" (`csrc/mamba_scan_bwd_sm90.cu`, TMA + TF32
    `wgmma`) where a TMA tensor map can describe every tile it loads — hd
    and ds multiples of 4 (rows of whole 16-byte units) and x, dy, Bc, Cc
    and the forward's states at 16-byte aligned addresses — else "mma"
    (`csrc/mamba_scan_bwd.cu`, `mma.sync` over `cp.async` or plain loads).
    Neither falls back to the other."""
    hd, ds = x.shape[3], Bc.shape[2]
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, dy, Bc, Cc, states))
    return "sm90" if hd % 4 == 0 and ds % 4 == 0 and aligned else "mma"


def _backward(x, dt, A, Bc, Cc, dy, dh, states, l, chunk: int,
              route: str | None = None):
    """(dx, ddt, dA, dBc, dCc): the backward kernels on the card (float32;
    `bwd_route`'s, or `route` where given, e.g. to time the "mma" kernels
    on operands "sm90" takes; counted as `BWD_COUNTERS` says),
    `ssd_scan_bwd_ref` on the CPU. `states` and `l` are what
    `_forward(..., keep=True)` returned; dy is shaped as x, dh (B, nh, hd,
    ds) or None (zero). The kernels write dBc's and dCc's partials for each
    group of heads (`HEADS_PER_BLOCK` / `SM90_HEADS_PER_BLOCK` a group) and
    dA's for each (row, chunk, head); they are summed here (the same order
    every call)."""
    B, S, nh, hd, ds, c = ssd_shapes(x, dt, A, Bc, Cc, chunk)
    if not _lib.on_cuda(x):
        return ssd_scan_bwd_ref(x, dt, A, Bc, Cc, dy, dh, chunk=chunk,
                                states=states)
    dev = x.device
    _check(x, dt, A, Bc, Cc, (torch.float32,))
    _lib.require(dy, "dy", (torch.float32,), 4, dev)
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} must be shaped as x "
                         f"{tuple(x.shape)}")
    if dh is not None:
        _lib.require(dh, "dh_final", (torch.float32,), 4, dev)
        if dh.shape != (B, nh, hd, ds):
            raise ValueError(f"dh_final {tuple(dh.shape)} must be "
                             f"{(B, nh, hd, ds)}")
    kc = kernel_chunk(c)
    nc = -(-S // kc)
    _lib.require(states, "states", (torch.float32,), 5, dev)
    _lib.require(l, "l", (torch.float32,), 4, dev)
    if states.shape != (B, nh, nc, hd, ds) or l.shape != (B, nh, nc,
                                                          MAX_CHUNK):
        raise ValueError("states / l are not the forward's scratch for "
                         "these shapes")
    if x.numel() == 0:
        return (torch.zeros_like(x), torch.zeros_like(dt),
                torch.zeros_like(A), torch.zeros_like(Bc),
                torch.zeros_like(Cc))
    route = route or bwd_route(x, dy, Bc, Cc, states)
    if route not in BWD_COUNTERS:
        raise ValueError(f"route {route!r}: one of {tuple(BWD_COUNTERS)}")
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    per_group = SM90_HEADS_PER_BLOCK if route == "sm90" else HEADS_PER_BLOCK
    groups = -(-nh // per_group)
    dB = torch.empty((groups, B, S, ds), dtype=torch.float32, device=dev)
    dC = torch.empty_like(dB)
    dA = torch.empty((B, nc, nh), dtype=torch.float32, device=dev)
    grads = torch.empty_like(states)  # D_k, then G_k
    lib = _lib.load()
    entry = (lib.tdorch_ssd_scan_bwd_sm90 if route == "sm90"
             else lib.tdorch_ssd_scan_bwd)
    rc = entry(
        dev.index or 0, x.data_ptr(), dt.data_ptr(), A.data_ptr(),
        Bc.data_ptr(), Cc.data_ptr(), dy.data_ptr(), _lib.ptr(dh),
        states.data_ptr(), l.data_ptr(), B, S, nh, hd, ds, kc, groups,
        grads.data_ptr(), dx.data_ptr(), ddt.data_ptr(), dB.data_ptr(),
        dC.data_ptr(), dA.data_ptr(), _lib.stream(x))
    _lib.check(rc, BWD_COUNTERS[route])
    _lib.count(BWD_COUNTERS[route], lambda: (
        _scan_ops(B, S, nh, hd, ds, kc, bwd=True),
        _lib.nbytes(x, dt, A, Bc, Cc, dy, dh, states, l, grads, dx, ddt, dB,
                    dC, dA)))
    return dx, ddt, dA.sum((0, 1)), dB.sum(0), dC.sum(0)


def _scan_ops(B, S, nh, hd, ds, c, bwd: bool = False) -> int:
    """The scan's operations in chunks of c: per (row, chunk) the causal
    pairs of C·Bᵀ (ds deep, shared by the heads) and per head those of the
    scores · x (hd deep) and c·hd·ds for the states in and out; the
    backward forms C·Bᵀ, (Σ_h Q)ᵀ·C and (Σ_h Q)·B and twice each head's
    products."""
    c = min(c, S)
    nc, pairs = -(-S // c), c * (c + 1) // 2
    per_head = 2 * pairs * hd + 4 * c * hd * ds
    if bwd:
        return 2 * B * nc * (3 * pairs * ds + nh * per_head)
    return B * nc * (2 * pairs * ds + nh * per_head)


def _check(x, dt, A, Bc, Cc, dtypes) -> None:
    """The checks of a launch's inputs: device, dtype, contiguity, widths
    and the grid's limits."""
    B, S, nh, hd = x.shape
    ds = Bc.shape[2]
    dev = x.device
    _lib.require(x, "x", dtypes, 4, dev)
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
