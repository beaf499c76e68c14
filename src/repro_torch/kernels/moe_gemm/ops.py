"""Grouped GEMM for MoE experts: `grouped_gemm` launches a CUDA kernel of
`csrc/moe_gemm.cu` for a CUDA tensor — float32 operands to `gg_tf32`
(3xTF32 on the tensor cores, counter "moe_gemm"); bf16 operands to
`gg_sm90` (TMA tiles, `wgmma`, a persistent tile walk; counter
"moe_gemm_sm90") where TMA can describe them, else to `gg_bf16` (bf16
`mma.sync` over a `cp.async` ring; counter "moe_gemm_bf16"), both with
float32 sums and y rounded to bf16 once (`route`) — and runs the plain
version (`ref.py`) for a CPU tensor.

Under grad it is a `torch.autograd.Function` whose backward launches two
more kernels on the card, each only for an input that needs its gradient
(the dtype and the layout pick the route, as for the forward):
- dx = dy · wᵀ (`_launch_dx`): the forward's kernels with w read
  transposed in place — `gg_tf32` with a transposed w stage (counter
  "moe_gemm_dx"), `gg_sm90` with B K-major ("moe_gemm_dx_sm90") or
  `gg_bf16` with B by `ldmatrix` ("moe_gemm_dx_bf16"), `route_dx`;
- dw[g] = x_gᵀ · dy_g (`_launch_dw`, `csrc/moe_gemm_bwd.cu`): one block a
  (group, 128 x 128 tile of dw) walks the group's rows — `gg_dw_tf32`
  (3xTF32, counter "moe_gemm_dw") or `gg_dw_bf16` ("moe_gemm_dw_bf16").
  No atomics: two calls give the same bits.
On the CPU the backward is `grouped_gemm_bwd_ref`.

Also home of `gathered_swiglu`, the gathered-weights form of the expert
FFN that the parameter server's `MoERouter` stage lambda runs: each task
carries its own gathered expert weight rows (the orchestrator's padded
multi-get view) instead of indexing a dense (G, ., .) stack, so it is the
per-task dual of `grouped_gemm`'s sorted-by-group layout.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import _lib
from .ref import grouped_gemm_bwd_ref, grouped_gemm_ref

_I32_MAX = 2**31 - 1


# the C entry point behind each launch counter
_ENTRIES = {"moe_gemm": "tdorch_grouped_gemm",
            "moe_gemm_sm90": "tdorch_grouped_gemm_sm90",
            "moe_gemm_bf16": "tdorch_grouped_gemm_bf16",
            "moe_gemm_dx": "tdorch_grouped_gemm_dx",
            "moe_gemm_dx_sm90": "tdorch_grouped_gemm_dx_sm90",
            "moe_gemm_dx_bf16": "tdorch_grouped_gemm_dx_bf16",
            "moe_gemm_dw": "tdorch_grouped_gemm_dw",
            "moe_gemm_dw_bf16": "tdorch_grouped_gemm_dw_bf16"}


def grouped_gemm(x: torch.Tensor, w: torch.Tensor,
                 group_sizes: torch.Tensor) -> torch.Tensor:
    """x: (M, K) sorted by group; w: (G, K, N); group_sizes: (G,) -> (M, N)
    in x's dtype. Group g owns the next group_sizes[g] rows; rows at or
    beyond the groups' sum give zeros, and empty groups are allowed. On
    the card x must be contiguous float32 or bf16, w of x's dtype with
    dense rows (a strided view, such as a slice of wider weight rows, is
    read in place) and group_sizes contiguous int32, all on one device; the
    sizes stay there (no host sync). float32 runs in 3xTF32, whatever
    `torch.backends.cuda.matmul.allow_tf32` says; bf16 reads x and w as
    they are and sums their exact products in float32, rounding y to bf16
    once, on the kernel `route` names (no fallback: a refused launch
    raises). Where x or w requires grad under grad mode the call is
    differentiable (`_GroupedGemm`): dx and dw come from the backward
    kernels on the card, from `grouped_gemm_bwd_ref` on the CPU; dw is
    dense, of w's shape, whatever w's strides."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _GroupedGemm.apply(x, w, group_sizes)
    if not _lib.on_cuda(x):
        return grouped_gemm_ref(x, w, group_sizes)
    return _launch(x, w, group_sizes)


class _GroupedGemm(torch.autograd.Function):
    """`grouped_gemm` with its backward: the kernels on the card, the plain
    version on the CPU."""

    @staticmethod
    def forward(ctx, x, w, group_sizes):
        ctx.save_for_backward(x, w, group_sizes)
        if not _lib.on_cuda(x):
            return grouped_gemm_ref(x, w, group_sizes)
        return _launch(x, w, group_sizes)

    @staticmethod
    def backward(ctx, dy):
        x, w, group_sizes = ctx.saved_tensors
        need_x, need_w = ctx.needs_input_grad[:2]
        if not _lib.on_cuda(x):
            dx, dw = grouped_gemm_bwd_ref(x, w, group_sizes, dy)
            return dx if need_x else None, dw if need_w else None, None
        dy = dy.contiguous()
        dx = _launch_dx(dy, w, group_sizes) if need_x else None
        dw = _launch_dw(x, dy, group_sizes, w.shape) if need_w else None
        return dx, dw, None


def _check_operands(x, w, group_sizes, name: str):
    """The checks of every tile-walk launch: x (named `name`: M rows)
    contiguous float32 or bf16, w (G, ·, ·) of x's dtype with dense rows,
    group_sizes (G,) int32, on one device."""
    dev = x.device
    _lib.require(x, name, (torch.float32, torch.bfloat16), 2, dev)
    _lib.require(w, "w", (x.dtype,), 3, dev, dense_rows=True)
    _lib.require(group_sizes, "group_sizes", (torch.int32,), 1, dev)
    if group_sizes.shape[0] != w.shape[0]:
        raise ValueError(f"group_sizes has {group_sizes.shape[0]} entries "
                         f"for {w.shape[0]} groups")


def _launch(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
            kernel: str | None = None) -> torch.Tensor:
    """`grouped_gemm` on the card. `kernel` (a launch counter) overrides
    `route`, for chip_smoke.py to time the kernel it does not choose; a
    kernel that cannot take the operands refuses them and this raises."""
    _check_operands(x, w, group_sizes, "x")
    if w.shape[1] != x.shape[1]:
        raise ValueError(f"w has depth {w.shape[1]}, x has {x.shape[1]} "
                         "columns")
    return _tiles(x, w, group_sizes, w.shape[2], kernel or route(x, w))


def _launch_dx(dy: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
               kernel: str | None = None) -> torch.Tensor:
    """dx = dy · w[g]ᵀ row by row on the card, (M, K) in dy's dtype: the
    forward's tile walk over dy (M, N) with w read transposed in place;
    rows at or beyond the groups' sum are 0. `kernel` overrides
    `route_dx`."""
    _check_operands(dy, w, group_sizes, "dy")
    if w.shape[2] != dy.shape[1]:
        raise ValueError(f"w has width {w.shape[2]}, dy has {dy.shape[1]} "
                         "columns")
    return _tiles(dy, w, group_sizes, w.shape[1], kernel or route_dx(dy, w))


def _tiles(x, w, group_sizes, n_out: int, counter: str) -> torch.Tensor:
    """Launch one of the tile-walk kernels (forward or dx) on x (M, depth)
    and w, writing (M, n_out): the prologue's plan of `tile_rows` tiles,
    then the kernel."""
    dev = x.device
    M, depth = x.shape
    G = w.shape[0]
    rows = tile_rows(M, G)
    # the worst case: every nonempty group adds one partly filled tile
    num_tiles = -(-M // rows) + G
    if max(M, depth, n_out, num_tiles) > _I32_MAX:
        raise ValueError(f"shape (M={M}, depth={depth}, N={n_out}, G={G}) "
                         "is beyond the kernel's int32 operands")
    out = torch.empty((M, n_out), dtype=x.dtype, device=dev)
    if M == 0 or n_out == 0:
        return out
    plan = torch.empty((num_tiles, 4), dtype=torch.int32, device=dev)
    args = [dev.index or 0, x.data_ptr(), w.data_ptr(), w.stride(0),
            w.stride(1), group_sizes.data_ptr(), M, depth, n_out, G, rows,
            num_tiles]
    if not counter.endswith("_sm90"):  # the cp.async kernels' copy width
        args.append(int(copies16(x, w)))
    rc = getattr(_lib.load(), _ENTRIES[counter])(
        *args, plan.data_ptr(), out.data_ptr(), _lib.stream(x))
    _lib.check(rc, counter)
    _lib.count(counter)
    return out


def _launch_dw(x: torch.Tensor, dy: torch.Tensor, group_sizes: torch.Tensor,
               w_shape) -> torch.Tensor:
    """dw[g] = x_gᵀ · dy_g on the card, (G, K, N) dense in x's dtype, the
    sums over group g's rows only; an empty group's dw is 0 and rows at or
    beyond the groups' sum are not read. Float32 sums (3xTF32 for float32
    operands), rounded to the dtype once; no atomics."""
    dev = x.device
    _lib.require(x, "x", (torch.float32, torch.bfloat16), 2, dev)
    _lib.require(dy, "dy", (x.dtype,), 2, dev)
    _lib.require(group_sizes, "group_sizes", (torch.int32,), 1, dev)
    G, K, N = (int(v) for v in w_shape)
    M = x.shape[0]
    if x.shape[1] != K or dy.shape != (M, N) or group_sizes.shape[0] != G:
        raise ValueError(f"x {tuple(x.shape)}, dy {tuple(dy.shape)} and "
                         f"{group_sizes.shape[0]} sizes do not fit w "
                         f"({G}, {K}, {N})")
    col_tiles = -(-K // 128) * -(-N // 128)
    if max(M, K, N, G * col_tiles) > _I32_MAX:
        raise ValueError(f"shape (M={M}, K={K}, N={N}, G={G}) is beyond "
                         "the kernel's int32 operands")
    out = torch.empty((G, K, N), dtype=x.dtype, device=dev)
    if out.numel() == 0:
        return out
    counter = "moe_gemm_dw" if x.dtype == torch.float32 else \
        "moe_gemm_dw_bf16"
    v = 16 // x.element_size()
    vec16 = (x.data_ptr() % 16 == 0 and dy.data_ptr() % 16 == 0
             and K % v == 0 and N % v == 0)
    rc = getattr(_lib.load(), _ENTRIES[counter])(
        dev.index or 0, x.data_ptr(), dy.data_ptr(),
        group_sizes.data_ptr(), M, K, N, G, int(vec16), out.data_ptr(),
        _lib.stream(x))
    _lib.check(rc, counter)
    _lib.count(counter)
    return out


def route(x: torch.Tensor, w: torch.Tensor) -> str:
    """The launch counter of the kernel a CUDA call takes: "moe_gemm"
    (`gg_tf32`) for float32; for bf16 "moe_gemm_sm90" (`gg_sm90`) where a
    TMA tensor map can describe x and w — both bases and w's strides
    16-byte aligned, K > 0 and K and N multiples of 8 (`copies16`, and N)
    — else "moe_gemm_bf16" (`gg_bf16`)."""
    if x.dtype != torch.bfloat16:
        return "moe_gemm"
    K, N = x.shape[1], w.shape[2]
    if K > 0 and N % 8 == 0 and copies16(x, w):
        return "moe_gemm_sm90"
    return "moe_gemm_bf16"


def route_dx(dy: torch.Tensor, w: torch.Tensor) -> str:
    """The launch counter of the dx kernel a CUDA call takes: "moe_gemm_dx"
    (`gg_tf32`, w transposed) for float32; for bf16 "moe_gemm_dx_sm90"
    (`gg_sm90`, B K-major) where a TMA tensor map can describe dy and w —
    both bases and w's strides 16-byte aligned, N > 0 and K and N multiples
    of 8 — else "moe_gemm_dx_bf16" (`gg_bf16`, w transposed)."""
    if dy.dtype != torch.bfloat16:
        return "moe_gemm_dx"
    K, N = w.shape[1], dy.shape[1]
    if N > 0 and K % 8 == 0 and copies16(dy, w):
        return "moe_gemm_dx_sm90"
    return "moe_gemm_dx_bf16"


def tile_rows(M: int, G: int) -> int:
    """The kernel's rows a tile: 64 where the G groups average fewer than
    128 of the M rows (a decode step), else 128."""
    return 64 if M < 128 * G else 128


def copies16(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether the kernel may load x and w in 16-byte copies: both bases
    16-byte aligned, and K and w's group and row strides multiples of 16
    bytes (4 float32 values, 8 bf16). Otherwise it loads them one value at
    a time."""
    v = 16 // x.element_size()
    return (x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
            and x.shape[1] % v == 0 and w.stride(0) % v == 0
            and w.stride(1) % v == 0)


def gathered_swiglu(x, w_in, w_out, gate):
    """Per-task gathered-expert SwiGLU combine.

    x: (n, d) token activations; w_in: (n, A, d, 2f) and w_out: (n, A, f, d)
    — each task's gathered expert weight rows (slot a = the task's a-th
    routed expert, zero-filled past its arity); gate: (n, A) combine weights
    (0 = inactive slot, so padding contributes nothing). Returns the gated
    expert mixture (n, d).

    Gate half first, as the JAX package's `core.spmd.grouped_swiglu`.
    Written against the array subset numpy and torch share, so the numpy
    oracle backend and the torch backend run the same expression.
    """
    xp = np if isinstance(x, np.ndarray) else torch
    f = w_out.shape[2]
    h = xp.einsum("nd,nadf->naf", x, w_in)  # (n, A, 2f)
    g, up = h[..., :f], h[..., f:]
    act = g * (1.0 / (1.0 + xp.exp(-g))) * up  # silu(gate) * up
    y = xp.einsum("naf,nafd->nad", act, w_out)  # (n, A, d)
    return (y * gate[..., None]).sum(axis=1)
