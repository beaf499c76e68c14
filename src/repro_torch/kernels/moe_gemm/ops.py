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
- dw[g] = x_gᵀ · dy_g (`_launch_dw`, `csrc/moe_gemm_bwd.cu`): a
  prologue cuts each group's rows into chunks of at most `dw_chunk_rows`
  rows and lists the work units (chunk, 128 x 128 tile of dw) longest
  chunk first (`dw_plan_ref` is its plain twin); one persistent block an
  SM takes the units in list order as it frees up. A group of one chunk
  is written directly; a split group's chunks write float32 partials
  that a second kernel adds in chunk order — `gg_dw_sm90` (TMA +
  `wgmma`, counter "moe_gemm_dw_sm90") where TMA can describe bf16 x and
  dy, else `gg_dw_bf16` ("moe_gemm_dw_bf16"), and `gg_dw_tf32` (3xTF32,
  counter "moe_gemm_dw") for float32 (`route_dw`). No atomics: two calls
  give the same bits.
On the CPU the backward is `grouped_gemm_bwd_ref`.

Also home of `gathered_swiglu`, the gathered-weights form of the expert
FFN that the parameter server's `MoERouter` stage lambda runs: each task
carries its own gathered expert weight rows (the orchestrator's padded
multi-get view) instead of indexing a dense (G, ., .) stack, so it is the
per-task dual of `grouped_gemm`'s sorted-by-group layout.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

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
            "moe_gemm_dw_sm90": "tdorch_grouped_gemm_dw_sm90",
            "moe_gemm_dw_bf16": "tdorch_grouped_gemm_dw_bf16"}

# the dw kernels' tile of dw (csrc/moe_gemm_bwd.cu's kBM x kBN) and the
# rows a bf16 sum stays on the tensor core (kSumDepth): a chunk of a
# group's rows is a whole number of such sums
DW_TILE = 128
SUM_DEPTH = 256


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
    _lib.count(counter, lambda: (
        2 * min(int(group_sizes.sum()), M) * depth * n_out,
        _lib.nbytes(x, w, group_sizes, out)))
    return out


def _launch_dw(x: torch.Tensor, dy: torch.Tensor, group_sizes: torch.Tensor,
               w_shape, kernel: str | None = None,
               scratch: dict | None = None) -> torch.Tensor:
    """dw[g] = x_gᵀ · dy_g on the card, (G, K, N) dense in x's dtype, the
    sums over group g's rows only; an empty group's dw is 0 and rows at or
    beyond the groups' sum are not read. Float32 sums (3xTF32 for float32
    operands), rounded to the dtype once; no atomics. `kernel` (a launch
    counter of x's dtype) overrides `route_dw`; `scratch`, where given,
    receives the call's plan and partial-sum workspace (chip_smoke.py reads
    them back)."""
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
    counter = kernel or route_dw(x, dy)
    if counter not in (("moe_gemm_dw",) if x.dtype == torch.float32 else
                       ("moe_gemm_dw_sm90", "moe_gemm_dw_bf16")):
        raise ValueError(f"{counter} is no dw kernel of {x.dtype} operands")
    out = torch.empty((G, K, N), dtype=x.dtype, device=dev)
    if out.numel() == 0:
        return out
    walk = dw_walk(M, K, N, G, _sm_count(dev.index or 0))
    if max(M, K, N, walk.max_chunks * walk.tiles) > _I32_MAX:
        raise ValueError(f"shape (M={M}, K={K}, N={N}, G={G}) is beyond "
                         "the kernel's int32 operands")
    # one allocation: the plan's int4 entries, then the float32 partials
    # (16-byte aligned after the plan)
    n_plan = 4 * (1 + walk.max_chunks + 2 * G)
    buf = torch.empty(n_plan + walk.slots * K * N, dtype=torch.float32,
                      device=dev)
    args = [dev.index or 0, x.data_ptr(), dy.data_ptr(),
            group_sizes.data_ptr(), M, K, N, G, walk.chunk_rows,
            walk.max_chunks, walk.blocks, walk.max_split]
    if counter != "moe_gemm_dw_sm90":  # the cp.async kernels' copy width
        v = 16 // x.element_size()
        args.append(int(x.data_ptr() % 16 == 0 and dy.data_ptr() % 16 == 0
                        and K % v == 0 and N % v == 0))
    rc = getattr(_lib.load(), _ENTRIES[counter])(
        *args, buf.data_ptr(), buf.data_ptr() + 4 * n_plan, out.data_ptr(),
        _lib.stream(x))
    _lib.check(rc, counter)
    _lib.count(counter, lambda: (
        2 * min(int(group_sizes.sum()), M) * K * N,
        _lib.nbytes(x, dy, group_sizes, out)))
    if scratch is not None:
        scratch.update(plan=buf[:n_plan].view(torch.int32).view(-1, 4),
                       workspace=buf[n_plan:].view(walk.slots, K, N),
                       **walk._asdict())
    return out


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def dw_chunk_rows(M: int, K: int, N: int, sms: int) -> int:
    """The most rows of a group one dw work unit sums: an SM's fair share
    of the call, tiles·M / sms with tiles = ⌈K/128⌉·⌈N/128⌉ (the dw tiles
    of a group), rounded down to a multiple of SUM_DEPTH and at least
    SUM_DEPTH. From the shapes and the SM count alone: no host sync on the
    sizes. A group longer than this is split, so its tiles cannot end the
    call alone; the walk takes the longest units first. Half a share
    splits one more chunk: at granite's training shapes it read up to 3%
    slower, a quarter slower still (gg_dw_variants.py)."""
    tiles = -(-K // DW_TILE) * -(-N // DW_TILE)
    rows = tiles * M // sms // SUM_DEPTH * SUM_DEPTH
    return max(rows, SUM_DEPTH)


class DwWalk(NamedTuple):
    """The host's numbers for a dw launch (`dw_walk`)."""
    chunk_rows: int  # C, `dw_chunk_rows`
    tiles: int       # dw tiles a group
    max_chunks: int  # G + ⌈M/C⌉: ⌈rows/C⌉ a group, an empty group one
    max_split: int   # groups that can exceed C: the reduce's rows of
    #                  blocks (0 skips it)
    slots: int       # float32 partials in the workspace: a split group of
    #                  L > C rows has ⌈L/C⌉ < 2L/C chunks, so ≤ 2·⌈M/C⌉
    blocks: int      # the persistent grid: one block an SM, no more than
    #                  the units


@functools.lru_cache(maxsize=256)
def dw_walk(M: int, K: int, N: int, G: int, sms: int) -> DwWalk:
    """The host's numbers for a dw launch at these shapes on `sms` SMs."""
    C = dw_chunk_rows(M, K, N, sms)
    tiles = -(-K // DW_TILE) * -(-N // DW_TILE)
    max_chunks = G + -(-M // C)
    max_split = min(G, M // (C + 1))
    return DwWalk(chunk_rows=C, tiles=tiles, max_chunks=max_chunks,
                  max_split=max_split,
                  slots=2 * -(-M // C) if max_split else 0,
                  blocks=min(sms, max_chunks * tiles))


def dw_plan_ref(group_sizes, M: int, C: int) -> tuple:
    """The plain version of the dw prologue's plan (`dw_plan` in
    csrc/moe_gemm_bwd.cu): (chunks, splits). Each group's rows (negative
    sizes as 0, cut at M) are cut from its first row into chunks of C rows
    and a last shorter one; an empty group is one chunk of no rows.
    `chunks` lists (group, first row, end row, slot) longest first, ties in
    (group, chunk) order; slot is -1 for a group of one chunk (its units
    write dw) and the chunk's partial in the workspace for a split group
    (consecutive slots, split groups in group order). `splits` lists
    (group, first slot, chunks) of the split groups, in group order."""
    full, rest, splits = [], [], []
    start = slot = 0
    for g, size in enumerate(np.asarray(group_sizes).tolist()):
        end = min(start + max(int(size), 0), M)
        rows = end - start
        n_full = rows // C
        split = rows > C
        base = slot if split else -1
        full += [(g, start + j * C, start + (j + 1) * C,
                  base + j if split else -1) for j in range(n_full)]
        if rows % C or rows == 0:
            rest.append((g, start + n_full * C, end,
                         base + n_full if split else -1))
        if split:
            n = n_full + (rows % C != 0)
            splits.append((g, slot, n))
            slot += n
        start = end
    rest.sort(key=lambda c: (c[1] - c[2], c[0]))
    return full + rest, splits


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


def route_dw(x: torch.Tensor, dy: torch.Tensor) -> str:
    """The launch counter of the dw kernel a CUDA call takes: "moe_gemm_dw"
    (`gg_dw_tf32`) for float32; for bf16 "moe_gemm_dw_sm90" (`gg_dw_sm90`)
    where a TMA tensor map can describe x and dy — both bases 16-byte
    aligned, K and N multiples of 8 (x and dy are contiguous, so their rows
    are then 16-byte aligned too) — else "moe_gemm_dw_bf16"
    (`gg_dw_bf16`)."""
    if x.dtype != torch.bfloat16:
        return "moe_gemm_dw"
    if (x.data_ptr() % 16 == 0 and dy.data_ptr() % 16 == 0
            and x.shape[1] % 8 == 0 and dy.shape[1] % 8 == 0):
        return "moe_gemm_dw_sm90"
    return "moe_gemm_dw_bf16"


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
