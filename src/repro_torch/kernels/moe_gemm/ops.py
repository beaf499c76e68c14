"""Grouped GEMM for MoE experts: `grouped_gemm` launches a CUDA kernel of
`csrc/moe_gemm.cu` for a CUDA tensor — float32 operands to `gg_tf32`
(3xTF32 on the tensor cores, counter "moe_gemm"); bf16 operands to
`gg_sm90` (TMA tiles, `wgmma`, a persistent tile walk; counter
"moe_gemm_sm90") where TMA can describe them, else to `gg_bf16` (bf16
`mma.sync` over a `cp.async` ring; counter "moe_gemm_bf16"), both with
float32 sums and y rounded to bf16 once (`route`) — and runs the plain
version (`ref.py`) for a CPU tensor.

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
from .ref import grouped_gemm_ref

_I32_MAX = 2**31 - 1


# the C entry point behind each launch counter
_ENTRIES = {"moe_gemm": "tdorch_grouped_gemm",
            "moe_gemm_sm90": "tdorch_grouped_gemm_sm90",
            "moe_gemm_bf16": "tdorch_grouped_gemm_bf16"}


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
    raises). On the card it has no backward yet: x or w requiring grad
    under grad mode raises `NotImplementedError` (ROADMAP A11d)."""
    if not _lib.on_cuda(x):
        return grouped_gemm_ref(x, w, group_sizes)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise NotImplementedError(
            "grouped_gemm has no backward kernel on the card yet (ROADMAP "
            "item A11d); the plain version trains on the CPU")
    return _launch(x, w, group_sizes)


def _launch(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
            kernel: str | None = None) -> torch.Tensor:
    """`grouped_gemm` on the card. `kernel` (a launch counter) overrides
    `route`, for chip_smoke.py to time the kernel it does not choose; a
    kernel that cannot take the operands refuses them and this raises."""
    dev = x.device
    _lib.require(x, "x", (torch.float32, torch.bfloat16), 2, dev)
    _lib.require(w, "w", (x.dtype,), 3, dev, dense_rows=True)
    _lib.require(group_sizes, "group_sizes", (torch.int32,), 1, dev)
    M, K = x.shape
    G, Kw, N = w.shape
    if Kw != K:
        raise ValueError(f"w has depth {Kw}, x has {K} columns")
    if group_sizes.shape[0] != G:
        raise ValueError(f"group_sizes has {group_sizes.shape[0]} entries "
                         f"for {G} groups")
    counter = kernel or route(x, w)
    rows = tile_rows(M, G)
    # the worst case: every nonempty group adds one partly filled tile
    num_tiles = -(-M // rows) + G
    if max(M, K, N, num_tiles) > _I32_MAX:
        raise ValueError(f"shape (M={M}, K={K}, N={N}, G={G}) is beyond the "
                         "kernel's int32 operands")
    out = torch.empty((M, N), dtype=x.dtype, device=dev)
    if M == 0 or N == 0:
        return out
    plan = torch.empty((num_tiles, 4), dtype=torch.int32, device=dev)
    args = [dev.index or 0, x.data_ptr(), w.data_ptr(), w.stride(0),
            w.stride(1), group_sizes.data_ptr(), M, K, N, G, rows, num_tiles]
    if counter != "moe_gemm_sm90":  # the cp.async kernels' copy width
        args.append(int(copies16(x, w)))
    rc = getattr(_lib.load(), _ENTRIES[counter])(
        *args, plan.data_ptr(), out.data_ptr(), _lib.stream(x))
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
