#!/usr/bin/env python3
"""Design variants of the bf16 grouped GEMM `gg_sm90`, timed side by side on
one NVIDIA GPU at chip_smoke.py's GG_BF16_SHAPES (granite-moe-3b-a800m's
prefill and decode projections, batch 8).

    python3 gg_sm90_variants.py

Each variant is a copy of `src/repro_torch/csrc/moe_gemm.cu` with one
constant changed, built by `kernel_variants.build` into a library of its own
under a temporary directory, and called through its C entry
`tdorch_grouped_gemm_sm90` on the same operands:

  shipped        the source as it is
  no_cluster     128-row tiles without the two-block cluster (each block
                 loads its whole x tile; no TMA multicast)
  columns_64     64-row tiles (decode) of 64 columns (544 tiles at granite's
                 in-projection over 132 SMs: 4.1 waves)
  columns_256    64-row tiles of 256 columns (136 tiles: 1.03 waves)
  sum_128        float32 sums added every 128 of k in place of 256

Every output is held to chip_smoke.py's `gemm_check` gate; the time of a
call is CUDA events around it (the median of 20, after 3), its host work
included. Prints the card's name and power limit, one line a shape, and
writes the numbers to chiprun_out/gg_sm90_variants.json. Needs the card and
the CUDA toolkit; imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

from kernel_variants import build

ROOT = Path(__file__).resolve().parent

# variant -> (text of moe_gemm.cu, its replacement)
VARIANTS = {
    "shipped": None,
    "no_cluster": ("static constexpr int kCluster = BM == 128 ? 2 : 1;",
                   "static constexpr int kCluster = 1;"),
    "columns_64": ("static constexpr int kBN = 128;",
                   "static constexpr int kBN = BM == 64 ? 64 : 128;"),
    "columns_256": ("static constexpr int kBN = 128;",
                    "static constexpr int kBN = BM == 64 ? 256 : 128;"),
    "sum_128": ("constexpr int kSumDepth = 256;",
                "constexpr int kSumDepth = 128;"),
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("gg_sm90_variants.py needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (GG_BF16_SHAPES, GRANITE, SEED, gemm_check,
                            gpu_name_and_power, time_ms)
    from repro_torch.kernels import _lib
    from repro_torch.kernels.moe_gemm.ops import route, tile_rows

    card = gpu_name_and_power()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    E, d, f, k = GRANITE["E"], GRANITE["d"], GRANITE["f"], GRANITE["k"]
    # the operands of chip_smoke.py's row 4b, drawn the same way
    rng = np.random.default_rng(SEED + 4)
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    w = {"in": (torch.randn((E, d, 2 * f), generator=g, device=dev)
                * d ** -0.5).to(torch.bfloat16),
         "out": (torch.randn((E, f, d), generator=g, device=dev)
                 * f ** -0.5).to(torch.bfloat16)}
    rows_out = []
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    with tempfile.TemporaryDirectory() as tmp:
        libs, _ = build(Path(tmp), "moe_gemm.cu", VARIANTS,
                        "tdorch_grouped_gemm_sm90",
                        [i32, ptr, ptr, i64, i64, ptr, i32, i32, i32, i32,
                         i32, i32, ptr, ptr, ptr])
        for label, tokens, proj in GG_BF16_SHAPES:
            experts = np.argsort(rng.random((tokens, E)), axis=1)[:, :k]
            sizes_np = np.bincount(experts.reshape(-1), minlength=E).astype(
                np.int32)
            wt = w[proj]
            M, K, N = tokens * k, wt.shape[1], wt.shape[2]
            x = torch.randn((M, K), generator=g, device=dev).to(
                torch.bfloat16)
            sizes = torch.from_numpy(sizes_np).to(dev)
            if route(x, wt) != "moe_gemm_sm90":
                raise AssertionError(f"{label}: routed to {route(x, wt)}")
            rows = tile_rows(M, E)
            num_tiles = -(-M // rows) + E
            plan = torch.empty((num_tiles, 4), dtype=torch.int32, device=dev)
            out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
            args = (dev.index or 0, x.data_ptr(), wt.data_ptr(),
                    wt.stride(0), wt.stride(1), sizes.data_ptr(), M, K, N, E,
                    rows, num_tiles, plan.data_ptr(), out.data_ptr(),
                    _lib.stream(x))
            row = dict(shape=label, M=M, K=K, N=N, tile_rows=rows)
            for name, fn in libs.items():
                def call():
                    rc = fn(*args)
                    if rc != 0:
                        raise RuntimeError(f"{name}: cudaError {rc}")
                call()
                torch.cuda.synchronize()
                share = gemm_check(x, wt, sizes, out, f"{name} {label}")[1]
                row[name] = dict(ms=time_ms(call, reps=20),
                                 share_of_gate=share)
            print(json.dumps(row), flush=True)
            rows_out.append(row)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "gg_sm90_variants.json").write_text(json.dumps(
        {"card": card, "shapes": rows_out}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
