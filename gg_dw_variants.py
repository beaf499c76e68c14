#!/usr/bin/env python3
"""Design variants of B4's weight-gradient kernels (csrc/moe_gemm_bwd.cu),
timed side by side on one NVIDIA GPU at chip_smoke.py's row 4d shapes
(granite-moe-1b-a400m's in- and out-projection over 131,072 Zipf-1.2 rows).

    python3 gg_dw_variants.py

Source variants of `gg_dw_sm90` (bf16), each a copy of the source built by
`kernel_variants.build` into a library of its own and called through its C
entry `tdorch_grouped_gemm_dw_sm90` on the same operands:

  shipped        the source as it is
  store_at_end   a unit's stores when its last sum is added, not beside
                 the next unit's first sum

and the walk's chunk length, passed by the host, as a share of an SM's fair
share of the call's tile-rows: the whole share ("C", `ops.dw_chunk_rows`), a
half ("C/2"), a quarter ("C/4"), and no split at all ("whole": past every
group), for
`gg_dw_sm90` and, through the package's own library, `gg_dw_bf16` on the
same bf16 operands and `gg_dw_tf32` in float32.

Every output is held to chip_smoke.py's `dw_check` gate; the time of a
call is CUDA events around it (the median of 20, after 3), its host work
included. Prints the card's name and power limit, then one JSON line a
shape. Needs the card and the CUDA toolkit; imports nothing of JAX.
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

# variant -> (text of moe_gemm_bwd.cu, its replacement)
VARIANTS = {
    "shipped": None,
    "store_at_end": [
        ("        if (s0 == 0 && last.g >= 0) store_wgmma(acc, last, wg, K, N, "
         "ws, dw);\n", ""),
        ("      last = w;\n    }\n    if (last.g >= 0)",
         "      store_wgmma(acc, w, wg, K, N, ws, dw);\n"
         "      last = {-1, 0, 0, 0, 0, 0};\n    }\n    if (last.g >= 0)")],
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("gg_dw_variants.py needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (GG_BWD_M, GG_BWD_SHAPES, GRANITE_1B, SEED,
                            _bwd_case, _grouped_wsums, _sizes_zipf, dw_check,
                            gpu_name_and_power, time_ms)
    from repro_torch.kernels import _lib
    from repro_torch.kernels.moe_gemm import ops

    card = gpu_name_and_power()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    sms = ops._sm_count(0)
    E, d, f = GRANITE_1B["E"], GRANITE_1B["d"], GRANITE_1B["f"]
    rng = np.random.default_rng(SEED + 29)  # row 4d's sizes
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    argtypes = [i32, ptr, ptr, ptr, *[i32] * 8, ptr, ptr, ptr, ptr]
    lib = _lib.load()
    with tempfile.TemporaryDirectory() as tmp:
        libs, _ = build(Path(tmp), "moe_gemm_bwd.cu", VARIANTS,
                        "tdorch_grouped_gemm_dw_sm90", argtypes)
        for i, (label, proj) in enumerate(GG_BWD_SHAPES):
            K, N = (d, 2 * f) if proj == "in" else (f, d)
            sizes = _sizes_zipf(rng, GG_BWD_M, E)
            M = GG_BWD_M
            tiles = -(-K // ops.DW_TILE) * -(-N // ops.DW_TILE)

            def share(frac, tiles=tiles, M=M):  # of an SM's fair share
                rows = int(tiles * M / sms * frac)
                return max(ops.SUM_DEPTH,
                           rows // ops.SUM_DEPTH * ops.SUM_DEPTH)
            chunks = {"C": share(1.0), "C/2": share(0.5),
                      "C/4": share(0.25),
                      "whole": -(-M // ops.SUM_DEPTH) * ops.SUM_DEPTH}
            if chunks["C"] != ops.dw_chunk_rows(M, K, N, sms):
                raise AssertionError("C is not the shipped rule")
            row = dict(shape=label, M=M, K=K, N=N, largest=int(sizes.max()),
                       chunk_rows=chunks)
            for dtype in (torch.bfloat16, torch.float32):
                x, dy, w, sz = _bwd_case(dev, E, M, K, N, sizes, dtype,
                                         SEED + 2900 + i)
                sums = _grouped_wsums(x, dy, sz, E)
                fns = ({f"gg_dw_sm90 {v}": (fn, False)
                        for v, fn in libs.items()}
                       if dtype == torch.bfloat16 else {})
                fns.update(
                    {"gg_dw_bf16": (lib.tdorch_grouped_gemm_dw_bf16, True)}
                    if dtype == torch.bfloat16 else
                    {"gg_dw_tf32": (lib.tdorch_grouped_gemm_dw, True)})
                for kname, (fn, vec) in fns.items():
                    for cname, C in chunks.items():
                        if ("shipped" not in kname and "sm90" in kname
                                and cname != "C"):
                            continue
                        walk = ops.dw_walk(M, K, N, E, sms)
                        max_chunks = E + -(-M // C)
                        max_split = min(E, M // (C + 1))
                        plan = torch.empty((1 + max_chunks + 2 * E, 4),
                                           dtype=torch.int32, device=dev)
                        ws = torch.empty(
                            (2 * -(-M // C) if max_split else 0, K, N),
                            dtype=torch.float32, device=dev)
                        out = torch.empty((E, K, N), dtype=dtype, device=dev)
                        args = [0, x.data_ptr(), dy.data_ptr(),
                                sz.data_ptr(), M, K, N, E, C, max_chunks,
                                walk.blocks, max_split]
                        if vec:
                            args.append(1)
                        args += [plan.data_ptr(), ws.data_ptr(),
                                 out.data_ptr(), _lib.stream(x)]

                        def call(fn=fn, args=args, name=kname):
                            rc = fn(*args)
                            if rc != 0:
                                raise RuntimeError(f"{name}: cudaError {rc}")
                        call()
                        torch.cuda.synchronize()
                        share = dw_check(x, dy, sz, out,
                                         f"{kname} {cname} {label}",
                                         sums)[1]
                        row[f"{kname} {cname}"] = dict(
                            ms=time_ms(call, reps=20), share_of_gate=share,
                            split_groups=int(plan[0, 1]))
                        del plan, ws, out
                del x, dy, w, sz, sums
                torch.cuda.empty_cache()
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
