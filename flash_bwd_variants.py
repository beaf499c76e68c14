#!/usr/bin/env python3
"""Design variants of the attention backward, bf16 (`fa_bwd_dkdv_sm90`,
`fa_bwd_dq_sm90`) or float32 (`fa_bwd_dkdv_tf32`, `fa_bwd_dq_tf32`), timed
side by side on one NVIDIA GPU at chip_smoke.py's row-5c shapes
(tinyllama-1.1b's training step, prefill_mha, prefill_gqa128).

    python3 flash_bwd_variants.py [--dtype bfloat16|float32] [VARIANT ...]

Each variant is a copy of the dtype's source (bf16:
`src/repro_torch/csrc/flash_attention_bwd_sm90.cu`, C entry
`tdorch_flash_attention_bwd_bf16`; float32:
`flash_attention_bwd_tf32_sm90.cu`, `tdorch_flash_attention_bwd_tf32`) with
pieces of text changed, built by `kernel_variants.build` into a library of
its own under a temporary directory, and called through its C entry on the
same inputs (the shipped source and the variants named, or all). bf16:

  shipped     the source as it is
  dq_past_end fa_bwd_dq_sm90's last step issues S and dP from the ring
              stage after its tile's (an older tile, or never written) and
              drops them, as first written (shipped: from its own tile)
  dq_branch   the last step skips them behind a branch inside the loop
  dq_peeled   the last tile's dq product alone, after a loop over the others
  rows_64     fa_bwd_dkdv_sm90 walks 64 query rows a step at every head dim
              (Sᵀ and dPᵀ m64n64, dv and dk four k16 steps a group)
  keys_64     fa_bwd_dq_sm90 walks 64 keys a step at every head dim
  regs_240    240 registers a consumer thread, 24 a producer thread (232
              and 40 shipped)
  stages_2    a ring of 2 stages in both kernels (4 shipped)

float32:

  shipped     the source as it is
  keys_32     32 keys a dk/dv block and a dq step at every head dim (64 at
              hd 32 and 64, 32 at hd 128 shipped): S and dP m64n32
  regs_232    232 registers a consumer thread, 40 a producer thread (240
              and 24 shipped)
  chunk_8     A fragments of 8 k8 slices a group of `wgmma`s before it
              waits (4 shipped: 32 registers)
  dq_scalar   fa_bwd_dq_tf32 stores dS and dS_lo one value at a time
              (shipped: a float2 of two keys of a row)
  dq_no_bar   fa_bwd_dq_tf32 writes a tile's dS with no barrier after the
              warpgroup's previous product, which the ring orders at depth
              2 (hd 64, 128) but not at 4 (hd 32)
  generic     both kernels reach shared memory through a pointer rounded up
              through an integer, which the compiler cannot place in shared
              memory: generic LD / ST on 64-bit addresses (shipped: LDS / STS)
  at_divide   the swizzled offset `at` with its chunk as (c % 32) / 4
              and c % 4 (shipped: (c & 31) >> 2, c & 3; nvcc 12.9
              miscompiles this form under dq_scalar at hd 128, which then
              faults: name it without dq_scalar)
  at_shift    `at` as (c >> 5), (c >> 2) & 7 and c & 3

Every output is held to chip_smoke.py's `bwd_check` gate, and must equal,
bit for bit, the output of the variant's last timed call. The time of a
call is CUDA events around it (the median of 10, after 2), the variants in
turns (shipped, ..., last, last, ..., shipped); the device time split by
kernel is torch.profiler's (`device_ms`; "split not measured" where it fell
back to CUDA events). Beside them, each shape reads the backward of
`F.scaled_dot_product_attention` on the same inputs (`library_ms`, CUDA
events the same way). Prints the card's name and power limit, each
variant's registers, shared memory and spills (`-Xptxas -v`) and one line a
shape and variant, and writes the numbers to
chiprun_out/flash_bwd_variants_<dtype>.json. Needs the card and the CUDA
toolkit; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
import tempfile
from pathlib import Path

from kernel_variants import build

ROOT = Path(__file__).resolve().parent
# dtype -> (source, C entry); the float32 entry also takes k_lo and v_lo
# scratch
SOURCES = {"bfloat16": ("flash_attention_bwd_sm90.cu",
                        "tdorch_flash_attention_bwd_bf16"),
           "float32": ("flash_attention_bwd_tf32_sm90.cu",
                       "tdorch_flash_attention_bwd_tf32")}

# fa_bwd_dq_sm90's walk as shipped: the last step issues S and dP of its
# own tile again and drops them
_DQ_WALK = """    for (int j = 0; j < n_tiles; ++j) {
      const int jn = j + 1 < n_tiles ? j + 1 : j;
      if (jn > j) mbar_wait(&full[jn % kStages], (jn / kStages) & 1);
      zero(sc);
      zero(dp);
      wgmma_fence();
      gemm_rn<HD, kKT>(acc, dsa, tile(j), kKT);
      issue_sdp(tile(jn));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(dsa);
      fence_regs(sc);
      fence_regs(dp);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[j % kStages]);
      probs(jn);  // the last step's: dropped
    }
"""
# ... as first written: the last step's S and dP read the ring stage after
# its tile's, which holds an older tile or was never written
_DQ_PAST_END = _DQ_WALK.replace(
    "      const int jn = j + 1 < n_tiles ? j + 1 : j;\n"
    "      if (jn > j) mbar_wait(&full[jn % kStages], (jn / kStages) & 1);\n",
    "      const int jn = j + 1;\n"
    "      if (jn < n_tiles) mbar_wait(&full[jn % kStages], "
    "(jn / kStages) & 1);\n")
# the next tile's S, dP and dS behind a branch inside the loop
_DQ_BRANCH = """    for (int j = 0; j < n_tiles; ++j) {
      const bool next = j + 1 < n_tiles;
      if (next) mbar_wait(&full[(j + 1) % kStages], ((j + 1) / kStages) & 1);
      zero(sc);
      zero(dp);
      wgmma_fence();
      gemm_rn<HD, kKT>(acc, dsa, tile(j), kKT);
      if (next) issue_sdp(tile(j + 1));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(dsa);
      fence_regs(sc);
      fence_regs(dp);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[j % kStages]);
      if (next) probs(j + 1);
    }
"""
# the last tile's dq product alone, after a loop over the others
_DQ_PEELED = """    for (int j = 0; j + 1 < n_tiles; ++j) {
      mbar_wait(&full[(j + 1) % kStages], ((j + 1) / kStages) & 1);
      zero(sc);
      zero(dp);
      wgmma_fence();
      gemm_rn<HD, kKT>(acc, dsa, tile(j), kKT);
      issue_sdp(tile(j + 1));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(dsa);
      fence_regs(sc);
      fence_regs(dp);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[j % kStages]);
      probs(j + 1);
    }
    wgmma_fence();
    gemm_rn<HD, kKT>(acc, dsa, tile(n_tiles - 1), kKT);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
"""

# fa_bwd_dq_tf32's stores of dS and dS_lo as shipped: a float2 of two keys
_DQ_STORE = """          const uint32_t off = at(kQRows, rl + 8 * r, 8 * n + 2 * t);
          *reinterpret_cast<float2*>(xs + off) = make_float2(x[0], x[1]);
          *reinterpret_cast<float2*>(xslo + off) =
              make_float2(tf32_lo(x[0]), tf32_lo(x[1]));
"""
# ... one value at a time
_DQ_STORE_SCALAR = """#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const uint32_t off = at(kQRows, rl + 8 * r, 8 * n + 2 * t + c);
            *reinterpret_cast<float*>(xs + off) = x[c];
            *reinterpret_cast<float*>(xslo + off) = tf32_lo(x[c]);
          }
"""
# the swizzled offset as shipped
_AT = """__device__ __forceinline__ uint32_t at(int rows, int r, int c) {
  return (c / 32) * rows * 128 + sm90::swizzled<128>(r, (c & 31) >> 2) +
         (c & 3) * 4;
}
"""
# the barrier before a dq tile's dS is written
_DQ_BAR = """      sm90::bar_sync(kOwn + wg, 128);
      // sc[4n + e] is"""

# dtype -> variant -> (text of the source, its replacement), or a list
VARIANTS = {"bfloat16": {
    "shipped": None,
    "dq_past_end": (_DQ_WALK, _DQ_PAST_END),
    "dq_branch": (_DQ_WALK, _DQ_BRANCH),
    "dq_peeled": (_DQ_WALK, _DQ_PEELED),
    "rows_64": ("static constexpr int kRows = HD <= 64 ? 128 : 64;",
                "static constexpr int kRows = 64;"),
    "keys_64": ("static constexpr int kKT = HD <= 64 ? 128 : 64;",
                "static constexpr int kKT = 64;"),
    "regs_240": ("constexpr int kConsumerRegs = 232, kProducerRegs = 40;",
                 "constexpr int kConsumerRegs = 240, kProducerRegs = 24;"),
    "stages_2": ("constexpr int kStages = 4;", "constexpr int kStages = 2;"),
}, "float32": {
    "shipped": None,
    "keys_32": [("static constexpr int kKeys = HD <= 64 ? 64 : 32;",
                 "static constexpr int kKeys = 32;"),
                ("static constexpr int kKT = HD <= 64 ? 64 : 32;",
                 "static constexpr int kKT = 32;")],
    "regs_232": ("constexpr int kConsumerRegs = 240, kProducerRegs = 24;",
                 "constexpr int kConsumerRegs = 232, kProducerRegs = 40;"),
    "chunk_8": ("constexpr int kChunk = 4;", "constexpr int kChunk = 8;"),
    "dq_scalar": (_DQ_STORE, _DQ_STORE_SCALAR),
    "dq_no_bar": (_DQ_BAR, "      // sc[4n + e] is"),
    "at_divide": (_AT, _AT.replace("(c & 31) >> 2) +\n         (c & 3)",
                                   "(c % 32) / 4) +\n         (c % 4)")),
    "at_shift": (_AT, _AT.replace(
        "(c / 32) * rows * 128 + sm90::swizzled<128>(r, (c & 31) >> 2)",
        "(c >> 5) * rows * 128 + sm90::swizzled<128>(r, (c >> 2) & 7)")),
    "generic": ("  uint8_t* smem = aligned_smem(smem_raw);\n",
                "  uint8_t* smem = reinterpret_cast<uint8_t*>(\n"
                "      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & "
                "~uintptr_t(1023));\n"),
}}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", choices=list(SOURCES), default="bfloat16")
    ap.add_argument("variants", nargs="*")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_bwd_variants.py needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (SEED, _bwd_library, bwd_check, bwd_gate,
                            bwd_inputs, bwd_split, bwd_timing_shapes,
                            device_ms, gpu_name_and_power, kernel_resources,
                            time_ms)
    from repro_torch.kernels import _lib

    known = VARIANTS[args.dtype]
    unknown = set(args.variants) - set(known)
    if unknown:
        print(f"unknown variants {sorted(unknown)}; known for {args.dtype}: "
              f"{list(known)}", file=sys.stderr)
        return 2
    variants = {n: v for n, v in known.items()
                if n == "shipped" or not args.variants or n in args.variants}
    card = gpu_name_and_power()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    out = {"card": card, "dtype": args.dtype,
           "variants": {k: v for k, v in variants.items()}, "shapes": []}
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    scratch = args.dtype == "float32"
    argtypes = ([i32, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32,
                 i32, f32, i32, ptr] + [ptr, ptr] * scratch
                + [ptr, ptr, ptr, ptr])
    source, entry = SOURCES[args.dtype]
    with tempfile.TemporaryDirectory() as tmp:
        libs, logs = build(Path(tmp), source, variants, entry, argtypes)
        resources = {name: kernel_resources(log,
                                            names=("fa_bwd_dkdv", "fa_bwd_dq"))
                     for name, log in logs.items()}
        out["resources"] = resources
        for name, res in resources.items():
            for kentry, used in res.items():
                kernel = next(k for k in ("dkdv", "dq") if k in kentry)
                hd = kentry.split("ILi")[1].split("E")[0]
                print(f"{name} {kernel} hd {hd}: {used}", flush=True)
        for i, st in enumerate(bwd_timing_shapes()):
            # the inputs of chip_smoke.py's row 5c at this shape
            inputs = bwd_inputs(dev, st["B"], st["S"], st["H"], st["KV"],
                                st["hd"], True, args.dtype, SEED + 600 + i,
                                kernel_forward=True)
            q, k, v, o, lse, dout = inputs
            B, S, H, hd = q.shape
            KV = k.shape[2]
            gate = bwd_gate(inputs, True)
            rows = {}
            for name in list(libs) + list(libs)[::-1]:
                fn = libs[name]
                dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
                D = torch.empty((B, H, S), dtype=torch.float32, device=dev)
                lo = ((torch.empty_like(k), torch.empty_like(v))
                      if scratch else ())

                def call(fn=fn, dq=dq, dk=dk, dv=dv, D=D, lo=lo, name=name):
                    rc = fn(dev.index or 0, q.data_ptr(), k.data_ptr(),
                            v.data_ptr(), o.data_ptr(), dout.data_ptr(),
                            lse.data_ptr(), B, S, S, H, KV, hd, hd ** -0.5,
                            1, D.data_ptr(), *(t.data_ptr() for t in lo),
                            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                            _lib.stream(q))
                    if rc != 0:
                        raise RuntimeError(f"variant {name}: cudaError {rc}")
                ms = time_ms(call, reps=10, warmup=2)
                if name in rows:
                    rows[name]["ms"].append(ms)
                    continue
                last = [x.clone() for x in (dq, dk, dv)]
                call()
                torch.cuda.synchronize()
                if not all(torch.equal(a, b)
                           for a, b in zip(last, (dq, dk, dv))):
                    raise AssertionError(f"variant {name} at {st['tag']}: "
                                         "two calls give other bits")
                del last
                err, share = bwd_check((dq, dk, dv), inputs, True,
                                       f"variant {name} at {st['tag']}",
                                       gate)
                dms, events, source_ = device_ms(call, reps=3)
                rows[name] = dict(ms=[ms], device_ms=dms,
                                  device_source=source_,
                                  device_split=bwd_split(events, source_),
                                  max_abs_err=err, share_of_gate=share)
            for name, r in rows.items():
                split = ("split not measured" if r["device_split"] is None
                         else ", ".join(f"{k} {v:.4f}" for k, v
                                        in r["device_split"].items()))
                print(f"{st['tag']} {name}: call {r['ms'][0]:.4f} / "
                      f"{r['ms'][1]:.4f} ms, device {r['device_ms']:.4f} "
                      f"({split}), {r['share_of_gate']:.4f} of the gate",
                      flush=True)
            lib, note = _bwd_library(q, k, v, dout)
            lib_ms = time_ms(lib, reps=10, warmup=2) if lib else None
            print(f"{st['tag']} library: "
                  f"{'null' if lib_ms is None else f'{lib_ms:.4f} ms'} "
                  f"({note})", flush=True)
            out["shapes"].append(dict(tag=st["tag"], variants=rows,
                                      library_ms=lib_ms, library_note=note))
            del inputs, gate, lib
            torch.cuda.empty_cache()
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / f"flash_bwd_variants_{args.dtype}.json"
     ).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
