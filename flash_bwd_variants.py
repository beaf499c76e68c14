#!/usr/bin/env python3
"""Design variants of the bf16 attention backward (`fa_bwd_dkdv_sm90`,
`fa_bwd_dq_sm90`), timed side by side on one NVIDIA GPU at chip_smoke.py's
row-5c shapes (tinyllama-1.1b's training step, prefill_mha,
prefill_gqa128).

    python3 flash_bwd_variants.py [VARIANT ...]   # all with none named

Each variant is a copy of `src/repro_torch/csrc/flash_attention_bwd_sm90.cu`
with one piece of text changed, built by `kernel_variants.build` into a
library of its own under a temporary directory, and called through its C
entry `tdorch_flash_attention_bwd_bf16` on the same inputs (the shipped
source and the variants named, or all):

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

Every output is held to chip_smoke.py's `bwd_check` gate. The time of a
call is CUDA events around it (the median of 10, after 2), the variants in
turns (shipped, ..., last, last, ..., shipped); the device time split by
kernel is torch.profiler's (`device_ms`; "split not measured" where it fell
back to CUDA events). Prints the card's name and power limit, each
variant's registers, shared memory and spills (`-Xptxas -v`) and one line a
shape and variant, and writes the numbers to
chiprun_out/flash_bwd_variants.json. Needs the card and the CUDA toolkit;
imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import json
import sys
import tempfile
from pathlib import Path

from kernel_variants import build

ROOT = Path(__file__).resolve().parent
SOURCE = "flash_attention_bwd_sm90.cu"

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

# variant -> (text of the source, its replacement)
VARIANTS = {
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
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_bwd_variants.py needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (SEED, bwd_check, bwd_gate, bwd_inputs, bwd_split,
                            bwd_timing_shapes, device_ms, gpu_name_and_power,
                            kernel_resources, time_ms)
    from repro_torch.kernels import _lib

    names = sys.argv[1:] or list(VARIANTS)
    unknown = set(names) - set(VARIANTS)
    if unknown:
        print(f"unknown variants {sorted(unknown)}; known: {list(VARIANTS)}",
              file=sys.stderr)
        return 2
    variants = {n: v for n, v in VARIANTS.items()
                if n == "shipped" or n in names}
    card = gpu_name_and_power()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    out = {"card": card, "variants": {k: v and list(v)
                                      for k, v in variants.items()},
           "shapes": []}
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    with tempfile.TemporaryDirectory() as tmp:
        libs, logs = build(Path(tmp), SOURCE, variants,
                           "tdorch_flash_attention_bwd_bf16",
                           [i32, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
                            i32, i32, i32, f32, i32, ptr, ptr, ptr, ptr, ptr])
        resources = {name: kernel_resources(log,
                                            names=("fa_bwd_dkdv", "fa_bwd_dq"))
                     for name, log in logs.items()}
        out["resources"] = resources
        for name, res in resources.items():
            for entry, used in res.items():
                kernel = next(k for k in ("dkdv", "dq") if k in entry)
                hd = entry.split("ILi")[1].split("E")[0]
                print(f"{name} {kernel} hd {hd}: {used}", flush=True)
        for i, st in enumerate(bwd_timing_shapes()):
            # the inputs of chip_smoke.py's row 5c at this shape
            inputs = bwd_inputs(dev, st["B"], st["S"], st["H"], st["KV"],
                                st["hd"], True, "bfloat16", SEED + 600 + i,
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

                def call(fn=fn, dq=dq, dk=dk, dv=dv, D=D):
                    rc = fn(dev.index or 0, q.data_ptr(), k.data_ptr(),
                            v.data_ptr(), o.data_ptr(), dout.data_ptr(),
                            lse.data_ptr(), B, S, S, H, KV, hd, hd ** -0.5,
                            1, D.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                            dv.data_ptr(), _lib.stream(q))
                    if rc != 0:
                        raise RuntimeError(f"variant {name}: cudaError {rc}")
                ms = time_ms(call, reps=10, warmup=2)
                if name in rows:
                    rows[name]["ms"].append(ms)
                    continue
                call()
                torch.cuda.synchronize()
                err, share = bwd_check((dq, dk, dv), inputs, True,
                                       f"variant {name} at {st['tag']}",
                                       gate)
                dms, events, source = device_ms(call, reps=3)
                rows[name] = dict(ms=[ms], device_ms=dms,
                                  device_source=source,
                                  device_split=bwd_split(events, source),
                                  max_abs_err=err, share_of_gate=share)
            for name, r in rows.items():
                split = ("split not measured" if r["device_split"] is None
                         else ", ".join(f"{k} {v:.4f}" for k, v
                                        in r["device_split"].items()))
                print(f"{st['tag']} {name}: call {r['ms'][0]:.4f} / "
                      f"{r['ms'][1]:.4f} ms, device {r['device_ms']:.4f} "
                      f"({split}), {r['share_of_gate']:.4f} of the gate",
                      flush=True)
            out["shapes"].append(dict(tag=st["tag"], variants=rows))
            del inputs, gate
            torch.cuda.empty_cache()
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "flash_bwd_variants.json").write_text(
        json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
