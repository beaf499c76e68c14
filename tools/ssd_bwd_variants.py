#!/usr/bin/env python3
"""Time design variants of B7's backward on one NVIDIA GPU (PERF.md row 7b).

    python3 tools/ssd_bwd_variants.py [VARIANT ...]

Each variant is `src/repro_torch/csrc/mamba_scan_bwd_sm90.cu` with pieces
of text replaced (`VARIANTS`; "shipped" is the source as it is), built with
mamba_scan_bwd.cu (the state pass it calls) into a library of its own, one
nvcc a variant, all started together. At row 7b's two shapes
(`chip_smoke.ssd_bwd_timing_shapes()`: zamba2-1.2b's training step and
phase 5's ssd stage) every variant runs on the same operands and the
forward's own states: its outputs held to phase 2's gate
(`chip_smoke.ssd_bwd_check`) and against the shipped variant's (max |Δ|),
its call ms by CUDA events in turns (each variant, then all in reverse,
twice), and its device ms by kernel (torch.profiler). Prints a line a
shape and writes chiprun_out/ssd_bwd_variants.json. Needs the CUDA toolkit
and a card; imports nothing of JAX.

The variants undo the triangle's balance over the two consumer
warpgroups piece by piece:
  p_unsplit   Pᵀ as warpgroup 0's rows over all 128 columns of t (two
              n64 passes) and warpgroup 1's over its 64 (one), 128 : 64
  no_skip     W·dy over every k8 step of t >= the warpgroup's first s
              (warpgroup 0's warps 16 steps each, warpgroup 1's 8)
  unbalanced  both, and warpgroup 1's warps on their strips in order:
              the arithmetic of the kernel before the balance, bit for bit
  from_m0     W·dy's loop from the strip's first s (a bound known only at
              run time) in place of the skip inside a loop of constant
              bounds; the same arithmetic

and, timed only (their outputs are wrong and not checked), the chunk
kernel with one part taken out (`ABLATIONS`):
  no_b_loads  B·Gᵀ's and B·Cᵀ's A fragments a constant, not B read from
              global memory
  no_c_loads  (dy·H)·C without C's global reads
  no_wdy      no W·dy (`mma.sync`)
  no_dy_lo    dy's lo half not written (each head's 32 KB pass)
"""
from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

CSRC = ROOT / "src" / "repro_torch" / "csrc"
SOURCE = "mamba_scan_bwd_sm90.cu"

P_UNSPLIT = [
    ("constexpr int kQT = 12;", "constexpr int kQT = WG == 0 ? 16 : 8;"),
    ("return WG == 0 ? 8 * j : j < 8 ? 64 + 8 * j : 32 + 8 * j;",
     "return WG == 0 ? 8 * j : 64 + 8 * j;"),
    ("auto q_other = [](int j) { return WG == 1 && j >= 8; };",
     "auto q_other = [](int j) { return false; };"),
    ("""          p_pass(Int<32>{}, Int<8>{}, Int<0>{}, Int<0>{}, m0, 64, sr, ls,
                 dts, colz);""",
     """          p_pass(Int<64>{}, Int<8>{}, Int<0>{}, Int<0>{}, m0, 64, sr, ls,
                 dts, colz);"""),
    ("""          p_pass(Int<32>{}, Int<8>{}, Int<0>{}, Int<1>{}, 16 * wi, 96, so,
                 lso, dso, colz2);
          store_colz(colz2, vec.colz2, so);""", ""),
    ("    if (u < 96)\n", "    if (u < 128)\n"),
    ("(u < 64 ? vec.colz2[u] : 0.f)", "0.f"),
]
NO_SKIP = [("          if (kk < m0) continue;\n", "")]
IN_ORDER = [("const int strip = WG == 0 ? wi : 3 - wi;",
             "const int strip = wi;")]
VARIANTS = {
    "shipped": [],
    "p_unsplit": P_UNSPLIT,
    "no_skip": NO_SKIP,
    "unbalanced": P_UNSPLIT + NO_SKIP + IN_ORDER,
    "from_m0": [("for (int kk = kS0; kk < kC; kk += 8) {\n"
                 "          if (kk < m0) continue;\n",
                 "for (int kk = m0; kk < kC; kk += 8) {\n")],
}
ABLATIONS = {
    "no_b_loads": [(
        "auto b_at = [&](int s, int n, int, int) { return bval(s, n); };",
        "auto b_at = [&](int s, int n, int, int) { return 1.f; };")],
    "no_c_loads": [("dcol[c] += yh[e] * cval(tc + c, n);",
                    "dcol[c] += yh[e];")],
    "no_wdy": [("          if (kk < m0) continue;\n",
                "          continue;\n")],
    "no_dy_lo": [("          dst[e] = tf32_lo(src[e]);\n",
                  "          (void)src;\n")],
}


def build(tmp: Path, names: list) -> dict:
    """{variant: its `tdorch_ssd_scan_bwd_sm90` as a ctypes function};
    prints each kernel's registers and spills."""
    from repro_torch.kernels import _lib

    nvcc = _lib._nvcc()
    text = (CSRC / SOURCE).read_text()
    procs = {}
    for name in names:
        src = text
        for old, new in {**VARIANTS, **ABLATIONS}[name]:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} not once in {SOURCE}")
            src = src.replace(old, new)
        d = tmp / name
        d.mkdir()
        (d / SOURCE).write_text(src)
        for f in ("mamba_scan_bwd.cu", "errors.cu", "sm90.cuh"):
            shutil.copy(CSRC / f, d / f)
        procs[name] = subprocess.Popen(
            [nvcc, *_lib.FLAGS, "-shared", str(d / SOURCE),
             str(d / "mamba_scan_bwd.cu"), str(d / "errors.cu"), "-o",
             str(d / "lib.so")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    i32, ptr = ctypes.c_int, ctypes.c_void_p
    fns = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{out}")
        lines = out.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and "_sm90" in line:
                kernel = "chunk" if "chunk" in line else "dstates"
                usage = " ".join(x.strip() for x in lines[i + 1:i + 4]
                                 if "spill" in x or "registers" in x)
                print(f"{name} {kernel}: {usage}", flush=True)
        fn = ctypes.CDLL(str(tmp / name / "lib.so")).tdorch_ssd_scan_bwd_sm90
        fn.argtypes = [i32, *[ptr] * 9, *[i32] * 7, *[ptr] * 7]
        fn.restype = i32
        fns[name] = fn
    return fns


def main() -> None:
    import torch

    import chip_smoke as c
    from repro_torch.kernels import _lib
    from repro_torch.kernels.mamba_scan import ops

    names = sys.argv[1:] or [*VARIANTS, *ABLATIONS]
    if "shipped" not in names:
        names.insert(0, "shipped")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    dev = torch.device("cuda", 0)
    card = c.gpu_name_and_power()
    print(card, flush=True)
    tmp = Path(tempfile.mkdtemp(prefix="ssd_bwd_variants_"))
    try:
        fns = build(tmp, names)
        _lib.load()
        result = dict(card=card, shapes=[])
        for i, st in enumerate(c.ssd_bwd_timing_shapes()):
            case = (st["tag"], st["B"], st["S"], st["nh"], st["hd"],
                    st["ds"], st["chunk"], False, False)
            inputs = c.ssd_bwd_inputs(dev, case, c.SEED + 800 + i)
            x, dt, A, Bc, Cc, dy, _ = inputs
            chunk = st["chunk"]
            _, _, states, l = ops._forward(x, dt, A, Bc, Cc, chunk, True,
                                           True)
            B, S, nh, hd, ds, cc = ops.ssd_shapes(x, dt, A, Bc, Cc, chunk)
            kc = ops.kernel_chunk(cc)
            nc = -(-S // kc)
            groups = -(-nh // ops.SM90_HEADS_PER_BLOCK)

            def run(fn):
                dx, ddt = torch.empty_like(x), torch.empty_like(dt)
                dB = torch.empty((groups, B, S, ds), device=dev)
                dC = torch.empty_like(dB)
                dA = torch.empty((B, nc, nh), device=dev)
                grads = torch.empty_like(states)
                rc = fn(dev.index or 0, x.data_ptr(), dt.data_ptr(),
                        A.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
                        dy.data_ptr(), None, states.data_ptr(), l.data_ptr(),
                        B, S, nh, hd, ds, kc, groups, grads.data_ptr(),
                        dx.data_ptr(), ddt.data_ptr(), dB.data_ptr(),
                        dC.data_ptr(), dA.data_ptr(), _lib.stream(x))
                _lib.check(rc, "mamba_scan_bwd")
                return dx, ddt, dA.sum((0, 1)), dB.sum(0), dC.sum(0)
            gate = c.ssd_bwd_gate(inputs, chunk)
            outs = {n: run(fns[n]) for n in names}
            row = dict(stage=st["tag"], variants={})
            for n in names:
                share = None
                if n not in ABLATIONS:
                    _, share, _ = c.ssd_bwd_check(outs[n], inputs, chunk,
                                                  f"{n} {st['tag']}", gate)
                row["variants"][n] = dict(
                    share_of_gate=share,
                    max_diff_from_shipped=max(
                        float((a - b).abs().max())
                        for a, b in zip(outs[n], outs["shipped"])),
                    turns_ms=[])
            del outs, gate
            for _ in range(2):
                for n in [*names, *reversed(names)]:
                    row["variants"][n]["turns_ms"].append(
                        c.time_ms(lambda n=n: run(fns[n]), reps=20,
                                  warmup=2))
            for n in names:
                v = row["variants"][n]
                v["ms"] = sum(v["turns_ms"]) / len(v["turns_ms"])
                v["device_ms"], events, source = c.device_ms(
                    lambda n=n: run(fns[n]), reps=5)
                v["device_split"] = c.bwd_split(
                    events, source, {**c.SSD_BWD_PARTS,
                                     "sums": "reduce_kernel"})
            print(json.dumps(row), flush=True)
            result["shapes"].append(row)
            del inputs, states, l, x, dt, A, Bc, Cc, dy
            torch.cuda.empty_cache()
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "ssd_bwd_variants.json").write_text(json.dumps(result,
                                                              indent=1))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
