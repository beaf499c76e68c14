#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit) on any failed check:

1. Environment: the card's name and power limit, the torch and CUDA
   versions, the time to build the CUDA kernels from `src/repro_torch/
   csrc/` with nvcc (sm_90a), and the registers, shared memory and spills
   of the attention, scan, grouped GEMM, segment-combine and fused-read
   kernels (the 3xTF32 float32 ones, the SIMT float32 ones and the bf16
   tensor-core ones).
2. Kernel parity: every kernel against its plain PyTorch version on the
   card — the histogram on each of its routes (`histogram.ops.route`: the
   shared-memory route below 48 KB and in the opt-in band, the global
   route; uniform and Zipf ids, weighted and not, out-of-range ids, ids
   not 16-byte aligned), the segment combine (every
   merge, float32 and float64, empty segments, negative and tied
   priorities, Zipf-2.0 hot segments, NaN / ±inf / ±3e38 under min, max
   and or), the fused stage (every read_op x merge, arity-0 rows, a
   single-row batch, NaN and ±3e38 min/max reads below and at the max
   arity; the gather-reduce on each layout of `stage_fused.ops.layout`,
   w = 1 ... 1536 in float32 and float64, with a task of arity 1,000 and
   rows not 16-byte aligned), the grouped GEMM (the MOE geometries of
   tests/test_kernels.py, empty groups, rows beyond the groups' sum, the
   parameter-server path's two projections), and attention, decode
   attention and the SSD scan (see phase 5; bf16 attention and decode take
   the tensor-core kernels `flash_attention_sm90` and `flash_decode_sm90`,
   float32 attention the 3xTF32 kernel `flash_attention_tf32`, float32
   decode the SIMT one).
3. The main path at a real cluster and backlog size — the full YCSB
   setting of the repo's benchmark: P=16 machines, 50,000 tasks per machine
   (800,000 tasks a stage), 800,000 keys of width 16 (51 MB of float32 store
   on the card). Four stages go through `Orchestrator(..., backend="torch")`
   and, on a copy of the store, through the float64 numpy oracle:
     (a) arity-1 Zipf 2.0, update v*c0 + c1, write_back="add";
     (b) arity-1 uniform keys, write_back="write" with random int32
         priorities (its Phase-1 root call passes the host cutoff and
         launches the weighted histogram);
     (c) ragged multi-get, arity 1-8, Zipf 1.5, fused_read("add", finish=
         scale by context), write_back="min" (the fused stage kernel);
     (d) (a) with replication on, two stages in one session, so the second
         stage's replica-local pairs run the unweighted histogram.
   Each stage must give the oracle's `phase_signature()`, `refcount` and
   `exec_site` exactly, and values within the tolerance stated at
   `_check_values`. Each stage must launch each kernel exactly as often as
   `EXPECTED_LAUNCHES` says, and send no lambda to the host path.
4. The parameter-server path at granite-moe-3b-a800m's full width: one MoE
   layer (40 experts of 1536 x 1024 + 512 x 1536 words, top-8; 377 MB of
   float32 on the card) and the 49,155 x 1536 embedding table, on P=8
   machines with bench_paramserve's Zipf-1.2 traffic and replication.
   Four decode steps of 128 tokens through `MoERouter.decode_step` on the
   card, each also through `naive_dispatch(gemm="torch")` (the grouped GEMM
   kernel), both against a float64 host reference made expert by expert;
   embedding lookup, bag pooling (the fused stage kernel), a gradient push
   (the segment-combine kernel), replicated lookups and
   `embed_skew_aware` on the exported hot-row cache, against their numpy
   oracles. Each stage must launch each kernel exactly as often as
   `PS_EXPECTED` says, and no lambda may go to the host path. Then K1-K3
   against their plain versions at this path's inputs, a TF32 control run
   of one decode step (how far a lower precision lands from the
   tolerance), and the costs: decode steps of 16 tokens and every embedding stage on the card
   and on the numpy backend give the same `phase_signature()`, `refcount`,
   `exec_site` and work ratios, and bench_paramserve's gate (orchestrated
   work ratio <= 1.5, naive >= 2x) holds on its own MoE mix on both.
5. The attention and SSM path: the three kernels no model of the JAX
   package calls, through their own entry points (`repro_torch.kernels.
   attention`, `decode_attention`, `mamba_ssd`), at the widths of the
   configs that use them (read from `repro_torch.configs`), each stage in
   float32 and in bf16:
     ssd            zamba2-1.2b's Mamba2 scan, x (2, 32768, 64, 64), chunk
                    128 (batch 32 cut to 2);
     prefill_mha    zamba2-1.2b's shared attention, causal (1, 32768, 32,
                    64) (batch 32 cut to 1);
     prefill_gqa128 command-r-35b's attention, q (1, 8192, 64, 128), k/v 8
                    heads (batch 32 cut to 1, seq 32768 to 8192);
     decode_long    zamba2-1.2b's long_500k decode: caches (1, 524288, 32,
                    64), length 500,000 as a device tensor;
     decode_gqa     tinyllama-1.1b's decode_32k: q (128, 32, 64), caches
                    (128, 32768, 4, 64), length 30,000.
   Each output is held against the plain version (float64 for float32
   runs, float32 on the same inputs for bf16) within the tolerances stated
   at ATTN_REL and SSD_REL; each stage must launch its kernel once
   (`ATTN_EXPECTED`: the bf16 attention and decode stages the `*_sm90`
   kernels, float32 attention `flash_attention_tf32`, float32 decode the
   SIMT kernel). Phase 2 holds the five
   kernels against their plain versions at the FLASH / DECODE / MAMBA
   geometries of tests/test_kernels.py and at edge cases
   (`attention_ssm_parity`).
6. Kernel times at the paths' shapes (CUDA events, median of several
   runs) beside the plain version, the one PyTorch call that computes the
   same function (`torch.bincount`, `index_add_`, `embedding_bag`,
   `torch._grouped_mm` where it takes float32,
   `F.scaled_dot_product_attention`; none for the SSD scan), and the least
   time the card could take (bytes over 3.35 TB/s, or operations over 67
   TFLOP/s in float32 FMAs, 495/3 TFLOP/s for the float32 kernels that
   run 3xTF32 on the tensor cores (with the FMA bound beside it), or 989
   TFLOP/s in bf16, whichever is larger). The segment combine is timed
   at the writer combines of stages (a) add (`index_add_`), (c) min
   (`index_reduce_(..., "amin")`) and (b) write (no one call). The
   histogram (at stage (b)'s root call, the parameter-server lookup's, a
   decode step's and `embed_skew_aware`'s raw ids) and the fused gather-reduce (at stage (c) and the
   parameter-server bags) also get the call's host time and the device
   time alone (torch.profiler's kernels and fills over 20 calls; CUDA
   events around calls queued behind a spin kernel where three profiler
   sessions miss them).
7. Device busy share: stages (a)-(c) once more under torch.profiler, after a
   warm-up run; the device's busy time (kernels, copies, fills) against the
   stage's wall time.
8. The other engines and multi-round plans, at phase 3's full setting:
   stages (a)-(c) through `Orchestrator(engine=e)` for e in "pull", "push",
   "sort" and "auto" on the card and, on a copy of the store, on the numpy
   oracle: `phase_signature()`, `exec_site`, `refcount`, values within
   `_check_values`' tolerance, `auto`'s decisions equal to the oracle's,
   no lambda on the host path, launches as `ENGINE_EXPECTED` (plus
   `AUTO_ESTIMATE` under auto). Then benchmarks/bench_plan.py's two cells
   at their full sizes, engine "pull" — pagerank_stages (Barabási-Albert
   n = 50,000, 10 rounds of two stages) and bfs_stages (n = 100,000, from
   vertex 0) — each through `run_plan` and the same `run_stage` loop on
   the card and `run_plan` on numpy: equal session reports
   (`assert_session_parity`), values within the reckoned tolerance (BFS
   exact), at most one host sync a round under the plan, the walls of both.
9. TDO-GP: Erdős-Rényi (2^19 vertices, average degree 16) and star (2^19)
   graphs and bench_graph's Barabási-Albert graph (30,000, attach 8),
   ingested at P=16 on the card and on the numpy oracle (every layout
   array and the ingest bill equal), then BFS, SSSP, CC, PageRank (10
   rounds, tol 0) and BC from vertex 0 both ways: rounds and every
   round's `phase_signature()` equal, BFS / SSSP / CC values exact, BC
   within BC_REL; PageRank's device-route combines are measured against
   exact sums (`_measured_combines`) and the float32 ranks' error is
   reported; PageRank once more in float64 on the ER graph is the gate,
   within PAGERANK_F64_ABS. The ER ingest's Phase-1 root call is timed as
   one more histogram shape of phase 6 (row 1e).

10. The KV store and the serve tier (`repro_torch.kvstore`,
   `repro_torch.serve`) at the main path's table:
   `DistributedHashTable(800,000, 16, value_width=16)` (bench_ycsb's full
   setting, 51 MB of float32 on the card), YCSB Zipf 1.5 with a
   stationary hot set. One-shot: `execute_batch` of YCSB A and B (800,000
   operations), `multi_get` of 100,000 tasks of arity 1-8 and `run_chain`
   over 100,000 chains of 4 hops, each against the numpy backend
   (`phase_signature()`, `refcount`, `exec_site` exactly, values within
   `_check_values`' gates; `execute_batch` also against
   `DistributedHashTable.oracle`). Streaming, sync mode: 65,536 GET / RMW
   requests (10% RMW) and 4,096 multi-gets through `table.serve()` at
   max_batch 256 and 8,192 (size trigger only), every result bit-identical
   to `execute_batch` / `multi_get` on the card over the same coalesced
   batches and within a float32-drift gate of the numpy backend's replay.
   Thread mode: bench_serve's 20,000 requests offered at 80% of the sync
   rate at 256, with `TorchBackend.prefetch` and with it a no-op: every
   future resolves without an error, the numpy replay of the batches the
   executor ran matches each result and the final table; requests/s, p50,
   p99, `overlap_frac`. The card's busy share of a sync run
   (torch.profiler). Then `MoEFrontend` (128 tokens, bit-identical to
   `decode_step`) and `EmbeddingFrontend` (8,192 lookups and bags
   bit-identical to `lookup` / `lookup_bags`, 8,192 gradient pushes within
   K2's sum bound) at phase 4's granite widths. Launches by
   `SERVE_EXPECTED` and, for a streamed run, by its batches' kinds
   (`SERVE_BATCH`); no lambda may go to the host route.

The last line is ``{"ok": true, "device": {...}}``; the line before it
holds the per-kernel numbers as JSON, and the one before that the card's
name and power limit.

A diagnostic of the open fault C2 (ROADMAP), not in the default run:
``--c2-repeats N`` runs phase 5's bf16 prefill_mha stage N times after
phase 4 and reads every share of its gate, then runs phases 5-10 as
always.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet) used for the bound of each kernel
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# float32 work on the tensor cores in 3xTF32: three TF32 products (495
# TFLOP/s dense) for each float32 one (moe_gemm, flash_attention_tf32)
FP32_TC_OPS_PER_S = 495e12 / 3
BF16_OPS_PER_S = 989e12  # dense, tensor cores

P = 16
TASKS_PER_MACHINE = 50_000
VALUE_WIDTH = 16
SEED = 20251111
# host-clock margin before and after a profiled block: torch.profiler keeps
# only the device events whose timestamps fall inside its session, and the
# card's timestamps can sit milliseconds off the host's, more than 20 short
# calls last
PROFILE_PAD_S = 0.25


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_resources(nvcc_log: Path, names=("fa_tf32", "fa_sm90",
                                             "fd_split", "fd_sm90",
                                             "ssd_states", "ssd_state_pass",
                                             "ssd_outputs", "gg_tf32",
                                             "seg_combine",
                                             "fused_reduce", "hist_shared",
                                             "hist_global")) -> dict:
    """Registers, shared memory and spills per instantiation of the named
    kernels, as `nvcc -Xptxas=-v` reported them in the build's log."""
    out, entry, spills = {}, None, ""
    for line in nvcc_log.read_text().splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
            entry = entry if any(n in entry for n in names) else None
            spills = ""
        elif entry is not None and "spill stores" in line:
            spills = line.strip()
        elif entry is not None and "Used" in line:
            out[entry] = line.split(":", 1)[1].strip() + (
                f"; {spills}" if spills else "")
            entry = None
    return out


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------
def time_ms(fn, reps: int = 10, warmup: int = 3) -> float:
    """Median device time of `fn()` over `reps` runs, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(bytes_moved: float, ops: float, ops_per_s: float = FP32_OPS_PER_S):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 2: kernel parity on the card
# ---------------------------------------------------------------------------
def _within(got, want, allowed, name: str) -> tuple:
    """(max |Δ|, max |Δ| / allowed) of `got` against `want`, elementwise
    tolerance `allowed`; raises past the tolerance or on a malformed
    output (another shape, or a value that is not finite)."""
    import torch

    got, want = got.double(), want.double()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: malformed output "
                             f"{tuple(got.shape)}")
    err = (got - want).abs()
    if not err.numel():
        return 0.0, 0.0
    ratio = err / allowed.clamp(min=1e-300)
    share = float(ratio.max().item())
    if not bool((err <= allowed).all()):
        i = tuple(int(x) for x in torch.nonzero(ratio == share)[0])
        raise AssertionError(
            f"{name}: beyond tolerance, max |Δ| {err.max().item()} ({share:.3g}"
            f" of it; at {i}: got {got[i].item()}, want {want[i].item()}, "
            f"allowed {allowed[i].item()}; {int((err > allowed).sum())} "
            "elements beyond)")
    return float(err.max().item()), share


def _sum_bound_ok(got, want, mags, rel=1e-6, abs_=1e-6, rel_want=0.0,
                  name="sum") -> float:
    """Float sums whose terms add in another order (atomics, another
    blocking, float32 against a float64 reference): |Δ| <= rel_want*|want|
    + rel*Σ|terms| + abs_ per element (Σ|terms| per element: `mags`).
    Tensors or numpy arrays; `got` must be finite, of `want`'s shape."""
    import torch

    got, want, mags = (torch.as_tensor(a).double() for a in (got, want, mags))
    allowed = rel_want * want.abs() + rel * mags + abs_
    return _within(got, want, allowed, name)[0]


def _same_with_nan(got, want, name: str) -> None:
    """Bit-for-bit equal values, NaN where the plain version has NaN."""
    import torch

    got = got.cpu()
    want = want.cpu()
    nan = torch.isnan(want)
    if not (torch.equal(torch.isnan(got), nan)
            and torch.equal(got[~nan], want[~nan])):
        raise AssertionError(f"{name}: differs from the plain version")


def _gemm_case(geom, rng):
    """Rows split into G groups at random cuts, as tests/test_kernels.py
    makes its MOE cases."""
    G, M, K, N = geom
    cuts = np.sort(rng.integers(0, M + 1, size=G - 1))
    sizes = np.diff(np.r_[0, cuts, M]).astype(np.int32)
    return (rng.standard_normal((M, K)).astype(np.float32),
            (rng.standard_normal((G, K, N)) * 0.1).astype(np.float32), sizes)


def gemm_parity(dev, x, w, sizes, name: str) -> float:
    """grouped_gemm on the card against its plain version: |Δ| <=
    1e-5 * Σ_k |x_k w_k| + 1e-6 per element (float32 on both sides, sums
    in another order)."""
    import torch

    from repro_torch.kernels.moe_gemm.ops import grouped_gemm
    from repro_torch.kernels.moe_gemm.ref import grouped_gemm_ref

    x, w, sizes = (torch.as_tensor(a).to(dev) for a in (x, w, sizes))
    got = grouped_gemm(x, w, sizes)
    want = grouped_gemm_ref(x, w, sizes)
    mags = grouped_gemm_ref(x.abs(), w.abs(), sizes)
    return _sum_bound_ok(got, want, mags, rel=1e-5, name=f"moe_gemm {name}")


def _zipf_ids(rng, n: int, bins: int, gamma: float = 1.2) -> np.ndarray:
    p = 1.0 / np.arange(1, bins + 1) ** gamma
    return rng.permutation(bins)[rng.choice(bins, size=n, p=p / p.sum())]


# (bins, ids): each route of the histogram kernel on an H100 (227 KB of
# opt-in shared memory a block, 132 SMs): the shared route below 48 KB of
# bins (300, 12,288, 40) and in the opt-in band (50,000), the global route
# past the merge's break-even (49,155 and 800,000 bins: the paths' lookup
# and stage (b)) and past the opt-in limit (60,000)
HIST_PARITY = [(300, 40_000), (12_288, 8_000_000), (50_000, 8_000_000),
               (49_155, 8_192), (800_000, 800_000), (60_000, 2_000_000),
               (40, 1_024), (1, 1)]


def histogram_route_parity(dev) -> str:
    """K1 on each route (`histogram.ops.route`) against its plain version,
    exactly: uniform and Zipf-1.2 ids, weighted (int32 in [-2, 9)) and
    not, 1% of the ids below 0 and 1% past the bins; and ids in a view one
    id into its buffer (not 16-byte aligned). Raises if a route was not
    taken."""
    import torch

    from repro_torch.kernels.histogram.ops import (count_ids, device_limits,
                                                   route)
    from repro_torch.kernels.histogram.ref import histogram_ref

    rng = np.random.default_rng(SEED)
    limits = device_limits(dev.index or 0)
    taken, cases = set(), 0
    for bins, n in HIST_PARITY:
        kind = route(n, bins, limits)[0]
        taken.add(kind if kind == "global" or 4 * bins <= 48 * 1024
                  else "shared opt-in")
        for zipf in (False, True):
            ids = _zipf_ids(rng, n, bins) if zipf else rng.integers(0, bins, n)
            ids[rng.random(n) < 0.01] = -3
            ids[rng.random(n) < 0.01] = bins + 5
            flat = torch.from_numpy(np.r_[0, ids].astype(np.int32)).to(dev)
            wts = torch.from_numpy(rng.integers(-2, 9, n + 1).astype(
                np.int32)).to(dev)
            views = [(flat[1:].clone(), w) for w in (None, wts[1:].clone())]
            if zipf and kind == "global":
                views += [(flat[1:], None), (flat[1:], wts[1:])]
            for k, w in views:
                cases += 1
                if not torch.equal(count_ids(k, bins, weights=w),
                                   histogram_ref(k, bins, w)):
                    raise AssertionError(
                        f"histogram {kind} bins={bins} n={n} zipf={zipf} "
                        f"weighted={w is not None} aligned="
                        f"{k.data_ptr() % 16 == 0} differs")
    if taken != {"shared", "shared opt-in", "global"}:
        raise AssertionError(f"histogram parity took only {taken}")
    return (f"exact on {cases} cases over the routes {sorted(taken)} "
            f"(limits {tuple(limits)})")


def fused_layout_parity(dev) -> float:
    """K3's gather-reduce on each layout (`stage_fused.ops.layout`): w in
    1 ... 1536, float32 and float64, every read op, 300 tasks of arity 0-8
    and one of 1,000 over 97 rows, rows 16-byte aligned and a view one
    value in; min/max/first with NaN, ±inf and ±3e38 values, exact (NaN as
    NaN), add within the sum bound (a·u·Σ|terms| for a task of arity a past
    1e-6/u); the max-arity fill read off indptr and stated (8). Returns the
    worst sum error."""
    import torch

    from repro_torch.kernels.stage_fused.ops import fused_reduce, layout
    from repro_torch.kernels.stage_fused.ref import reduce_pairs_ref

    rng = np.random.default_rng(SEED)
    K, n = 97, 301
    arity = rng.integers(0, 9, n)
    arity[150] = 1000
    indptr = torch.from_numpy(np.r_[0, np.cumsum(arity)].astype(
        np.int32)).to(dev)
    idx = torch.from_numpy(rng.integers(0, K, int(arity.sum())).astype(
        np.int32)).to(dev)
    edge = np.array([np.nan, np.inf, -np.inf, 3e38, -3e38])
    # the sum gate a task: 1e-6, or a·u for a task of arity a, whose pairs
    # add in the values' type in pair order (each add rounds by at most
    # u·Σ|terms|; u = 2^-24 in float32): the arity-1,000 task needs it
    a = torch.from_numpy(arity).to(dev, torch.float64)[:, None]
    rel = {dt: (a * u).clamp(min=1e-6) for dt, u in (
        (torch.float32, 2.0 ** -24), (torch.float64, 2.0 ** -53))}
    worst, layouts = 0.0, set()
    for w in (1, 3, 4, 5, 16, 17, 33, 1536):
        for dt in (torch.float32, torch.float64):
            for read_op in ("add", "min", "max", "first"):
                vals = rng.normal(size=(K * w + 1))
                if read_op != "add":
                    pick = rng.random(vals.size) < 0.05
                    vals[pick] = edge[rng.integers(0, 5, int(pick.sum()))]
                flat = torch.from_numpy(vals).to(dev, dt)
                for values in (flat[:-1].view(K, w), flat[1:].view(K, w)):
                    layouts.add(layout(w, values.element_size(),
                                       values.data_ptr() % 16 == 0))
                    for max_ar in (None, 8):
                        got = fused_reduce(values, indptr, idx,
                                           read_op=read_op, max_arity=max_ar)
                        want = reduce_pairs_ref(values, indptr, idx,
                                                read_op=read_op,
                                                max_arity=max_ar)
                        if read_op == "add":
                            worst = max(worst, _sum_bound_ok(
                                got, want, reduce_pairs_ref(
                                    values.abs(), indptr, idx,
                                    read_op="add"), rel=rel[dt],
                                name=f"fused_reduce add w={w} {dt}"))
                        else:
                            _same_with_nan(got, want, f"fused_reduce "
                                           f"{read_op} w={w} {dt}")
    log(f"  stage_fused: {len(layouts)} layouts (vec, lanes a task, "
        f"vectors a lane) {sorted(tuple(x) for x in layouts)} over w = 1 "
        "... 1536, float32 and float64, every read op, with NaN/±inf/±3e38, "
        "arity 0 and 1,000, rows not 16-byte aligned; exact but sums")
    return worst


def parity_phase(dev) -> dict:
    import torch

    from repro_torch.kernels.segment_combine.ops import combine
    from repro_torch.kernels.segment_combine.ref import combine_ref
    from repro_torch.kernels.stage_fused.ops import (FUSED_READ_OPS,
                                                     fused_reduce,
                                                     fused_stage)
    from repro_torch.kernels.stage_fused.ref import (fused_stage_ref,
                                                     reduce_pairs_ref)

    g = torch.Generator().manual_seed(SEED)
    worst = {"histogram": 0.0, "segment_combine": 0.0, "stage_fused": 0.0}

    # histogram: exact on each route, with ids outside [0, bins) on both
    # sides
    log(f"  histogram: {histogram_route_parity(dev)}")

    # segment combine: min/max/or/write exact, add within the sum bound
    for dt in (torch.float32, torch.float64):
        for n, w, S in [(200_000, 16, 1300), (2000, 3, 200), (1, 1, 1),
                        (511, 8, 13)]:
            vals = torch.randn(n, w, generator=g, dtype=dt).to(dev)
            # S+3 ids: some rows drop; S=1300 over few rows leaves empties
            seg = torch.randint(-1, S + 3, (n,), generator=g,
                                dtype=torch.int32).to(dev)
            for order in (torch.randint(-2**31, 2**31 - 1, (n,), generator=g,
                                        dtype=torch.int64).to(torch.int32),
                          torch.randint(-3, 3, (n,), generator=g,
                                        dtype=torch.int32)):  # ties
                order = order.to(dev)
                for op in ("add", "min", "max", "or", "write"):
                    got = combine(vals, seg, S, op=op, order=order)
                    want = combine_ref(vals, seg, S, op=op, order=order)
                    if op == "add":
                        mags = combine_ref(vals.abs(), seg, S, op="add")
                        e = _sum_bound_ok(got, want, mags)
                        worst["segment_combine"] = max(
                            worst["segment_combine"], e)
                    elif not torch.equal(got, want):
                        raise AssertionError(
                            f"combine {op} {dt} n={n} S={S} differs")
    # Zipf-2.0 hot segments in task order (the warp pre-combine and the
    # per-warp tables), ids outside the range, tied orders
    rng = np.random.default_rng(SEED)
    for dt in (torch.float32, torch.float64):
        for n, w, S in [(300_000, 16, 20_000), (5000, 3, 700),
                        (2000, 1536, 300)]:
            p = 1.0 / np.arange(1, S + 1) ** 2.0
            seg = torch.from_numpy(rng.choice(S, size=n, p=p / p.sum())
                                   .astype(np.int32))
            seg[::97] = S + 1
            vals = torch.randn(n, w, generator=g, dtype=dt).to(dev)
            seg = seg.to(dev)
            order = torch.randint(-3, 3, (n,), generator=g,
                                  dtype=torch.int32).to(dev)
            for op in ("add", "min", "max", "or", "write"):
                got = combine(vals, seg, S, op=op, order=order)
                want = combine_ref(vals, seg, S, op=op, order=order)
                if op == "add":
                    mags = combine_ref(vals.abs(), seg, S, op="add")
                    worst["segment_combine"] = max(
                        worst["segment_combine"],
                        _sum_bound_ok(got, want, mags))
                elif not torch.equal(got, want):
                    raise AssertionError(
                        f"combine {op} {dt} hot n={n} w={w} differs")
    # NaN, ±inf and ±3e38 under min/max/or: NaN propagates, the identity
    # folds into hit segments, as the numpy oracle does
    edge = torch.tensor([np.nan, np.inf, -np.inf, 3e38, -3e38, 1.0, -2.0,
                         0.0], dtype=torch.float64)
    for dt in (torch.float32, torch.float64):
        pick = torch.randint(0, edge.numel(), (4096, 16), generator=g)
        vals = edge.to(dt)[pick]
        vals[torch.rand(4096, 16, generator=g) < 0.7] = 1.5
        seg = torch.randint(-2, 39, (4096,), generator=g,
                            dtype=torch.int32)
        vals, seg = vals.to(dev), seg.to(dev)
        for op in ("min", "max", "or"):
            _same_with_nan(combine(vals, seg, 37, op=op),
                           combine_ref(vals, seg, 37, op=op),
                           f"combine {op} {dt} at NaN/inf")
    log("  segment_combine: 80 random cases, 30 on Zipf-2.0 hot segments "
        "(w = 16, 3, 1536) and 6 at NaN/±inf/±3e38; min/max/or/write exact "
        "(NaN as NaN), add within 1e-6*sum|terms| + 1e-6")

    # fused stage: every read_op x merge; min/max/first reads then a
    # non-add merge are exact, anything with a sum within the sum bound
    def finish(ctx, red):
        return red * ctx[:, :1]

    for n, K, w, S, max_ar in [(5000, 300, 16, 40, 8), (1, 10, 16, 1, 5),
                               (777, 50, 3, 9, 12)]:
        ar = torch.randint(0, max_ar + 1, (n,), generator=g)
        ar[::7] = 0  # arity-0 rows
        indptr = torch.zeros(n + 1, dtype=torch.int32)
        indptr[1:] = torch.cumsum(ar, 0)
        idx = torch.randint(0, K, (int(indptr[-1]),), generator=g,
                            dtype=torch.int32)
        vals = torch.randn(K, w, generator=g).to(dev)
        ctx = torch.randn(n, 2, generator=g).to(dev)
        seg = torch.randint(0, S + 1, (n,), generator=g,
                            dtype=torch.int32).to(dev)
        order = torch.randint(-50, 50, (n,), generator=g,
                              dtype=torch.int32).to(dev)
        indptr, idx = indptr.to(dev), idx.to(dev)
        for read_op in FUSED_READ_OPS:
            for merge in ("add", "min", "max", "or", "write"):
                kw = dict(num_segments=S, read_op=read_op, finish=finish,
                          merge_name=merge)
                ug, cg = fused_stage(vals, indptr, idx, ctx, seg, order, **kw)
                uw, cw = fused_stage_ref(vals, indptr, idx, ctx, seg, order,
                                         **kw)
                if read_op == "add" or merge == "add":
                    um, _ = fused_stage_ref(vals.abs(), indptr, idx,
                                            ctx.abs(), seg, order,
                                            **{**kw, "read_op": "add",
                                               "merge_name": "add"})
                    cm = combine_ref(um, seg, S, op="add") if merge == "add" \
                        else combine_ref(um, seg, S, op="max").clamp(min=0)
                    e = max(_sum_bound_ok(ug, uw, um),
                            _sum_bound_ok(cg, cw, cm))
                    worst["stage_fused"] = max(worst["stage_fused"], e)
                elif not (torch.equal(ug, uw) and torch.equal(cg, cw)):
                    raise AssertionError(
                        f"fused_stage {read_op}x{merge} n={n} differs")
    # min/max reads at NaN and ±3e38, below and at the max arity
    values = torch.tensor([[3e38, 1.0], [np.nan, -3e38], [1.0, np.inf],
                           [-3e38, -np.inf], [2.0, 0.5]], dtype=torch.float64)
    tasks = [[0], [0, 1], [2, 3, 4], [4], [2, 0], [], [3, 3, 3], [0, 2]]
    indptr = torch.tensor(np.r_[0, np.cumsum([len(t) for t in tasks])],
                          dtype=torch.int32)
    idx = torch.tensor([k for t in tasks for k in t], dtype=torch.int32)
    for dt in (torch.float32, torch.float64):
        for read_op in ("min", "max"):
            for max_ar in (None, 3, 5):
                _same_with_nan(
                    fused_reduce(values.to(dt).to(dev), indptr.to(dev),
                                 idx.to(dev), read_op=read_op,
                                 max_arity=max_ar),
                    reduce_pairs_ref(values.to(dt), indptr, idx,
                                     read_op=read_op, max_arity=max_ar),
                    f"fused_reduce {read_op} {dt} at NaN/3e38")
    log("  stage_fused: 60 cases (every read_op x merge, arity-0 rows, a "
        "single-row batch) and 12 min/max reads at NaN/±inf/±3e38 below "
        "and at the max arity; sums within 1e-6*sum|terms| + 1e-6, the "
        "rest exact (NaN as NaN)")
    worst["stage_fused"] = max(worst["stage_fused"],
                               fused_layout_parity(dev))

    # grouped GEMM: tests/test_kernels.py's MOE geometries, its empty-group
    # case, rows beyond the groups' sum, and the path's two shapes
    rng = np.random.default_rng(SEED)
    E, d, f = GRANITE["E"], GRANITE["d"], GRANITE["f"]
    cases = [(f"MOE {geom}", *_gemm_case(geom, rng)) for geom in (
        (4, 96, 32, 64), (1, 1, 64, 128), (6, 150, 128, 256),
        (3, 17, 32, 64), (E, 1024, d, 2 * f), (E, 1024, f, d))]
    cases.append(("empty groups", np.ones((8, 32), np.float32),
                  np.ones((4, 32, 16), np.float32),
                  np.array([0, 8, 0, 0], np.int32)))
    x, w, _ = _gemm_case((5, 57, 24, 40), rng)
    cases.append(("rows beyond the sum", x, w,
                  np.array([11, 0, 20, 9, 0], np.int32)))
    worst["moe_gemm"] = max(gemm_parity(dev, *c[1:], name=c[0])
                            for c in cases)
    log(f"  moe_gemm: {len(cases)} cases (the MOE geometries, empty groups, "
        "rows beyond the sum, the path's in- and out-projection); within "
        "1e-5*sum|x w| + 1e-6")
    worst.update(attention_ssm_parity(dev))
    return worst


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------
def muladd(contexts, vals):
    out = vals * contexts[:, 0:1] + contexts[:, 1:2]
    return {"update": out, "result": out}


def scale_by_context(contexts, reduced):
    return reduced * contexts[:, 0:1]


def _launch(**kw):
    """A stage's launches per kernel: those named, 0 for the rest."""
    return {"histogram": 0, "segment_combine": 0, "stage_fused": 0,
            "moe_gemm": 0, "flash_attention_tf32": 0,
            "flash_attention_sm90": 0,
            "flash_decode": 0, "flash_decode_sm90": 0, "mamba_scan": 0,
            **kw}


# launches of each kernel in each stage of the main path: K1 where Phase 1
# passes the host cutoff (stage b's weighted root call, the replica-local
# pairs of stage d's second stage), K2 once for every stage's writer
# combine, K3 in the ragged stage c
EXPECTED_LAUNCHES = {
    "a": _launch(segment_combine=1),
    "b": _launch(histogram=1, segment_combine=1),
    "c": _launch(segment_combine=1, stage_fused=1),
    "d0": _launch(segment_combine=1),
    "d1": _launch(histogram=1, segment_combine=1),
}


def make_stages(tpm: int):
    """The four stages' task batches (numpy, from the seed)."""
    from repro_torch.core import TaskBatch, fused_read
    from repro_torch.kvstore.ycsb import zipf_keys_stationary as zipf

    rng = np.random.default_rng(SEED)
    n, K = P * tpm, 16 * tpm
    origin = TaskBatch.even_origins(n, P)

    def ctx():
        return rng.standard_normal((n, 2))

    a = TaskBatch(contexts=ctx(), read_keys=zipf(n, K, 2.0, rng,
                                                     rng.permutation(K)),
                  origin=origin)
    b = TaskBatch(contexts=ctx(), read_keys=rng.integers(0, K, n),
                  origin=origin,
                  priority=rng.integers(-2**31 + 1, 2**31 - 1, n))
    arity = rng.integers(1, 9, n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(arity, out=indptr[1:])
    c = TaskBatch(contexts=ctx(), origin=origin, read_indptr=indptr,
                  read_indices=zipf(int(indptr[-1]), K, 1.5, rng,
                                     rng.permutation(K)))
    return K, [
        ("a", "arity-1 zipf2.0 add", a, muladd, "add", None, 1),
        ("b", "arity-1 uniform write", b, muladd, "write", None, 1),
        ("c", "ragged zipf1.5 fused_read(add) min", c,
         fused_read("add", scale_by_context), "min", None, 1),
        ("d", "(a) replicated, 2 stages", a, muladd, "add", True, 2),
    ]


def term_magnitudes(tasks, values, kind: str) -> np.ndarray:
    """Per task, the magnitude of the terms its update sums (float64):
    |v|*|c0| + |c1| for muladd, (sum_i |v_i|)*|c0| for the fused stage."""
    c = np.abs(tasks.contexts)
    if kind == "muladd":
        v = np.zeros((tasks.n, values.shape[1]))
        has = tasks.read_keys >= 0
        v[has] = np.abs(values[tasks.read_keys[has]])
        return v * c[:, 0:1] + c[:, 1:2]
    cs = np.concatenate([np.zeros((1, values.shape[1])),
                         np.cumsum(np.abs(values[tasks.read_indices]), 0)])
    return (cs[tasks.read_indptr[1:]] - cs[tasks.read_indptr[:-1]]) \
        * c[:, 0:1]


def _check_values(name, got, want, old, tasks, mags, merge):
    """Store rows after a stage, torch (float32 on the card, applied to the
    float64 host copy) against the float64 oracle. Tolerance per element:
    |Δ| <= 1e-5*|want| + 1e-6*T + 1e-6, where T is the magnitude of the
    terms that made the row: |old| + Σ|terms| of the segment for add (the
    atomics sum up to hundreds of thousands of terms into a hot key in a
    run-dependent order, so a fixed rtol would be wrong), |old| + the
    largest |term| of the segment for min/max/write (float32 rounding of
    the winning term). Rows no task writes must be bit-identical."""
    wk = tasks.write_keys
    live = wk >= 0
    uniq, inv = np.unique(wk[live], return_inverse=True)
    T = np.zeros((uniq.size, got.shape[1]))
    if merge == "add":
        np.add.at(T, inv, mags[live])
    else:
        np.maximum.at(T, inv, mags[live])
    T += np.abs(old[uniq])
    err = np.abs(got[uniq] - want[uniq])
    allowed = 1e-5 * np.abs(want[uniq]) + 1e-6 * T + 1e-6
    ok = err <= allowed
    if not ok.all():
        i = np.argwhere(~ok)[0]
        raise AssertionError(
            f"stage {name}: key {uniq[i[0]]} col {i[1]} got "
            f"{got[uniq][tuple(i)]} want {want[uniq][tuple(i)]} "
            f"(T={T[tuple(i)]})")
    rest = np.ones(got.shape[0], dtype=bool)
    rest[uniq] = False
    if not np.array_equal(got[rest], want[rest]):
        raise AssertionError(f"stage {name}: an unwritten row changed")
    return float(err.max(initial=0.0)), float((err / allowed).max(initial=0))


class _Stages:
    """Runs the named stages of a path: the kernel launches of each are
    checked against the expected table (on the card), its wall time kept."""

    def __init__(self, device: str, expected: dict):
        self.device, self.expected = device, expected
        self.rows = []

    def run(self, tag: str, fn, **info):
        import torch

        from repro_torch import kernels

        if self.device == "cuda":
            torch.cuda.synchronize()
        before = kernels.launches()
        t0 = time.perf_counter()
        out = fn()
        if self.device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ran = {k: v - before[k] for k, v in kernels.launches().items()}
        if self.device == "cuda" and ran != self.expected[tag]:
            raise AssertionError(f"stage {tag}: kernel launches {ran}, "
                                 f"expected {self.expected[tag]}")
        self.rows.append(dict(stage=tag, wall_s=wall, launches=ran, **info))
        return out


def _same_bill(name, a, b) -> None:
    """Cost of the torch run `a` equal to the numpy run `b`'s."""
    if a.report.phase_signature() != b.report.phase_signature():
        raise AssertionError(f"{name}: phase_signature differs")
    if a.refcount != b.refcount:
        raise AssertionError(f"{name}: refcount differs")
    if hasattr(a, "exec_site") and not np.array_equal(a.exec_site,
                                                      b.exec_site):
        raise AssertionError(f"{name}: exec_site differs")


def _timed_backend(be):
    """Wrap a torch backend's device calls to split a stage's wall time
    into device numerics (these calls, synchronized) and the host cost
    model (the rest)."""
    import torch

    be.numerics_s = 0.0
    for meth in ("execute", "apply_writes", "key_counts"):
        inner = getattr(be, meth)

        def timed(*a, _inner=inner, **k):
            t = time.perf_counter()
            out = _inner(*a, **k)
            if be.device.type == "cuda":
                torch.cuda.synchronize(be.device)
            be.numerics_s += time.perf_counter() - t
            return out

        setattr(be, meth, timed)


def main_path(device: str = "cuda", tpm: int = TASKS_PER_MACHINE):
    """Run the four stages through the torch backend and the numpy oracle;
    return (one summary dict per stage, K, stages, initial values). Raises
    on any mismatch. `device="cpu"` runs the plain versions (a rehearsal
    without a card)."""
    from repro_torch.core import DataStore, Orchestrator, TorchBackend

    K, stages = make_stages(tpm)
    rng = np.random.default_rng(SEED + 1)
    init = rng.standard_normal((K, VALUE_WIDTH))
    st_dev = DataStore.create(K, P, value_width=VALUE_WIDTH)
    st_ora = DataStore.create(K, P, value_width=VALUE_WIDTH)
    st_dev.write_rows(np.arange(K), init)
    st = _Stages(device, EXPECTED_LAUNCHES)
    for name, desc, tasks, f, merge, rep, n_stages in stages:
        if name == "d":  # (a) again, from the same starting values
            st_dev.write_rows(np.arange(K), init)
        backend = "torch" if device == "cuda" else TorchBackend(device=device)
        s_dev = Orchestrator(st_dev, backend=backend, replication=rep)
        s_ora = Orchestrator(st_ora, backend="numpy", replication=rep)
        _timed_backend(s_dev.backend)
        kind = "fused" if tasks.max_arity > 1 else "muladd"
        for k in range(n_stages):
            # the oracle starts each stage from the torch store's values
            # (the torch side keeps its device copy), so each check sees
            # only that stage's rounding
            st_ora.write_rows(np.arange(K), st_dev.values)
            old = st_ora.values.copy()
            mags = term_magnitudes(tasks, old, kind)
            s_dev.backend.numerics_s = 0.0
            tag = f"{name}{k}" if n_stages > 1 else name
            r_dev = st.run(tag, lambda: s_dev.run_stage(
                tasks, f, write_back=merge, return_results=True),
                desc=desc, tasks=tasks.n, pairs=tasks.nnz)
            row = st.rows[-1]
            wall = row["wall_s"]
            if s_dev.backend._host_lambdas:
                raise AssertionError(f"stage {tag}: a lambda fell back to "
                                     "the host path")
            t0 = time.perf_counter()
            r_ora = s_ora.run_stage(tasks, f, write_back=merge,
                                    return_results=True)
            wall_ora = time.perf_counter() - t0
            _same_bill(f"stage {tag}", r_dev, r_ora)
            res_err = _sum_bound_ok(
                np.asarray(r_dev.results, dtype=np.float64),
                np.asarray(r_ora.results, dtype=np.float64), mags,
                rel_want=1e-5, name=f"stage {tag} results")
            val_err, val_share = _check_values(
                tag, st_dev.values, st_ora.values, old, tasks, mags, merge)
            numerics = s_dev.backend.numerics_s
            row.update(numerics_s=numerics,
                       host_cost_model_s=wall - numerics,
                       tasks_per_s=tasks.n / wall, oracle_wall_s=wall_ora,
                       max_result_err=res_err, max_value_err=val_err,
                       max_value_err_share_of_tolerance=val_share,
                       replicated_chunks=(s_dev.replicas.num_replicated
                                          if s_dev.replicas is not None
                                          else 0))
            log(f"  stage {tag} ({desc}): {tasks.n} tasks, {tasks.nnz} "
                f"pairs, wall {wall:.3f} s = host cost model "
                f"{wall - numerics:.3f} s + backend calls (device numerics "
                f"with their transfers) {numerics:.3f} s"
                f", {tasks.n / wall:.0f} tasks/s (oracle {wall_ora:.3f} s); "
                f"max |Δ| results {res_err:.3g}, store "
                f"{val_err:.3g} (at most {val_share:.3g} of its tolerance); "
                f"signature/refcount/exec_site equal; launches "
                f"{row['launches']}")
    return st.rows, K, stages, init


# ---------------------------------------------------------------------------
# phase 4: the parameter-server path
# ---------------------------------------------------------------------------
# granite-moe-3b-a800m (src/repro/configs/granite_moe_3b_a800m.py) at full
# width: one of its 32 MoE layers (each layer has the same shapes and chunks
# of its own, so a layer is the unit of depth) and its embedding table. The
# cluster and traffic are benchmarks/bench_paramserve.py's.
GRANITE = dict(E=40, d=1536, f=512, k=8, vocab=49_155)
PS_P = 8
PS_ALPHA = 1.2
PS_SEED = 13
PS_REPLICATE = {"num_hot": 4, "refresh": 1, "decay": 0.5, "min_count": 2.0}
DECODE_T = 128  # tokens a decode step (k = 8 gives 1,024 assignments)
DECODE_STEPS = 4  # the first one cold
COST_T = 16  # decode steps held against the numpy backend (host float64)
EMBED_N = 8192  # ids, bags and gradient rows a stage (bench_paramserve's T)
EMBED_HOT = dict(PS_REPLICATE, num_hot=GRANITE["vocab"] // 64)
# bench_paramserve's own MoE mix (its full setting), where its gate holds
GATE_MIX = dict(E=16, d=32, f=64, k=2, T=512, stages=6)

# launches of each kernel in each stage of the parameter-server path: K1
# once for a decode step's Phase-1 root call and once more for the
# replica-local pairs of a step after the first election; K4 twice per
# naive dispatch (in- and out-projection); K1 once for each embedding
# lookup, whose root call (or, once rows are replicated, whose
# replica-local pairs) passes the backend's sparse-range cutoff, plus K3
# for the bags, K2 for the gradient push, and K1 for embed_skew_aware
PS_EXPECTED = {
    "decode0": _launch(histogram=1), "naive0": _launch(moe_gemm=2),
    "decode1": _launch(histogram=2), "naive1": _launch(moe_gemm=2),
    "decode2": _launch(histogram=2), "naive2": _launch(moe_gemm=2),
    "decode3": _launch(histogram=2), "naive3": _launch(moe_gemm=2),
    "lookup": _launch(histogram=1),
    "bags": _launch(histogram=1, stage_fused=1),
    "update": _launch(segment_combine=1),
    "hot0": _launch(histogram=1), "hot1": _launch(histogram=1),
    "hot2": _launch(histogram=1), "hot3": _launch(histogram=1),
    "skew_aware": _launch(histogram=1),
}


def expert_reference(x, top_i, gates, w_in, w_out) -> np.ndarray:
    """The routed expert mixture in float64 on the host, expert by expert:
    the rows of expert e as one product with w_in[e], silu(gate) * up, the
    product with w_out[e], scaled by their gates and added to their tokens.
    The arithmetic of `MoERouter.oracle` without its dense gather."""
    f = w_out.shape[1]
    y = np.zeros((x.shape[0], w_out.shape[2]))
    for e in np.unique(top_i[top_i >= 0]):
        tok, slot = np.nonzero(top_i == e)
        h = x[tok] @ w_in[e]
        g, up = h[:, :f], h[:, f:]
        act = g * (1.0 / (1.0 + np.exp(-g))) * up
        np.add.at(y, tok, (act @ w_out[e]) * gates[tok, slot][:, None])
    return y


# decode and naive outputs (float32 on the card) against the float64
# reference: the sound runs' worst reading was 1.43e-06 on outputs of
# 0.3-0.5; the naive arm with TF32 products misses it (the control in
# `paramserve_kernel_parity`)
DECODE_REL = 1e-5


def _check_close(name, got, want, rel=DECODE_REL) -> float:
    """|Δ| <= rel * (1 + |want|) per element (float32 against float64)."""
    got = np.asarray(got, dtype=np.float64)
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"{name}: malformed output {got.shape}")
    err = np.abs(got - want)
    if not (err <= rel * (1.0 + np.abs(want))).all():
        raise AssertionError(f"{name}: max |Δ| {err.max()} beyond "
                             f"{rel}*(1+|ref|)")
    return float(err.max(initial=0.0))


def _steady_ratio(router, warm, **sess) -> float:
    """Orchestrated work_ratio (max/mean per-machine work) of the session's
    stages after the first, whose per-machine work was `warm`."""
    work = router.session(**sess).report.per_machine()["work"] - warm
    return float(work.max() / work.mean())


def paramserve_path(device: str = "cuda", f: int | None = None,
                    embed_dim: int | None = None):
    """The MoE decode and embedding stages through the torch backend on
    `device`, checked against float64 references; returns (stage rows,
    summary, tensors for the timing phase). Only this part of phase 4 runs
    between the launch counts' reset and reading: the cost comparison with
    the numpy backend and the gate mix come after, in `paramserve_costs`.
    `f`/`embed_dim` cut the widths for a rehearsal on the CPU
    (``device="cpu"``). The stores keep granite's chunk sizes then: the
    cost model's merge threshold (C = ceil(B / sigma)) reads them, and with
    it which Phase-1 calls pass the cutoff that launches K1."""
    import torch

    from repro_torch.core import TorchBackend
    from repro_torch.core.embedding import embed_skew_aware
    from repro_torch.kvstore.ycsb import zipf_keys_stationary as zipf
    from repro_torch.paramserve import EmbeddingStore, MoERouter

    E, d, k = GRANITE["E"], GRANITE["d"], GRANITE["k"]
    f = GRANITE["f"] if f is None else f
    backend = None if device == "cuda" else TorchBackend(device=device)
    gemm_dev = None if device == "cuda" else device
    st = _Stages(device, PS_EXPECTED)
    summary = {}

    t0 = time.perf_counter()
    router = MoERouter(E, d, f, PS_P, num_layers=1, top_k=k, seed=0)
    router.store.chunk_words = 3 * d * GRANITE["f"]
    router.init_weights(1)
    w_in, w_out = router.layer_weights(0)
    perm = np.random.default_rng(PS_SEED).permutation(E)
    summary["moe_setup_s"] = time.perf_counter() - t0
    sess_kw = dict(backend=backend, replicate=PS_REPLICATE)
    naive_ratio, warm, peak = 0.0, None, []
    for s in range(DECODE_STEPS):
        x, ti, g = router.zipf_routing(DECODE_T, alpha=PS_ALPHA,
                                       seed=PS_SEED + s, rank_perm=perm)
        want = expert_reference(x, ti, g, w_in, w_out)
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        res = st.run(f"decode{s}", lambda: router.decode_step(
            x, ti, g, **sess_kw), pairs=int((ti >= 0).sum()))
        if device == "cuda":
            peak.append(torch.cuda.max_memory_allocated())
        nd = st.run(f"naive{s}", lambda: router.naive_dispatch(
            x, ti, g, gemm="torch", device=gemm_dev))
        st.rows[-2]["max_abs_err"] = _check_close(f"decode{s}", res.y, want)
        st.rows[-1]["max_abs_err"] = _check_close(f"naive{s}", nd.y, want)
        naive_ratio = max(naive_ratio, nd.work_ratio)
        if s == 0:
            warm = router.session(**sess_kw).report.per_machine()[
                "work"].copy()
    sess = router.session(**sess_kw)
    if sess.backend._host_lambdas:
        raise AssertionError("decode: the MoE lambda fell back to the host")
    summary.update(moe_orchestrated_work_ratio=_steady_ratio(
        router, warm, **sess_kw), moe_naive_work_ratio=naive_ratio,
        decode_peak_bytes=peak)
    routing = (x, ti, g, want)
    if summary["moe_orchestrated_work_ratio"] > 1.5:
        raise AssertionError("orchestrated work_ratio "
                             f"{summary['moe_orchestrated_work_ratio']} > 1.5")

    # embedding: granite's table, lookups / bags / gradient push, then a
    # replicating session and its exported hot-row cache
    V, D = GRANITE["vocab"], d if embed_dim is None else embed_dim
    t0 = time.perf_counter()
    store = EmbeddingStore(V, D, PS_P, seed=0)
    store.store.chunk_words = d
    store.init_table(1)
    summary["embed_setup_s"] = time.perf_counter() - t0
    rng = np.random.default_rng(PS_SEED)
    perm_v = rng.permutation(V)
    n = EMBED_N
    ids = zipf(n, V, PS_ALPHA, rng, perm_v)
    table0 = store.table.copy()
    res = st.run("lookup", lambda: store.lookup(ids, backend=backend))
    st.rows[-1]["max_abs_err"] = _check_close(
        "lookup", res.values, table0[ids], rel=1e-6)
    arity = rng.integers(1, 9, n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(arity, out=indptr[1:])
    bag_ids = zipf(int(indptr[-1]), V, PS_ALPHA, rng, perm_v)
    res = st.run("bags", lambda: store.lookup_bags((indptr, bag_ids),
                                                   backend=backend),
                 pairs=int(indptr[-1]))
    sums = np.add.reduceat(table0[bag_ids], indptr[:-1], axis=0)
    mags = np.add.reduceat(np.abs(table0[bag_ids]), indptr[:-1], axis=0)
    st.rows[-1]["max_abs_err"] = _sum_bound_ok(res.values, sums, mags,
                                               rel_want=1e-5, name="bags")
    up_ids = zipf(n, V, PS_ALPHA, rng, perm_v)
    grads = rng.standard_normal((n, D))
    st.run("update", lambda: store.update(up_ids, grads, backend=backend))
    want = EmbeddingStore.oracle_update(table0, up_ids, grads)
    tmag = EmbeddingStore.oracle_update(np.abs(table0), up_ids,
                                        np.abs(grads))
    st.rows[-1]["max_abs_err"] = _sum_bound_ok(store.table, want, tmag,
                                               rel_want=1e-5, name="update")
    hot_kw = dict(backend=backend, replicate=EMBED_HOT)
    table1 = store.table.copy()
    hot_ids = [zipf(n, V, PS_ALPHA, rng, perm_v)
               for _ in range(DECODE_STEPS)]
    for s, h in enumerate(hot_ids):
        res = st.run(f"hot{s}", lambda: store.lookup(h, **hot_kw))
        st.rows[-1]["max_abs_err"] = _check_close(
            f"hot{s}", res.values, table1[h], rel=1e-6)
    cache = store.device_cache(**hot_kw, device=device)
    dev = torch.device(device)
    table_dev = torch.from_numpy(table1.astype(np.float32)).to(dev)
    q = zipf(n, V, PS_ALPHA, rng, perm_v)
    q_dev = torch.from_numpy(q.astype(np.int32)).to(dev)
    out, cache2, hit = st.run("skew_aware", lambda: embed_skew_aware(
        table_dev, q_dev, cache))
    lookup = cache.lookup.cpu().numpy()
    want_counts = cache.counts.cpu().numpy() + np.bincount(q, minlength=V)
    if not (torch.equal(out.cpu(), torch.from_numpy(
            table1[q].astype(np.float32)))
            and np.array_equal(cache2.counts.cpu().numpy(), want_counts)
            and float(hit) == float(np.mean(lookup[q] >= 0))):
        raise AssertionError("embed_skew_aware differs from its reference")
    summary.update(
        embed_hot_rows=int(cache.hot_ids.numel()), embed_hit_rate=float(hit),
        embed_replica_local_words=float(store.session(
            **hot_kw).report.replica_local_words))
    for sess in store._sessions.values():
        if sess.backend._host_lambdas:
            raise AssertionError("embedding: a lambda fell back to the host")
    tensors = dict(router=router, perm=perm, routing=routing, store=store,
                   ids=ids, skew_ids=q,
                   bags=(indptr, bag_ids), grads=(up_ids, grads),
                   hot_ids=hot_ids)
    return st.rows, summary, tensors


def paramserve_costs(device: str, t: dict) -> dict:
    """Phase 4's cost half: the decode steps at T = COST_T and every
    embedding stage again on the torch backend (fresh sessions) and on the
    numpy backend — phase_signature, refcount, exec_site and both arms'
    work ratios equal — then bench_paramserve's gate on its own MoE mix."""
    from repro_torch.core import TorchBackend
    from repro_torch.paramserve import EmbeddingStore, MoERouter

    router = t["router"]
    be = TorchBackend(device=None if device == "cuda" else device)
    gemm_dev = None if device == "cuda" else device
    arms = {"torch": dict(backend=be, replicate=PS_REPLICATE),
            "numpy": dict(backend="numpy", replicate=PS_REPLICATE)}
    warm = {}
    for s in range(DECODE_STEPS):
        x, ti, g = router.zipf_routing(COST_T, alpha=PS_ALPHA,
                                       seed=PS_SEED + s, rank_perm=t["perm"])
        a = router.decode_step(x, ti, g, **arms["torch"])
        b = router.decode_step(x, ti, g, **arms["numpy"])
        _same_bill(f"decode T={COST_T} step {s}", a, b)
        _check_close(f"decode T={COST_T} step {s}", a.y, b.y)
        na = router.naive_dispatch(x, ti, g, gemm="torch", device=gemm_dev)
        nb = router.naive_dispatch(x, ti, g)
        if na.work_ratio != nb.work_ratio:
            raise AssertionError("naive work_ratio differs from numpy's")
        _check_close(f"naive T={COST_T} step {s}", na.y, nb.y)
        if s == 0:
            warm = {arm: router.session(**kw).report.per_machine()[
                "work"].copy() for arm, kw in arms.items()}
    ratios = {arm: _steady_ratio(router, warm[arm], **kw)
              for arm, kw in arms.items()}
    if ratios["torch"] != ratios["numpy"]:
        raise AssertionError(f"orchestrated work_ratio differs: {ratios}")

    src = t["store"]
    twins = {arm: EmbeddingStore.from_reference(src) for arm in arms}
    ops = [("lookup", lambda es, kw: es.lookup(t["ids"], **kw), {}),
           ("bags", lambda es, kw: es.lookup_bags(t["bags"], **kw), {}),
           ("update", lambda es, kw: es.update(*t["grads"], **kw), {})]
    ops += [(f"hot{s}", lambda es, kw, h=h: es.lookup(h, **kw),
             {"replicate": EMBED_HOT}) for s, h in enumerate(t["hot_ids"])]
    for name, op, extra in ops:
        got = {arm: op(twins[arm], {"backend": arms[arm]["backend"],
                                    **extra}) for arm in arms}
        _same_bill(f"embedding {name}", got["torch"], got["numpy"])

    c = GATE_MIX
    gate = {}
    for arm, backend in (("torch", be), ("numpy", "numpy")):
        r = MoERouter(c["E"], c["d"], c["f"], PS_P, top_k=c["k"], seed=0)
        r.init_weights(1)
        perm = np.random.default_rng(PS_SEED).permutation(c["E"])
        naive, w0 = 0.0, None
        for s in range(c["stages"]):
            x, ti, g = r.zipf_routing(c["T"], alpha=PS_ALPHA,
                                      seed=PS_SEED + s, rank_perm=perm)
            r.decode_step(x, ti, g, backend=backend, replicate=PS_REPLICATE)
            naive = max(naive, r.naive_dispatch(
                x, ti, g, gemm="torch", device=gemm_dev).work_ratio)
            if s == 0:
                w0 = r.session(backend=backend, replicate=PS_REPLICATE
                               ).report.per_machine()["work"].copy()
        gate[arm] = (_steady_ratio(r, w0, backend=backend,
                                   replicate=PS_REPLICATE), naive)
    if gate["torch"] != gate["numpy"]:
        raise AssertionError(f"gate mix ratios differ: {gate}")
    orch, naive = gate["torch"]
    if not (orch <= 1.5 and naive >= 2.0 and naive >= 2.0 * orch):
        raise AssertionError(f"bench_paramserve gate failed: orchestrated "
                             f"{orch}, naive {naive}")
    return dict(cost_decode_orchestrated_work_ratio=ratios["torch"],
                gate_mix=c, gate_orchestrated=orch, gate_naive=naive)


def paramserve_kernel_parity(dev, t: dict) -> dict:
    """K1-K3 on the card at the parameter-server path's own inputs, each
    against its plain version on the same tensors (after the path's launch
    counts are read, so these launches do not count): K1 over a decode
    step's expert ids (40 bins) and the lookup's ids (49,155 bins, beyond
    the shared-memory budget), unweighted and weighted by multiplicity as
    the Phase-1 root call passes them; K2 adding the update's 8,192
    gradient rows of width 1536 into its segments; K3 pooling the 8,192
    bags over the store's device table. Then a control for the decode
    tolerance: both arms once more with TF32 allowed."""
    import torch

    from repro_torch.core import TorchBackend
    from repro_torch.kernels.histogram.ops import count_ids
    from repro_torch.kernels.histogram.ref import histogram_ref
    from repro_torch.kernels.moe_gemm.ops import grouped_gemm
    from repro_torch.kernels.segment_combine.ops import combine
    from repro_torch.kernels.segment_combine.ref import combine_ref
    from repro_torch.kernels.stage_fused.ops import fused_reduce
    from repro_torch.kernels.stage_fused.ref import reduce_pairs_ref

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    router, store = t["router"], t["store"]
    x, ti, g, want = t["routing"]
    for ids, bins in ((ti[ti >= 0], router.E), (t["ids"], store.V)):
        uniq, cnt = np.unique(ids, return_counts=True)
        for k, w in ((i32(ids), None), (i32(uniq), i32(cnt))):
            if not torch.equal(count_ids(k, bins, weights=w),
                               histogram_ref(k, bins, w)):
                raise AssertionError(f"histogram: {k.numel()} ids into "
                                     f"{bins} bins differ")
    worst = {"histogram": 0.0}

    up_ids, grads = t["grads"]
    uniq, inv = np.unique(up_ids, return_inverse=True)
    upd = torch.from_numpy(grads.astype(np.float32)).to(dev)
    seg = i32(inv)
    worst["segment_combine"] = _sum_bound_ok(
        combine(upd, seg, uniq.size, op="add"),
        combine_ref(upd, seg, uniq.size, op="add"),
        combine_ref(upd.abs(), seg, uniq.size, op="add"),
        name="segment_combine at the update")

    table = TorchBackend(device=dev).device_values(store.store)
    indptr, bag_ids = (i32(a) for a in t["bags"])
    worst["stage_fused"] = _sum_bound_ok(
        fused_reduce(table, indptr, bag_ids, read_op="add"),
        reduce_pairs_ref(table, indptr, bag_ids, read_op="add"),
        reduce_pairs_ref(table.abs(), indptr, bag_ids, read_op="add"),
        name="stage_fused at the bags")
    log(f"  K1-K3 at the path's inputs against their plain versions: K1 "
        f"exact (decode {router.E} bins, lookup {store.V} bins; weighted "
        f"and not), K2 max |Δ| {worst['segment_combine']:.3g}, K3 "
        f"{worst['stage_fused']:.3g} (within 1e-6*sum|terms| + 1e-6)")
    if dev.type != "cuda":
        return worst
    # the control: TF32 allowed for float32 products, one decode step and
    # one naive dispatch whose grouped GEMMs are the plain version (torch
    # matmuls, which take TF32 then); each one's distance from the limit
    from repro_torch.kernels.moe_gemm.ref import grouped_gemm_ref
    from repro_torch.paramserve import moe

    torch.backends.cuda.matmul.allow_tf32 = True
    moe.grouped_gemm = grouped_gemm_ref
    try:
        runs = {"decode": router.decode_step(
            x, ti, g, backend=TorchBackend(device=dev),
            replicate=PS_REPLICATE).y,
            "naive": router.naive_dispatch(x, ti, g, gemm="torch").y}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        moe.grouped_gemm = grouped_gemm
    for arm, y in runs.items():
        err = np.abs(y - want)
        share = float((err / (DECODE_REL * (1.0 + np.abs(want)))).max())
        worst[f"tf32_{arm}_max_abs_err"] = float(err.max())
        worst[f"tf32_{arm}_share_of_limit"] = share
        log(f"  control, TF32 allowed: {arm} off the float64 reference by "
            f"{err.max():.3g}, {share:.3g}x the limit {DECODE_REL}*(1+|ref|)")
    return worst


def _grouped_rows(x, top_i, num_experts: int):
    """The naive arm's layout: kept assignments sorted by expert (stable),
    their activations as float32, and the per-expert row counts."""
    keep = top_i >= 0
    flat_e = top_i[keep]
    order = np.argsort(flat_e, kind="stable")
    xs = x[np.nonzero(keep)[0][order]].astype(np.float32)
    return xs, np.bincount(flat_e, minlength=num_experts).astype(np.int32)


def moe_gemm_timing(dev, t: dict, launches: int) -> dict:
    """K4 at the path's in-projection (the naive arm of the last decode
    step: M = 1,024, K = 1,536, N = 1,024, G = 40), its out-projection
    (K = 512, N = 1,536), and a prefill-sized in-projection (4,096 tokens,
    M = 32,768): each against its plain version, the one PyTorch call for
    it where the installed torch has one, and its bound in 3xTF32 on the
    tensor cores (with the FMA bound beside it)."""
    import torch

    from repro_torch.core import TorchBackend
    from repro_torch.kernels.moe_gemm.ops import grouped_gemm
    from repro_torch.kernels.moe_gemm.ref import grouped_gemm_ref

    router = t["router"]
    E, d, f = router.E, router.d, router.f
    # the naive arm's operands: views of the store's float32 device rows
    rows = TorchBackend(device=dev).device_values(router.store)[:E]
    w_in = rows[:, :2 * d * f].view(E, d, 2 * f)
    w_out = rows[:, 2 * d * f:].view(E, f, d)
    xs, sizes = _grouped_rows(t["routing"][0], t["routing"][1], E)
    xs, sizes = torch.from_numpy(xs).to(dev), torch.from_numpy(sizes).to(dev)
    h = grouped_gemm(xs, w_in, sizes)
    act = (h[:, :f] * torch.sigmoid(h[:, :f]) * h[:, f:]).contiguous()
    xp, tip, _ = router.zipf_routing(4096, alpha=PS_ALPHA,
                                     seed=PS_SEED + DECODE_STEPS,
                                     rank_perm=t["perm"])
    xp, sizes_p = _grouped_rows(xp, tip, E)
    xp, sizes_p = torch.from_numpy(xp).to(dev), \
        torch.from_numpy(sizes_p).to(dev)
    shapes = []
    for label, x, w, sz in (("in-projection", xs, w_in, sizes),
                            ("out-projection", act, w_out, sizes),
                            ("prefill in-projection", xp, w_in, sizes_p)):
        M, K = x.shape
        N = w.shape[2]
        err = gemm_parity(dev, x, w, sz, label)
        bounds = sz.cpu().numpy()
        used = int((bounds > 0).sum())
        nbytes, ops = 4 * (M * K + used * K * N + M * N + E), 2 * M * K * N
        b_ms, b_by = bound(nbytes, ops, FP32_TC_OPS_PER_S)
        starts = np.r_[0, np.cumsum(bounds)]
        offs = torch.from_numpy(np.cumsum(bounds).astype(np.int32)).to(dev)
        wc = w.contiguous()  # the library call and the loop get stacks

        def loop(x=x, w=wc, starts=starts):
            return [x[starts[g]:starts[g + 1]] @ w[g] for g in range(E)
                    if starts[g + 1] > starts[g]]

        library_ms, note = None, ""
        try:
            lib = torch._grouped_mm(x, wc, offs=offs)
            _sum_bound_ok(lib, grouped_gemm_ref(x, w, sz),
                          grouped_gemm_ref(x.abs(), w.abs(), sz), rel=1e-5)
            library_ms = time_ms(lambda: torch._grouped_mm(x, wc, offs=offs))
        except (RuntimeError, TypeError, AttributeError, AssertionError) as exc:
            note = (f"torch._grouped_mm refuses this call "
                    f"({type(exc).__name__}: {str(exc).splitlines()[0]})")
        shapes.append(dict(
            shape=f"{label}: x ({M}, {K}) float32 over {used} of {E} "
                  f"experts, w ({E}, {K}, {N}) a view of the store's rows",
            max_abs_err=err,
            ms=time_ms(lambda: grouped_gemm(x, w, sz)),
            plain_ms=time_ms(lambda: grouped_gemm_ref(x, w, sz)),
            bound_ms=b_ms, bound_by=b_by,
            bound_fma_ms=bound(nbytes, ops)[0], library_ms=library_ms,
            library_note=note, matmul_loop_ms=time_ms(loop)))
    row = dict(name="moe_gemm", route="cuda",
               source="src/repro_torch/csrc/moe_gemm.cu",
               replaces="src/repro/kernels/moe_gemm/kernel.py:40",
               launches=launches, **shapes[0],
               shapes=shapes)
    row["max_abs_err"] = max(s["max_abs_err"] for s in shapes)
    return row


# ---------------------------------------------------------------------------
# phase 5: the attention and SSM path
# ---------------------------------------------------------------------------
# The three kernels no model of the JAX package calls (its models run their
# own XLA attention and chunked SSD), driven through their own entry points
# (`repro_torch.kernels.attention`, `decode_attention`, `mamba_ssd`) at the
# widths of the configs that use them, read from `repro_torch.configs`. The
# sequence lengths and batches are the JAX package's shape table
# (src/repro/launch/specs.py:27-29).
SPEC_SHAPES = {"prefill_32k": (32_768, 32), "decode_32k": (32_768, 128),
               "long_500k": (524_288, 1)}
ATTN_DTYPES = ("float32", "bfloat16")  # the configs' compute dtype: bf16
U32 = 2.0 ** -24     # float32 unit roundoff
BF16_ROUND = 2.0 ** -8  # relative rounding of a bf16 output (8-bit mantissa)
# float32 kernel against the float64 plain version: |Δ| <= ATTN_REL·(1 +
# |want|). The output is a convex combination of v rows; float32 scores,
# exponentials and sums over up to ~1,000 rows a lane (decode) or 64-key
# tiles (prefill) leave a relative error of a few 1e-7 (√n·u32), so the JAX
# suite's 2e-5 has a margin of 10x and more. The prefill kernel's 3xTF32
# products carry 21 bits of each operand (under 3·2^-20 a product, the
# tensor core truncating each tile's sums); one TF32 rounding of them would
# miss this gate many times over (tests/test_torch_tf32.py).
ATTN_REL = 2e-5
# SSD float32 against float64: |Δ| <= (SSD_REL + 8·u32·max|l|)·Σ|terms| +
# 1e-6, Σ|terms| being the plain version run on |x|, |B|, |C|. SSD_REL
# covers float32 sums of up to 2·128 + 64 products a term; the max|l| part
# covers the decay's exp(l_t − l_s), whose float32 l_t and l_s each carry
# an absolute error of a few u32·|l| from the cumulative sum.
SSD_REL = 1e-5
MATH_SCORE_BYTES = 20e9  # the library's math backend only below this


def attention_ssm_stages() -> list:
    """The path's five stages, widths from the ported configs."""
    from repro_torch.configs import get_config

    z, t, c = (get_config(a) for a in ("zamba2-1.2b", "tinyllama-1.1b",
                                       "command-r-35b"))
    s = z.ssm
    seq, _ = SPEC_SHAPES["prefill_32k"]
    long_T, long_B = SPEC_SHAPES["long_500k"]
    dec_T, dec_B = SPEC_SHAPES["decode_32k"]
    return [
        dict(tag="ssd", kernel="mamba_scan", B=2, S=seq,
             nh=s.expand * z.d_model // s.head_dim, hd=s.head_dim,
             ds=s.d_state, chunk=s.chunk,
             source="zamba2-1.2b Mamba2 block, prefill_32k",
             cut="batch 32 -> 2"),
        dict(tag="prefill_mha", kernel="flash_attention", B=1, S=seq, T=seq,
             H=z.n_heads, KV=z.n_kv_heads, hd=z.head_dim,
             source="zamba2-1.2b shared attention, prefill_32k",
             cut="batch 32 -> 1"),
        dict(tag="prefill_gqa128", kernel="flash_attention", B=1, S=8192,
             T=8192, H=c.n_heads, KV=c.n_kv_heads, hd=c.head_dim,
             source="command-r-35b attention, prefill_32k",
             cut="batch 32 -> 1, seq 32768 -> 8192"),
        dict(tag="decode_long", kernel="flash_decode", B=long_B, T=long_T,
             H=z.n_heads, KV=z.n_kv_heads, hd=z.head_dim, length=500_000,
             source="zamba2-1.2b shared attention, long_500k", cut="none"),
        dict(tag="decode_gqa", kernel="flash_decode", B=dec_B, T=dec_T,
             H=t.n_heads, KV=t.n_kv_heads, hd=t.head_dim, length=30_000,
             source="tinyllama-1.1b attention, decode_32k", cut="none"),
    ]


def launched_kernel(kernel: str, dtype: str) -> str:
    """The counter a stage of family `kernel` launches in `dtype`: bf16
    attention and decode take the tensor-core kernels (`*_sm90`), float32
    attention the 3xTF32 one (`flash_attention_tf32`), float32 decode the
    SIMT one; the scan has one kernel for both."""
    if kernel != "mamba_scan" and dtype == "bfloat16":
        return f"{kernel}_sm90"
    if kernel == "flash_attention":
        return "flash_attention_tf32"
    return kernel


# each stage launches its kernel once, in each dtype
ATTN_EXPECTED = {f"{tag}/{dt}": _launch(**{launched_kernel(kernel, dt): 1})
                 for tag, kernel in (("ssd", "mamba_scan"),
                                     ("prefill_mha", "flash_attention"),
                                     ("prefill_gqa128", "flash_attention"),
                                     ("decode_long", "flash_decode"),
                                     ("decode_gqa", "flash_decode"))
                 for dt in ATTN_DTYPES}


def stage_inputs(st: dict, dtype: str, dev, seed: int) -> tuple:
    """A stage's inputs, made on the device from the seed (the bf16 inputs
    are the float32 ones rounded): (q, k, v) for attention, (q, k, v,
    length as a 0-d device tensor) for decode, (x, dt, A, B, C) for the
    scan with dt ~ U(0.01, 0.3) and A ~ −U(0.3, 2.0) in float32."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, dtype)

    def normal(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dt)

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device=dev)

    if st["kernel"] == "mamba_scan":
        B, S, nh, hd, ds = (st[k] for k in ("B", "S", "nh", "hd", "ds"))
        return (normal(B, S, nh, hd), uniform(0.01, 0.3, B, S, nh),
                -uniform(0.3, 2.0, nh), normal(B, S, ds), normal(B, S, ds))
    B, T, H, KV, hd = (st[k] for k in ("B", "T", "H", "KV", "hd"))
    if st["kernel"] == "flash_attention":
        return (normal(B, st["S"], H, hd), normal(B, T, KV, hd),
                normal(B, T, KV, hd))
    return (normal(B, H, hd), normal(B, T, KV, hd), normal(B, T, KV, hd),
            torch.tensor(st["length"], dtype=torch.int64, device=dev))


def _kernel_call(st: dict, inputs: tuple):
    from repro_torch.kernels import attention, decode_attention, mamba_ssd

    if st["kernel"] == "mamba_scan":
        return lambda: mamba_ssd(*inputs, chunk=st["chunk"])
    if st["kernel"] == "flash_attention":
        return lambda: attention(*inputs, causal=st.get("causal", True))
    return lambda: decode_attention(*inputs)


def _plain_call(st: dict, inputs: tuple, up=None):
    """The plain version on `inputs` (each float tensor passed through
    `up` first: .double() or .float()); decode runs in slices of 32 batch
    rows, which it treats independently, to bound its float64 copies."""
    import torch

    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.flash_decode.ref import decode_attention_ref
    from repro_torch.kernels.mamba_scan.ref import ssd_scan_ref

    def lift(t):
        return up(t) if up is not None and t.is_floating_point() else t

    if st["kernel"] == "mamba_scan":
        return ssd_scan_ref(*map(lift, inputs), chunk=st["chunk"])
    if st["kernel"] == "flash_attention":
        return attention_ref(*map(lift, inputs),
                             causal=st.get("causal", True))
    q, k, v, length = inputs
    return torch.cat([decode_attention_ref(lift(q[i:i + 32]),
                                           lift(k[i:i + 32]),
                                           lift(v[i:i + 32]), length)
                      for i in range(0, q.shape[0], 32)])


def check_against_plain(st: dict, inputs: tuple, got, dtype: str,
                        name: str) -> tuple:
    """The kernel's output against the plain version on the same inputs:
    in float64 for a float32 run, in float32 for a bf16 run (plus the bf16
    rounding of the kernel's output). Tolerances: ATTN_REL and SSD_REL
    above."""
    import torch

    up = (lambda t: t.double()) if dtype == "float32" else \
        (lambda t: t.float())
    want = _plain_call(st, inputs, up)
    if st["kernel"] == "mamba_scan":
        x, dt, A, Bc, Cc = inputs
        c = min(st["chunk"], x.shape[1])
        max_l = float((dt.double() * A.double()).reshape(
            x.shape[0], -1, c, x.shape[2]).cumsum(2).abs().max().item())
        mags = _plain_call(st, (x.abs(), dt, A, Bc.abs(), Cc.abs()), up)
        allowed = (SSD_REL + 8 * U32 * max_l) * mags.double() + 1e-6
        del mags
    else:
        allowed = ATTN_REL * (1 + want.double().abs())
    if dtype == "bfloat16":
        allowed = allowed + BF16_ROUND * want.double().abs()
    out = _within(got, want, allowed, name)
    del want, allowed
    torch.cuda.empty_cache()
    return out


def attention_ssm_parity(dev) -> dict:
    """B5-B7 against their plain versions on the card (phase 2), each
    case in float32 (the 3xTF32 attention kernel, the SIMT decode and scan
    kernels) and bf16 (the tensor-core ones):
    the FLASH, DECODE and MAMBA geometries of tests/test_kernels.py, hd 32,
    64 and 128 causal and not, ragged query tiles (S = 100, 300), non-causal
    S != T, decode with G = 1, 4, 8, 16 and 20 (two bf16 blocks a KV head),
    valid prefixes of 0, 1, T and > T and ending on a cache tile (64, 128)
    as an int and as a device tensor, causal S != T refused, a scan whose
    unmasked decay would overflow (finite), and a scan asked for chunk 256.
    Returns the worst max |Δ| per launched kernel."""
    import torch

    from repro_torch.kernels import attention

    worst = {k: 0.0 for k in KERNEL_SOURCES}
    n = {k: 0 for k in worst}
    seed = SEED

    def run(st, inputs, dtype, name):
        got = _kernel_call(st, inputs)()
        e, _ = check_against_plain(st, inputs, got, dtype, name)
        kernel = launched_kernel(st["kernel"], dtype)
        worst[kernel] = max(worst[kernel], e)
        n[kernel] += 1

    for S, T, H, KV, hd, causal in [
            (128, 128, 4, 4, 64, True), (128, 128, 4, 4, 64, False),
            (256, 256, 8, 2, 64, True), (256, 256, 8, 2, 64, False),
            (128, 128, 4, 1, 128, True), (128, 128, 4, 1, 128, False),
            (64, 64, 2, 2, 32, True), (64, 64, 2, 2, 32, False),
            (100, 100, 4, 2, 64, True), (100, 100, 4, 2, 64, False),
            (300, 300, 4, 2, 128, True), (300, 300, 4, 2, 128, False),
            (48, 80, 4, 2, 32, False), (200, 129, 4, 1, 64, False),
            (130, 384, 8, 2, 128, False)]:
        st = dict(kernel="flash_attention", B=2, S=S, T=T, H=H, KV=KV,
                  hd=hd, causal=causal)
        for dtype in ATTN_DTYPES:
            seed += 1
            run(st, stage_inputs(st, dtype, dev, seed), dtype,
                f"attention {(S, T, H, KV, hd, causal)} {dtype}")
    q = torch.zeros((1, 64, 2, 32), device=dev)
    kv = torch.zeros((1, 128, 2, 32), device=dev)
    try:
        attention(q, kv, kv, causal=True)
    except ValueError:
        pass
    else:
        raise AssertionError("attention took causal S != T")

    for B, T, KV, G, hd, own in [(2, 128, 2, 4, 64, 100),
                                 (1, 256, 1, 8, 64, 256),
                                 (2, 64, 4, 1, 32, 1),
                                 (2, 1000, 2, 16, 128, 700),
                                 (3, 700, 2, 8, 64, 650),
                                 (2, 333, 1, 20, 32, 200)]:
        for length in sorted({0, 1, 64, 128, own, T, T + 5}):
            for dtype in ATTN_DTYPES:
                seed += 1
                st = dict(kernel="flash_decode", B=B, T=T, H=KV * G, KV=KV,
                          hd=hd, length=length)
                q, k, v, dev_len = stage_inputs(st, dtype, dev, seed)
                for ln in (length, dev_len):
                    run(st, (q, k, v, ln), dtype,
                        f"decode {(B, T, KV, G, hd)} length {length} "
                        f"({type(ln).__name__}) {dtype}")

    for S, nh, hd, ds, chunk in [(32, 2, 8, 8, 16), (64, 3, 16, 8, 16),
                                 (128, 1, 32, 16, 32), (256, 2, 64, 64, 256),
                                 (42, 20, 5, 3, 7), (300, 17, 64, 64, 100)]:
        st = dict(kernel="mamba_scan", B=2, S=S, nh=nh, hd=hd, ds=ds,
                  chunk=chunk)
        for dtype in ATTN_DTYPES:
            seed += 1
            inputs = stage_inputs(st, dtype, dev, seed)
            run(st, inputs, dtype, f"ssd {(S, nh, hd, ds, chunk)} {dtype}")
    # dt ~ U(1, 5), A ~ −U(5, 25): l falls by up to ~2,000 within a chunk
    # of 16, so exp(l_t − l_s) for s > t would be inf in float32
    st = dict(kernel="mamba_scan", B=2, S=64, nh=3, hd=16, ds=8, chunk=16)
    x, _, _, Bc, Cc = stage_inputs(st, "float32", dev, seed + 1)
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    dt = 1 + 4 * torch.rand((2, 64, 3), generator=g, device=dev)
    A = -(5 + 20 * torch.rand((3,), generator=g, device=dev))
    run(st, (x, dt, A, Bc, Cc), "float32", "ssd with |dt·A| up to 125")
    log(f"  attention: {n['flash_attention_tf32']} float32 "
        f"(flash_attention_tf32) and "
        f"{n['flash_attention_sm90']} bf16 (flash_attention_sm90) cases "
        "(the FLASH geometries, S = 100 and 300, non-causal S != T), causal "
        f"S != T refused; decode: {n['flash_decode']} float32 "
        f"(flash_decode) and {n['flash_decode_sm90']} bf16 "
        "(flash_decode_sm90) cases (the DECODE geometries, G = 16 at hd "
        "128, G = 20; lengths 0, 1, 64, 128, the geometry's, T, T + 5, as an "
        f"int and a device tensor); mamba_scan: {n['mamba_scan']} cases (the "
        "MAMBA geometries, chunk 256 on S = 256, hd 5 / ds 3 / chunk 7 / 20 "
        "heads, chunk 100 / 17 heads, |dt·A| up to 125); within "
        f"{ATTN_REL}·(1+|ref|) (attention) and ({SSD_REL} + 8·u32·max|l|)·"
        "Σ|terms| + 1e-6 (scan) against float64, plus 2^-8·|ref| for bf16 "
        "against float32 on the same inputs")
    return worst


def attention_ssm_path(dev, stages=None) -> list:
    """Drive the five stages (or `stages`, for a rehearsal at a small size
    on the CPU) in float32 and bf16 through the entry points; on the card
    each stage's launches are checked against ATTN_EXPECTED. Every output
    is held against the plain version (`check_against_plain`). Returns one
    row per stage and dtype."""
    import torch

    on_card = dev.type == "cuda"
    st_runner = _Stages(dev.type, ATTN_EXPECTED)
    for i, st in enumerate(stages or attention_ssm_stages()):
        for dtype in ATTN_DTYPES:
            tag = f"{st['tag']}/{dtype}"
            inputs = stage_inputs(st, dtype, dev, SEED + 100 + i)
            if on_card:
                torch.cuda.reset_peak_memory_stats(dev)
            got = st_runner.run(tag, _kernel_call(st, inputs),
                                source=st["source"], cut=st["cut"])
            row = st_runner.rows[-1]
            # the call's own peak (inputs, output and the kernels' scratch,
            # e.g. the scan's float32 chunk states), before the check
            row["peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                 if on_card else None)
            try:
                err, share = check_against_plain(st, inputs, got, dtype, tag)
            except AssertionError as exc:
                # a second call of the kernel and of the plain version tell
                # an output that changes from call to call from a steady one
                again = _kernel_call(st, inputs)()
                up = (lambda t: t.double()) if dtype == "float32" else \
                    (lambda t: t.float())
                plain = [_plain_call(st, inputs, up) for _ in range(2)]
                raise AssertionError(
                    f"{exc}; a second kernel call is "
                    f"{'' if torch.equal(again, got) else 'not '}identical "
                    f"to the first, two plain calls are "
                    f"{'' if torch.equal(*plain) else 'not '}identical"
                ) from exc
            row.update(max_abs_err=err, share_of_tolerance=share,
                       shape=_stage_shape(st, dtype))
            log(f"  {tag} ({st['source']}; cut: {st['cut']}): "
                f"{row['shape']}; wall {row['wall_s']:.4f} s, max |Δ| "
                f"{err:.3g} ({share:.3g} of its tolerance)"
                + (f", peak device memory {row['peak_bytes'] / 1e9:.2f} GB"
                   if on_card else ""))
            del inputs, got
            torch.cuda.empty_cache()
    return st_runner.rows


def _stage_shape(st: dict, dtype: str) -> str:
    if st["kernel"] == "mamba_scan":
        return (f"x ({st['B']}, {st['S']}, {st['nh']}, {st['hd']}), B/C "
                f"({st['B']}, {st['S']}, {st['ds']}) {dtype}, chunk "
                f"{st['chunk']}")
    if st["kernel"] == "flash_attention":
        return (f"q ({st['B']}, {st['S']}, {st['H']}, {st['hd']}), k/v "
                f"({st['B']}, {st['T']}, {st['KV']}, {st['hd']}) {dtype}, "
                "causal")
    return (f"q ({st['B']}, {st['H']}, {st['hd']}), caches ({st['B']}, "
            f"{st['T']}, {st['KV']}, {st['hd']}) {dtype}, length "
            f"{st['length']}")


def _work(st: dict, dtype: str) -> tuple:
    """(bytes, operations, peak operations/s) of a stage: each input read
    once and the output written once; the operations its data needs (the
    causal half of the scores and of the scan's c x c products, C·Bᵀ once
    per (b, chunk) as its heads share it, the valid prefix of a cache).
    The rate is the one of the units the kernel runs on: bf16 tensor cores,
    3xTF32 on them for float32 attention and the float32 scan, FMAs for
    float32 decode."""
    e = 2 if dtype == "bfloat16" else 4
    rate = BF16_OPS_PER_S if dtype == "bfloat16" else (
        FP32_TC_OPS_PER_S if st["kernel"] in ("flash_attention", "mamba_scan")
        else FP32_OPS_PER_S)
    if st["kernel"] == "mamba_scan":
        B, S, nh, hd, ds, c = (st[k] for k in ("B", "S", "nh", "hd", "ds",
                                                "chunk"))
        pairs = c * (c + 1) // 2
        ops = B * (S // c) * (2 * pairs * ds
                              + nh * (2 * pairs * hd + 4 * c * hd * ds))
        return e * (2 * B * S * nh * hd + 2 * B * S * ds) \
            + 4 * (B * S * nh + nh), ops, rate
    B, T, H, KV, hd = (st[k] for k in ("B", "T", "H", "KV", "hd"))
    if st["kernel"] == "flash_attention":
        S = st["S"]
        return e * (2 * B * S * H * hd + 2 * B * T * KV * hd), \
            4 * hd * B * H * S * (S + 1) // 2, rate
    n_valid = T if st["length"] <= 0 else min(st["length"], T)
    return e * (2 * B * H * hd + 2 * B * n_valid * KV * hd) + 8, \
        4 * B * H * n_valid * hd, rate


def _library_call(st: dict, inputs: tuple):
    """One PyTorch call computing the stage's function, on inputs laid out
    as it takes them (made here, outside the timing), or (None, note). The
    math backend only where its float32 score tensor stays under
    MATH_SCORE_BYTES (it is what takes GQA in float32)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    if st["kernel"] == "mamba_scan":
        return None, ("no one PyTorch call computes the SSD scan (a "
                      "chunked scan with a decaying state)")
    backends = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                SDPBackend.CUDNN_ATTENTION]
    if st["kernel"] == "flash_attention":
        q, k, v = (t.transpose(1, 2).contiguous() for t in inputs)
        if 4 * q.shape[0] * q.shape[1] * q.shape[2] * k.shape[2] \
                <= MATH_SCORE_BYTES:
            backends.append(SDPBackend.MATH)

        def call():
            with sdpa_kernel(backends):
                return F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True).transpose(1, 2)
        return call, ("F.scaled_dot_product_attention(is_causal=True, "
                      "enable_gqa=True), (B, H, S, hd) layout")
    q, k, v, length = inputs
    B, H, hd = q.shape
    KV = k.shape[2]
    # the G query heads of a KV head as G query rows: no expanded cache
    q4 = q.reshape(B, KV, H // KV, hd)
    kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))
    mask = (torch.arange(k.shape[1], device=q.device) < length)[None, None,
                                                                None]

    def call():
        with sdpa_kernel(backends):
            return F.scaled_dot_product_attention(
                q4, kt, vt, attn_mask=mask).reshape(B, H, hd)
    return call, ("F.scaled_dot_product_attention with a boolean prefix "
                  "mask, the G query heads of a KV head as G query rows")


def time_auto(fn) -> float:
    """time_ms with as many runs as fit in about a second (3 to 10)."""
    import torch

    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = time.perf_counter() - t
    reps = int(max(3, min(10, 1.0 / max(once, 1e-6))))
    return time_ms(fn, reps=reps, warmup=1)


KERNEL_SOURCES = {
    "flash_attention_tf32": ("src/repro_torch/csrc/flash_attention_tf32.cu",
                             "src/repro/kernels/flash_attention/kernel.py:75"),
    "flash_attention_sm90": ("src/repro_torch/csrc/flash_attention_sm90.cu",
                             "src/repro/kernels/flash_attention/kernel.py:75"),
    "flash_decode": ("src/repro_torch/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_decode/kernel.py:60"),
    "flash_decode_sm90": ("src/repro_torch/csrc/flash_decode.cu",
                          "src/repro/kernels/flash_decode/kernel.py:60"),
    "mamba_scan": ("src/repro_torch/csrc/mamba_scan.cu",
                   "src/repro/kernels/mamba_scan/kernel.py:58"),
}


def attention_ssm_timing(dev, launches: dict, errors: dict) -> list:
    """B5-B7 at every stage of the path, in float32 and bf16: the kernel,
    its plain version (on the same inputs, so computing in float32), the one
    PyTorch call for it (checked against the plain version first), and the
    bound (bytes over 3.35 TB/s, or operations at the rate `_work` gives:
    989 TFLOP/s in bf16, 495/3 in 3xTF32, 67 in float32 FMAs; a 3xTF32
    kernel's row also carries the FMA bound, `bound_fma_ms`). One row per
    kernel; its first shape is the headline, the rest are under
    `shapes`."""
    import torch

    by_kernel = {k: [] for k in KERNEL_SOURCES}
    for i, st in enumerate(attention_ssm_stages()):
        for dtype in ATTN_DTYPES:
            inputs = stage_inputs(st, dtype, dev, SEED + 100 + i)
            run, plain = _kernel_call(st, inputs), \
                (lambda st=st, inputs=inputs: _plain_call(st, inputs))
            nbytes, ops, rate = _work(st, dtype)
            b_ms, b_by = bound(nbytes, ops, rate)
            fma = ({"bound_fma_ms": bound(nbytes, ops)[0]}
                   if rate == FP32_TC_OPS_PER_S else {})
            lib, note = _library_call(st, inputs)
            library_ms = None
            if lib is not None:
                try:
                    want = plain()
                    got = lib()
                    _within(got, want, 3e-2 * (1 + want.double().abs()),
                            f"library {st['tag']}")
                    del want, got
                    library_ms = time_auto(lib)
                except (RuntimeError, AssertionError) as exc:
                    note += (f"; refused or off: {type(exc).__name__}: "
                             f"{str(exc).splitlines()[0][:160]}")
            by_kernel[launched_kernel(st["kernel"], dtype)].append(dict(
                stage=st["tag"], dtype=dtype,
                shape=f"{st['tag']}: {_stage_shape(st, dtype)}",
                ms=time_auto(run), plain_ms=time_auto(plain),
                bound_ms=b_ms, bound_by=b_by, **fma, bytes=nbytes,
                operations=ops, library_ms=library_ms, library_note=note))
            del inputs, run, plain, lib
            torch.cuda.empty_cache()
    rows = []
    for name, shapes in by_kernel.items():
        source, replaces = KERNEL_SOURCES[name]
        rows.append(dict(name=name, route="cuda", source=source,
                         replaces=replaces, launches=launches[name],
                         **shapes[0], max_abs_err=errors[name],
                         shapes=shapes))
        for s in shapes:
            lib = (f"{s['library_ms']:.4f}" if s["library_ms"] is not None
                   else f"null ({s['library_note']})")
            fma = (f"; {s['bound_fma_ms']:.4f} in FMAs"
                   if "bound_fma_ms" in s else "")
            log(f"  {name}: {s['ms']:.4f} ms (plain {s['plain_ms']:.4f}, "
                f"library {lib}, bound {s['bound_ms']:.4f} by "
                f"{s['bound_by']}{fma}) at {s['shape']}")
    return rows


# ---------------------------------------------------------------------------
# phase 6: kernel times at the main path's shapes
# ---------------------------------------------------------------------------
def _writer_segments(tasks, all_rows: bool):
    """A stage's writer combine as the backend runs it: per-row segment ids
    (np.unique's inverse over the written keys, in task order) and the
    segment count. With `all_rows` every task keeps a row and non-writers
    carry the id S (dropped), as on the fused path."""
    wk = tasks.write_keys
    live = wk >= 0
    uniq, inv = np.unique(wk[live], return_inverse=True)
    if not all_rows:
        return inv.astype(np.int32), uniq.size
    seg = np.full(wk.size, uniq.size, dtype=np.int32)
    seg[live] = inv
    return seg, uniq.size


def segment_combine_timing(dev, by: dict, launches: dict) -> dict:
    """K2 at three writer combines of the main path, float32 rows of width
    16 made from the seed: stage (a)'s add over Zipf-2.0 keys (the
    headline; library `index_add_`), stage (c)'s min over the fused
    stage's per-task rows (library `index_reduce_(..., "amin")` on the
    writer rows), stage (b)'s ordered write over uniform keys (no one
    PyTorch call keeps the lowest-priority row). Bounds: each input read
    once and each output written once (for write, only the winning rows
    are read), one operation per element merged."""
    import torch

    from repro_torch.kernels.segment_combine.ops import combine
    from repro_torch.kernels.segment_combine.ref import combine_ref, identity

    g = torch.Generator().manual_seed(SEED)
    shapes, err = [], 0.0
    for tag, op in (("a", "add"), ("c", "min"), ("b", "write")):
        tasks = by[tag]
        seg_np, S = _writer_segments(tasks, all_rows=tag == "c")
        N, W = seg_np.size, VALUE_WIDTH
        upd = torch.randn(N, W, generator=g).to(dev)
        seg = torch.from_numpy(seg_np).to(dev)
        order = (torch.from_numpy(tasks.priority[tasks.write_keys >= 0]
                                  .astype(np.int32)).to(dev)
                 if op == "write" else None)
        got = combine(upd, seg, S, op=op, order=order)
        want = combine_ref(upd, seg, S, op=op, order=order)
        if op == "add":
            err = max(err, _sum_bound_ok(
                got, want, combine_ref(upd.abs(), seg, S, op="add")))
        elif not torch.equal(got, want):
            raise AssertionError(f"segment_combine {op} at stage {tag} "
                                 "differs from the plain version")
        if op == "write":
            nbytes = 4 * N + 4 * N + 2 * 4 * S * W
        else:
            nbytes = 4 * N * W + 4 * N + 4 * S * W
        b_ms, b_by = bound(nbytes, N * W)
        library_ms, note = None, ("no one PyTorch call keeps each segment's "
                                  "row of lowest priority")
        if op == "add":
            acc = torch.zeros(S, W, device=dev)
            library_ms = time_ms(lambda: acc.index_add_(0, seg, upd))
            note = "Tensor.index_add_"
        elif op == "min":
            live = seg < S
            l_seg, l_upd = seg[live].long(), upd[live].contiguous()
            acc = torch.full((S, W), identity("min", upd.dtype), device=dev)
            lib = acc.clone().index_reduce_(0, l_seg, l_upd, "amin")
            if not torch.equal(lib, want):
                raise AssertionError("index_reduce_ amin differs from the "
                                     "plain version")
            library_ms = time_ms(
                lambda: acc.index_reduce_(0, l_seg, l_upd, "amin"))
            note = "Tensor.index_reduce_(..., 'amin') on the writer rows"
        shapes.append(dict(
            stage=tag, op=op, ms=time_ms(lambda: combine(
                upd, seg, S, op=op, order=order)),
            plain_ms=time_ms(lambda: combine_ref(upd, seg, S, op=op,
                                                 order=order)),
            bound_ms=b_ms, bound_by=b_by, bytes=nbytes, operations=N * W,
            library_ms=library_ms, library_note=note,
            shape=f"stage ({tag}): ({N}, {W}) float32 -> {S} segments, "
                  f"{op}"))
        del upd, seg, order
    for sh in shapes:
        lib = (f"{sh['library_ms']:.4f}" if sh["library_ms"] is not None
               else f"null ({sh['library_note']})")
        log(f"  segment_combine: {sh['ms']:.4f} ms (plain "
            f"{sh['plain_ms']:.4f}, library {lib}, bound "
            f"{sh['bound_ms']:.4f} by {sh['bound_by']}) at {sh['shape']}")
    head = shapes[0]
    return dict(name="segment_combine", route="cuda",
                source="src/repro_torch/csrc/segment_combine.cu",
                replaces="src/repro/kernels/segment_combine/kernel.py:42",
                launches=launches["segment_combine"], max_abs_err=err,
                **{k: head[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms", "shape")},
                shapes=shapes)


def device_ms(fn, reps: int = 20) -> tuple:
    """The device's own time for one `fn()` call: the summed durations of
    the device events (kernels, fills, copies) that torch.profiler records
    over `reps` calls, over `reps`; that time by event name; and how it was
    taken. Beside `time_ms`, which also counts the host's work for the call
    while the card waits. Where three profiler sessions record none of the
    calls' device events, the time is `queued_device_ms`'s instead."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a session now and then records no device events
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        if events and len(events) % reps == 0:  # every call's, or none
            break
        log(f"  the profiler saw {len(events)} device events over {reps} "
            "calls; profiling again")
    else:
        log("  the profiler missed the calls' device events three times; "
            "timing them queued behind a spin kernel")
        return queued_device_ms(fn, reps), {}, "events"
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start) / reps / 1e3
    return sum(by_name.values()), by_name, "profiler"


def queued_device_ms(fn, reps: int = 20) -> float:
    """Device time of one `fn()` call by CUDA events, none of the host's:
    the `reps` calls are issued while a spin kernel holds the stream, so
    the events bracket only the device's work for them (and the gaps
    between their launches)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # ~25 ms, far longer than issuing the calls
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int = 50) -> float:
    """Median host time to issue one `fn()` call (the card idle, nothing
    waited for): what the wrapper costs before the device starts."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    return float(np.median(times))


def _i32(a, dev):
    """A host integer array as a contiguous int32 tensor on `dev`."""
    import torch

    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)


def _call_times(fn) -> dict:
    """A kernel call's event time (`ms`: the call as a user makes it, host
    work included), its host time (`host_ms`) and its device time
    (`device_ms`; `device_events`: each device event's ms a call;
    `device_source`: "profiler", or "events" where it fell back to
    `queued_device_ms`). The host clock reads first, before the profiler
    has touched the process."""
    times = dict(ms=time_ms(fn, reps=20), host_ms=host_ms(fn))
    (times["device_ms"], times["device_events"],
     times["device_source"]) = device_ms(fn)
    return times


def _log_shapes(name: str, shapes: list) -> None:
    for s in shapes:
        lib = (f"{s['library_ms']:.4f}" if s["library_ms"] is not None
               else "null")
        events = (", ".join(f"{k} {v:.4f}" for k, v in
                            s["device_events"].items())
                  or "CUDA events, the calls queued behind a spin")
        log(f"  {name}: call {s['ms']:.4f} ms (host {s['host_ms']:.4f}), "
            f"device {s['device_ms']:.4f} ms ({events}), plain "
            f"{s['plain_ms']:.4f}, library {lib}, bound {s['bound_ms']:.4f} "
            f"by {s['bound_by']}; {s['launches']} launches on its path; at "
            f"{s['shape']}")


def _histogram_shape(label, ids, wts, bins: int, n_launch: int) -> dict:
    """K1 at one call: checked against its plain version exactly, then
    timed beside the plain version and `torch.bincount` with the same
    weights. Bound: ids (and weights) read once, the bins written once,
    one add an id."""
    import torch

    from repro_torch.kernels.histogram.ops import count_ids
    from repro_torch.kernels.histogram.ref import histogram_ref

    n = ids.numel()
    got = count_ids(ids, bins, weights=wts)
    if not torch.equal(got, histogram_ref(ids, bins, wts)):
        raise AssertionError(f"histogram at the {label} differs")
    b_ms, b_by = bound(4 * n * (1 + (wts is not None)) + 4 * bins, n)
    return dict(
        **_call_times(lambda: count_ids(ids, bins, weights=wts)),
        plain_ms=time_ms(lambda: histogram_ref(ids, bins, wts)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: torch.bincount(ids, weights=wts,
                                                  minlength=bins)),
        launches=n_launch,
        shape=f"{label}: ids ({n},) int32"
              f"{'' if wts is None else ' + weights'}, {bins} bins")


def histogram_timing(dev, K, by: dict, launches: dict, ps: dict,
                     ps_launches: dict) -> dict:
    """K1 at three root calls, each weighted by multiplicity as the engine
    passes it: stage (b)'s (800,000 uniform keys, every pair reaching the
    root unmerged, over 800,000 bins; the headline), the parameter-server
    lookup's (the distinct ids of 8,192 Zipf-1.2 ids over 49,155 bins) and
    a decode step's (the distinct experts of 1,024 assignments over 40
    bins); and at `embed_skew_aware`'s unweighted call on its raw 8,192
    Zipf-1.2 ids over the 49,155 bins, repeats and all (the hot id about a
    fifth of them), where atomics on one bin would serialize
    (`_histogram_shape`)."""
    keys = by["b"].read_keys
    ti = ps["routing"][1]
    cases = [("stage (b) root call", _i32(keys, dev),
              _i32(np.ones_like(keys), dev), K, launches["histogram"])]
    for label, ids, bins in (("lookup root call", ps["ids"], ps["store"].V),
                             ("decode step root call", ti[ti >= 0],
                              ps["router"].E)):
        uniq, cnt = np.unique(ids, return_counts=True)
        cases.append((label, _i32(uniq, dev), _i32(cnt, dev), bins,
                      ps_launches["histogram"]))
    cases.append(("skew-aware embedding's raw ids", _i32(ps["skew_ids"], dev),
                  None, ps["store"].V, ps_launches["histogram"]))
    shapes = [_histogram_shape(*case) for case in cases]
    _log_shapes("histogram", shapes)
    return dict(name="histogram", route="cuda",
                source="src/repro_torch/csrc/histogram.cu",
                replaces="src/repro/kernels/histogram/kernel.py:37",
                max_abs_err=0.0, **shapes[0], shapes=shapes)


def stage_fused_timing(dev, K, by: dict, init, launches: dict, ps: dict,
                       ps_launches: dict) -> dict:
    """K3's gather-reduce (read_op add) at stage (c) (800,000 tasks of
    arity 1-8 over the (800,000, 16) float32 store, Zipf-1.5 keys; the
    headline) and at the parameter-server bags (8,192 bags of arity 1-8,
    Zipf 1.2, over the 49,155 x 1536 float32 table). Library:
    `F.embedding_bag` (mode "sum"; empty bags give 0), checked against the
    plain version first. Bound: the distinct rows read once, indptr and
    indices read once, the output written once, one add a pair and
    column."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core import TorchBackend
    from repro_torch.kernels.stage_fused.ops import fused_reduce
    from repro_torch.kernels.stage_fused.ref import reduce_pairs_ref

    tc = by["c"]
    cases = [("stage (c)", torch.from_numpy(init.astype(np.float32)).to(dev),
              _i32(tc.read_indptr, dev), _i32(tc.read_indices, dev),
              launches["stage_fused"]),
             ("parameter-server bags",
              TorchBackend(device=dev).device_values(ps["store"].store),
              _i32(ps["bags"][0], dev), _i32(ps["bags"][1], dev),
              ps_launches["stage_fused"])]
    shapes, err = [], 0.0
    for label, vals, indptr, idx, n_launch in cases:
        want = reduce_pairs_ref(vals, indptr, idx, read_op="add")
        mags = reduce_pairs_ref(vals.abs(), indptr, idx, read_op="add")
        err = max(err, _sum_bound_ok(
            fused_reduce(vals, indptr, idx, read_op="add"), want, mags,
            name=f"stage_fused at {label}"))

        def bag(vals=vals, indptr=indptr, idx=idx):
            return F.embedding_bag(idx, vals, indptr, mode="sum",
                                   include_last_offset=True)

        _sum_bound_ok(bag(), want, mags, name=f"embedding_bag at {label}")
        del want, mags
        nt, nnz = indptr.numel() - 1, idx.numel()
        rows_read = int(torch.unique(idx).numel())
        w = vals.shape[1]
        b_ms, b_by = bound(4 * rows_read * w + 4 * (nt + 1) + 4 * nnz
                           + 4 * nt * w, nnz * w)
        shapes.append(dict(
            **_call_times(lambda: fused_reduce(vals, indptr, idx,
                                               read_op="add")),
            plain_ms=time_ms(lambda: reduce_pairs_ref(vals, indptr, idx,
                                                      read_op="add")),
            bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(bag),
            launches=n_launch,
            shape=f"{label}: {nt} tasks, {nnz} pairs over "
                  f"({vals.shape[0]}, {w}) float32, {rows_read} distinct "
                  "rows, read_op add"))
        torch.cuda.empty_cache()
    _log_shapes("stage_fused", shapes)
    return dict(name="stage_fused", route="cuda",
                source="src/repro_torch/csrc/stage_fused.cu",
                replaces="src/repro/kernels/stage_fused/kernel.py:162",
                max_abs_err=err, **shapes[0], shapes=shapes)


def timing_phase(dev, K, stages, init, launches, ps: dict,
                 ps_launches: dict) -> list:
    """K1-K3 at the main path's and the parameter-server path's shapes.
    A row's top-level numbers are its first shape's; `launches` there is
    the main path's count, a shape's own is its path's."""
    by = {s[0]: s[2] for s in stages}
    return [histogram_timing(dev, K, by, launches, ps, ps_launches),
            segment_combine_timing(dev, by, launches),
            stage_fused_timing(dev, K, by, init, launches, ps, ps_launches)]


# ---------------------------------------------------------------------------
# phase 7: how busy the card is during a stage
# ---------------------------------------------------------------------------
_OWN_KERNELS = ("hist_", "seg_combine", "write_gather", "fused_reduce")


def device_busy(name: str, run) -> dict:
    """Wall time of `run()` and the device's busy time in it, by
    torch.profiler: busy is the union of the device's own events (kernels,
    copies, fills), split into this port's kernels, host<->device copies
    and torch's other kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):  # a session now and then records no device events
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            time.sleep(PROFILE_PAD_S)
        spans = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        if spans:
            break
        log(f"  {name}: the profiler saw no device activity; profiling "
            "again")
    else:
        raise AssertionError(f"{name}: the profiler saw no device activity")
    busy_us, end = 0.0, -np.inf
    split = {"port_kernels_ms": 0.0, "copies_ms": 0.0,
             "other_device_ms": 0.0}
    for s, e, ev_name in spans:
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
        key = ("port_kernels_ms" if any(k in ev_name for k in _OWN_KERNELS)
               else "copies_ms" if ev_name.startswith("Memcpy")
               else "other_device_ms")
        split[key] += (e - s) / 1e3
    busy = busy_us / 1e6
    return dict(wall_s=wall, device_busy_s=busy,
                idle_share=1.0 - busy / wall, **split)


def _log_busy(label, row) -> None:
    log(f"  {label}: wall {row['wall_s']:.3f} s, device busy "
        f"{row['device_busy_s'] * 1e3:.2f} ms (idle "
        f"{row['idle_share']:.4f}); port kernels "
        f"{row['port_kernels_ms']:.3f} ms, copies {row['copies_ms']:.3f} "
        f"ms, other device work {row['other_device_ms']:.3f} ms")


def busy_phase(K, stages, init) -> list:
    """Device busy and idle share of stages (a)-(c) on the torch backend
    (`device_busy`), in a second run of each stage (the first one uploads
    the store)."""
    import torch

    from repro_torch.core import DataStore, Orchestrator

    rows = []
    for name, desc, tasks, f, merge, rep, _ in stages:
        if name == "d":
            continue
        st = DataStore.create(K, P, value_width=VALUE_WIDTH)
        st.write_rows(np.arange(K), init)
        sess = Orchestrator(st, backend="torch", replication=rep)
        sess.run_stage(tasks, f, write_back=merge, return_results=True)
        torch.cuda.synchronize()
        row = dict(stage=name, desc=desc, **device_busy(
            f"stage {name}", lambda: sess.run_stage(
                tasks, f, write_back=merge, return_results=True)))
        _log_busy(f"stage {name} ({desc})", row)
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# phase 8: the other engines and multi-round plans
# ---------------------------------------------------------------------------
ENGINES = ("pull", "push", "sort", "auto")
# launches of each kernel in stages (a)-(c) under each fixed engine: the
# baselines never call Phase 1's histogram, every stage's writer combine is
# one K2 and the ragged stage (c) one K3; TD-Orch's are phase 3's
ENGINE_EXPECTED = {
    **{eng: {"a": _launch(segment_combine=1),
             "b": _launch(segment_combine=1),
             "c": _launch(segment_combine=1, stage_fused=1)}
       for eng in ("pull", "push", "sort")},
    "tdorch": {k: EXPECTED_LAUNCHES[k] for k in "abc"},
}
# engine="auto" replays every candidate's bill before it runs the stage on
# the one it picks: TD-Orch's replay makes its Phase-1 root call, which
# launches K1 where phase 3's TD-Orch stage does, at (b)
AUTO_ESTIMATE = {"a": _launch(), "b": _launch(histogram=1), "c": _launch()}


def _plus(x: dict, y: dict) -> dict:
    return {k: x[k] + y[k] for k in x}


def _torch_backend(device: str, **kw):
    from repro_torch.core import TorchBackend

    return TorchBackend(**kw) if device == "cuda" \
        else TorchBackend(device=device, **kw)


def _same_decisions(name, a, b) -> None:
    """engine="auto": the torch session's decision ledger equal to the
    numpy session's (chosen engine, every candidate's predicted bill)."""
    ka = [(d.choice, d.predicted, d.predicted_words, d.switched)
          for d in a.report.policy_decisions]
    kb = [(d.choice, d.predicted, d.predicted_words, d.switched)
          for d in b.report.policy_decisions]
    if ka != kb:
        raise AssertionError(f"{name}: policy decisions differ: {ka} / {kb}")


def engines_path(device: str = "cuda", tpm: int = TASKS_PER_MACHINE):
    """Stages (a)-(c) of phase 3 through `Orchestrator(engine=e)` for every
    e of ENGINES, one session a backend and engine (the stages chain, so
    `auto`'s hysteresis sees its incumbent), on the card and on a copy of
    the store through the numpy oracle. Each stage is held to the oracle as
    in phase 3; under `auto` the decisions must be the oracle's too. Returns
    (one row a stage, the launches expected of each stage)."""
    from repro_torch.core import DataStore, Orchestrator

    K, stages = make_stages(tpm)
    init = np.random.default_rng(SEED + 1).standard_normal((K, VALUE_WIDTH))
    expected: dict = {}
    st = _Stages(device, expected)
    for eng in ENGINES:
        st_dev = DataStore.create(K, P, value_width=VALUE_WIDTH)
        st_ora = DataStore.create(K, P, value_width=VALUE_WIDTH)
        st_dev.write_rows(np.arange(K), init)
        s_dev = Orchestrator(st_dev, engine=eng,
                             backend=_torch_backend(device))
        s_ora = Orchestrator(st_ora, engine=eng, backend="numpy")
        _timed_backend(s_dev.backend)
        for name, desc, tasks, f, merge, _, _ in stages:
            if name not in "abc":
                continue
            tag = f"{eng}/{name}"
            st_ora.write_rows(np.arange(K), st_dev.values)
            old = st_ora.values.copy()
            mags = term_magnitudes(tasks, old, "fused" if tasks.max_arity > 1
                                   else "muladd")
            # the oracle first: under auto its decision names the engine
            # whose launches the torch stage must show
            t0 = time.perf_counter()
            r_ora = s_ora.run_stage(tasks, f, write_back=merge,
                                    return_results=True)
            wall_ora = time.perf_counter() - t0
            choice = r_ora.decision.choice if eng == "auto" else eng
            expected[tag] = ENGINE_EXPECTED[choice][name]
            if eng == "auto":
                expected[tag] = _plus(expected[tag], AUTO_ESTIMATE[name])
            s_dev.backend.numerics_s = 0.0
            r_dev = st.run(tag, lambda: s_dev.run_stage(
                tasks, f, write_back=merge, return_results=True),
                desc=desc, tasks=tasks.n, pairs=tasks.nnz)
            row = st.rows[-1]
            if s_dev.backend._host_lambdas:
                raise AssertionError(f"{tag}: a lambda fell back to the "
                                     "host path")
            _same_bill(tag, r_dev, r_ora)
            if eng == "auto":
                _same_decisions(tag, s_dev, s_ora)
            res_err = _sum_bound_ok(
                np.asarray(r_dev.results, dtype=np.float64),
                np.asarray(r_ora.results, dtype=np.float64), mags,
                rel_want=1e-5, name=f"{tag} results")
            val_err, val_share = _check_values(
                tag, st_dev.values, st_ora.values, old, tasks, mags, merge)
            wall, numerics = row["wall_s"], s_dev.backend.numerics_s
            row.update(engine=eng, chosen=choice, numerics_s=numerics,
                       host_cost_model_s=wall - numerics,
                       oracle_wall_s=wall_ora, max_result_err=res_err,
                       max_value_err=val_err,
                       max_value_err_share_of_tolerance=val_share)
            log(f"  {tag}{f' (chose {choice})' if eng == 'auto' else ''}: "
                f"wall {wall:.3f} s = host {wall - numerics:.3f} + backend "
                f"calls {numerics:.3f} (oracle {wall_ora:.3f} s); max |Δ| "
                f"results {res_err:.3g}, store {val_err:.3g} ({val_share:.3g}"
                f" of its tolerance); signature/refcount/exec_site"
                f"{'/decisions' if eng == 'auto' else ''} equal; launches "
                f"{ {k: v for k, v in row['launches'].items() if v} }")
    return st.rows, expected


# benchmarks/bench_plan.py's two cells at their full sizes, engine "pull"
PLAN_SEED = 23
PLAN_P = 8
PLAN_ROUNDS = 10
ALPHA = 0.85


def _f_contrib(ctx, vals):
    """rank-bank gather × (alpha/deg) per edge task."""
    return {"update": vals * ctx[:, 0:1]}


def _f_apply(ctx, vals):
    """rank' = (1-alpha)/n + acc for the rank half; 0 for the acc reset."""
    return {"update": ctx[:, 0:1] + vals * ctx[:, 1:2]}


def _f_bfs(ctx, vals):
    """distance candidate = the round number riding in the context."""
    return {"update": ctx[:, 0:1] + vals * 0.0}


def pagerank_stages(n: int) -> dict:
    """bench_plan's pagerank_stages: power iteration over a two-bank store
    (ranks, accumulators), two stages a round of fixed shapes and no user
    callback; PLAN_ROUNDS rounds on a Barabási-Albert graph (attach 8)."""
    from repro_torch.core import DataStore, StagePlan, TaskBatch
    from repro_torch.graph import generators

    g = generators.barabasi_albert(n, 8, seed=PLAN_SEED)
    deg = np.bincount(g.src, minlength=n).astype(np.float64)
    ctx_a = np.where(deg[g.src] > 0, ALPHA / np.maximum(deg[g.src], 1.0),
                     0.0)[:, None]
    batch_a = TaskBatch(contexts=ctx_a, read_keys=g.src, write_keys=n + g.dst,
                        origin=TaskBatch.even_origins(g.m, PLAN_P))
    ctx_rank = np.zeros((n, 2))
    ctx_rank[:, 0] = (1.0 - ALPHA) / n
    ctx_rank[:, 1] = 1.0
    batch_b = TaskBatch.concat([
        TaskBatch(contexts=ctx_rank, read_keys=np.arange(n) + n,
                  write_keys=np.arange(n, dtype=np.int64),
                  origin=TaskBatch.even_origins(n, PLAN_P)),
        TaskBatch(contexts=np.zeros((n, 2)),
                  read_keys=np.full(n, -1, dtype=np.int64),
                  write_keys=np.arange(n, dtype=np.int64) + n,
                  origin=TaskBatch.even_origins(n, PLAN_P))])

    def fresh():
        store = DataStore.create(2 * n, PLAN_P, value_width=1, chunk_words=1)
        vals = np.zeros((2 * n, 1))
        vals[:n] = 1.0 / n
        store.write_rows(np.arange(2 * n), vals)
        return store

    def loop(sess, store):
        for _ in range(PLAN_ROUNDS):
            sess.run_stage(batch_a, _f_contrib, "add")
            sess.run_stage(batch_b, _f_apply, "write")
        return PLAN_ROUNDS

    plan = StagePlan("pagerank-stages").loop(
        StagePlan().stage(batch_a, _f_contrib, "add")
                   .stage(batch_b, _f_apply, "write"),
        until=None, max_rounds=PLAN_ROUNDS)

    # float32 sums of nonnegative terms: a round adds at most (k + 3)·2^-24
    # to a rank's relative error for k in-edges (the context's and the
    # product's roundings, k - 1 adds in any order, the base's rounding and
    # its add), so R rounds at most R·(max in-degree + 3)·2^-24, plus
    # 2^-24 for the first ranks' rounding
    rel = (PLAN_ROUNDS * (int(np.bincount(g.dst, minlength=n).max()) + 3)
           + 1) * 2.0 ** -24
    # no user callback reads the host: the plan flushes once, at its exit
    return dict(name="pagerank_stages", fresh=fresh, loop=loop,
                plan=lambda sess, store: sess.run_plan(plan).rounds,
                stages_a_round=2, values=lambda store: store.values[:n, 0],
                rel=rel, fewer_syncs=True,
                desc=f"BA n={n} m={g.m}, {PLAN_ROUNDS} rounds")


def bfs_stages(n: int) -> dict:
    """bench_plan's bfs_stages from source 0: frontier BFS with a min merge
    over per-round edge batches whose sizes drift; the plan's emission reads
    the host values once a round. Barabási-Albert graph (attach 4)."""
    from repro_torch.core import CARRY, StagePlan, TaskBatch, DataStore
    from repro_torch.graph import generators

    g = generators.barabasi_albert(n, 4, seed=PLAN_SEED + 1)
    order = np.argsort(g.src, kind="stable")
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, g.src + 1, 1)
    np.cumsum(indptr, out=indptr)
    out_dst = g.dst[order]
    inf = float(n + 10)

    def frontier_batch(frontier, rnd):
        counts = indptr[frontier + 1] - indptr[frontier]
        total = int(counts.sum())
        if total == 0:
            return None
        offs = np.repeat(np.cumsum(counts) - counts, counts)
        flat = np.repeat(indptr[frontier], counts) \
            + np.arange(total, dtype=np.int64) - offs
        return TaskBatch(contexts=np.full((total, 1), float(rnd)),
                         read_keys=np.full(total, -1, dtype=np.int64),
                         write_keys=out_dst[flat],
                         origin=TaskBatch.even_origins(total, PLAN_P))

    def fresh():
        store = DataStore.create(n, PLAN_P, value_width=1, chunk_words=1)
        vals = np.full((n, 1), inf)
        vals[0] = 0.0
        store.write_rows(np.arange(n), vals)
        return store

    def loop(sess, store):
        rnd, batch = 1, frontier_batch(np.array([0]), 1)
        while batch is not None:
            sess.run_stage(batch, _f_bfs, "min")
            newly = np.flatnonzero(store.values[:, 0] == rnd)
            rnd += 1
            batch = frontier_batch(newly, rnd) if newly.size else None
        return rnd - 1

    def plan(sess, store):
        def emit(state, res):
            newly = np.flatnonzero(store.values[:, 0] == state.round + 1)
            return (frontier_batch(newly, state.round + 2) if newly.size
                    else None)

        plan = StagePlan("bfs-stages").loop(
            StagePlan().stage(CARRY, _f_bfs, "min", emit=emit),
            until="empty", max_rounds=n)
        return sess.run_plan(plan, carry=frontier_batch(np.array([0]),
                                                        1)).rounds

    # the emission reads the host values every round: a flush a round, as
    # many host syncs as the loop's write-back of its one stage
    return dict(name="bfs_stages", fresh=fresh, loop=loop, plan=plan,
                stages_a_round=1, values=lambda store: store.values[:, 0],
                rel=0.0, fewer_syncs=False,
                desc=f"BA n={n} m={g.m}, source 0")


def plans_path(device: str = "cuda", n_pagerank: int = 50_000,
               n_bfs: int = 100_000):
    """Each plan cell three ways, one session each over a fresh store,
    engine "pull": `run_plan` on the card, the same `run_stage` loop on the
    card, `run_plan` on the numpy oracle. The three session reports must be
    equal (`assert_session_parity`), the values within the cell's reckoned
    tolerance of the oracle's (BFS exact), the plan at most one host sync a
    round and no more than the loop (fewer where no callback reads the
    host); each stage launches one K2."""
    import torch

    from repro_torch.core import Orchestrator, assert_session_parity

    rows, expected = [], {}
    st = _Stages(device, expected)
    for cell in (pagerank_stages(n_pagerank), bfs_stages(n_bfs)):
        name, runs = cell["name"], {}
        for mode, backend, drive in (
                ("numpy", "numpy", cell["plan"]),
                ("plan", _torch_backend(device), cell["plan"]),
                ("loop", _torch_backend(device), cell["loop"])):
            store = cell["fresh"]()
            sess = Orchestrator(store, engine="pull", backend=backend)
            before = sess.backend.host_syncs
            tag = f"{name}/{mode}"
            if mode == "numpy":
                t0 = time.perf_counter()
                rounds = drive(sess, store)
                wall = time.perf_counter() - t0
            else:
                expected[tag] = _launch(segment_combine=cell["stages_a_round"]
                                        * runs["numpy"]["rounds"])
                rounds = st.run(tag, lambda: drive(sess, store))
                wall = st.rows[-1]["wall_s"]
                if sess.backend._host_lambdas:
                    raise AssertionError(f"{tag}: a lambda fell back to the "
                                         "host path")
            runs[mode] = dict(rounds=rounds, wall_s=wall,
                                syncs=sess.backend.host_syncs - before,
                                report=sess.report,
                                values=cell["values"](store).copy())
        want = runs["numpy"]
        for mode in ("plan", "loop"):
            got = runs[mode]
            if got["rounds"] != want["rounds"]:
                raise AssertionError(f"{name}/{mode}: {got['rounds']} "
                                     f"rounds, oracle {want['rounds']}")
            assert_session_parity(got["report"], want["report"])
            err = np.abs(got["values"] - want["values"])
            allowed = cell["rel"] * np.abs(want["values"])
            if not (err <= allowed).all():
                i = int(np.argmax(err - allowed))
                raise AssertionError(
                    f"{name}/{mode}: value {i} {got['values'][i]} against "
                    f"{want['values'][i]} (allowed {allowed[i]})")
            got["max_abs_err"] = float(err.max(initial=0.0))
            got["err_share"] = float((err / np.maximum(allowed, 1e-300))
                                     .max(initial=0.0)) if cell["rel"] else 0.0
        rounds = want["rounds"]
        spr = {d: runs[d]["syncs"] / rounds for d in ("plan", "loop")}
        if spr["plan"] > 1.0:
            raise AssertionError(f"{name}: {spr['plan']} host syncs a round "
                                 "under the plan")
        if spr["plan"] > spr["loop"] or (cell["fewer_syncs"]
                                         and spr["plan"] >= spr["loop"]):
            raise AssertionError(f"{name}: the plan syncs {spr['plan']} a "
                                 f"round, the loop {spr['loop']}")
        row = dict(cell=name, desc=cell["desc"], rounds=rounds,
                   **{f"{d}_{k}": runs[d][k] for d in runs
                      for k in ("wall_s", "syncs")},
                   host_syncs_a_round=spr,
                   max_abs_err={d: runs[d]["max_abs_err"]
                                for d in ("plan", "loop")},
                   err_share_of_tolerance={d: runs[d]["err_share"]
                                           for d in ("plan", "loop")})
        rows.append(row)
        log(f"  {name} ({cell['desc']}): {rounds} rounds; wall plan "
            f"{runs['plan']['wall_s']:.3f} s, loop {runs['loop']['wall_s']:.3f}"
            f" s (numpy plan {runs['numpy']['wall_s']:.3f} s); host syncs a "
            f"round plan {spr['plan']:.3f}, loop {spr['loop']:.3f}; reports "
            f"equal; max |Δ| plan {runs['plan']['max_abs_err']:.3g}, loop "
            f"{runs['loop']['max_abs_err']:.3g}")
        if device == "cuda":
            torch.cuda.empty_cache()
    return rows, expected


# ---------------------------------------------------------------------------
# phase 9: TDO-GP on the card
# ---------------------------------------------------------------------------
# Graph500's scale-20 problem cut to scale 19 (2^19 vertices: at 2^20 the
# host's cost model and oracle combines take phase 9 past 6 minutes), at
# average degree 16 (Graph500: 32) and with Erdős-Rényi / star /
# Barabási-Albert graphs standing in for its Kronecker generator; P = 16,
# as benchmarks/bench_graph.py
GRAPH_SCALE = 19
GRAPH_P = 16
GRAPH_BA_N = 30_000  # bench_graph's full size
INGEST_ARRAYS = ("vertex_home", "edge_machine", "out_indptr", "out_edges",
                 "in_indptr", "in_edges", "src_grp_indptr",
                 "src_grp_machines", "dst_grp_indptr", "dst_grp_machines")
PAGERANK_ROUNDS = 10
# the float64 PageRank's ranks against the oracle's
PAGERANK_F64_ABS = 1e-12
BC_REL = 1e-9
# one kernel on the graph path: the ingest stage's Phase-1 root call
GRAPH_EXPECTED_INGEST = _launch(histogram=1)


def graph_specs(scale: int = GRAPH_SCALE, ba_n: int = GRAPH_BA_N) -> list:
    from repro_torch.graph import barabasi_albert, erdos_renyi, star_graph

    return [("er", lambda: erdos_renyi(2 ** scale, avg_degree=16, seed=2)),
            ("star", lambda: star_graph(2 ** scale)),
            ("ba", lambda: barabasi_albert(ba_n, attach=8, seed=1))]


def _algorithms() -> list:
    from repro_torch.graph import bc, bfs, cc, pagerank, sssp

    return [("bfs", lambda og, **kw: bfs(og, 0, **kw)),
            ("sssp", lambda og, **kw: sssp(og, 0, **kw)),
            ("cc", lambda og, **kw: cc(og, **kw)),
            ("pagerank", lambda og, **kw: pagerank(
                og, max_iter=PAGERANK_ROUNDS, tol=0.0, **kw)),
            ("bc", lambda og, **kw: bc(og, 0, **kw))]


def _measured_combines(be, unit: float, log_rows: list) -> None:
    """Measure every `combine_by_key` call that takes the device route
    (`sorted_segment_sum`: one counted host sync) against the exact float64
    segment sums of the same inputs, beside a rounding model of a prefix
    sum in the backend's dtype (unit roundoff `unit`): a segment's error at
    most unit·((k + 4)·M + Σ|its terms|), M the prefix's magnitude at its
    end and k its terms (a sequential scan's k adds, or a blocked scan's
    two end adds, one carry and partials below M). The card's scan exceeds
    that model (PERF.md §6), and no bound that holds for any scan
    order is smaller than the ranks themselves, so the model's share is
    reported, not gated: the float64 run's ranks are the gate. Appends
    (max |Δ|, share of the model) a device call."""
    inner = be.combine_by_key

    def combine(values, keys, num_keys, merge, order):
        syncs = be.host_syncs
        uniq, got = inner(values, keys, num_keys, merge, order)
        if be.host_syncs == syncs:
            return uniq, got
        v = np.asarray(values, dtype=np.float64)[:, 0]
        exact = np.bincount(keys, weights=v, minlength=num_keys)[uniq]
        seg_mag = np.bincount(keys, weights=np.abs(v),
                              minlength=num_keys)[uniq]
        k = np.bincount(keys, minlength=num_keys)[uniq]
        model = unit * ((k + 4.0) * np.cumsum(seg_mag) + seg_mag)
        err = np.abs(got[:, 0] - exact)
        if not np.isfinite(got).all():
            raise AssertionError("device edge combine: a sum is not finite")
        log_rows.append((float(err.max(initial=0.0)), float(
            (err / np.maximum(model, 1e-300)).max(initial=0.0))))
        return uniq, got

    be.combine_by_key = combine


def _check_algorithm(tag, name, got, want, info_t, info_n) -> dict:
    if info_t.rounds != info_n.rounds:
        raise AssertionError(f"{tag}: {info_t.rounds} rounds, oracle "
                             f"{info_n.rounds}")
    sig_t = [s.report.phase_signature() for s in info_t.stats]
    sig_n = [s.report.phase_signature() for s in info_n.stats]
    if sig_t != sig_n:
        raise AssertionError(f"{tag}: a round's phase_signature differs")
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        raise AssertionError(f"{tag}: shape {got.shape}, want {want.shape}")
    if name in ("bfs", "sssp", "cc"):
        if not np.array_equal(got, want):
            raise AssertionError(f"{tag}: values differ from the oracle's")
        return dict(max_abs_err=0.0)
    err = np.abs(got - want)
    if name == "bc":
        allowed = BC_REL * (1.0 + np.abs(want))
        if not (err <= allowed).all():
            raise AssertionError(f"{tag}: max |Δ| {err.max()} beyond "
                                 f"{BC_REL}·(1+|ref|)")
    return dict(max_abs_err=float(err.max(initial=0.0)),
                max_rel_err=float((err / np.maximum(np.abs(want), 1e-300))
                                  .max(initial=0.0)),
                l1_err=float(err.sum()))


def graph_path(device: str = "cuda", scale: int = GRAPH_SCALE,
               ba_n: int = GRAPH_BA_N):
    """TDO-GP on the card: each graph ingested at P=16 (seed 0, weights
    from seed 3) on the card and through the numpy oracle, then BFS, SSSP,
    CC, PageRank (10 rounds, tol 0) and BC from vertex 0 both ways; on the
    Erdős-Rényi graph PageRank once more in float64. Returns (rows, the
    launches expected of each stage, the ingest's Phase-1 root call on the
    Erdős-Rényi graph: keys, bins, weights)."""
    import torch

    from repro_torch.graph import ingest

    rows, expected, root_call = [], {}, None
    st = _Stages(device, expected)
    for gname, make in graph_specs(scale, ba_n):
        t0 = time.perf_counter()
        g = make().with_weights(seed=3)
        log(f"  graph {gname}: n {g.n}, m {g.m} (made in "
            f"{time.perf_counter() - t0:.2f} s)")
        be = _torch_backend(device)
        _timed_backend(be)
        calls = []
        counts = be.key_counts

        def recorded(keys, num_keys, weights=None, _inner=counts):
            calls.append((np.asarray(keys), num_keys, weights))
            return _inner(keys, num_keys, weights)

        be.key_counts = recorded
        tag = f"ingest/{gname}"
        expected[tag] = GRAPH_EXPECTED_INGEST
        og_t = st.run(tag, lambda: ingest(g, GRAPH_P, seed=0, backend=be))
        wall = st.rows[-1]["wall_s"]
        if be._host_lambdas:
            raise AssertionError(f"{tag}: the ingest lambda fell back to the "
                                 "host path")
        t0 = time.perf_counter()
        og_n = ingest(g, GRAPH_P, seed=0, backend="numpy")
        wall_ora = time.perf_counter() - t0
        for arr in INGEST_ARRAYS:
            if not np.array_equal(getattr(og_t, arr), getattr(og_n, arr)):
                raise AssertionError(f"{tag}: {arr} differs")
        if og_t.ingest_report.phase_signature() \
                != og_n.ingest_report.phase_signature():
            raise AssertionError(f"{tag}: phase_signature differs")
        if gname == "er":
            root_call = calls[0]
        st.rows[-1].update(graph=gname, n=g.n, m=g.m,
                           numerics_s=be.numerics_s,
                           host_s=wall - be.numerics_s, oracle_wall_s=wall_ora,
                           root_call_ids=int(calls[0][0].size))
        log(f"  {tag}: wall {wall:.3f} s = host (cost model, trees, CSR) "
            f"{wall - be.numerics_s:.3f} + backend calls "
            f"{be.numerics_s:.3f} (oracle {wall_ora:.3f} s); root call "
            f"{calls[0][0].size} ids over {calls[0][1]} bins; arrays and "
            f"signature equal")
        del calls
        runs = [(name, alg, {}) for name, alg in _algorithms()]
        if gname == "er":
            runs.append(("pagerank", _algorithms()[3][1],
                         dict(dtype="float64")))
        oracle = {}  # the float64 PageRank is held to the same oracle run
        for name, alg, kw in runs:
            tag = f"{name}{'_f64' if kw else ''}/{gname}"
            be_a = _torch_backend(device, **kw)
            combines: list = []
            if name == "pagerank":
                _measured_combines(
                    be_a, 2.0 ** (-53 if kw else -24), combines)
            expected[tag] = _launch()
            got, info_t = st.run(tag, lambda: alg(og_t, backend=be_a))
            wall = st.rows[-1]["wall_s"]
            if name not in oracle:
                t0 = time.perf_counter()
                oracle[name] = (*alg(og_n, backend="numpy"),
                                time.perf_counter() - t0)
            want, info_n, wall_ora = oracle[name]
            res = _check_algorithm(tag, name, got, want, info_t, info_n)
            res["device_rounds"] = be_a.host_syncs
            if name == "pagerank":
                if len(combines) != be_a.host_syncs:
                    raise AssertionError(f"{tag}: unmeasured device rounds")
                res.update(combine_max_abs_err=max(
                    (c[0] for c in combines), default=0.0),
                    combine_model_share=max((c[1] for c in combines),
                                            default=0.0))
                if kw and res["max_abs_err"] > PAGERANK_F64_ABS:
                    raise AssertionError(f"{tag}: max |Δ| "
                                         f"{res['max_abs_err']} beyond "
                                         f"{PAGERANK_F64_ABS}")
            st.rows[-1].update(graph=gname, algorithm=name,
                               rounds=info_t.rounds, oracle_wall_s=wall_ora,
                               **res)
            extra = ""
            if name == "pagerank":
                extra = (f"; device combines max |Δ| "
                         f"{res['combine_max_abs_err']:.3g}, "
                         f"{res['combine_model_share']:.3g} of the rounding "
                         f"model; ranks max |Δ| {res['max_abs_err']:.3g} "
                         f"(max relative {res['max_rel_err']:.3g}), L1 "
                         f"{res['l1_err']:.3g}"
                         + (f", gate {PAGERANK_F64_ABS}" if kw else ""))
            elif name == "bc":
                extra = f"; max |Δ| {res['max_abs_err']:.3g}"
            log(f"  {tag}: {info_t.rounds} rounds, wall {wall:.3f} s "
                f"(oracle {wall_ora:.3f} s), {be_a.host_syncs} rounds on "
                f"the device route of combine_by_key; rounds and "
                f"signatures equal{'' if name in ('pagerank', 'bc') else ', values exact'}"
                f"{extra}")
        del og_t, og_n, g
        if device == "cuda":
            torch.cuda.empty_cache()
    return st.rows, expected, root_call


def ingest_histogram_timing(dev, call, launches: int) -> dict:
    """K1 at the Erdős-Rényi ingest's Phase-1 root call (every edge's
    source, weighted by the meta-task counts the engine passes, over
    2^GRAPH_SCALE bins): the largest n >> bins call of any path."""
    keys, bins, weights = call
    shape = _histogram_shape("ingest root call", _i32(keys, dev),
                             _i32(weights, dev), bins, launches)
    _log_shapes("histogram", [shape])
    return shape


# ---------------------------------------------------------------------------
# phase 10: the KV store and the streaming serve tier
# ---------------------------------------------------------------------------
# benchmarks/bench_ycsb.py's full setting (P = 16, 50,000 tasks a machine,
# 16 keys a task, rows of 16 words) and benchmarks/bench_serve.py's stream
# (Zipf 1.5, 10% read-modify-writes of (1.0, 0.5), its open-loop window)
SERVE_P = 16
SERVE_TPM = 50_000
SERVE_KEYS = 16 * SERVE_TPM  # 800,000 rows of 16: 51 MB of float32
SERVE_WIDTH = 16
SERVE_GAMMA = 1.5
SERVE_SEED = 29
MGET_N = 100_000  # one-shot multi-get tasks, arity 1-8
CHAIN_N = 100_000  # one-shot read-modify-write chains
CHAIN_HOPS = 4
STREAM_N = 65_536  # sync-mode GET / RMW requests
STREAM_MGETS = 4_096  # sync-mode multi-gets, arity 1-8
STREAM_BATCHES = (256, 8_192)
THREAD_N = 20_000  # bench_serve's open-loop count
THREAD_LOAD = 0.8  # offered: this share of the sync rate at max_batch 256
THREAD_TURNS = (True, False, False, True)  # prefetch on / off, in turns
THREAD_WINDOW = {"max_batch": 256, "min_window": 100e-6,
                 "max_window": 5e-3, "max_queue": 1 << 15}
RMW_OPERAND = (1.0, 0.5)
FRONT_T = 128  # tokens through MoEFrontend
FRONT_N = 8_192  # lookups, bags and gradient pushes a front door's stage

# launches of the one-shot stages: K2 for every write merge (each YCSB batch,
# each chain hop); no K1, as every Phase-1 root call here covers fewer than
# an eighth of the 800,000 keys (the backend's host cutoff), and no K3, as
# the KV lambdas are not fused reads
SERVE_EXPECTED = {
    "ycsb_A": _launch(segment_combine=1),
    "ycsb_B": _launch(segment_combine=1),
    "multi_get": _launch(),
    "chain": _launch(segment_combine=CHAIN_HOPS),
    "moe_front": _launch(histogram=1), "moe_shot": _launch(histogram=1),
    "embed_front": _launch(histogram=2, stage_fused=1, segment_combine=1),
    "embed_shot": _launch(histogram=2, stage_fused=1),
}
# launches of one streamed batch, by kind: a GET / RMW batch with a writer
# combines once (K2); the GETs-only batch and the multi-gets launch nothing
# (their Phase-1 calls cover at most 8,192 keys of 800,000: the host route)
SERVE_BATCH = {"kv_write": _launch(segment_combine=1), "kv_read": _launch(),
               "mget": _launch()}


def _capture(sess) -> list:
    """The OrchestrationResult of every stage `sess` runs from now on (for
    `exec_site`, which the kvstore results do not carry)."""
    box, inner = [], sess.run_stage

    def run_stage(*a, **k):
        res = inner(*a, **k)
        box.append(res)
        return res

    sess.run_stage = run_stage
    return box


def _kv_table(device, K, init):
    from repro_torch.kvstore import DistributedHashTable

    t = DistributedHashTable(K, SERVE_P, value_width=SERVE_WIDTH,
                             seed=SERVE_SEED)
    t.bulk_load(np.arange(K), init)
    return t


def _card_backend(device):
    """None (the entry points' default: the card) on the card; the plain
    versions on the CPU for a rehearsal."""
    from repro_torch.core import TorchBackend

    return None if device == "cuda" else TorchBackend(device=device)


def _no_host_route(name, table) -> None:
    for sess in table._sessions.values():
        be = sess.backend
        if getattr(be, "_host_lambdas", None):
            raise AssertionError(f"{name}: a lambda fell back to the host")


def _results_close(name, got, want) -> float:
    """Fetched rows, float32 of the float64 rows: |Δ| <= 1e-6·|want| +
    1e-6 (one rounding is 2^-24·|want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return _sum_bound_ok(got, want, np.abs(want), name=name)


def kv_one_shot(device, st, K, tpm, n_mget, n_chain, init) -> dict:
    """execute_batch (YCSB A and B), multi_get and run_chain through the
    table's entry points on the card, each against the numpy backend on a
    twin table that starts from the card table's values (so each check sees
    one stage's rounding): bills, refcounts and exec sites exactly, values
    within `_check_values`' gates; execute_batch also against
    `DistributedHashTable.oracle`."""
    from repro_torch.kvstore import DistributedHashTable, make_ycsb_stream
    from repro_torch.kvstore.ycsb import zipf_keys_stationary

    be = _card_backend(device)
    t_dev, t_ora = _kv_table(device, K, init), _kv_table(device, K, init)
    box_dev = _capture(t_dev.session(backend=be))
    box_ora = _capture(t_ora.session(backend="numpy"))
    out = {}

    def twin():
        t_ora.store.write_rows(np.arange(K), t_dev.values)
        box_dev.clear()
        box_ora.clear()
        return t_dev.values.copy()

    def same_sites(tag):
        if len(box_dev) != len(box_ora) or not all(
                np.array_equal(a.exec_site, b.exec_site)
                for a, b in zip(box_dev, box_ora)):
            raise AssertionError(f"{tag}: exec_site differs")

    for wl in ("A", "B"):
        tag = f"ycsb_{wl}"
        keys, is_read, operand = next(make_ycsb_stream(
            wl, tpm, SERVE_P, K, SERVE_GAMMA, SERVE_SEED))
        old = twin()
        r_dev = st.run(tag, lambda: t_dev.execute_batch(
            keys, is_read, operand, backend=be), tasks=keys.size)
        t0 = time.perf_counter()
        r_ora = t_ora.execute_batch(keys, is_read, operand, backend="numpy")
        st.rows[-1]["oracle_wall_s"] = time.perf_counter() - t0
        _same_bill(tag, r_dev, r_ora)
        same_sites(tag)
        tasks = t_dev._make_batch(keys, is_read, operand, None)
        mags = np.abs(old[keys]) * np.abs(operand[:, 0:1]) \
            + np.abs(operand[:, 1:2])
        err = _results_close(tag, r_dev.values, r_ora.values)
        _check_values(tag, t_dev.values, t_ora.values, old, tasks, mags,
                      "write")
        want_vals, want_res = DistributedHashTable.oracle(
            old, keys, is_read, operand)
        _results_close(f"{tag} oracle", r_dev.values, want_res)
        val_err, share = _check_values(f"{tag} oracle", t_dev.values,
                                       want_vals, old, tasks, mags, "write")
        st.rows[-1].update(max_result_err=err, max_value_err=val_err,
                           max_value_err_share_of_tolerance=share,
                           reads=int(is_read.sum()))
        out[tag] = _log_one_shot(st.rows[-1], f"{keys.size} operations, "
                                 f"{int(is_read.sum())} reads")

    rng = np.random.default_rng(SERVE_SEED + 1)
    perm = rng.permutation(K)
    arity = rng.integers(1, 9, n_mget)
    indptr = np.zeros(n_mget + 1, dtype=np.int64)
    np.cumsum(arity, out=indptr[1:])
    indices = zipf_keys_stationary(int(indptr[-1]), K, SERVE_GAMMA, rng, perm)
    twin()
    r_dev = st.run("multi_get", lambda: t_dev.multi_get(
        (indptr, indices), backend=be), tasks=n_mget, pairs=indices.size)
    t0 = time.perf_counter()
    r_ora = t_ora.multi_get((indptr, indices), backend="numpy")
    oracle_wall = time.perf_counter() - t0
    _same_bill("multi_get", r_dev, r_ora)
    same_sites("multi_get")
    if not np.array_equal(r_dev.mask, r_ora.mask):
        raise AssertionError("multi_get: mask differs")
    m = r_dev.mask
    st.rows[-1].update(oracle_wall_s=oracle_wall,
                       max_result_err=_results_close(
                           "multi_get", r_dev.values[m], r_ora.values[m]))
    out["multi_get"] = _log_one_shot(st.rows[-1], f"{n_mget} tasks, "
                                     f"{indices.size} pairs")

    keys = zipf_keys_stationary(n_chain * CHAIN_HOPS, K, SERVE_GAMMA, rng,
                                perm).reshape(n_chain, CHAIN_HOPS)
    operand = rng.random((n_chain, 2))
    old = twin()
    c_dev = st.run("chain", lambda: t_dev.run_chain(keys, operand,
                                                    backend=be),
                   tasks=n_chain, hops=CHAIN_HOPS)
    t0 = time.perf_counter()
    c_ora = t_ora.run_chain(keys, operand, backend="numpy")
    st.rows[-1]["oracle_wall_s"] = time.perf_counter() - t0
    if c_dev.hops != c_ora.hops or not np.array_equal(c_dev.keys,
                                                      c_ora.keys):
        raise AssertionError("chain: hops or keys differ")
    for j, (a, b) in enumerate(zip(c_dev.reports, c_ora.reports)):
        if a.phase_signature() != b.phase_signature():
            raise AssertionError(f"chain hop {j}: phase_signature differs")
    same_sites("chain")
    # each hop rounds v·m + a once in float32, 2^-24 of its magnitude; four
    # hops compound to under 4·3·2^-24 ≈ 7e-7 of it (|v| < 5 here): the
    # gate 1e-5·|want| + 1e-5 covers that many times over
    live = ~np.isnan(c_ora.values)
    allowed = 1e-5 * np.abs(c_ora.values[live]) + 1e-5
    err = np.abs(c_dev.values[live] - c_ora.values[live])
    table_err = np.abs(t_dev.values - t_ora.values)
    if not (np.array_equal(live, ~np.isnan(c_dev.values))
            and (err <= allowed).all()
            and (table_err <= 1e-5 * np.abs(t_ora.values) + 1e-5).all()):
        raise AssertionError(f"chain: values beyond 1e-5·|want| + 1e-5 "
                             f"(max |Δ| {err.max()}, table "
                             f"{table_err.max()})")
    st.rows[-1].update(max_result_err=float(err.max()),
                       max_value_err=float(table_err.max()))
    out["chain"] = _log_one_shot(st.rows[-1], f"{n_chain} chains of "
                                 f"{c_dev.hops} hops")
    del old
    _no_host_route("one-shot", t_dev)
    return out


def _log_one_shot(row, what) -> dict:
    log(f"  {row['stage']} ({what}): wall {row['wall_s']:.3f} s (numpy "
        f"oracle {row['oracle_wall_s']:.3f} s); bills, refcounts and exec "
        f"sites equal, max |Δ| results {row['max_result_err']:.3g}"
        + (f", table {row['max_value_err']:.3g}"
           if "max_value_err" in row else ""))
    return row


def serve_stream(K, n, n_mget, seed):
    """The closed-loop stream: GETs and RMWs (1.0, 0.5) on Zipf 1.5 keys of
    a stationary hot set, and multi-gets of arity 1-8, one after every
    n / n_mget GET / RMW requests."""
    from repro_torch.kvstore.ycsb import zipf_keys_stationary

    rng = np.random.default_rng(seed)
    perm = rng.permutation(K)
    keys = zipf_keys_stationary(n, K, SERVE_GAMMA, rng, perm)
    is_rmw = rng.random(n) < 0.10
    arity = rng.integers(1, 9, n_mget)
    flat = zipf_keys_stationary(int(arity.sum()), K, SERVE_GAMMA, rng, perm)
    groups = np.split(flat, np.cumsum(arity)[:-1]) if n_mget else []
    return dict(keys=keys, is_rmw=is_rmw, groups=groups,
                mget_after=(np.arange(n_mget) * n) // max(n_mget, 1))


def _drive(fe, stream, rate=None):
    """Submit the stream (paced at `rate` requests/s if given); returns the
    futures in request order: GET / RMW requests, then multi-gets."""
    keys, is_rmw, groups = stream["keys"], stream["is_rmw"], stream["groups"]
    after = stream["mget_after"]
    kv, mg, j = [], [], 0
    t0 = time.monotonic()
    for i in range(keys.size):
        if rate is not None:
            lag = t0 + i / rate - time.monotonic()
            if lag > 1e-4:
                time.sleep(lag)
        kv.append(fe.read_modify_write(int(keys[i]), *RMW_OPERAND)
                  if is_rmw[i] else fe.get(int(keys[i])))
        while j < len(groups) and after[j] == i:
            mg.append(fe.multi_get(groups[j]))
            j += 1
    return kv, mg


def _record_batches(fe) -> list:
    """The batches the frontend's executor runs, in order, as (tag, request
    futures): recorded here by wrapping the frontend object's `_execute`,
    not in the library."""
    ran, inner = [], fe._execute

    def execute(prepared):
        ran.append((prepared.spec.name,
                    [r.future for r in prepared.requests]))
        inner(prepared)

    fe._execute = execute
    return ran


def _batches_as_requests(ran, kv, mg):
    """(tag, request indices) of each executed batch."""
    index = {id(f): i for i, f in enumerate(kv)}
    index.update({id(f): i for i, f in enumerate(mg)})
    return [(tag, np.array([index[id(f)] for f in futs], dtype=np.int64))
            for tag, futs in ran]


def _batch_kind(tag, idx, stream) -> str:
    if tag == "mget":
        return "mget"
    return "kv_write" if stream["is_rmw"][idx].any() else "kv_read"


def _one_shot_batch(table, tag, idx, stream, backend):
    """The batch `execute_batch` / `multi_get` builds for these requests:
    the per-request results, in batch order."""
    if tag == "kv":
        rmw = stream["is_rmw"][idx]
        operand = np.where(rmw[:, None], RMW_OPERAND, (1.0, 0.0))
        res = table.execute_batch(stream["keys"][idx], ~rmw, operand,
                                  backend=backend)
        return list(res.values)
    res = table.multi_get([stream["groups"][i] for i in idx],
                          backend=backend)
    return [res.values[j][res.mask[j]] for j in range(idx.size)]


def _replay_numpy(name, table, served, batches, stream, kv, mg) -> float:
    """Replay the executed batches through the numpy backend on `table`,
    which starts from the served table's initial values; every request's
    result and the final table against the card's (`served`). The card's
    values drift from float64 by one float32 rounding (2^-24·|v|) at each
    write of a key, and by one at the load: a row read or left after w
    writes is held to (w + 1)·2^-23·|v| + 1e-6 (twice the drift). Returns
    the largest share of that gate."""
    writes = np.zeros(table.store.num_keys, dtype=np.int64)
    worst = 0.0

    def gate(got, want, w):
        nonlocal worst
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        allowed = (w[:, None] + 1) * 2 * U32 * np.abs(want) + 1e-6
        err = np.abs(got - want)
        if got.shape != want.shape or not (err <= allowed).all():
            raise AssertionError(f"{name} numpy replay: |Δ| {err.max()} "
                                 "beyond (w + 1)·2^-23·|want| + 1e-6")
        worst = max(worst, float((err / allowed).max(initial=0.0)))

    for tag, idx in batches:
        want = _one_shot_batch(table, tag, idx, stream, "numpy")
        futs = kv if tag == "kv" else mg
        for j, i in enumerate(idx):
            ks = np.atleast_1d(stream["keys"][i] if tag == "kv"
                               else stream["groups"][i])
            gate(np.atleast_2d(futs[i].result(timeout=0)),
                 np.atleast_2d(want[j]), writes[ks])
        if tag == "kv":
            written = np.unique(stream["keys"][idx][stream["is_rmw"][idx]])
            writes[written] += 1
    gate(served.values, table.values, writes)
    return worst


def _check_futures(name, kv, mg, fe) -> None:
    """Every future resolved, none with an error, no admission refused."""
    errors = []
    for f in kv + mg:
        try:
            f.result(timeout=0)
        except Exception as exc:  # noqa: BLE001 - collected, then raised
            errors.append(exc)
    if errors or fe.stats.failed or fe.stats.rejected:
        raise AssertionError(
            f"{name}: {len(errors)} futures unresolved or rejected (failed "
            f"{fe.stats.failed}, refused {fe.stats.rejected})"
            + (f"; first: {errors[0]!r}" if errors else ""))


def _note_launches(st, tag, ran, kinds) -> dict:
    """A streamed run's launches against its batches' kinds (SERVE_BATCH),
    checked and kept in `st.expected` like a stage's."""
    expected = _launch()
    for k in kinds:
        expected = _plus(expected, SERVE_BATCH[k])
    st.expected[tag] = expected
    if st.device == "cuda" and ran != expected:
        raise AssertionError(f"stage {tag}: kernel launches {ran}, "
                             f"expected {expected}")
    return expected


def serve_sync(device, st, K, init, stream, max_batch) -> dict:
    """The closed loop in sync mode at `max_batch`, only the size trigger
    firing: every request bit-identical to `execute_batch` / `multi_get`
    on the card over the same coalesced batches (a twin table replays
    them), and within the replay gate of the numpy backend."""
    be = _card_backend(device)
    table, twin = _kv_table(device, K, init), _kv_table(device, K, init)
    fe = table.serve(backend=be, mode="sync", config={
        "max_batch": max_batch, "min_window": 1.0, "max_window": 1.0,
        "max_queue": 1 << 16})
    ran = _record_batches(fe)
    tag = f"sync{max_batch}"
    before = _launch_counts()
    t0 = time.perf_counter()
    kv, mg = _drive(fe, stream)
    fe.flush()
    fe.drain()
    wall = time.perf_counter() - t0
    launches = _launch_counts(before)
    rep = fe.report()
    fe.close()
    _check_futures(tag, kv, mg, fe)
    batches = _batches_as_requests(ran, kv, mg)
    kinds = [_batch_kind(t, i, stream) for t, i in batches]
    st.expected[f"{tag}_replay"] = _note_launches(st, tag, launches, kinds)
    row = dict(stage=tag, wall_s=wall, launches=launches,
               requests=len(kv) + len(mg), batches=len(batches))
    st.rows.append(row)
    twin_be = _card_backend(device)
    shots = st.run(f"{tag}_replay", lambda: [
        _one_shot_batch(twin, b_tag, idx, stream, twin_be)
        for b_tag, idx in batches])
    replay_wall = st.rows[-1]["wall_s"]
    for (b_tag, idx), want in zip(batches, shots):
        futs = kv if b_tag == "kv" else mg
        for j, i in enumerate(idx):
            if not np.array_equal(futs[i].result(timeout=0), want[j]):
                raise AssertionError(f"{tag}: request {b_tag}#{i} differs "
                                     "from the one-shot batch")
    if not np.array_equal(table.values, twin.values):
        raise AssertionError(f"{tag}: the table differs from the one-shot "
                             "batches'")
    worst = _replay_numpy(tag, _kv_table(device, K, init), table, batches,
                          stream, kv, mg)
    _no_host_route(tag, table)
    _no_host_route(f"{tag} replay", twin)
    exec_s = fe.stats.overlap.busy["exec"]
    row.update(requests_per_s=row["requests"] / wall,
               ms_per_batch=wall / len(batches) * 1e3,
               exec_ms_per_batch=exec_s / len(batches) * 1e3,
               admission_us_per_request=(wall - exec_s) / row["requests"]
               * 1e6,
               batches_by_trigger=rep["batches_by_trigger"],
               kinds={k: kinds.count(k) for k in SERVE_BATCH},
               p50_s=rep["p50_s"], p99_s=rep["p99_s"],
               replay_share_of_gate=worst)
    log(f"  {tag}: {row['requests']} requests in {len(batches)} batches "
        f"({row['kinds']}; triggers {rep['batches_by_trigger']}), wall "
        f"{wall:.3f} s = {row['requests_per_s']:.0f} requests/s: the "
        f"executor {row['exec_ms_per_batch']:.3f} ms a batch, admission "
        f"{row['admission_us_per_request']:.1f} us a request; every result "
        f"bit-identical to the one-shot batches (their wall "
        f"{replay_wall:.3f} s), the numpy replay within {worst:.3g} of its "
        "gate")
    return row


def prefetch_cost(device, K, init, reps: int = 200) -> dict:
    """Host time, single-threaded, of what `TorchBackend.prefetch` moves
    off the executor for a 256-request GET batch: the prefetch itself
    (pinned copy, side-stream copy, event), the executor's pickup of the
    staged contexts (event wait, `record_stream`) and the upload the
    executor makes without a prefetch (one pageable copy); medians of
    `reps` calls, synchronized between calls."""
    import torch

    from repro_torch.core import make_backend

    table = _kv_table(device, K, init)
    be = make_backend(_card_backend(device))
    n = THREAD_WINDOW["max_batch"]
    tasks = table._make_batch(np.arange(n), np.ones(n, dtype=bool),
                              np.tile((1.0, 0.0), (n, 1)), None)
    times = {"prefetch_us": [], "pickup_us": [], "upload_us": []}

    def clock(key, fn):
        if be.device.type == "cuda":
            torch.cuda.synchronize(be.device)
        t0 = time.perf_counter()
        fn()
        times[key].append((time.perf_counter() - t0) * 1e6)

    for _ in range(reps):
        clock("prefetch_us", lambda: be.prefetch(tasks, table.store))
        clock("pickup_us", lambda: be._dctx(tasks))
        clock("upload_us", lambda: be._dctx(tasks))
    out = {k: float(np.median(v)) for k, v in times.items()}
    log(f"  prefetch of a {n}-request batch's contexts: "
        f"{out['prefetch_us']:.1f} us of the router's time; the executor's "
        f"pickup {out['pickup_us']:.1f} us against an upload of "
        f"{out['upload_us']:.1f} us without it (medians of {reps})")
    return out


def serve_busy(device, st, K, init) -> dict:
    """Device busy and idle share of the serve tier (`device_busy`): a
    sync-mode run at max_batch 256 of a quarter of the closed-loop stream
    (16,384 GET / RMW requests and 1,024 multi-gets), on a fresh table."""
    table = _kv_table(device, K, init)
    stream = serve_stream(K, STREAM_N // 4, STREAM_MGETS // 4,
                          SERVE_SEED + 4)
    fe = table.serve(backend=_card_backend(device), mode="sync", config={
        "max_batch": 256, "min_window": 1.0, "max_window": 1.0,
        "max_queue": 1 << 16})
    ran, futs = _record_batches(fe), []
    before = _launch_counts()

    def run():
        futs.extend(_drive(fe, stream))
        fe.flush()

    row = dict(stage="busy_sync256", **device_busy("busy_sync256", run))
    fe.close()
    kv, mg = futs
    batches = _batches_as_requests(ran, kv, mg)
    _note_launches(st, "busy_sync256", _launch_counts(before),
                   [_batch_kind(t, i, stream) for t, i in batches])
    row.update(requests=len(kv) + len(mg), batches=len(batches))
    _log_busy(f"sync256 under the profiler ({row['requests']} requests, "
              f"{len(batches)} batches)", row)
    return row


def serve_thread(device, st, K, init, stream, rate, tag,
                 prefetch=True) -> dict:
    """bench_serve's open loop in thread mode: the stream offered at `rate`
    requests/s to the router / executor pair. Every future must resolve
    without an error, and replaying the batches the executor ran through the
    numpy backend must give each result and the final table within the
    replay gate. `prefetch=False` runs the same with the backend's prefetch
    a no-op (overridden on this backend object only), to see what staging
    the contexts takes off the executor."""
    be = _card_backend(device)
    table = _kv_table(device, K, init)
    fe = table.serve(backend=be, mode="thread", config=THREAD_WINDOW)
    backend = fe.sessions[0].backend
    if not prefetch:
        backend.prefetch = lambda tasks, store: None
    ran = _record_batches(fe)
    before = _launch_counts()
    t0 = time.perf_counter()
    kv, mg = _drive(fe, stream, rate=rate)
    fe.drain(timeout=300.0)
    wall = time.perf_counter() - t0
    rep = fe.report()
    fe.close()
    ran_launches = _launch_counts(before)
    _check_futures(tag, kv, mg, fe)
    batches = _batches_as_requests(ran, kv, mg)
    _note_launches(st, tag, ran_launches,
                   [_batch_kind(t, i, stream) for t, i in batches])
    worst = _replay_numpy(tag, _kv_table(device, K, init), table, batches,
                          stream, kv, mg)
    _no_host_route(tag, table)
    busy = fe.stats.overlap.busy
    row = dict(stage=tag, wall_s=wall, launches=ran_launches,
               requests=len(kv) + len(mg), offered_per_s=rate,
               requests_per_s=rep["completed"] / wall,
               p50_s=rep["p50_s"], p99_s=rep["p99_s"],
               overlap_frac=rep["overlap_fraction"],
               exec_busy_s=busy["exec"], route_busy_s=busy["route"],
               batches=len(batches), merged=rep["merged_batches"],
               exec_ms_per_batch=busy["exec"] / len(batches) * 1e3,
               occupancy=rep["batch_occupancy"],
               queue_peak=rep["queue_peak"], replay_share_of_gate=worst)
    st.rows.append(row)
    log(f"  {tag}: {row['requests']} requests offered at {rate:.0f}/s: "
        f"{row['requests_per_s']:.0f} requests/s, p50 "
        f"{row['p50_s'] * 1e3:.3f} ms, p99 {row['p99_s'] * 1e3:.3f} ms, "
        f"overlap_frac {row['overlap_frac']:.4f}; {len(batches)} batches "
        f"({row['merged']} merged, occupancy {row['occupancy']:.3f}), "
        f"executor {row['exec_ms_per_batch']:.3f} ms a batch, router "
        f"{busy['route']:.3f} s; the numpy replay within {worst:.3g} of its "
        "gate")
    return row


def _launch_counts(before=None) -> dict:
    from repro_torch import kernels

    now = kernels.launches()
    return now if before is None else {k: v - before[k]
                                       for k, v in now.items()}


def front_doors(device, st, ps: dict) -> dict:
    """MoEFrontend and EmbeddingFrontend at phase 4's granite widths (its
    router and table): 128 routed tokens bit-identical to `decode_step` on
    the card for the same admission order (and within DECODE_REL of the
    float64 expert reference); 8,192 lookups and bags bit-identical to
    `lookup` / `lookup_bags`; 8,192 gradient pushes within K2's sum bound
    of the float64 update."""
    from repro_torch.kvstore.ycsb import zipf_keys_stationary
    from repro_torch.paramserve import EmbeddingStore

    be = _card_backend(device)
    router, store = ps["router"], ps["store"]
    sync = {"min_window": 1.0, "max_window": 1.0}
    x, ti, g = router.zipf_routing(FRONT_T, alpha=PS_ALPHA,
                                   seed=PS_SEED + 100, rank_perm=ps["perm"])
    fe = router.serve(backend=be, mode="sync",
                      config={"max_batch": FRONT_T, **sync})

    def decode_all():
        futs = [fe.decode(x[t], ti[t], g[t]) for t in range(FRONT_T)]
        return np.stack([f.result(timeout=0) for f in futs])

    y = st.run("moe_front", decode_all, tokens=FRONT_T)
    fe.close()
    one = st.run("moe_shot", lambda: router.decode_step(x, ti, g,
                                                        backend=be))
    if fe.stats.batches != 1 or not np.array_equal(y, one.y):
        raise AssertionError("MoEFrontend: not bit-identical to decode_step")
    w_in, w_out = router.layer_weights(0)
    err = _check_close("moe_front", y, expert_reference(x, ti, g, w_in,
                                                        w_out))
    st.rows[-2]["max_abs_err"] = err

    rng = np.random.default_rng(PS_SEED + 100)
    V, d = store.V, store.d
    perm = rng.permutation(V)
    ids = zipf_keys_stationary(FRONT_N, V, PS_ALPHA, rng, perm)
    arity = rng.integers(1, 9, FRONT_N)
    flat = zipf_keys_stationary(int(arity.sum()), V, PS_ALPHA, rng, perm)
    bags = np.split(flat, np.cumsum(arity)[:-1])
    up_ids = zipf_keys_stationary(FRONT_N, V, PS_ALPHA, rng, perm)
    grads = rng.standard_normal((FRONT_N, d))
    # the front door and the one-shot calls each start from one upload of
    # the same host table (the card's float32 copy after phase 4's push
    # holds sums rounded on the card, not the host's float64 ones)
    table0 = store.table.copy()
    store.store.write_rows(np.arange(V), table0)
    fe = store.serve(backend=be, mode="sync",
                     config={"max_batch": FRONT_N, **sync})

    def serve_all():
        lk = [fe.lookup(int(i)) for i in ids]
        bg = [fe.lookup_bag(b) for b in bags]
        gr = [fe.push_grad(int(i), gv) for i, gv in zip(up_ids, grads)]
        fe.flush()
        return ([f.result(timeout=0) for f in lk],
                [f.result(timeout=0) for f in bg],
                [f.result(timeout=0) for f in gr])

    lk, bg, gr = st.run("embed_front", serve_all, requests=3 * FRONT_N)
    fe.close()
    if fe.stats.batches != 3 or any(r is not None for r in gr):
        raise AssertionError("EmbeddingFrontend: batches or pushes differ")
    want = EmbeddingStore.oracle_update(table0, up_ids, grads)
    mags = EmbeddingStore.oracle_update(np.abs(table0), up_ids,
                                        np.abs(grads))
    grad_err = _sum_bound_ok(store.table, want, mags, rel_want=1e-5,
                             name="push_grad")
    store.store.write_rows(np.arange(V), table0)
    indptr = np.zeros(FRONT_N + 1, dtype=np.int64)
    np.cumsum(arity, out=indptr[1:])

    def one_shot():
        return (store.lookup(ids, backend=be).values,
                store.lookup_bags((indptr, flat), backend=be).values)

    want_lk, want_bg = st.run("embed_shot", one_shot)
    if not (np.array_equal(np.stack(lk), want_lk)
            and np.array_equal(np.stack(bg), want_bg)):
        raise AssertionError("EmbeddingFrontend: lookups or bags not "
                             "bit-identical to lookup / lookup_bags")
    st.rows[-2]["max_abs_err"] = grad_err
    for sess in list(router._sessions.values()) + list(
            store._sessions.values()):
        if getattr(sess.backend, "_host_lambdas", None):
            raise AssertionError("front doors: a lambda fell back to the "
                                 "host")
    walls = {r["stage"]: r["wall_s"] for r in st.rows[-4:]}
    log(f"  MoEFrontend: {FRONT_T} tokens in one batch "
        f"({walls['moe_front']:.4f} s; decode_step {walls['moe_shot']:.4f} "
        f"s), bit-identical to decode_step, max |Δ| {err:.3g} from the "
        f"float64 reference; 3 x {FRONT_N} embedding requests "
        f"{walls['embed_front']:.4f} s (lookup + lookup_bags "
        f"{walls['embed_shot']:.4f} s); "
        f"EmbeddingFrontend: {FRONT_N} lookups and bags bit-identical to "
        f"lookup / lookup_bags, {FRONT_N} gradient pushes max |Δ| "
        f"{grad_err:.3g} (within 1e-6·Σ|terms| + 1e-5·|want| + 1e-6)")
    return dict(moe_max_abs_err=err, grad_max_abs_err=grad_err)


def serve_path(device: str, ps: dict, *,
               K: int = SERVE_KEYS, tpm: int = SERVE_TPM,
               n_mget: int = MGET_N, n_chain: int = CHAIN_N,
               n_stream: int = STREAM_N, n_stream_mget: int = STREAM_MGETS,
               n_thread: int = THREAD_N, batches=STREAM_BATCHES):
    """Phase 10: the one-shot KV stages, the closed loop in sync mode at
    each of `batches`, the open loop in thread mode (with and without
    prefetch) and the parameter-server front doors (on `ps`, phase 4's
    tensors). Returns (rows, summary, expected launches by stage). The
    keyword sizes cut it down for a rehearsal on the CPU."""
    st = _Stages(device, dict(SERVE_EXPECTED))
    init = np.random.default_rng(SERVE_SEED).random((K, SERVE_WIDTH))
    summary = {"one_shot": kv_one_shot(device, st, K, tpm, n_mget, n_chain,
                                       init)}
    stream = serve_stream(K, n_stream, n_stream_mget, SERVE_SEED + 2)
    sync = {b: serve_sync(device, st, K, init, stream, b) for b in batches}
    rate = THREAD_LOAD * sync[batches[0]]["requests_per_s"]
    t_stream = serve_stream(K, n_thread, 0, SERVE_SEED + 3)
    # with prefetch and without, in turns: the two are compared only
    # within this run, and the turns show the spread between runs
    summary["thread"] = [
        serve_thread(device, st, K, init, t_stream, rate,
                     f"thread{i}" + ("" if on else "_no_prefetch"), on)
        for i, on in enumerate(THREAD_TURNS)]
    summary["prefetch_cost"] = prefetch_cost(device, K, init)
    if device == "cuda":  # the profiler reads the card's events
        summary["busy"] = serve_busy(device, st, K, init)
    summary["front_doors"] = front_doors(device, st, ps)
    return st.rows, summary, st.expected


# ---------------------------------------------------------------------------
# C2: bf16 prefill_mha once beyond its gate (a diagnostic, not in the default
# run: `--c2-repeats N`)
# ---------------------------------------------------------------------------


def c2_repeats(dev, n: int) -> dict:
    """Phase 5's bf16 prefill_mha stage `n` times in this process, on its
    own inputs (same seed): each repeat calls the kernel and the float32
    plain version again and reads the share of the gate (ATTN_REL·(1+|ref|)
    + 2^-8·|ref|), and whether the kernel's output and the plain version's
    are bit-identical to their first calls. Raises after the last repeat if
    any share passed 1."""
    import torch

    stages = attention_ssm_stages()
    i = next(j for j, s in enumerate(stages) if s["tag"] == "prefill_mha")
    st = stages[i]
    inputs = stage_inputs(st, "bfloat16", dev, SEED + 100 + i)
    call = _kernel_call(st, inputs)
    first = call()
    want0 = _plain_call(st, inputs, lambda t: t.float())
    shares, worst_at, out_same, ref_same = [], [], 0, 0
    for _ in range(n):
        got = call()
        want = _plain_call(st, inputs, lambda t: t.float())
        out_same += bool(torch.equal(got, first))
        ref_same += bool(torch.equal(want, want0))
        w = want.double()
        ratio = (got.double() - w).abs() / (ATTN_REL * (1 + w.abs())
                                           + BF16_ROUND * w.abs())
        share = float(ratio.max().item())
        shares.append(share)
        worst_at.append(tuple(int(x) for x in
                              torch.nonzero(ratio == share)[0]))
        del got, want, w, ratio
    torch.cuda.empty_cache()
    out = dict(repeats=n, shares=shares, worst_at=worst_at,
               kernel_identical=out_same, plain_identical=ref_same,
               tf32=torch.backends.cuda.matmul.allow_tf32)
    log(f"  C2: {n} repeats of prefill_mha/bfloat16 after phases 2-4: "
        f"share of the gate min {min(shares):.6g}, max {max(shares):.6g} "
        f"(first five {[round(s, 6) for s in shares[:5]]}); kernel output "
        f"identical to its first call {out_same}/{n}, plain version "
        f"{ref_same}/{n}; worst elements {sorted(set(worst_at))[:4]}; "
        f"allow_tf32 {out['tf32']}")
    if max(shares) > 1:
        raise AssertionError(f"C2: prefill_mha/bfloat16 beyond its gate in "
                             f"{sum(s > 1 for s in shares)} of {n} repeats")
    return out


def _check_path_launches(path: str, launches: dict, expected: dict) -> None:
    """A path's launches must be its table's totals, and every kernel of
    the path (any that its table expects) must have run."""
    log(f"  kernel launches on the {path}: {launches}")
    want = {k: sum(e.get(k, 0) for e in expected.values()) for k in launches}
    missing = [k for k, v in want.items() if v > 0 and launches[k] <= 0]
    if missing:
        raise AssertionError(f"{path} never launched {missing}")
    if launches != want:
        raise AssertionError(f"{path} launches {launches}, expected {want}")


def _log_paramserve(rows, summary) -> None:
    for r in rows:
        err = r.get("max_abs_err")
        log(f"  {r['stage']}: wall {r['wall_s']:.3f} s, launches "
            f"{ {k: v for k, v in r['launches'].items() if v} }"
            + (f", max |Δ| {err:.3g}" if err is not None else ""))
    peak = summary["decode_peak_bytes"]
    log(f"  decode peak device memory (max_memory_allocated) per step: "
        f"{[f'{b / 1e9:.3f} GB' for b in peak]}")
    log(f"  work ratio at T={DECODE_T}: orchestrated "
        f"{summary['moe_orchestrated_work_ratio']:.4f} (steps 1-"
        f"{DECODE_STEPS - 1}), naive {summary['moe_naive_work_ratio']:.4f} "
        f"(worst step); embedding cache: {summary['embed_hot_rows']} hot "
        f"rows, hit rate {summary['embed_hit_rate']:.4f}")


def parse_args(argv):
    ap = argparse.ArgumentParser(
        description="Smoke run of the PyTorch/CUDA port on one NVIDIA GPU "
        "(phases in the module docstring). With no arguments it runs every "
        "phase and prints the result lines.")
    ap.add_argument("--c2-repeats", type=int, default=0, metavar="N",
                    help="after phase 4, run phase 5's bf16 prefill_mha "
                    "stage N times and read each share of its gate")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print("chip_smoke.py runs from a checkout of the repo: "
              f"{SRC / 'repro_torch'} is missing", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch import kernels
    from repro_torch.kernels import _lib

    card = gpu_name_and_power()
    log(f"[1/10] environment: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _lib.build()
    log(f"  kernels built from src/repro_torch/csrc in "
        f"{time.perf_counter() - t0:.2f} s (sm_90a)")
    resources = kernel_resources(_lib.build_dir() / "nvcc.log")
    for name, use in resources.items():
        log(f"  {name}: {use}")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("[2/10] kernel parity against the plain PyTorch versions")
    parity_worst = parity_phase(dev)
    torch.cuda.synchronize()

    log("[3/10] main path: P=16, 800,000 tasks/stage, 800,000 keys x 16, "
        "backend='torch' vs the numpy oracle")
    kernels.reset_launches()
    stages_out, K, stages, init = main_path("cuda")
    torch.cuda.synchronize()
    launches = kernels.launches()
    _check_path_launches("main path", launches, EXPECTED_LAUNCHES)

    log("[4/10] parameter-server path: granite-moe-3b-a800m, one MoE layer "
        "(40 experts x 2,359,296 words, top-8) and the 49,155 x 1536 "
        "embedding table, P=8, backend='torch'")
    kernels.reset_launches()
    ps_rows, ps_summary, ps_data = paramserve_path("cuda")
    torch.cuda.synchronize()
    ps_launches = kernels.launches()
    _check_path_launches("parameter-server path", ps_launches, PS_EXPECTED)
    _log_paramserve(ps_rows, ps_summary)
    ps_parity = paramserve_kernel_parity(dev, ps_data)
    ps_summary["kernel_parity"] = ps_parity
    ps_summary.update(paramserve_costs("cuda", ps_data))
    log(f"  T={COST_T} decode steps and every embedding stage: "
        "phase_signature/refcount/exec_site and work ratios equal to the "
        "numpy backend's; bench_paramserve gate on its own mix "
        f"{GATE_MIX}: orchestrated {ps_summary['gate_orchestrated']}, "
        f"naive {ps_summary['gate_naive']}")

    c2 = c2_repeats(dev, args.c2_repeats) if args.c2_repeats else None
    log("[5/10] attention and SSM path: zamba2-1.2b (Mamba2 scan, shared "
        "MHA prefill and long_500k decode), command-r-35b (GQA prefill, hd "
        "128), tinyllama-1.1b (GQA decode_32k), float32 and bf16")
    kernels.reset_launches()
    attn_rows = attention_ssm_path(dev)
    torch.cuda.synchronize()
    attn_launches = kernels.launches()
    _check_path_launches("attention and SSM path", attn_launches,
                         ATTN_EXPECTED)
    errors = {k: max([parity_worst[k]] + [r["max_abs_err"] for r in attn_rows
                                          if r["launches"][k]])
              for k in KERNEL_SOURCES}

    log("[6/10] kernel times at the paths' shapes")
    rows = timing_phase(dev, K, stages, init, launches, ps_data,
                        ps_launches)
    rows.append(moe_gemm_timing(dev, ps_data, ps_launches["moe_gemm"]))
    for r in rows:  # the worst error of either path's parity check
        r["max_abs_err"] = max(r["max_abs_err"], ps_parity.get(r["name"], 0))
    for s in rows[-1]["shapes"]:
        lib = (f"{s['library_ms']:.4f}" if s["library_ms"] is not None
               else f"null: {s['library_note']}")
        log(f"  moe_gemm: {s['ms']:.4f} ms (plain {s['plain_ms']:.4f}, "
            f"library {lib}, loop of matmuls {s['matmul_loop_ms']:.4f}, "
            f"bound {s['bound_ms']:.4f} by {s['bound_by']}; "
            f"{s['bound_fma_ms']:.4f} in FMAs) at {s['shape']}")
    rows += attention_ssm_timing(dev, attn_launches, errors)
    for r in rows:
        if not all(np.isfinite(r[k]) for k in ("ms", "plain_ms", "bound_ms")):
            raise AssertionError(f"{r['name']}: non-finite timing")

    log("[7/10] device busy share of a stage (torch.profiler)")
    busy = busy_phase(K, stages, init)

    log("[8/10] engines and plans: stages (a)-(c) under engine='pull', "
        "'push', 'sort', 'auto'; bench_plan's pagerank_stages and "
        "bfs_stages through run_plan and the run_stage loop")
    kernels.reset_launches()
    engine_rows, engine_expected = engines_path("cuda")
    plan_rows, plan_expected = plans_path("cuda")
    torch.cuda.synchronize()
    _check_path_launches("engines and plans path", kernels.launches(),
                         {**engine_expected, **plan_expected})

    log(f"[9/10] TDO-GP: Erdős-Rényi and star graphs of 2^{GRAPH_SCALE} "
        f"vertices, Barabási-Albert of {GRAPH_BA_N}, P={GRAPH_P}; BFS, SSSP, "
        "CC, PageRank, BC, backend='torch' vs the numpy oracle")
    kernels.reset_launches()
    graph_rows, graph_expected, root_call = graph_path("cuda")
    torch.cuda.synchronize()
    graph_launches = kernels.launches()
    _check_path_launches("graph path", graph_launches, graph_expected)
    log("  phase 6, row 1e: K1 at the Erdős-Rényi ingest's root call")
    rows[0]["shapes"].append(ingest_histogram_timing(
        dev, root_call, graph_launches["histogram"]))

    log("[10/10] KV store and serve tier: DistributedHashTable(800,000, "
        "16, value_width=16) one-shot (YCSB A/B, multi_get, run_chain), "
        "streamed in sync and thread mode, and the MoE / embedding front "
        "doors at granite-moe-3b-a800m's widths")
    kernels.reset_launches()
    serve_rows, serve_summary, serve_expected = serve_path("cuda", ps_data)
    torch.cuda.synchronize()
    _check_path_launches("serving path", kernels.launches(), serve_expected)

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "stages": stages_out, "kernels": rows,
         "device_busy": busy, "paramserve": {"stages": ps_rows,
                                             **ps_summary},
         "attention_ssm": {"stages": attn_rows, "resources": resources},
         "engines": engine_rows, "plans": plan_rows, "graph": graph_rows,
         "serve": {"stages": serve_rows, **serve_summary}, "c2": c2},
        indent=1, default=str))

    log(gpu_name_and_power())
    log(json.dumps({"kernels": [{k: r[k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        for r in rows]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
