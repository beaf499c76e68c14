#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit) on any failed check:

1. Environment: the card's name and power limit, the torch and CUDA
   versions, and the time to build the CUDA kernels from `src/repro_torch/
   csrc/` with nvcc (sm_90a).
2. Kernel parity: every kernel against its plain PyTorch version on the
   card — the histogram (weighted and not, bins below and above the
   shared-memory budget, out-of-range ids), the segment combine (every
   merge, float32 and float64, empty segments, negative and tied
   priorities), and the fused stage (every read_op x merge, arity-0 rows, a
   single-row batch).
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
4. Kernel times at the main path's shapes (CUDA events, median of several
   runs) beside the plain version, the one PyTorch call that computes the
   same function (`torch.bincount`, `index_add_`, `embedding_bag`), and the
   least time the card could take
   (bytes over 3.35 TB/s, or operations over 67 TFLOP/s, whichever is
   larger).
5. Device busy share: stages (a)-(c) once more under torch.profiler, after a
   warm-up run; the device's busy time (kernels, copies, fills) against the
   stage's wall time.

The last line is ``{"ok": true, "device": {...}}``; the line before it
holds the per-kernel numbers as JSON, and the one before that the card's
name and power limit.
"""
from __future__ import annotations

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

P = 16
TASKS_PER_MACHINE = 50_000
VALUE_WIDTH = 16
SEED = 20251111


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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


def bound(bytes_moved: float, ops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 2: kernel parity on the card
# ---------------------------------------------------------------------------
def _sum_bound_ok(got, want, mags, rel=1e-6, abs_=1e-6) -> float:
    """Atomic float sums add in a run-dependent order: hold them to
    |Δ| <= rel * Σ|terms| + abs_ (Σ|terms| per output element, `mags`)."""
    err = (got.double() - want.double()).abs()
    if not bool((err <= rel * mags.double() + abs_).all()):
        raise AssertionError(f"sum beyond tolerance: max |Δ| "
                             f"{err.max().item()}")
    return float(err.max().item()) if err.numel() else 0.0


def parity_phase(dev) -> dict:
    import torch

    from repro_torch.kernels.histogram.ops import count_ids, shared_bins
    from repro_torch.kernels.histogram.ref import histogram_ref
    from repro_torch.kernels.segment_combine.ops import combine
    from repro_torch.kernels.segment_combine.ref import combine_ref
    from repro_torch.kernels.stage_fused.ops import (FUSED_READ_OPS,
                                                     fused_stage)
    from repro_torch.kernels.stage_fused.ref import fused_stage_ref

    g = torch.Generator().manual_seed(SEED)
    worst = {"histogram": 0.0, "segment_combine": 0.0, "stage_fused": 0.0}

    # histogram: exact, with ids outside [0, bins) on both sides
    sb = shared_bins()
    for bins, n in [(300, 4000), (sb, 200_000), (sb + 1, 200_000),
                    (800_000, 800_000), (1, 1)]:
        ids = torch.randint(-7, bins + 7, (n,), generator=g,
                            dtype=torch.int32).to(dev)
        wts = torch.randint(0, 5, (n,), generator=g,
                            dtype=torch.int32).to(dev)
        for w in (None, wts):
            got, want = count_ids(ids, bins, weights=w), \
                histogram_ref(ids, bins, w)
            if not torch.equal(got, want):
                raise AssertionError(f"histogram bins={bins} n={n} "
                                     f"weighted={w is not None} differs")
    log(f"  histogram: exact on 10 cases (shared-memory budget {sb} bins)")

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
    log("  segment_combine: 80 cases; min/max/or/write exact, add within "
        "1e-6*sum|terms| + 1e-6")

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
    log("  stage_fused: 60 cases (every read_op x merge, arity-0 rows, a "
        "single-row batch); sums within 1e-6*sum|terms| + 1e-6, the rest "
        "exact")
    return worst


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------
def zipf_keys(n, num_keys, gamma, rng):
    """n keys from Zipf(gamma) over num_keys ranks, identities permuted."""
    p = np.arange(1, num_keys + 1, dtype=np.float64) ** (-gamma)
    p /= p.sum()
    return rng.permutation(num_keys)[rng.choice(num_keys, size=n, p=p)]


def muladd(contexts, vals):
    out = vals * contexts[:, 0:1] + contexts[:, 1:2]
    return {"update": out, "result": out}


def scale_by_context(contexts, reduced):
    return reduced * contexts[:, 0:1]


# launches of each kernel in each stage of the main path: K1 where Phase 1
# passes the host cutoff (stage b's weighted root call, the replica-local
# pairs of stage d's second stage), K2 once for every stage's writer
# combine, K3 in the ragged stage c
EXPECTED_LAUNCHES = {
    "a": {"histogram": 0, "segment_combine": 1, "stage_fused": 0},
    "b": {"histogram": 1, "segment_combine": 1, "stage_fused": 0},
    "c": {"histogram": 0, "segment_combine": 1, "stage_fused": 1},
    "d0": {"histogram": 0, "segment_combine": 1, "stage_fused": 0},
    "d1": {"histogram": 1, "segment_combine": 1, "stage_fused": 0},
}


def make_stages(tpm: int):
    """The four stages' task batches (numpy, from the seed)."""
    from repro_torch.core import TaskBatch, fused_read

    rng = np.random.default_rng(SEED)
    n, K = P * tpm, 16 * tpm
    origin = TaskBatch.even_origins(n, P)

    def ctx():
        return rng.standard_normal((n, 2))

    a = TaskBatch(contexts=ctx(), read_keys=zipf_keys(n, K, 2.0, rng),
                  origin=origin)
    b = TaskBatch(contexts=ctx(), read_keys=rng.integers(0, K, n),
                  origin=origin,
                  priority=rng.integers(-2**31 + 1, 2**31 - 1, n))
    arity = rng.integers(1, 9, n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(arity, out=indptr[1:])
    c = TaskBatch(contexts=ctx(), origin=origin, read_indptr=indptr,
                  read_indices=zipf_keys(int(indptr[-1]), K, 1.5, rng))
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


def _timed_backend(sess):
    """Wrap the session backend's device calls to split a stage's wall time
    into device numerics (these calls, synchronized) and the host cost
    model (the rest)."""
    import torch

    be = sess.backend
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
    from repro_torch import kernels
    from repro_torch.core import DataStore, Orchestrator, TorchBackend

    K, stages = make_stages(tpm)
    rng = np.random.default_rng(SEED + 1)
    init = rng.standard_normal((K, VALUE_WIDTH))
    st_dev = DataStore.create(K, P, value_width=VALUE_WIDTH)
    st_ora = DataStore.create(K, P, value_width=VALUE_WIDTH)
    st_dev.write_rows(np.arange(K), init)
    out = []
    for name, desc, tasks, f, merge, rep, n_stages in stages:
        if name == "d":  # (a) again, from the same starting values
            st_dev.write_rows(np.arange(K), init)
        backend = "torch" if device == "cuda" else TorchBackend(device=device)
        s_dev = Orchestrator(st_dev, backend=backend, replication=rep)
        s_ora = Orchestrator(st_ora, backend="numpy", replication=rep)
        _timed_backend(s_dev)
        kind = "fused" if tasks.max_arity > 1 else "muladd"
        for k in range(n_stages):
            # the oracle starts each stage from the torch store's values
            # (the torch side keeps its device copy), so each check sees
            # only that stage's rounding
            st_ora.write_rows(np.arange(K), st_dev.values)
            old = st_ora.values.copy()
            mags = term_magnitudes(tasks, old, kind)
            s_dev.backend.numerics_s = 0.0
            before = kernels.launches()
            t0 = time.perf_counter()
            r_dev = s_dev.run_stage(tasks, f, write_back=merge,
                                    return_results=True)
            wall = time.perf_counter() - t0
            tag = f"{name}{k}" if n_stages > 1 else name
            ran = {kn: v - before[kn] for kn, v in kernels.launches().items()}
            if device == "cuda" and ran != EXPECTED_LAUNCHES[tag]:
                raise AssertionError(f"stage {tag}: kernel launches {ran}, "
                                     f"expected {EXPECTED_LAUNCHES[tag]}")
            if s_dev.backend._host_lambdas:
                raise AssertionError(f"stage {tag}: a lambda fell back to "
                                     "the host path")
            t0 = time.perf_counter()
            r_ora = s_ora.run_stage(tasks, f, write_back=merge,
                                    return_results=True)
            wall_ora = time.perf_counter() - t0
            if r_dev.report.phase_signature() != \
                    r_ora.report.phase_signature():
                raise AssertionError(f"stage {tag}: phase_signature differs")
            if r_dev.refcount != r_ora.refcount:
                raise AssertionError(f"stage {tag}: refcount differs")
            if not np.array_equal(r_dev.exec_site, r_ora.exec_site):
                raise AssertionError(f"stage {tag}: exec_site differs")
            res_d = np.asarray(r_dev.results, dtype=np.float64)
            res_o = np.asarray(r_ora.results, dtype=np.float64)
            if res_d.shape != res_o.shape or not np.isfinite(res_d).all():
                raise AssertionError(f"stage {tag}: results malformed")
            res_err = np.abs(res_d - res_o)
            if not (res_err <= 1e-5 * np.abs(res_o) + 1e-6 * mags
                    + 1e-6).all():
                raise AssertionError(f"stage {tag}: results beyond "
                                     f"tolerance ({res_err.max()})")
            val_err, val_share = _check_values(
                tag, st_dev.values, st_ora.values, old, tasks, mags, merge)
            numerics = s_dev.backend.numerics_s
            row = dict(stage=tag, desc=desc, tasks=tasks.n, pairs=tasks.nnz,
                       launches=ran,
                       wall_s=wall, numerics_s=numerics,
                       host_cost_model_s=wall - numerics,
                       tasks_per_s=tasks.n / wall, oracle_wall_s=wall_ora,
                       max_result_err=float(res_err.max()),
                       max_value_err=val_err,
                       max_value_err_share_of_tolerance=val_share,
                       replicated_chunks=(s_dev.replicas.num_replicated
                                          if s_dev.replicas is not None
                                          else 0))
            log(f"  stage {tag} ({desc}): {tasks.n} tasks, {tasks.nnz} "
                f"pairs, wall {wall:.3f} s = host cost model "
                f"{wall - numerics:.3f} s + backend calls (device numerics "
                f"with their transfers) {numerics:.3f} s"
                f", {tasks.n / wall:.0f} tasks/s (oracle {wall_ora:.3f} s); "
                f"max |Δ| results {row['max_result_err']:.3g}, store "
                f"{val_err:.3g} (at most {val_share:.3g} of its tolerance); "
                f"signature/refcount/exec_site equal; launches {ran}")
            out.append(row)
    return out, K, stages, init


# ---------------------------------------------------------------------------
# phase 4: kernel times at the main path's shapes
# ---------------------------------------------------------------------------
def timing_phase(dev, K, stages, init, launches) -> list:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.histogram.ops import count_ids
    from repro_torch.kernels.histogram.ref import histogram_ref
    from repro_torch.kernels.segment_combine.ops import combine
    from repro_torch.kernels.segment_combine.ref import combine_ref
    from repro_torch.kernels.stage_fused.ops import fused_reduce
    from repro_torch.kernels.stage_fused.ref import reduce_pairs_ref

    by = {s[0]: s[2] for s in stages}
    rows = []

    # K1 at stage (b)'s Phase-1 root call: every pair reaches the root
    # unmerged on uniform keys, one weighted row each
    keys = torch.from_numpy(by["b"].read_keys.astype(np.int32)).to(dev)
    ones = torch.ones_like(keys)
    n = keys.numel()
    got, want = count_ids(keys, K, weights=ones), histogram_ref(keys, K, ones)
    err = float((got - want).abs().max().item())
    b_ms, b_by = bound(4 * n + 4 * n + 4 * K, n)
    rows.append(dict(
        name="histogram", route="cuda",
        source="src/repro_torch/csrc/histogram.cu",
        replaces="src/repro/kernels/histogram/kernel.py:37",
        launches=launches["histogram"], max_abs_err=err,
        ms=time_ms(lambda: count_ids(keys, K, weights=ones)),
        plain_ms=time_ms(lambda: histogram_ref(keys, K, ones)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: torch.bincount(keys, weights=ones,
                                                  minlength=K)),
        shape=f"ids ({n},) int32 + weights, {K} bins"))

    # K2 at stage (a)'s writer combine: every task writes its Zipf 2.0 key
    wk = by["a"].write_keys
    uniq, inv = np.unique(wk, return_inverse=True)
    S = uniq.size
    g = torch.Generator().manual_seed(SEED)
    upd = torch.randn(wk.size, VALUE_WIDTH, generator=g).to(dev)
    seg = torch.from_numpy(inv.astype(np.int32)).to(dev)
    got = combine(upd, seg, S, op="add")
    want = combine_ref(upd, seg, S, op="add")
    mags = combine_ref(upd.abs(), seg, S, op="add")
    err = _sum_bound_ok(got, want, mags)
    N = wk.size
    b_ms, b_by = bound(4 * N * VALUE_WIDTH + 4 * N + 4 * S * VALUE_WIDTH,
                       N * VALUE_WIDTH)
    acc = torch.zeros(S, VALUE_WIDTH, device=dev)
    rows.append(dict(
        name="segment_combine", route="cuda",
        source="src/repro_torch/csrc/segment_combine.cu",
        replaces="src/repro/kernels/segment_combine/kernel.py:42",
        launches=launches["segment_combine"], max_abs_err=err,
        ms=time_ms(lambda: combine(upd, seg, S, op="add")),
        plain_ms=time_ms(lambda: combine_ref(upd, seg, S, op="add")),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: acc.index_add_(0, seg, upd)),
        shape=f"({N}, {VALUE_WIDTH}) float32 -> {S} segments, add"))

    # K3 at stage (c)'s gather-reduce; the library call is embedding_bag's
    # CSR gather-sum (empty bags give 0), checked against the plain version
    tc = by["c"]
    vals = torch.from_numpy(init.astype(np.float32)).to(dev)
    indptr = torch.from_numpy(tc.read_indptr.astype(np.int32)).to(dev)
    idx = torch.from_numpy(tc.read_indices.astype(np.int32)).to(dev)
    got = fused_reduce(vals, indptr, idx, read_op="add")
    want = reduce_pairs_ref(vals, indptr, idx, read_op="add")
    mags = reduce_pairs_ref(vals.abs(), indptr, idx, read_op="add")
    err = _sum_bound_ok(got, want, mags)

    def bag():
        return F.embedding_bag(idx, vals, indptr, mode="sum",
                               include_last_offset=True)

    _sum_bound_ok(bag(), want, mags)
    rows_read = np.unique(tc.read_indices).size
    nt, nnz = tc.n, tc.nnz
    b_ms, b_by = bound(4 * rows_read * VALUE_WIDTH + 4 * (nt + 1) + 4 * nnz
                       + 4 * nt * VALUE_WIDTH, nnz * VALUE_WIDTH)
    rows.append(dict(
        name="stage_fused", route="cuda",
        source="src/repro_torch/csrc/stage_fused.cu",
        replaces="src/repro/kernels/stage_fused/kernel.py:162",
        launches=launches["stage_fused"], max_abs_err=err,
        ms=time_ms(lambda: fused_reduce(vals, indptr, idx, read_op="add")),
        plain_ms=time_ms(lambda: reduce_pairs_ref(vals, indptr, idx,
                                                  read_op="add")),
        bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(bag),
        shape=f"{nt} tasks, {nnz} pairs over ({K}, {VALUE_WIDTH}) float32, "
              f"{rows_read} distinct rows, read_op add"))
    for r in rows:
        log(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
            f"library {r['library_ms']:.4f}, bound {r['bound_ms']:.4f} by "
            f"{r['bound_by']}) at {r['shape']}; {r['launches']} launches "
            f"on the main path")
    return rows


# ---------------------------------------------------------------------------
# phase 5: how busy the card is during a stage
# ---------------------------------------------------------------------------
_OWN_KERNELS = ("hist_", "seg_combine", "write_elect", "write_gather",
                "fused_reduce")


def busy_phase(K, stages, init) -> list:
    """Device busy and idle share of stages (a)-(c) on the torch backend, by
    torch.profiler: busy is the union of the device's own events (kernels,
    copies, fills) over a stage's wall time, in a second run of the stage
    (the first one uploads the store). Device time is split into this
    port's kernels, host<->device copies, and torch's other kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sess.run_stage(tasks, f, write_back=merge, return_results=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        spans = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        if not spans:
            raise AssertionError(f"stage {name}: the profiler saw no "
                                 "device activity")
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
        row = dict(stage=name, desc=desc, wall_s=wall, device_busy_s=busy,
                   idle_share=1.0 - busy / wall, **split)
        log(f"  stage {name} ({desc}): wall {wall:.3f} s, device busy "
            f"{busy * 1e3:.2f} ms (idle {row['idle_share']:.4f}); port "
            f"kernels {split['port_kernels_ms']:.3f} ms, copies "
            f"{split['copies_ms']:.3f} ms, other device work "
            f"{split['other_device_ms']:.3f} ms")
        rows.append(row)
    return rows


def main() -> int:
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
    log(f"[1/5] environment: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _lib.build()
    log(f"  kernels built from src/repro_torch/csrc in "
        f"{time.perf_counter() - t0:.2f} s (sm_90a)")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("[2/5] kernel parity against the plain PyTorch versions")
    parity_phase(dev)
    torch.cuda.synchronize()

    log("[3/5] main path: P=16, 800,000 tasks/stage, 800,000 keys x 16, "
        "backend='torch' vs the numpy oracle")
    kernels.reset_launches()
    stages_out, K, stages, init = main_path("cuda")
    torch.cuda.synchronize()
    launches = kernels.launches()
    log(f"  kernel launches on the main path: {launches}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    want = {k: sum(e[k] for e in EXPECTED_LAUNCHES.values())
            for k in launches}
    if launches != want:
        raise AssertionError(f"main path launches {launches}, expected "
                             f"{want}")

    log("[4/5] kernel times at the main path's shapes")
    rows = timing_phase(dev, K, stages, init, launches)
    for r in rows:
        if not all(np.isfinite(r[k]) for k in ("ms", "plain_ms", "bound_ms")):
            raise AssertionError(f"{r['name']}: non-finite timing")

    log("[5/5] device busy share of a stage (torch.profiler)")
    busy = busy_phase(K, stages, init)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "stages": stages_out, "kernels": rows,
         "device_busy": busy}, indent=1))

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
