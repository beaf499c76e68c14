"""The port's other engines — the §2.3 baselines `pull`, `push`, `sort` and
the per-stage policy `auto` — against the JAX package's, on the same
seeded numpy inputs in one process (the port through
``TorchBackend(device="cpu")``, the reference through ``backend="numpy"``).

- Stages: per-phase `phase_signature()`, `exec_site` and `refcount`
  exactly; values and results within 1e-12 in float64 and within rtol
  1e-5 / atol 1e-5 in float32 (both sides sum the same few terms, in
  other orders and precisions).
- `estimate_cost` of every engine (TD-Orch's too) equals the reference's
  bill, phase by phase, and the realized bill of a conforming stage.
- `auto`'s decision trace (choice, incumbent, switch, every candidate's
  predicted bill, predicted / realized / policy words) equals the
  reference's on `tests/test_policy.py`'s workloads, replication on and
  off, and its hysteresis and configuration behave as the reference's.
"""
import numpy as np
import pytest
import torch

import repro.core as ref
import repro_torch.core as port
from repro.core.policy import StageLayout as RefLayout
from repro_torch.core.cost import POLICY_PHASE
from repro_torch.core.policy import StageLayout as PortLayout
from repro_torch.kvstore.ycsb import zipf_keys_stationary

# one intra-op thread per test process: the suite runs in parallel workers
torch.set_num_threads(1)

ENGINES = ["pull", "push", "sort", "auto"]
KINDS = ["arity1", "ragged", "fused"]
REP = {"num_hot": 8, "refresh": 1, "min_count": 1.0}
F64_TOL = 1e-12
F32_RTOL = F32_ATOL = 1e-5


def _muladd(contexts, vals):
    out = vals * contexts[:, 0:1] + contexts[:, 1:2]
    return {"update": out, "result": out}


def _masked_sum(contexts, vals, mask):
    s = (vals * mask[..., None]).sum(1)
    return {"update": s * contexts[:, :1], "result": s}


def _scale(contexts, red):
    return red * contexts[:, :1] + contexts[:, 1:2]


def _lambda(pkg, kind):
    if kind == "arity1":
        return _muladd
    if kind == "ragged":
        return _masked_sum
    return pkg.fused_read("add", _scale)


def _batches(pkg, kind, K=60, n=64, P=4, seed=1):
    """Three stages' batches (one a merge): Zipf-skewed keys, so hot chunks
    exist for the forest, replication and `auto` to see."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(K)
    out = []
    for _ in range(3):
        ctx = rng.standard_normal((n, 2))
        prio = rng.integers(-1000, 1000, n)
        origin = rng.integers(0, P, n)
        if kind == "arity1":
            keys = zipf_keys_stationary(n, K, 1.2, rng, perm)
            out.append(pkg.TaskBatch(contexts=ctx, read_keys=keys,
                                     origin=origin, priority=prio))
            continue
        groups = [zipf_keys_stationary(int(a), K, 1.2, rng, perm).tolist()
                  for a in rng.integers(0, 5, n)]
        tb = pkg.TaskBatch.from_ragged(ctx, groups, origin)
        tb.priority = prio
        out.append(tb)
    return out


def _store(pkg, K=60, P=4, w=3, seed=0):
    store = pkg.DataStore.create(K, P, value_width=w)
    store.write_rows(np.arange(K),
                     np.random.default_rng(seed).standard_normal((K, w)))
    return store


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64),
                               rtol=rtol, atol=atol)


def _trace(sess):
    return [(d.stage_index, d.choice, d.incumbent, d.switched,
             tuple(sorted(d.predicted.items())), d.predicted_words,
             d.realized_words, d.policy_words)
            for d in sess.report.policy_decisions]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("replication", [None, REP],
                         ids=["rep_off", "rep_on"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("engine", ENGINES)
def test_engine_stages_match_reference(engine, kind, replication, dtype):
    rtol, atol = ((F64_TOL, F64_TOL) if dtype == "float64"
                  else (F32_RTOL, F32_ATOL))
    st_p, st_r = _store(port), _store(ref)
    be = port.TorchBackend(device="cpu", dtype=dtype)
    s_p = port.Orchestrator(st_p, engine=engine, backend=be,
                            replication=replication)
    s_r = ref.Orchestrator(st_r, engine=engine, backend="numpy",
                           replication=replication)
    for merge, tb_p, tb_r in zip(("add", "min", "write"),
                                 _batches(port, kind), _batches(ref, kind)):
        r_p = s_p.run_stage(tb_p, _lambda(port, kind), write_back=merge,
                            return_results=True)
        r_r = s_r.run_stage(tb_r, _lambda(ref, kind), write_back=merge,
                            return_results=True)
        assert r_p.report.phase_signature() == r_r.report.phase_signature()
        np.testing.assert_array_equal(r_p.exec_site, r_r.exec_site)
        assert r_p.refcount == r_r.refcount
        _close(r_p.results, r_r.results, rtol, atol)
        _close(st_p.values, st_r.values, rtol, atol)
    assert not be._host_lambdas
    assert _trace(s_p) == _trace(s_r)
    ref.assert_session_parity(s_p.report, s_r.report)


def _layout_inputs(pkg, case):
    """(store, batch, replicas, return_results) of one estimator case; the
    replicated case takes the directory a session built over a stage."""
    kind = "arity1" if case in ("arity1", "results", "replicated") else case
    store, batches = _store(pkg), _batches(pkg, kind, seed=7)
    replicas = None
    if case == "replicated":
        sess = pkg.Orchestrator(store, backend="numpy", replication=REP)
        sess.run_stage(batches[0], _muladd)
        sess.run_stage(batches[1], _muladd)
        replicas = sess.replicas
        assert replicas.num_replicated > 0
    return store, batches[2], replicas, case == "results"


@pytest.mark.parametrize("case", ["arity1", "ragged", "replicated",
                                  "results"])
@pytest.mark.parametrize("engine", ["tdorch", "pull", "push", "sort"])
def test_estimate_cost_matches_reference(engine, case):
    st_p, tb_p, rep_p, results = _layout_inputs(port, case)
    st_r, tb_r, rep_r, _ = _layout_inputs(ref, case)
    eng_p = port.make_engine(engine, 4,
                             backend=port.TorchBackend(device="cpu"))
    eng_r = ref.make_engine(engine, 4, backend="numpy")
    est_p = eng_p.estimate_cost(None, PortLayout.capture(
        tb_p, st_p, replicas=rep_p, return_results=results))
    est_r = eng_r.estimate_cost(None, RefLayout.capture(
        tb_r, st_r, replicas=rep_r, return_results=results))
    assert est_p.engine == est_r.engine == engine
    assert est_p.report.phase_signature() == est_r.report.phase_signature()
    assert (est_p.total_words, est_p.rounds, est_p.max_comm) == \
        (est_r.total_words, est_r.rounds, est_r.max_comm)
    # the bill is the realized one for a lambda of the store's width
    f = _lambda(port, "fused" if case == "ragged" else "arity1")
    res = eng_p.run_stage(tb_p, st_p, f, return_results=results,
                          replicas=rep_p)
    port.assert_cost_parity(est_p.report, res.report)


# tests/test_policy.py's workload grid, on a (64, 4) store over P = 8
PP, KK, WW = 8, 64, 4


def _policy_store(pkg):
    store = pkg.DataStore.create(KK, PP, value_width=WW, chunk_words=WW)
    store.write_rows(np.arange(KK), np.random.default_rng(99)
                     .standard_normal((KK, WW)))
    return store


def _policy_batch(pkg, keys, origin, seed, write_keys=None):
    n = keys.size
    return pkg.TaskBatch(
        read_keys=keys, origin=origin,
        write_keys=keys.copy() if write_keys is None else write_keys,
        contexts=np.random.default_rng(seed).standard_normal((n, 2)))


def _workload(pkg, name, stages=4, n=320):
    if name == "uniform":
        rng = np.random.default_rng(0)
        return [_policy_batch(pkg, rng.integers(0, KK, n),
                              rng.integers(0, PP, n), i) for i in range(stages)]
    if name.startswith("zipf"):
        rng = np.random.default_rng(1)
        perm = rng.permutation(KK)
        return [_policy_batch(pkg, zipf_keys_stationary(
            n, KK, float(name.split("_")[1]), rng, perm),
            rng.integers(0, PP, n), 1 + i) for i in range(stages)]
    if name == "hot_chunk":
        rng = np.random.default_rng(2)
        return [_policy_batch(pkg, np.zeros(n, dtype=np.int64),
                              rng.integers(0, PP, n), 2 + i)
                for i in range(stages)]
    # graph frontier: read the source chunk, write the destination's
    rng = np.random.default_rng(3)
    adj = [rng.choice(KK, size=rng.integers(8, 17), replace=False)
           for _ in range(KK)]
    home = _policy_store(pkg).home
    frontier, out = np.arange(6, dtype=np.int64), []
    for i in range(5):
        src = np.repeat(frontier, [len(adj[int(v)]) for v in frontier])
        dst = np.concatenate([adj[int(v)] for v in frontier])
        out.append(pkg.TaskBatch(
            read_keys=src.astype(np.int64), write_keys=dst.astype(np.int64),
            contexts=rng.standard_normal((src.size, 2)), origin=home[src]))
        frontier = np.unique(dst)
    return out


def _policy_muladd(ctx, vals):
    return {"update": vals * ctx[:, :1] + ctx[:, 1:2]}


@pytest.mark.parametrize("replication", [None, {"num_hot": 8, "refresh": 2,
                                                "min_count": 1.0}],
                         ids=["rep_off", "rep_on"])
@pytest.mark.parametrize("workload", ["uniform", "zipf_0.8", "zipf_1.2",
                                      "zipf_1.5", "hot_chunk", "frontier"])
def test_auto_decision_trace_matches_reference(workload, replication):
    sessions = []
    for pkg, backend in ((port, port.TorchBackend(device="cpu",
                                                  dtype="float64")),
                         (ref, "numpy")):
        sess = pkg.Orchestrator(_policy_store(pkg), engine="auto",
                                backend=backend, replication=replication)
        for b in _workload(pkg, workload):
            sess.run_stage(b, _policy_muladd, write_back="add")
        sessions.append(sess)
    s_p, s_r = sessions
    assert _trace(s_p) and _trace(s_p) == _trace(s_r)
    ref.assert_session_parity(s_p.report, s_r.report)
    np.testing.assert_allclose(s_p.store.values, s_r.store.values,
                               rtol=F64_TOL, atol=F64_TOL)
    # a conforming lambda: the chosen engine's prediction is the stage's
    # bill without the policy phase
    for d, stage in zip(s_p.report.policy_decisions, s_p.report.stages):
        port.assert_cost_parity(d.estimate.report, port.StageReport(
            stage.P, [ph for ph in stage.phases
                      if ph.name not in (POLICY_PHASE, "replica_refresh")]))


def _estimate(pkg, name, words):
    cost = pkg.CostAccumulator(2)
    cost.begin("synthetic")
    cost.send(np.array([0]), np.array([1]), float(words))
    cost.tick()
    cost.end()
    return pkg.PhaseCostEstimate(name, cost.totals())


@pytest.mark.parametrize("objective", ["total_words", "bsp"])
def test_hysteresis_matches_reference(objective):
    """The same bill sequence through both packages' `StagePolicy`: inside
    the 5% band the incumbent stays, a decisive challenger wins, ties go
    to candidate order."""
    bills = [(100, 110), (102, 100), (100, 50), (60, 58), (7, 7), (7, 1)]
    traces = []
    for pkg in (port, ref):
        policy = pkg.StagePolicy(pkg.PolicyConfig(
            candidates=("a", "b"), objective=objective, round_latency=3.0))
        traces.append([
            (d.choice, d.incumbent, d.switched, d.predicted,
             d.predicted_words)
            for d in (policy.choose({"a": _estimate(pkg, "a", wa),
                                     "b": _estimate(pkg, "b", wb)})
                      for wa, wb in bills)])
    assert traces[0] == traces[1]
    assert [t[0] for t in traces[0]] == ["a", "a", "b", "b", "b", "b"]


def test_policy_config_and_candidates_match_reference():
    from repro.core.policy import make_policy_config as ref_make
    from repro_torch.core.policy import make_policy_config as port_make

    spec = {"candidates": ["pull", "push"], "hysteresis": 0.2}
    assert port_make(spec) == port.PolicyConfig(**{**spec, "candidates": (
        "pull", "push")})
    assert port_make(None) == port.PolicyConfig()
    assert tuple(port_make(spec).__dict__.items()) == \
        tuple(ref_make(spec).__dict__.items())
    with pytest.raises(TypeError):
        port_make("tdorch")
    with pytest.raises(ValueError, match="not estimable"):
        port.Orchestrator(_policy_store(port), engine="auto",
                          backend="numpy", policy={"candidates": ("zzz",)})
    chosen = []
    for pkg, backend in ((port, port.TorchBackend(device="cpu")),
                         (ref, "numpy")):
        sess = pkg.Orchestrator(_policy_store(pkg), engine="auto",
                                backend=backend,
                                policy={"candidates": ("pull", "sort")})
        for b in _workload(pkg, "zipf_1.2"):
            sess.run_stage(b, _policy_muladd, write_back="add")
        chosen.append([d.choice for d in sess.report.policy_decisions])
    assert chosen[0] == chosen[1]
    assert set(chosen[0]) <= {"pull", "sort"}
