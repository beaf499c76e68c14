"""The port's mesh-sharded backend (`repro_torch.core.backend.TorchSpmdBackend`
+ `core/shardexec.py`), the counterpart of `tests/test_spmd_backend.py`, on
the stacked mesh at P = 4 (all machines in one process, the plain kernels
on the CPU):

- every engine, arity 1 and ragged, replication on and off: per-phase
  words/rounds, `exec_site` and `refcount` equal to the numpy oracle's
  (`assert_cost_parity`, bit for bit); values and results within 1e-12 of
  the oracle in float64 and rtol 2e-4 / atol 1e-5 in float32;
- the measured `ShardStageStats` against the cost model's placement, the
  replica slab, 1-D results and contexts, the fallback of a lambda torch
  cannot run, the slab cache against an out-of-band write, `run_chain`,
  the graph front door, the machine-count failure, and the Zipf balance
  case at P = 8 (which the JAX suite runs only on an 8-device mesh);
- `tests/test_elastic.py`'s `TestChaosSharded` at P = 8: recovery and
  migration, session parity with the oracle, one recovery.

On the card: `tests/test_torch_cuda_spmd.py`.
"""
import numpy as np
import pytest
import torch

import repro.core as ref
from repro_torch.core import (DataStore, Orchestrator, TaskBatch,
                              TorchBackend, TorchSpmdBackend,
                              assert_cost_parity, assert_session_parity,
                              make_backend)

torch.set_num_threads(1)

P = 4
ENGINES = ["tdorch", "pull", "push", "sort"]
RTOL, ATOL = 2e-4, 1e-5  # float32 sharded pipeline vs float64 oracle
TOL64 = 1e-12
REP = {"num_hot": 8, "refresh": 2, "min_count": 1.0}

# one backend per dtype for the module: its mesh and caches stay warm
SPMD = {"float64": TorchSpmdBackend(device="cpu", dtype="float64"),
        "float32": TorchSpmdBackend(device="cpu")}


def _tol(dtype):
    return (TOL64, TOL64) if dtype == "float64" else (RTOL, ATOL)


def _muladd(contexts, in_vals):
    mul = contexts[:, 1:2]
    add = contexts[:, 2:3]
    return {"update": in_vals * mul + add, "result": in_vals}


def _masked_sum(contexts, vals, mask):
    flat = vals.reshape(vals.shape[0], -1) if vals.ndim == 3 else vals
    return {"update": flat[:, :3] + contexts[:, :1], "result": flat}


def _make_store(P=P, K=60, w=3, seed=0):
    rng = np.random.default_rng(seed)
    store = DataStore.create(K, P, value_width=w, chunk_words=w)
    store.write_rows(np.arange(K), rng.standard_normal((K, w)))
    return store


def _arity1_batches(K, n=72, stages=3, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(stages):
        keys = rng.integers(0, K, n)
        is_read = rng.random(n) < 0.5
        ctx = np.concatenate([is_read[:, None].astype(float),
                              rng.standard_normal((n, 2))], axis=1)
        wk = np.where(is_read, np.int64(-1), keys)
        out.append(TaskBatch(contexts=ctx, read_keys=keys, write_keys=wk,
                             origin=TaskBatch.even_origins(n, P)))
    return out


def _ragged_batches(K, n=48, stages=2, seed=2):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(stages):
        groups = [rng.integers(0, K, rng.integers(0, 4)).tolist()
                  for _ in range(n)]
        ctx = rng.standard_normal((n, 2))
        wk = np.array([g[0] if g else -1 for g in groups], dtype=np.int64)
        out.append(TaskBatch.from_ragged(ctx, groups,
                                         TaskBatch.even_origins(n, P),
                                         write_keys=wk))
    return out


def _run(backend, engine, batches, f, merge, replication=None, seed=0):
    store = _make_store(seed=seed)
    sess = Orchestrator(store, engine=engine, backend=backend,
                        replication=replication)
    results = [sess.run_stage(t, f, write_back=merge, return_results=True)
               for t in batches]
    return store, results, sess


def _assert_parity(store_np, res_np, store_sx, res_sx, rtol=RTOL, atol=ATOL):
    assert np.allclose(store_np.values, store_sx.values, rtol=rtol, atol=atol)
    for a, b in zip(res_np, res_sx):
        assert_cost_parity(a.report, b.report)
        assert np.array_equal(a.exec_site, b.exec_site)
        assert a.refcount == b.refcount
        if a.results is not None:
            n = np.asarray(a.results).shape[0]
            assert np.allclose(
                np.asarray(a.results, dtype=np.float64).reshape(n, -1),
                np.asarray(b.results, dtype=np.float64).reshape(n, -1),
                rtol=rtol, atol=atol)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("merge", ["write", "add", "min"])
@pytest.mark.parametrize("replicated", [False, True],
                         ids=["rep_off", "rep_on"])
def test_arity1_parity(engine, merge, replicated):
    rep = REP if replicated else None
    batches = _arity1_batches(K=60)
    s_np, r_np, _ = _run("numpy", engine, batches, _muladd, merge, rep)
    for dtype, be in SPMD.items():
        s_sx, r_sx, _ = _run(be, engine, batches, _muladd, merge, rep)
        _assert_parity(s_np, r_np, s_sx, r_sx, *_tol(dtype))
        assert not be._host_lambdas


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("replicated", [False, True],
                         ids=["rep_off", "rep_on"])
def test_ragged_parity(engine, replicated):
    rep = REP if replicated else None
    batches = _ragged_batches(K=60)
    s_np, r_np, _ = _run("numpy", engine, batches, _masked_sum, "add", rep)
    for dtype, be in SPMD.items():
        s_sx, r_sx, _ = _run(be, engine, batches, _masked_sum, "add", rep)
        _assert_parity(s_np, r_np, s_sx, r_sx, *_tol(dtype))


def test_values_match_single_device_torch():
    """The value contract, directly: torch_spmd against the single-device
    torch backend (not just both against the oracle)."""
    batches = _arity1_batches(K=60, stages=3, seed=21)
    s_tx, r_tx, _ = _run(TorchBackend(device="cpu", dtype="float64"),
                         "tdorch", batches, _muladd, "add")
    s_sx, r_sx, _ = _run(SPMD["float64"], "tdorch", batches, _muladd, "add")
    assert np.allclose(s_tx.values, s_sx.values, rtol=TOL64, atol=TOL64)
    for a, b in zip(r_tx, r_sx):
        assert_cost_parity(a.report, b.report)


def test_shard_layout_geometry():
    """Each chunk appears exactly once, on its home shard, and the inverse
    maps agree — the slab layout every shard's residency is cut from."""
    store = _make_store(K=37, seed=5)
    lay = store.shard_layout()
    assert np.array_equal(lay.owner, store.home)
    assert lay.counts.sum() == store.num_keys
    assert lay.slab_rows == int(lay.counts.max())
    live = lay.slab_keys < store.num_keys
    assert np.array_equal(np.sort(lay.slab_keys[live]),
                          np.arange(store.num_keys))
    back = lay.slab_keys[store.home, lay.local_slot]
    assert np.array_equal(back, np.arange(store.num_keys))
    # the residency holds exactly the homed rows, zeros elsewhere
    from repro_torch.core import shardexec

    be = SPMD["float64"]
    slabs = shardexec._slabs_for(store, be.mesh(P), be._np_dtype).numpy()
    assert np.array_equal(slabs[live], store.values[lay.slab_keys[live]])
    assert not slabs[~live].any()


def test_shard_stats_measure_real_placement():
    """The measured per-shard task counts equal the cost model's
    execution-site placement."""
    be = SPMD["float64"]
    be.reset_stats()
    batches = _arity1_batches(K=60, stages=1, seed=7)
    _, res, _ = _run(be, "push", batches, _muladd, "add")
    stats = be.stage_stats[-1]
    want = np.bincount(res[0].exec_site, minlength=P)
    assert np.array_equal(stats.tasks, want)
    assert stats.tasks.sum() == batches[0].n
    assert stats.work_ratio() >= 1.0
    # every request sent was received by an owner, every combined row too
    assert stats.fetch_sent.sum() == stats.fetch_recv.sum()
    assert stats.combine_sent.sum() == stats.combine_recv.sum()


def test_replica_slab_serves_hot_reads():
    """With replication on, hot chunks are read from the shard-local
    replica slab (measured), and the slab stays fresh across write-backs."""
    rep = {"num_hot": 8, "refresh": 1, "min_count": 1.0}
    batches = _arity1_batches(K=12, n=64, stages=4, seed=11)
    be = SPMD["float64"]
    be.reset_stats()
    s_np, r_np, _ = _run("numpy", "tdorch", batches, _muladd, "write", rep)
    s_sx, r_sx, _ = _run(be, "tdorch", batches, _muladd, "write", rep)
    _assert_parity(s_np, r_np, s_sx, r_sx, TOL64, TOL64)
    measured = sum(int(st.replica_local.sum()) for st in be.stage_stats)
    assert measured > 0


def test_session_report_per_machine():
    batches = _arity1_batches(K=60, stages=2, seed=13)
    _, _, sess = _run("numpy", "tdorch", batches, _muladd, "add")
    pm = sess.report.per_machine()
    assert pm["work"].shape == (P,)
    assert pm["work_ratio"] >= 1.0
    _, _, sess_sx = _run(SPMD["float32"], "tdorch", batches, _muladd, "add")
    pm_sx = sess_sx.report.per_machine()
    assert np.array_equal(pm["work"], pm_sx["work"])
    assert np.array_equal(pm["h_relation"], pm_sx["h_relation"])


def test_one_dimensional_results_keep_their_shape():
    def scalar_result(contexts, in_vals):
        return {"result": in_vals[:, 0] * 2.0}

    batches = _arity1_batches(K=60, stages=1, seed=17)
    _, r_np, _ = _run("numpy", "pull", batches, scalar_result, "add")
    _, r_sx, _ = _run(SPMD["float64"], "pull", batches, scalar_result, "add")
    assert np.asarray(r_np[0].results).shape \
        == np.asarray(r_sx[0].results).shape
    assert np.allclose(np.asarray(r_np[0].results, dtype=np.float64),
                       np.asarray(r_sx[0].results, dtype=np.float64),
                       rtol=TOL64, atol=TOL64)
    assert_cost_parity(r_np[0].report, r_sx[0].report)


def test_one_dimensional_contexts_reach_the_lambda_unchanged():
    def scale(ctx, vals):
        if ctx.ndim != 1:  # lifted contexts must fail loudly, not fall back
            raise AssertionError(f"contexts reached the lambda as "
                                 f"{tuple(ctx.shape)}")
        return {"result": vals * ctx[:, None]}

    ctx = np.random.default_rng(29).standard_normal(40)
    keys = np.random.default_rng(30).integers(0, 60, 40)

    def mk():
        return TaskBatch(contexts=ctx.copy(), read_keys=keys,
                         origin=TaskBatch.even_origins(40, P))

    be = SPMD["float64"]
    a = _run("numpy", "pull", [mk()], scale, "add")
    b = _run(be, "pull", [mk()], scale, "add")
    _assert_parity(a[0], a[1], b[0], b[1], TOL64, TOL64)
    assert id(scale) not in be._host_lambdas  # really ran on the mesh


def test_untraceable_lambda_falls_back():
    def hostile(contexts, in_vals):
        v = in_vals.astype(np.float64)  # numpy's astype: not on a tensor
        return {"update": v * 2.0, "result": v}

    be = TorchSpmdBackend(device="cpu", dtype="float64")
    batches = _arity1_batches(K=60, stages=2, seed=9)
    s_np, r_np, _ = _run("numpy", "pull", batches, hostile, "add")
    with pytest.warns(RuntimeWarning, match="host numpy path"):
        s_sx, r_sx, _ = _run(be, "pull", batches, hostile, "add")
    assert np.array_equal(s_np.values, s_sx.values)  # oracle path: exact
    for a, b in zip(r_np, r_sx):
        assert_cost_parity(a.report, b.report)
    assert id(hostile) in be._host_lambdas
    assert be.stage_stats == []  # no stage ran on the mesh


def test_slab_cache_tracks_store_version():
    """An out-of-band write between stages invalidates the sharded
    residency, as it does the single-device value cache."""
    store = _make_store(seed=11)
    sess = Orchestrator(store, engine="pull", backend=SPMD["float64"])
    batches = _arity1_batches(K=60, stages=2, seed=12)
    sess.run_stage(batches[0], _muladd, write_back="write",
                   return_results=True)
    store.write_rows(np.arange(store.num_keys),
                     np.full((store.num_keys, store.value_width), 7.0))
    res = sess.run_stage(batches[1], _muladd, write_back="write",
                         return_results=True)
    got = np.asarray(res.results, dtype=np.float64)
    assert np.allclose(got, 7.0, rtol=TOL64, atol=TOL64)


@pytest.mark.parametrize("engine", ["tdorch", "auto"])
def test_run_plan_front_door(engine):
    """StagePlan chains (the kv `run_chain` path) run through the sharded
    backend with hop-identical bills."""
    from repro_torch.kvstore import DistributedHashTable

    rng = np.random.default_rng(23)
    keys = rng.integers(0, 80, (24, 3))
    op = rng.standard_normal((24, 2))
    out = {}
    for name, backend in [("numpy", "numpy"), ("spmd", SPMD["float64"])]:
        ht = DistributedHashTable(80, P, value_width=4, seed=3)
        ht.bulk_load(np.arange(80),
                     np.random.default_rng(7).standard_normal((80, 4)))
        out[name] = ht.run_chain(keys, op, engine=engine, backend=backend)
    a, b = out["numpy"], out["spmd"]
    assert a.hops == b.hops
    assert np.array_equal(a.keys, b.keys)
    assert np.allclose(np.nan_to_num(a.values), np.nan_to_num(b.values),
                       rtol=TOL64, atol=TOL64)
    for ra, rb in zip(a.reports, b.reports):
        assert_cost_parity(ra, rb)


def test_graph_front_door():
    from repro_torch.graph import generators
    from repro_torch.graph.algorithms import pagerank
    from repro_torch.graph.partition import ingest

    g = generators.barabasi_albert(400, 4, seed=1)
    og = ingest(g, P=P, backend="numpy")
    v_np, i_np = pagerank(og, backend="numpy", max_iter=5, tol=0.0)
    v_sx, i_sx = pagerank(og, backend=SPMD["float64"], max_iter=5, tol=0.0)
    assert np.allclose(np.asarray(v_np, float), np.asarray(v_sx, float),
                       rtol=TOL64, atol=TOL64)
    assert i_np.rounds == i_sx.rounds
    for a, b in zip(i_np.stats, i_sx.stats):
        assert_cost_parity(a.report, b.report)


def test_orchestrator_validates_machines_at_construction():
    """The session asks the backend for its mesh when it is built: a
    backend whose mesh cannot hold P machines fails there, before any
    stage (here: a stand-in that refuses every P)."""
    class Refusing(TorchSpmdBackend):
        def validate_machines(self, P):
            raise RuntimeError(f"no mesh for P={P}")

    with pytest.raises(RuntimeError, match="no mesh for P=4"):
        Orchestrator(_make_store(), backend=Refusing(device="cpu"))


def test_make_backend_runs_on_the_card_by_default():
    """`make_backend("torch_spmd")` builds the backend on the card and never
    quietly on the CPU."""
    if torch.cuda.is_available():  # pragma: no cover - needs the card
        assert make_backend("torch_spmd").device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        make_backend("torch_spmd")
    assert TorchSpmdBackend(device="cpu").device.type == "cpu"
    assert make_backend(SPMD["float32"]) is SPMD["float32"]


def test_zipf_skew_balance_with_replication():
    """On the Zipf alpha=1.2 workload with replication on, the tdorch
    session's per-machine max/mean work ratio stays <= 1.5 on an 8-shard
    mesh, and the mesh measures the same placement."""
    from repro_torch.kvstore import make_ycsb_stream

    P8, nkeys = 8, 4096
    be = TorchSpmdBackend(device="cpu")
    store = DataStore.create(nkeys, P8, value_width=8, chunk_words=8)
    sess = Orchestrator(store, engine="tdorch", backend=be,
                        replication={"num_hot": 64, "refresh": 2,
                                     "decay": 0.5, "min_count": 8.0})
    origin = TaskBatch.even_origins(500 * P8, P8)
    for keys, is_read, operand in make_ycsb_stream(
            "C", 500, P8, nkeys, gamma=1.2, seed=17, stages=6):
        ctx = np.concatenate(
            [is_read[:, None].astype(np.float64), operand], axis=1)
        wk = np.where(is_read, np.int64(-1), keys)
        tasks = TaskBatch(contexts=ctx, read_keys=keys, write_keys=wk,
                          origin=origin)
        res = sess.run_stage(tasks, _muladd, write_back="write")
        assert np.array_equal(be.stage_stats[-1].tasks,
                              np.bincount(res.exec_site, minlength=P8))
    pm = sess.report.per_machine()
    assert pm["work_ratio"] <= 1.5, pm["work_ratio"]


# ---------------------------------------------------------------------------
# chaos conformance: a seeded kill mid-run on the 8-machine mesh
# ---------------------------------------------------------------------------
K_CHAOS, P_CHAOS, N_CHAOS = 192, 8, 384


def _chaos_store(salt=3, seed=42):
    st = DataStore.create(K_CHAOS, P_CHAOS, value_width=2, chunk_words=4,
                          salt=salt)
    st.write_rows(np.arange(K_CHAOS),
                  np.random.default_rng(seed).standard_normal((K_CHAOS, 2)))
    return st


def _chaos_batch(i):
    r = np.random.default_rng(1000 + i)
    keys = (r.zipf(1.4, size=N_CHAOS) % K_CHAOS).astype(np.int64)
    return TaskBatch(contexts=r.standard_normal((N_CHAOS, 1)),
                     read_keys=keys, write_keys=keys.copy(),
                     origin=r.integers(0, P_CHAOS, size=N_CHAOS))


def _chaos_muladd(ctx, vals):
    return {"update": vals * 0.5 + ctx[:, :1]}


def _drive(sess, stages=8):
    for i in range(stages):
        sess.run_stage(_chaos_batch(i), _chaos_muladd)
    return sess


class TestChaosSharded:
    def test_spmd_recovery_matches_oracle(self):
        elastic = {"recovery": {"injector": {4: [3]}},
                   "migration": {"refresh": 3, "min_count": 4.0}}
        oracle = _drive(Orchestrator(_chaos_store(), elasticity=elastic,
                                     backend="numpy"))
        be = TorchSpmdBackend(device="cpu")
        spmd = _drive(Orchestrator(_chaos_store(), backend=be,
                                   elasticity=elastic))
        spmd.backend.sync(spmd.store)
        np.testing.assert_allclose(spmd.store.values, oracle.store.values,
                                   rtol=2e-4, atol=1e-5)
        # the cost model is simulated identically on both backends — the
        # elastic phases included, bit for bit
        assert_session_parity(oracle.report, spmd.report)
        assert spmd.elastic.counters()["recoveries"] == 1
        assert len(be.stage_stats) == 8 and not be._host_lambdas

    def test_matches_the_reference_package(self):
        """The port's elastic sharded session bills what the JAX package's
        numpy session bills under the same spec."""
        elastic = {"recovery": {"injector": {4: [3]}},
                   "migration": {"refresh": 3, "min_count": 4.0}}
        st = ref.DataStore.create(K_CHAOS, P_CHAOS, value_width=2,
                                  chunk_words=4, salt=3)
        st.write_rows(np.arange(K_CHAOS), np.random.default_rng(42)
                      .standard_normal((K_CHAOS, 2)))
        rs = ref.Orchestrator(st, elasticity=elastic, backend="numpy")
        for i in range(8):
            b = _chaos_batch(i)
            rs.run_stage(ref.TaskBatch(contexts=b.contexts,
                                       read_keys=b.read_keys,
                                       write_keys=b.write_keys,
                                       origin=b.origin), _chaos_muladd)
        spmd = _drive(Orchestrator(_chaos_store(),
                                   backend=TorchSpmdBackend(device="cpu"),
                                   elasticity=elastic))
        assert [s.phase_signature() for s in spmd.report.stages] \
            == [s.phase_signature() for s in rs.report.stages]
        np.testing.assert_allclose(spmd.store.values, st.values, rtol=2e-4,
                                   atol=1e-5)
