"""The port's elastic sessions (`repro_torch.core.elasticity` through
`Orchestrator(elasticity=...)`) against the JAX package's, case by case
with `tests/test_elastic.py`, on the same seeded numpy inputs in one
process: the port on ``TorchBackend(device="cpu")`` in float64 and float32,
the reference on ``backend="numpy"``.

- Bills: every stage's `phase_signature()` (the migration, steal and
  recovery phases included), `exec_site`, the per-machine steal counters,
  the elastic counters and the migration `moves` log equal the
  reference's exactly.
- Values: within 1e-12 in float64 and rtol 1e-5 / atol 1e-5 in float32,
  each stage from the reference's values (skewed add stages grow a hot key
  by ~76x a stage, to 1e14 in eight, and the summation-order differences
  of the two packages with it: a whole run's drift is not one stage's
  rounding).
- Within the port, elasticity never changes values: migration and
  stealing runs, and restart / shrink recoveries (in memory, with a
  write-log, durable, heartbeat-driven), equal the inelastic run bit for
  bit in float64; a machine killed mid-plan (`run_chain`, under the torch
  plan scope) replays to the uninterrupted chain's values and bills.
"""
import numpy as np
import pytest
import torch

import repro.core as ref
import repro_torch.core as port
from repro.runtime import failures as ref_failures
from repro_torch.runtime import failures as port_failures

# one intra-op thread per test process: the suite runs in parallel workers
torch.set_num_threads(1)

K, P, N = 192, 8, 384
DTYPES = ["float64", "float32"]
F64_TOL = 1e-12
F32_TOL = 1e-5


def mk_store(pkg, salt=3, seed=42):
    st = pkg.DataStore.create(K, P, value_width=2, chunk_words=4, salt=salt)
    st.write_rows(np.arange(K),
                  np.random.default_rng(seed).standard_normal((K, 2)))
    return st


def batch(pkg, i, skew=False):
    r = np.random.default_rng(1000 + i)
    if skew:  # hot head: most demand lands on a handful of homes
        keys = r.zipf(1.4, size=N) % K
    else:
        keys = r.integers(0, K, size=N)
    return pkg.TaskBatch(contexts=r.standard_normal((N, 1)),
                         read_keys=keys.astype(np.int64),
                         write_keys=keys.astype(np.int64).copy(),
                         origin=r.integers(0, P, size=N))


def muladd(ctx, vals):
    return {"update": vals * 0.5 + ctx[:, :1]}


def _be(dtype):
    return port.TorchBackend(device="cpu", dtype=dtype)


def _tol(dtype):
    t = F64_TOL if dtype == "float64" else F32_TOL
    return dict(rtol=t, atol=t)


def drive(sess, pkg, stages=8, skew=False, first=0):
    """Run `stages` batches; the per-stage `exec_site`s."""
    return [sess.run_stage(batch(pkg, first + i, skew=skew), muladd).exec_site
            for i in range(stages)]


def both(elastic, dtype="float64", engine="tdorch", stages=8, skew=False,
         **kw):
    """The same elastic case on the reference (numpy) and the port (torch
    on the CPU), stage by stage: the two sessions, after checking that
    they agree."""
    r = ref.Orchestrator(mk_store(ref), engine=engine, backend="numpy",
                         elasticity=_spec(elastic, ref), **kw)
    p = port.Orchestrator(mk_store(port), engine=engine, backend=_be(dtype),
                          elasticity=_spec(elastic, port), **kw)
    for i in range(stages):
        p.store.write_rows(np.arange(K), r.store.values)
        a = r.run_stage(batch(ref, i, skew=skew), muladd)
        b = p.run_stage(batch(port, i, skew=skew), muladd)
        assert a.report.phase_signature() == b.report.phase_signature()
        np.testing.assert_array_equal(a.exec_site, b.exec_site)
        np.testing.assert_allclose(p.store.values, r.store.values,
                                   **_tol(dtype))
    same_state(r, p)
    return r, p


def _spec(elastic, pkg):
    return elastic(pkg) if callable(elastic) else elastic


def same_state(r, p):
    """Placement, steal ledgers and elastic state of two sessions equal."""
    np.testing.assert_array_equal(p.store.home, r.store.home)
    pm_r, pm_p = r.report.per_machine(), p.report.per_machine()
    for k in ("stolen_in", "stolen_out"):
        np.testing.assert_array_equal(pm_p[k], pm_r[k])
    for k in ("migration_words", "steal_words", "recovery_words"):
        assert getattr(p.report, k) == getattr(r.report, k)
    if r.elastic is None:
        assert p.elastic is None
        return
    assert p.elastic.counters() == r.elastic.counters()
    if r.elastic.planner is not None:
        assert p.elastic.planner.moves == r.elastic.planner.moves
        np.testing.assert_array_equal(p.elastic.planner.by_origin,
                                      r.elastic.planner.by_origin)


def port_run(elastic=None, stages=8, skew=False, engine="tdorch", **kw):
    """The port alone in float64, from the seeded store to the end."""
    sess = port.Orchestrator(mk_store(port), engine=engine,
                             backend=_be("float64"), elasticity=elastic,
                             **kw)
    drive(sess, port, stages, skew)
    return sess


def same_values_as_inelastic(elastic, **kw):
    """Elasticity moves placement and execution, never values: the elastic
    port run equals the inelastic one bit for bit (float64)."""
    sess = port_run(elastic, **kw)
    plain = port_run(**kw)
    np.testing.assert_array_equal(plain.store.values, sess.store.values)
    return sess, plain


# ---------------------------------------------------------------------------
# SessionConfig resolution + front-door uniformity
# ---------------------------------------------------------------------------
class TestSessionConfig:
    def test_kwarg_and_config_spellings_agree(self):
        a = port.Orchestrator(mk_store(port), engine="push", backend="numpy",
                              replication=True)
        b = port.Orchestrator(mk_store(port), config=port.SessionConfig(
            engine="push", backend="numpy", replication=True))
        assert a.config == b.config
        assert a.engine_name == b.engine_name == "push"
        assert a.replicator is not None and b.replicator is not None

    def test_elasticity_spellings_resolve_as_the_reference(self):
        spec = {"migration": {"refresh": 2}, "stealing": True}
        got = port.resolve_session_config(elasticity=spec)
        want = ref.resolve_session_config(elasticity=spec)
        assert got.elasticity == want.elasticity == spec
        with pytest.raises(ValueError, match="set it in one place"):
            port.resolve_session_config(
                port.SessionConfig(elasticity=spec), elasticity={"x": 1})
        sess = port.Orchestrator(mk_store(port), backend="numpy",
                                 config={"elasticity": spec})
        assert sess.elastic.planner is not None
        assert sess.elastic.stealer is not None
        assert sess.elastic.recovery is None

    def test_off_specs_build_no_manager(self):
        for spec in (None, False, {}, port.ElasticityConfig()):
            sess = port.Orchestrator(mk_store(port), backend="numpy",
                                     elasticity=spec)
            assert sess.elastic is None
            assert not sess._stealer_ok

    def test_bad_specs_raise_type_error_as_the_reference(self):
        for pkg in (ref, port):
            with pytest.raises(TypeError, match="bad elasticity spec"):
                pkg.make_elasticity(42, mk_store(pkg))
            with pytest.raises(TypeError, match="bad StealConfig spec"):
                pkg.make_elasticity({"stealing": 3}, mk_store(pkg))
            with pytest.raises(TypeError):
                pkg.Orchestrator(mk_store(pkg), backend="numpy",
                                 elasticity={"no_such_knob": True})

    def test_orchestration_takes_elasticity(self):
        st_r, st_p = mk_store(ref), mk_store(port)
        spec = {"stealing": {"threshold": 1.05, "min_tasks": 8}}
        a = ref.orchestration(batch(ref, 0, skew=True), muladd, st_r,
                              backend="numpy", elasticity=spec)
        b = port.orchestration(batch(port, 0, skew=True), muladd, st_p,
                               backend=_be("float64"), elasticity=spec)
        assert a.report.phase_signature() == b.report.phase_signature()
        np.testing.assert_array_equal(a.exec_site, b.exec_site)
        assert any(ph.name == "phase3_steal" and ph.sent.sum() > 0
                   for ph in b.report.phases)

    def test_hashtable_session_cache_keys_on_elasticity(self):
        from repro_torch.kvstore import DistributedHashTable
        ht = DistributedHashTable(64, 4, value_width=2)
        s1 = ht.session(backend="numpy", elasticity={"stealing": True})
        s2 = ht.session(config=port.SessionConfig(
            backend="numpy", elasticity={"stealing": True}))
        assert s1 is s2 and s1.elastic is not None
        assert ht.session(backend="numpy") is not s1
        # serve(elasticity=) builds the same session and forks it: one
        # manager, whose counters the report's "elastic" block carries
        fe = ht.serve(backend="numpy", elasticity={"stealing": True},
                      mode="sync", config={"max_batch": 4})
        assert fe.sessions[0] is s1 and fe.sessions[1].elastic is s1.elastic
        futs = [fe.get(k) for k in range(8)]
        fe.drain()
        assert all(f.result().shape == (2,) for f in futs)
        assert fe.report()["elastic"] == s1.elastic.counters()
        fe.close()

    def test_graph_session_takes_config_but_rejects_elasticity(self):
        from repro_torch.graph import GraphSession, erdos_renyi, ingest
        og = ingest(erdos_renyi(64, avg_degree=4, seed=2), P=4, seed=0,
                    backend="numpy")
        gs = GraphSession(og, config=port.SessionConfig(
            backend="numpy", replication=True))
        assert gs.replicator is not None
        with pytest.raises(ValueError, match="elasticity"):
            GraphSession(og, config=port.SessionConfig(
                backend="numpy",
                elasticity=port.ElasticityConfig(stealing=True)))

    def test_fork_shares_the_manager(self):
        sess = port.Orchestrator(mk_store(port), backend="numpy",
                                 elasticity={"migration": True,
                                             "stealing": True})
        sib = sess.fork()
        assert sib.elastic is sess.elastic
        assert sib._stealer_ok

    def test_prebuilt_engine_with_backend_in_config_raises(self):
        st = mk_store(port)
        eng = port.Orchestrator(st, backend="numpy").engine
        with pytest.raises(ValueError, match="prebuilt engine"):
            port.Orchestrator(st, engine=eng, backend="numpy",
                              elasticity={"stealing": True})


# ---------------------------------------------------------------------------
# live chunk migration
# ---------------------------------------------------------------------------
class TestMigration:
    ELASTIC = {"migration": {"refresh": 2, "min_count": 4.0}}

    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("engine", ["tdorch", "push"])
    def test_matches_jax(self, engine, dtype):
        r, p = both(self.ELASTIC, dtype, engine=engine, skew=True)
        assert p.elastic.counters()["migrations"] > 0
        assert p.report.migration_words > 0

    @pytest.mark.parametrize("engine", ["tdorch", "push"])
    def test_values_bit_identical_to_inelastic(self, engine):
        sess, plain = same_values_as_inelastic(self.ELASTIC, engine=engine,
                                               skew=True)
        # inelastic routing really changed: some chunk lives elsewhere now
        assert (plain.store.home != sess.store.home).any()

    def test_deterministic_elections(self):
        runs = []
        for _ in range(2):
            sess = port_run(self.ELASTIC, skew=True)
            runs.append((list(sess.elastic.planner.moves),
                         sess.report.migration_words,
                         sess.store.home.copy()))
        assert runs[0][0] == runs[1][0]
        assert runs[0][1] == runs[1][1]
        np.testing.assert_array_equal(runs[0][2], runs[1][2])

    def test_moves_follow_dominant_origin(self):
        out = []
        for pkg, be in ((ref, "numpy"), (port, _be("float64"))):
            st = mk_store(pkg)
            sess = pkg.Orchestrator(st, backend=be, elasticity={"migration": {
                "refresh": 1, "min_count": 4.0, "affinity": 0.5}})
            hot, requester = 7, int((st.home[7] + 1) % P)
            tasks = pkg.TaskBatch(
                contexts=np.zeros((N, 1)),
                read_keys=np.full(N, hot, dtype=np.int64),
                write_keys=np.full(N, -1, dtype=np.int64),
                origin=np.full(N, requester, dtype=np.int64))
            res = [sess.run_stage(tasks, lambda c, v: {"result": v},
                                  return_results=True) for _ in range(2)]
            assert int(st.home[hot]) == requester
            assert (hot, (requester + P - 1) % P, requester) in \
                sess.elastic.planner.moves
            out.append((sess.elastic.planner.moves,
                        [x.report.phase_signature() for x in res],
                        res[-1].results))
        assert out[0][0] == out[1][0] and out[0][1] == out[1][1]
        np.testing.assert_allclose(out[1][2], out[0][2], **_tol("float64"))

    def test_migration_in_run_chain_matches_jax(self):
        """Moves between the hops of `run_chain` (one plan; its emission
        callback flushes the host copy every hop): hop bills and fetched
        values as the JAX table's."""
        from repro_torch.kvstore import DistributedHashTable as PortHT
        from repro.kvstore import DistributedHashTable as RefHT

        r = np.random.default_rng(5)
        keys = r.zipf(1.5, size=(200, 6)) % 64
        operand = np.stack([np.full(200, 0.5), r.standard_normal(200)], 1)
        spec = {"migration": {"refresh": 1, "min_count": 2.0}}
        a = RefHT(64, P, value_width=2, seed=1).run_chain(
            keys, operand, backend="numpy", elasticity=spec)
        ht = PortHT(64, P, value_width=2, seed=1)
        b = ht.run_chain(keys, operand, backend=_be("float64"),
                         elasticity=spec)
        np.testing.assert_allclose(b.values, a.values, **_tol("float64"))
        for x, y in zip(a.reports, b.reports):
            assert x.phase_signature() == y.phase_signature()
        assert any(ph.name == "migration"
                   for rep in b.reports for ph in rep.phases)

    @pytest.mark.parametrize("dtype", DTYPES)
    def test_migration_inside_a_static_plan(self, dtype):
        """A plan with no callbacks keeps its write-backs on the device
        until it exits; a move inside it re-uploads the table, so the
        deferred rows must reach the host first."""
        spec = {"migration": {"refresh": 1, "min_count": 2.0}}
        runs = []
        for pkg, be in ((ref, "numpy"), (port, _be(dtype))):
            st = mk_store(pkg)
            keys = np.random.default_rng(3).integers(0, K, N)
            # every key requested from the machine after its home: moves
            tb = pkg.TaskBatch(contexts=np.ones((N, 1)), read_keys=keys,
                               write_keys=keys.copy(),
                               origin=(st.home[keys] + 1) % P)
            sess = pkg.Orchestrator(st, backend=be, elasticity=spec)
            sess.run_plan(pkg.StagePlan().loop(
                pkg.StagePlan().stage(tb, muladd, "write"), until=None,
                max_rounds=6))
            runs.append((st.values.copy(), sess))
        (want, r), (got, p) = runs
        assert p.elastic.planner.moves == r.elastic.planner.moves
        assert p.elastic.counters()["migrations"] > 0
        for a, b in zip(r.report.stages, p.report.stages):
            assert a.phase_signature() == b.phase_signature()
        np.testing.assert_allclose(got, want, **_tol(dtype))

    def test_rehome_validates_targets(self):
        st = mk_store(port)
        with pytest.raises(ValueError, match="machine ids"):
            st.rehome(np.array([0]), np.array([P]))


# ---------------------------------------------------------------------------
# Phase-3 work stealing
# ---------------------------------------------------------------------------
class TestStealing:
    ELASTIC = {"stealing": {"threshold": 1.05, "min_tasks": 8}}

    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("engine", ["tdorch", "push", "auto"])
    def test_matches_jax_and_steals_accounted(self, engine, dtype):
        r, p = both(self.ELASTIC, dtype, engine=engine, skew=True)
        pm = p.report.per_machine()
        stolen = int(pm["stolen_in"].sum())
        assert stolen > 0
        assert stolen == int(pm["stolen_out"].sum())
        assert stolen == p.elastic.counters()["stolen_tasks"]
        assert p.report.steal_words > 0

    @pytest.mark.parametrize("engine", ["tdorch", "push", "auto"])
    def test_values_bit_identical_to_inelastic(self, engine):
        same_values_as_inelastic(self.ELASTIC, engine=engine, skew=True)

    @pytest.mark.parametrize("engine", ["tdorch", "push"])
    def test_stealing_flattens_exec_site_histogram(self, engine):
        def peaks(elasticity):
            sess = port.Orchestrator(mk_store(port), engine=engine,
                                     backend=_be("float64"),
                                     elasticity=elasticity)
            return [int(np.bincount(ex, minlength=P).max())
                    for ex in drive(sess, port, 6, skew=True)]
        without, with_steal = peaks(None), peaks(self.ELASTIC)
        assert sum(with_steal) < sum(without)
        assert all(w <= p for w, p in zip(with_steal, without))

    @pytest.mark.parametrize("engine", ["pull", "sort"])
    def test_unsupported_engines_run_unchanged(self, engine):
        r, p = both(self.ELASTIC, engine=engine, stages=4)
        assert p.report.steal_words == 0
        sess, plain = same_values_as_inelastic(self.ELASTIC, engine=engine,
                                               stages=4)
        port.assert_session_parity(plain.report, sess.report)
        assert not p._stealer_ok

    def test_straggler_detector_drains_flagged_machine(self):
        sites = []
        for pkg, fail, be in ((ref, ref_failures, "numpy"),
                              (port, port_failures, _be("float64"))):
            det = fail.StragglerDetector(threshold=1.5, min_samples=1)
            for m in range(P):
                det.record(m, 10.0 if m == 2 else 1.0)
            assert det.stragglers() == [2]
            sess = pkg.Orchestrator(mk_store(pkg), backend=be,
                                    elasticity=pkg.ElasticityConfig(
                                        stealing=pkg.StealConfig(
                                            threshold=1.25, min_tasks=8,
                                            detector=det)))
            res = sess.run_stage(batch(pkg, 0), muladd)
            assert int(np.bincount(res.exec_site, minlength=P)[2]) == 0
            sites.append((res.exec_site, res.report.phase_signature()))
        np.testing.assert_array_equal(sites[0][0], sites[1][0])
        assert sites[0][1] == sites[1][1]


# ---------------------------------------------------------------------------
# stage-boundary failure recovery
# ---------------------------------------------------------------------------
class TestRecovery:
    def _compare_restart(self, elastic, dtype="float64", stages=8):
        r, p = both(elastic, dtype, stages=stages)
        sess, plain = same_values_as_inelastic(_spec(elastic, port),
                                               stages=stages)
        port.assert_session_parity(plain.report, sess.report,
                                   ignore=port.ELASTIC_PHASES)
        port.assert_session_parity(plain.report, p.report,
                                   ignore=port.ELASTIC_PHASES)
        return p

    @pytest.mark.parametrize("dtype", DTYPES)
    def test_restart_is_bit_identical_to_uninterrupted(self, dtype):
        rec = self._compare_restart({"recovery": {"injector": {4: [2]}}},
                                    dtype)
        c = rec.elastic.counters()
        assert c["recoveries"] == 1 and c["chunks_restored"] > 0
        assert c["machines_alive"] == P
        assert rec.report.recovery_words > 0

    @pytest.mark.parametrize("dtype", DTYPES)
    def test_restart_with_write_log_between_snapshots(self, dtype):
        rec = self._compare_restart({"recovery": {
            "injector": {5: [0, 3]}, "checkpoint_every": 3}}, dtype)
        assert rec.elastic.counters()["recoveries"] == 2

    def test_restart_with_durable_checkpoints(self, tmp_path):
        runs = []

        def spec(pkg):  # a directory of its own for every session
            runs.append(tmp_path / f"{pkg.__name__}-{len(runs)}")
            return {"recovery": {
                "injector": {4: [6]}, "checkpoint_every": 2,
                "directory": str(runs[-1])}}
        self._compare_restart(spec)
        from repro_torch.checkpoint import latest_step
        assert len(runs) == 3
        assert all(latest_step(str(d)) == 6 for d in runs)

    def test_heartbeat_driven_recovery(self):
        stores = []
        for pkg, fail, be in ((ref, ref_failures, "numpy"),
                              (port, port_failures, _be("float64"))):
            t = [0.0]
            mon = fail.HeartbeatMonitor(list(range(P)), timeout=5.0,
                                        clock=lambda: t[0])
            st = mk_store(pkg)
            sess = pkg.Orchestrator(st, backend=be,
                                    elasticity=pkg.ElasticityConfig(
                                        recovery=pkg.RecoveryConfig(
                                            monitor=mon)))
            for i in range(6):
                if i == 3:
                    t[0] = 6.0  # node silence crosses the timeout
                    for m in range(P):
                        if m != 5:
                            mon.beat(m)
                sess.run_stage(batch(pkg, i), muladd)
            assert sess.elastic.counters()["recoveries"] == 1
            stores.append((st.values, sess))
        np.testing.assert_allclose(stores[1][0], stores[0][0],
                                   **_tol("float64"))
        for a, b in zip(stores[0][1].report.stages,
                        stores[1][1].report.stages):
            assert a.phase_signature() == b.phase_signature()
        np.testing.assert_array_equal(port_run(stages=6).store.values,
                                      stores[1][0])

    @pytest.mark.parametrize("dtype", DTYPES)
    def test_shrink_drains_the_dead_machine(self, dtype):
        spec = {"recovery": {"injector": {3: [2]}, "on_failure": "shrink"}}
        r, p = both(spec, dtype)
        assert not (p.store.home == 2).any()
        c = p.elastic.counters()
        assert c["machines_alive"] == P - 1
        assert c["stolen_tasks"] > 0
        same_values_as_inelastic(spec)
        ra = r.run_stage(batch(ref, 99), muladd)
        pa = p.run_stage(batch(port, 99), muladd)
        assert int(np.bincount(pa.exec_site, minlength=P)[2]) == 0
        np.testing.assert_array_equal(pa.exec_site, ra.exec_site)
        assert pa.report.phase_signature() == ra.report.phase_signature()

    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("every", [1, 2])
    def test_mid_plan_kill_replays_from_stage_boundary(self, dtype, every):
        """A machine killed mid-`run_chain` (the torch plan scope): the
        remaining hops replay from the boundary, values and per-hop bills
        equal to the uninterrupted chain's and to the reference's."""
        from repro.kvstore import DistributedHashTable as RefHT
        from repro_torch.kvstore import DistributedHashTable as PortHT

        def chain(cls, be, **kw):
            table = cls(64, P, value_width=2, seed=1)
            r = np.random.default_rng(17)
            keys = r.integers(0, 64, size=(40, 6))
            operand = np.stack([np.full(40, 0.5), r.standard_normal(40)],
                               axis=1)
            return table, table.run_chain(keys, operand, backend=be, **kw)

        def kill(pkg):
            return pkg.SessionConfig(elasticity=pkg.ElasticityConfig(
                recovery=pkg.RecoveryConfig(injector={3: [4]},
                                            checkpoint_every=every)))

        ht_plain, out_plain = chain(PortHT, _be(dtype))
        be = _be(dtype)
        ht_kill, out_kill = chain(PortHT, be, config=kill(port))
        assert be.host_syncs > 0 and be._plan_depth == 0
        np.testing.assert_array_equal(out_plain.values, out_kill.values)
        np.testing.assert_array_equal(ht_plain.values, ht_kill.values)
        for a, b in zip(out_plain.reports, out_kill.reports):
            port.assert_cost_parity(a, b, ignore=port.ELASTIC_PHASES)
        assert any(ph.name == "recovery"
                   for rep in out_kill.reports for ph in rep.phases)
        ht_ref, out_ref = chain(RefHT, "numpy", config=kill(ref))
        np.testing.assert_allclose(out_kill.values, out_ref.values,
                                   **_tol(dtype))
        np.testing.assert_allclose(ht_kill.values, ht_ref.values,
                                   **_tol(dtype))
        for a, b in zip(out_ref.reports, out_kill.reports):
            assert a.phase_signature() == b.phase_signature()

    def test_replica_holders_donate_during_recovery(self):
        rep = {"num_hot": 16, "refresh": 2, "min_count": 4.0}
        r, p = both({"recovery": {"injector": {5: [1]}}}, skew=True,
                    replication=rep)
        rec_phases = [ph for st in p.report.stages for ph in st.phases
                      if ph.name == "recovery"]
        assert rec_phases and any(ph.sent.sum() > 0 for ph in rec_phases)

    def test_all_three_at_once(self):
        spec = {"recovery": {"injector": {4: [3]}, "checkpoint_every": 2},
                "migration": {"refresh": 3, "min_count": 4.0},
                "stealing": {"threshold": 1.05, "min_tasks": 8}}
        r, p = both(spec, "float32", skew=True)
        c = p.elastic.counters()
        assert c["recoveries"] == 1 and c["migrations"] > 0
        assert c["stolen_tasks"] > 0

    def test_bad_on_failure_mode_rejected(self):
        with pytest.raises(ValueError,
                           match="restart.*shrink|shrink.*restart"):
            port.RecoveryConfig(on_failure="panic")

    def test_every_machine_dead_raises(self):
        sess = port.Orchestrator(mk_store(port), backend=_be("float64"),
                                 elasticity={"recovery": {
                                     "injector": {1: list(range(P))},
                                     "on_failure": "shrink"}})
        sess.run_stage(batch(port, 0), muladd)
        with pytest.raises(RuntimeError, match="every machine is dead"):
            sess.run_stage(batch(port, 1), muladd)


# ---------------------------------------------------------------------------
# elastic restore: a durable checkpoint written on P machines recovers
# onto fewer (tests/test_checkpoint.py's case)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
def test_elastic_restore_onto_smaller_fleet(tmp_path, dtype):
    Kc, Pc, n = 128, 8, 256

    def mk(pkg):
        st = pkg.DataStore.create(Kc, Pc, value_width=2, chunk_words=4,
                                  salt=11)
        st.write_rows(np.arange(Kc),
                      np.random.default_rng(5).standard_normal((Kc, 2)))
        return st

    def b(pkg, i):
        r = np.random.default_rng(200 + i)
        keys = r.integers(0, Kc, size=n)
        return pkg.TaskBatch(contexts=r.standard_normal((n, 1)),
                             read_keys=keys, write_keys=keys.copy(),
                             origin=r.integers(0, Pc, size=n))

    def f(ctx, vals):
        return {"update": vals * 0.25 + ctx[:, :1]}

    def spec(name):
        return {"recovery": {"injector": {3: [1, 6]}, "on_failure": "shrink",
                             "directory": str(tmp_path / name)}}

    st_ref, st_plain, st = mk(ref), mk(port), mk(port)
    rs = ref.Orchestrator(st_ref, backend="numpy", elasticity=spec("ref"))
    plain = port.Orchestrator(st_plain, backend=_be(dtype))
    sess = port.Orchestrator(st, backend=_be(dtype), elasticity=spec("port"))
    for i in range(6):
        ra = rs.run_stage(b(ref, i), f)
        plain.run_stage(b(port, i), f)
        pa = sess.run_stage(b(port, i), f)
        assert ra.report.phase_signature() == pa.report.phase_signature()
        np.testing.assert_array_equal(ra.exec_site, pa.exec_site)
    if dtype == "float64":
        np.testing.assert_array_equal(st.values, st_plain.values)
    np.testing.assert_allclose(st.values, st_ref.values, **_tol(dtype))
    np.testing.assert_array_equal(st.home, st_ref.home)
    assert not np.isin(st.home, [1, 6]).any()
    assert sess.elastic.counters()["machines_alive"] == Pc - 2
    from repro_torch.checkpoint import latest_step
    assert latest_step(str(tmp_path / "port")) == \
        latest_step(str(tmp_path / "ref")) is not None
