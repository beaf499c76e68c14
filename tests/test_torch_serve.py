"""The port's streaming serve tier (`repro_torch.serve`, the hash table's
front door) against the JAX package's (`repro.serve`), on the same seeded
numpy inputs in one process.

The port runs on ``TorchBackend(device="cpu")`` (float64 and float32; every
kernel wrapper takes its plain version there) and on ``backend="numpy"``;
the reference runs on ``backend="numpy"``. Checks:

- the batching window's triggers and adaptation: the same decisions, fire
  instants and window lengths as the reference's `BatchWindow` under one
  fake clock (no sleeps);
- `TaskBatch.concat`: every field equal to the reference's;
- sync mode: size and deadline triggers, RMW visibility across batches,
  error rejection, close/drain, the double-buffer ledgers and the
  single-buffer opt-out, each against the reference's frontend driven with
  the same requests and clock: the same batches, per-stage
  `phase_signature()` equal, the served values in float64 within 1e-12
  and in float32 within rtol 1e-5 / atol 1e-6 (values in [0, 2));
- oracle parity: a coalesced window bit-identical to the port's own
  `execute_batch` / `multi_get` on the same backend;
- thread mode: a stream resolves to the table's rows, a staged window
  merges by `TaskBatch.concat`, backpressure is loud, overlap is measured,
  close is idempotent, and the executor runs every batch on the backend's
  device;
- `TorchBackend.prefetch`: `execute` takes the staged contexts, a batch
  staged in another dtype uploads again (the side stream's copy and `sync`
  on the card are held by the `cuda`-marked `tests/test_torch_cuda_serve.py`,
  which imports no JAX).
"""
import threading
import time

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.serve as ref_serve
from repro.kvstore import DistributedHashTable as RefTable
from repro_torch.core import DataStore, Orchestrator, TaskBatch, TorchBackend
from repro_torch.kvstore import DistributedHashTable
from repro_torch.serve import (BatchingConfig, BatchWindow, Frontend,
                               FrontendClosedError, QueueFullError,
                               RequestFuture, ServeRequest)

# one intra-op thread per test process: the suite runs in parallel workers
torch.set_num_threads(1)

F64_TOL = 1e-12
RTOL, ATOL = 1e-5, 1e-6
BACKENDS = ["numpy", "torch_cpu64", "torch_cpu32"]
PKGS = {"port": (BatchWindow, BatchingConfig, ServeRequest, RequestFuture),
        "ref": (ref_serve.BatchWindow, ref_serve.BatchingConfig,
                ref_serve.ServeRequest, ref_serve.RequestFuture)}


class FakeClock:
    """Injectable monotonic time for deterministic trigger tests."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += dt
        return self.t


def _backend(name):
    if name == "numpy":
        return "numpy"
    return TorchBackend(device="cpu",
                        dtype="float64" if name == "torch_cpu64"
                        else "float32")


def _tol(name):
    return (F64_TOL, F64_TOL) if name != "torch_cpu32" else (RTOL, ATOL)


def _tables(P=4, K=256, w=2, seed=3):
    """A port table and its JAX twin, loaded with the same seeded rows."""
    vals = np.random.default_rng(seed + 1).random((K, w))
    out = []
    for cls in (DistributedHashTable, RefTable):
        ht = cls(num_keys=K, num_machines=P, value_width=w, seed=seed)
        ht.bulk_load(np.arange(K), vals)
        out.append(ht)
    return out[0], out[1], vals


def _pair(clk, backend="torch_cpu64", double_buffer=True, **cfg):
    """The port's frontend on `backend` and the reference's on numpy, over
    twin tables, sync mode, one fake clock."""
    ht, rt, vals = _tables()
    fe = ht.serve(backend=_backend(backend), mode="sync", config=cfg,
                  clock=clk, double_buffer=double_buffer)
    rfe = rt.serve(backend="numpy", mode="sync", config=cfg, clock=clk,
                   double_buffer=double_buffer)
    return ht, rt, vals, fe, rfe


def _same_ledgers(fe, rfe):
    """Each buffer session's stages bill exactly what the reference's do."""
    assert len(fe.sessions) == len(rfe.sessions)
    for s, r in zip(fe.sessions, rfe.sessions):
        assert s.report.num_stages == r.report.num_stages
        for a, b in zip(s.report.stages, r.report.stages):
            assert a.phase_signature() == b.phase_signature()


def _req(pkg, tag="t", keys=(0,), t_submit=0.0, deadline=None):
    _, _, Req, Fut = PKGS[pkg]
    fut = Fut(tag, 0, t_submit, deadline)
    return Req(tag=tag, keys=np.asarray(keys, dtype=np.int64),
               ctx=np.zeros(1), write_key=-1, future=fut,
               t_submit=t_submit, deadline=deadline)


# ---------------------------------------------------------------------------
# BatchWindow trigger semantics (pure host logic, fake clock)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pkg", list(PKGS))
class TestBatchWindow:
    def _win(self, pkg, **cfg):
        Win, Cfg, _, _ = PKGS[pkg]
        return Win(Cfg(**cfg))

    def test_size_fires_before_deadline(self, pkg):
        win = self._win(pkg, max_batch=4, min_window=1.0, max_window=1.0)
        for i in range(3):
            win.push(_req(pkg, t_submit=i * 1e-4), now=i * 1e-4)
            assert not win.ready(now=i * 1e-4)
        win.push(_req(pkg, t_submit=3e-4), now=3e-4)
        assert win.ready(now=3e-4)  # full, long before t=1.0
        assert win.depth == 4

    def test_deadline_fires_before_size(self, pkg):
        win = self._win(pkg, max_batch=64, min_window=0.01, max_window=0.01)
        win.push(_req(pkg, t_submit=0.0), now=0.0)
        win.push(_req(pkg, t_submit=0.004), now=0.004)
        assert not win.ready(now=0.009)
        assert win.next_due(now=0.004) == pytest.approx(0.01)
        assert win.ready(now=0.01)
        assert win.depth == 2

    def test_slo_deadline_pulls_fire_earlier(self, pkg):
        win = self._win(pkg, max_batch=64, min_window=1.0, max_window=1.0)
        win.note_service(0.1)
        win.push(_req(pkg, t_submit=0.0, deadline=0.5), now=0.0)
        assert win.next_due(now=0.0) == pytest.approx(0.4)
        assert not win.ready(now=0.39)
        assert win.ready(now=0.41)
        win.take(now=0.41)
        assert win.next_due(now=0.41) is None

    def test_take_admission_order_and_cap(self, pkg):
        win = self._win(pkg, max_batch=3, max_queue=16)
        for i in range(5):
            win.push(_req(pkg, keys=(i,)), now=0.0)
        assert [int(r.keys[0]) for r in win.take(now=0.0)] == [0, 1, 2]
        assert win.depth == 2

    def test_backpressure_is_loud(self, pkg):
        win = self._win(pkg, max_batch=4, max_queue=4)
        for _ in range(4):
            win.push(_req(pkg), now=0.0)
        with pytest.raises(Exception, match="full") as exc:
            win.push(_req(pkg), now=0.0)
        assert type(exc.value).__name__ == "QueueFullError"
        assert win.depth == 4  # nothing silently dropped

    def test_config_validation(self, pkg):
        Cfg = PKGS[pkg][1]
        with pytest.raises(ValueError, match="max_batch"):
            Cfg(max_batch=0)
        with pytest.raises(ValueError, match="max_queue"):
            Cfg(max_batch=64, max_queue=32)
        with pytest.raises(ValueError, match="min_window"):
            Cfg(min_window=2e-3, max_window=1e-3)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_window_adaptation_trace_matches_jax(seed):
    """The same seeded arrival stream (bursts, trickles, SLOs, service
    feedback) through both windows: every decision, fire instant and
    window length equal to the last bit."""
    rng = np.random.default_rng(seed)
    cfg = dict(max_batch=10, min_window=1e-5, max_window=5e-2,
               rate_halflife=4.0, max_queue=64)
    wins = {p: PKGS[p][0](PKGS[p][1](**cfg)) for p in PKGS}
    trace = {p: [] for p in PKGS}
    t = 0.0
    for _ in range(400):
        t += float(rng.exponential(rng.choice([1e-6, 1e-3, 2e-2])))
        dl = float(rng.uniform(0, 0.05)) if rng.random() < 0.2 else None
        service = float(rng.uniform(1e-4, 1e-2))
        for p, win in wins.items():
            if win.depth < cfg["max_queue"]:
                win.push(_req(p, t_submit=t,
                              deadline=None if dl is None else t + dl),
                         now=t)
            trace[p].append((win.ready(t), win.next_due(t), win.window,
                             win.depth))
            if win.ready(t):
                trace[p].append(len(win.take(t)))
                win.note_service(service)
    assert trace["port"] == trace["ref"]


def test_window_adapts_to_arrival_rate():
    cfg = BatchingConfig(max_batch=10, min_window=1e-5, max_window=5.0,
                         rate_halflife=2.0)
    win = BatchWindow(cfg)
    assert win.window == 5.0
    t = 0.0
    for _ in range(200):  # 1 kHz arrivals -> est 10 * 1ms = 10 ms
        win.push(_req("port", t_submit=t), now=t)
        win.take(now=t)
        t += 1e-3
    assert win.window == pytest.approx(10 * 1e-3, rel=0.05)
    for _ in range(400):  # 1 MHz arrivals -> floor
        win.push(_req("port", t_submit=t), now=t)
        win.take(now=t)
        t += 1e-6
    assert win.window == pytest.approx(cfg.min_window, rel=1e-6)


# ---------------------------------------------------------------------------
# TaskBatch.concat against the reference's
# ---------------------------------------------------------------------------
CONCAT_FIELDS = ("contexts", "origin", "write_keys", "priority",
                 "read_indptr", "read_indices")


def _ragged(pkg, groups, P=4, ctx0=0.0):
    n = len(groups)
    return pkg.TaskBatch.from_ragged(np.full((n, 1), ctx0), groups,
                                     pkg.TaskBatch.even_origins(n, P))


@pytest.mark.parametrize("case", ["offsets", "union", "three"])
def test_concat_matches_jax(case):
    import repro_torch.core as port_core

    groups = {"offsets": [[[1, 2], [3]], [[4], [], [5, 6, 7]]],
              "union": [[[0, 1], [2], [3, 4, 5]], [[6], [], [7, 7]]],
              "three": [[[9]], [[1, 1, 1], [2]], [[], [3, 4]]]}[case]
    out = {}
    for pkg in (port_core, ref_core):
        store = pkg.DataStore.create(32, 4, value_width=1, chunk_words=1)
        out[pkg] = pkg.TaskBatch.concat(
            [_ragged(pkg, g, ctx0=float(i)) for i, g in enumerate(groups)],
            store)
    a, b = out[port_core], out[ref_core]
    for field in CONCAT_FIELDS:
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    np.testing.assert_array_equal(np.argsort(a.priority, kind="stable"),
                                  np.arange(a.n))
    whole = _ragged(port_core, [x for g in groups for x in g])
    np.testing.assert_array_equal(a.read_indptr, whole.read_indptr)
    np.testing.assert_array_equal(a.read_indices, whole.read_indices)


def test_concat_rejects_like_jax():
    a = TaskBatch(contexts=np.zeros((2, 2)), read_keys=np.arange(2),
                  origin=np.zeros(2, dtype=np.int64))
    b = TaskBatch(contexts=np.zeros((2, 3)), read_keys=np.arange(2),
                  origin=np.zeros(2, dtype=np.int64))
    with pytest.raises(ValueError, match="context widths"):
        TaskBatch.concat([a, b])
    with pytest.raises(ValueError, match="at least one"):
        TaskBatch.concat([])
    import repro_torch.core as port_core
    store = DataStore.create(32, 4, value_width=1, chunk_words=1)
    with pytest.raises(ValueError):
        TaskBatch.concat([_ragged(port_core, [[40]])], store)


# ---------------------------------------------------------------------------
# Frontend: sync mode against the reference's, same requests and clock
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", BACKENDS)
class TestFrontendSync:
    def test_size_trigger_end_to_end(self, backend):
        clk = FakeClock()
        ht, rt, vals, fe, rfe = _pair(clk, backend, max_batch=4,
                                      min_window=10.0, max_window=10.0)
        futs = [(fe.get(k), rfe.get(k)) for k in (1, 2, 3)]
        assert not any(f.done() for f, _ in futs)
        futs.append((fe.get(4), rfe.get(4)))  # fills the batch: fires
        assert all(f.done() for f, _ in futs)
        assert fe.stats.batches_by_trigger == rfe.stats.batches_by_trigger
        assert fe.stats.batches_by_trigger["size"] == 1
        for k, (f, g) in zip((1, 2, 3, 4), futs):
            np.testing.assert_allclose(f.result(), g.result(),
                                       *_tol(backend))
            np.testing.assert_allclose(f.result(), vals[k], *_tol(backend))
        _same_ledgers(fe, rfe)
        fe.close()
        rfe.close()

    def test_deadline_trigger_end_to_end(self, backend):
        clk = FakeClock()
        ht, rt, vals, fe, rfe = _pair(clk, backend, max_batch=64,
                                      min_window=0.01, max_window=0.01)
        f, g = fe.get(7), rfe.get(7)
        assert not f.done()
        clk.advance(0.02)
        fe.pump()
        rfe.pump()
        assert f.done() and g.done()
        assert fe.stats.batches_by_trigger["deadline"] == 1
        assert fe.stats.batches_by_trigger == rfe.stats.batches_by_trigger
        np.testing.assert_allclose(f.result(), g.result(), *_tol(backend))
        _same_ledgers(fe, rfe)
        fe.close()
        rfe.close()

    def test_result_timeout_and_slo_miss(self, backend):
        clk = FakeClock()
        ht, rt, vals, fe, rfe = _pair(clk, backend, max_batch=64,
                                      min_window=5.0, max_window=5.0)
        f = fe.get(1)
        with pytest.raises(TimeoutError):
            f.result(timeout=0.01)
        g = fe.get(2, deadline=-1.0)  # a blown SLO fires at once
        rfe.get(1)
        rfe.get(2, deadline=-1.0)
        assert g.done() and f.done()
        assert fe.stats.deadline_misses == rfe.stats.deadline_misses >= 1
        fe.close()
        rfe.close()

    def test_rmw_visibility_across_batches(self, backend):
        clk = FakeClock()
        ht, rt, vals, fe, rfe = _pair(clk, backend, max_batch=2,
                                      min_window=1.0, max_window=1.0)
        got = []
        for front in (fe, rfe):
            f0 = front.read_modify_write(9, 2.0, 1.0)
            f1 = front.get(9)  # same batch: the pre-write value
            g = front.get(9)
            front.flush()  # next batch: the write is visible
            got.append([f0.result(), f1.result(), g.result()])
        tol = _tol(backend)
        np.testing.assert_allclose(got[0][0], vals[9], *tol)
        np.testing.assert_allclose(got[0][1], vals[9], *tol)
        np.testing.assert_allclose(got[0][2], vals[9] * 2.0 + 1.0, *tol)
        for a, b in zip(*got):
            np.testing.assert_allclose(a, b, *tol)
        np.testing.assert_allclose(ht.values, rt.values, *tol)
        _same_ledgers(fe, rfe)
        fe.close()
        rfe.close()

    def test_errors_reject_batch_and_serving_continues(self, backend):
        ht, rt, vals, fe, rfe = _pair(FakeClock(), backend, max_batch=2,
                                      min_window=1.0, max_window=1.0)

        def _boom(contexts, in_vals):
            raise RuntimeError("lambda exploded")

        for front in (fe, rfe):
            front.register("boom", _boom, ctx_width=1)
            f1 = front.submit("boom", [1])
            f2 = front.submit("boom", [2])  # fires; both get the error
            for f in (f1, f2):
                with pytest.raises(RuntimeError, match="exploded"):
                    f.result()
            assert front.stats.failed == 2
            ok = front.get(5)
            front.flush()
            np.testing.assert_allclose(ok.result(), vals[5], *_tol(backend))
            front.close()

    def test_close_without_drain_rejects_pending(self, backend):
        ht, rt, vals, fe, rfe = _pair(FakeClock(), backend, max_batch=64,
                                      min_window=5.0, max_window=5.0)
        f = fe.get(3)
        fe.close(drain=False)
        with pytest.raises(FrontendClosedError):
            f.result()
        assert fe.stats.failed == 1
        with pytest.raises(FrontendClosedError):
            fe.get(1)
        rfe.close()

    def test_close_drains_pending(self, backend):
        ht, rt, vals, fe, rfe = _pair(FakeClock(), backend, max_batch=64,
                                      min_window=5.0, max_window=5.0)
        futs = [fe.get(k) for k in (3, 4, 5)]
        fe.close()  # drain=True: flushed and resolved first
        for k, f in zip((3, 4, 5), futs):
            np.testing.assert_allclose(f.result(), vals[k], *_tol(backend))
        assert fe.stats.batches_by_trigger["flush"] == 1
        fe.close()  # idempotent
        rfe.close()

    def test_double_buffer_ledgers(self, backend):
        clk = FakeClock()
        ht, rt, vals, fe, rfe = _pair(clk, backend, max_batch=2,
                                      min_window=1.0, max_window=1.0)
        for k in range(8):
            fe.get(k % 4)
            rfe.get(k % 4)
        assert len(fe.sessions) == 2
        assert fe.sessions[1].engine is fe.sessions[0].engine  # shared plan
        assert [s.report.num_stages for s in fe.sessions] == [2, 2]
        _same_ledgers(fe, rfe)
        rep, rrep = fe.report(), rfe.report()
        assert rep["session"] == rrep["session"]
        assert rep["session"]["stages"] == 4
        for key in ("submitted", "completed", "batches", "batch_occupancy",
                    "batches_by_trigger", "merged_batches", "queue_peak"):
            assert rep[key] == rrep[key], key
        assert set(rep) == set(rrep)
        fe.close()
        rfe.close()

    def test_single_buffer_opt_out(self, backend):
        ht, rt, vals, fe, rfe = _pair(FakeClock(), backend,
                                      double_buffer=False, max_batch=2)
        assert len(fe.sessions) == len(rfe.sessions) == 1
        f = fe.get(1)
        fe.flush()
        np.testing.assert_allclose(f.result(), vals[1], *_tol(backend))
        fe.close()
        rfe.close()


def test_admission_errors():
    ht, rt, vals, fe, rfe = _pair(FakeClock(), max_batch=4)
    with pytest.raises(KeyError, match="unregistered"):
        fe.submit("nope", [1])
    with pytest.raises(ValueError, match="already registered"):
        fe.register("kv", lambda c, v: {"result": v})
    with pytest.raises(ValueError, match="mode"):
        Frontend(ht.session(backend="numpy"), mode="async")
    with pytest.raises(ValueError, match="session_config"):
        Frontend(ht.session(backend="numpy"),
                 session_config={"backend": "numpy"})
    fe.close()
    rfe.close()
    with pytest.raises(FrontendClosedError):
        fe.get(1)


def test_bare_store_frontend_builds_its_session():
    """A bare DataStore: the frontend builds buffer A from
    `session_config=`; the default config is the card, and refuses
    elasticity as the table's sessions do."""
    store = DataStore.create(32, 4, value_width=2, chunk_words=2)
    vals = np.random.default_rng(0).random((32, 2))
    store.write_rows(np.arange(32), vals)
    fe = Frontend(store, session_config={"backend": "numpy"}, mode="sync",
                  config={"max_batch": 2})
    fe.register("g", lambda c, v: {"result": v}, ctx_width=1)
    futs = [fe.submit("g", [k]) for k in (3, 4)]
    np.testing.assert_array_equal(np.stack([f.result() for f in futs]),
                                  vals[[3, 4]])
    fe.close()
    # an elastic session config: the report's "elastic" block holds the
    # counters of the one manager the two buffer sessions share
    efe = Frontend(store, session_config={
        "backend": "numpy", "elasticity": {"stealing": True,
                                           "migration": True}},
        mode="sync", config={"max_batch": 2})
    assert efe.sessions[0].elastic is efe.sessions[1].elastic
    efe.register("g", lambda c, v: {"result": v}, ctx_width=1)
    futs = [efe.submit("g", [k]) for k in range(8)]
    np.testing.assert_array_equal(np.stack([f.result() for f in futs]),
                                  vals[:8])
    rep = efe.report()
    assert rep["elastic"] == efe.sessions[0].elastic.counters()
    assert set(rep["elastic"]) == {"migrations", "migration_elections",
                                   "stolen_tasks", "steal_rebalances"}
    efe.close()
    assert "elastic" not in fe.report()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Frontend(store, mode="sync")


# ---------------------------------------------------------------------------
# per-request integrity against the one-shot batch, each backend
# ---------------------------------------------------------------------------
def _ycsb_requests(n, K, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, K, n)
    is_read = rng.random(n) < 0.5
    operand = np.where(is_read[:, None], [1.0, 0.0], rng.random((n, 2)))
    return keys, is_read, operand


def _submit_kv(fe, keys, is_read, operand):
    return [fe.get(int(k)) if r else
            fe.read_modify_write(int(k), op[0], op[1])
            for k, r, op in zip(keys, is_read, operand)]


@pytest.mark.parametrize("backend", BACKENDS)
class TestOracleParity:
    def test_single_batch_bit_identical(self, backend):
        """A frontend-coalesced window is the batch `execute_batch` builds:
        per-request results bit-identical on the same backend, and the
        bill equal to the reference frontend's."""
        ht_a, rt, vals = _tables()
        ht_b, _, _ = _tables()
        n = 24
        keys, is_read, operand = _ycsb_requests(n, 256, 0)
        be = _backend(backend)
        cfg = {"max_batch": n, "min_window": 1.0, "max_window": 1.0}
        fe = ht_a.serve(backend=be, mode="sync", config=cfg)
        rfe = rt.serve(backend="numpy", mode="sync", config=cfg)
        futs = _submit_kv(fe, keys, is_read, operand)
        rfuts = _submit_kv(rfe, keys, is_read, operand)
        fe.flush()
        rfe.flush()
        assert fe.stats.batches == 1
        one = ht_b.execute_batch(keys, is_read, operand,
                                 backend=_backend(backend))
        got = np.stack([f.result() for f in futs])
        np.testing.assert_array_equal(got, one.values)
        np.testing.assert_array_equal(ht_a.values, ht_b.values)
        tol = _tol(backend)
        np.testing.assert_allclose(
            got, np.stack([f.result() for f in rfuts]), *tol)
        np.testing.assert_allclose(ht_a.values, rt.values, *tol)
        want_vals, want_res = RefTable.oracle(vals, keys, is_read, operand)
        np.testing.assert_allclose(got, want_res, *tol)
        np.testing.assert_allclose(ht_a.values, want_vals, *tol)
        _same_ledgers(fe, rfe)
        if not isinstance(be, str):
            assert not be._host_lambdas
        fe.close()
        rfe.close()

    def test_multi_get_matches_oracle(self, backend):
        ht, rt, vals = _tables()
        rng = np.random.default_rng(1)
        groups = [list(rng.integers(0, 256, rng.integers(1, 6)))
                  for _ in range(12)]
        cfg = {"max_batch": len(groups), "min_window": 1.0,
               "max_window": 1.0}
        fe = ht.serve(backend=_backend(backend), mode="sync", config=cfg)
        rfe = rt.serve(backend="numpy", mode="sync", config=cfg)
        futs = [fe.multi_get(g) for g in groups]
        rfuts = [rfe.multi_get(g) for g in groups]
        fe.flush()
        rfe.flush()
        _same_ledgers(fe, rfe)
        one = ht.multi_get(groups, backend=_backend(backend))
        for i, (g, f, r) in enumerate(zip(groups, futs, rfuts)):
            got = f.result()
            assert got.shape == (len(g), ht.store.value_width)
            np.testing.assert_array_equal(
                got, one.values[i][one.mask[i]].reshape(len(g), -1))
            np.testing.assert_allclose(got, r.result(), *_tol(backend))
            np.testing.assert_allclose(got, vals[g], *_tol(backend))
        fe.close()
        rfe.close()

    def test_sliced_stream_equals_one_shot(self, backend):
        ht, rt, vals = _tables()
        keys = np.random.default_rng(2).integers(0, 256, 40)
        fe = ht.serve(backend=_backend(backend), mode="sync",
                      config={"max_batch": 4, "min_window": 1.0,
                              "max_window": 1.0})
        futs = [fe.get(int(k)) for k in keys]
        fe.flush()
        assert fe.stats.batches == 10
        one = ht.execute_batch(keys, np.ones(40, dtype=bool),
                               np.tile([1.0, 0.0], (40, 1)),
                               backend=_backend(backend))
        np.testing.assert_array_equal(np.stack([f.result() for f in futs]),
                                      one.values)
        fe.close()


# ---------------------------------------------------------------------------
# thread mode: the double-buffered pipeline
# ---------------------------------------------------------------------------
class TestFrontendThread:
    def test_stream_resolves_correctly(self):
        ht, rt, vals = _tables(K=512)
        be = _backend("torch_cpu64")
        with ht.serve(backend=be, mode="thread",
                      config={"max_batch": 32, "min_window": 1e-4,
                              "max_window": 1e-3}) as fe:
            rng = np.random.default_rng(5)
            futs = [(int(k), fe.get(int(k)))
                    for k in rng.integers(0, 512, 300)]
            fe.drain(timeout=30.0)
            for k, f in futs:
                np.testing.assert_array_equal(f.result(timeout=5.0), vals[k])
            rep = fe.report()
        assert rep["completed"] == 300
        assert rep["failed"] == rep["rejected"] == 0
        assert rep["batches"] >= 300 // 32
        assert not be._host_lambdas

    def test_replayed_batches_match_reference(self):
        """Thread mode forms its batches by timing; replaying the batches
        the executor actually ran (recorded by wrapping `_execute`) through
        the reference's `execute_batch` on numpy gives every request's
        result and the final table."""
        ht, rt, vals = _tables(K=128)
        fe = ht.serve(backend=_backend("torch_cpu64"), mode="thread",
                      config={"max_batch": 16, "min_window": 1e-5,
                              "max_window": 1e-4})
        ran, inner = [], fe._execute

        def record(prepared):
            ran.append([r.future for r in prepared.requests])
            inner(prepared)

        fe._execute = record
        keys, is_read, operand = _ycsb_requests(200, 128, 9)
        futs = _submit_kv(fe, keys, is_read, operand)
        fe.drain(timeout=30.0)
        fe.close()
        index = {id(f): i for i, f in enumerate(futs)}
        assert sorted(index[id(f)] for b in ran for f in b) == list(
            range(200))
        for batch in ran:
            ix = np.array([index[id(f)] for f in batch])
            want = rt.execute_batch(keys[ix], is_read[ix], operand[ix],
                                    backend="numpy")
            np.testing.assert_allclose(
                np.stack([f.result() for f in batch]), want.values,
                rtol=F64_TOL, atol=F64_TOL)
        np.testing.assert_allclose(ht.values, rt.values, rtol=F64_TOL,
                                   atol=F64_TOL)

    def test_staged_merge_uses_concat(self):
        store = DataStore.create(64, 4, value_width=2, chunk_words=2)
        vals = np.random.default_rng(6).random((64, 2))
        store.write_rows(np.arange(64), vals)
        started, release = threading.Event(), threading.Event()

        def gate(contexts, in_vals):
            started.set()
            release.wait(timeout=30.0)
            return {"result": in_vals}

        fe = Frontend(Orchestrator(store, backend="numpy"),
                      config={"max_batch": 8}, mode="thread")
        fe.register("g", gate, ctx_width=1)
        try:
            f1 = [fe.submit("g", [k]) for k in (0, 1)]
            fe.flush()  # batch 1 -> executor (blocks in gate)
            assert started.wait(timeout=10.0)
            f2 = [fe.submit("g", [k]) for k in (2, 3)]
            fe.flush()  # batch 2 -> staged slot
            f3 = [fe.submit("g", [k]) for k in (4, 5)]
            fe.flush()  # batch 3 -> merges into staged batch 2
            deadline = time.monotonic() + 10.0
            while fe.stats.merged_batches < 1:
                assert time.monotonic() < deadline, "merge never happened"
                time.sleep(0.002)
        finally:
            release.set()
        fe.drain(timeout=30.0)
        for k, f in enumerate(f1 + f2 + f3):
            np.testing.assert_array_equal(f.result(timeout=5.0), vals[k])
        assert fe.stats.merged_batches == 1
        assert fe.stats.batches == 3
        fe.close()

    def test_merged_batch_is_prefetched_again(self):
        """The staged batch that absorbs a window is a new TaskBatch: the
        frontend stages its contexts again, and the executor takes them."""
        store = DataStore.create(64, 4, value_width=2, chunk_words=2)
        be = _backend("torch_cpu64")
        staged, taken = [], []
        prefetch, dctx = be.prefetch, be._dctx

        def spy_prefetch(tasks, st):
            staged.append(id(tasks))
            prefetch(tasks, st)

        def spy_dctx(tasks):
            taken.append((id(tasks), "_device_ctx" in tasks.__dict__))
            return dctx(tasks)

        be.prefetch, be._dctx = spy_prefetch, spy_dctx
        started, release = threading.Event(), threading.Event()

        def gate(contexts, in_vals):
            started.set()
            release.wait(timeout=30.0)
            return {"result": in_vals}

        fe = Frontend(Orchestrator(store, backend=be),
                      config={"max_batch": 8}, mode="thread")
        fe.register("g", gate, ctx_width=1)
        try:
            fe.submit("g", [0])
            fe.flush()
            assert started.wait(timeout=10.0)
            fe.submit("g", [1])
            fe.flush()
            fe.submit("g", [2])
            fe.flush()
            deadline = time.monotonic() + 10.0
            while fe.stats.merged_batches < 1:
                assert time.monotonic() < deadline, "merge never happened"
                time.sleep(0.002)
        finally:
            release.set()
        fe.drain(timeout=30.0)
        fe.close()
        assert len(staged) == 4  # three windows and the merged batch
        assert [s for s, had in taken] == [staged[0], staged[3]]
        assert all(had for _, had in taken)

    def test_drain_waits_for_a_window_the_router_took(self):
        """A window the router has taken but not yet staged is neither in
        a window nor staged: drain() must wait for it all the same."""
        store = DataStore.create(16, 4, value_width=1, chunk_words=1)
        store.write_rows(np.arange(16), np.arange(16, dtype=float)[:, None])
        fe = Frontend(Orchestrator(store, backend="numpy"),
                      config={"max_batch": 2}, mode="thread")
        fe.register("g", lambda c, v: {"result": v}, ctx_width=1)
        entered, release = threading.Event(), threading.Event()
        prepare = fe._prepare

        def held_prepare(*a):
            entered.set()
            release.wait(timeout=30.0)
            return prepare(*a)

        fe._prepare = held_prepare
        futs = [fe.submit("g", [k]) for k in (3, 4)]  # full: router takes
        assert entered.wait(timeout=10.0)
        drained = threading.Event()
        waiter = threading.Thread(
            target=lambda: (fe.drain(timeout=30.0), drained.set()))
        waiter.start()
        try:
            assert not drained.wait(timeout=0.3)  # still in the router
        finally:
            release.set()
        waiter.join(timeout=30.0)
        assert drained.is_set() and not waiter.is_alive()
        assert [f.result(timeout=0)[0] for f in futs] == [3.0, 4.0]
        fe.close()

    def test_backpressure_queue_full_is_loud(self):
        store = DataStore.create(64, 4, value_width=1, chunk_words=1)
        store.write_rows(np.arange(64), np.arange(64, dtype=float)[:, None])

        def slow(contexts, in_vals):
            time.sleep(0.05)
            return {"result": in_vals}

        fe = Frontend(Orchestrator(store, backend="numpy"),
                      config={"max_batch": 4, "max_queue": 16,
                              "min_window": 1e-5, "max_window": 1e-4},
                      mode="thread")
        fe.register("slow", slow, ctx_width=1)
        accepted, rejected = [], 0
        for i in range(1000):
            try:
                accepted.append((i % 64, fe.submit("slow", [i % 64])))
            except QueueFullError:
                rejected += 1
                break
        assert rejected, "queue never filled: backpressure path untested"
        assert fe.stats.rejected == rejected
        fe.drain(timeout=60.0)
        for k, f in accepted:
            assert f.result(timeout=10.0)[0] == float(k)
        assert fe.report()["completed"] == len(accepted)
        fe.close()

    def test_thread_errors_reject_the_batch(self):
        ht, rt, vals = _tables()
        fe = ht.serve(backend=_backend("torch_cpu64"), mode="thread",
                      config={"max_batch": 2, "min_window": 1e-5,
                              "max_window": 1e-4})

        def _boom(contexts, in_vals):
            raise RuntimeError("lambda exploded")

        fe.register("boom", _boom, ctx_width=1)
        bad = [fe.submit("boom", [1]), fe.submit("boom", [2])]
        ok = fe.get(5)
        fe.drain(timeout=30.0)
        for f in bad:
            with pytest.raises(RuntimeError, match="exploded"):
                f.result(timeout=5.0)
        np.testing.assert_array_equal(ok.result(timeout=5.0), vals[5])
        assert fe.stats.failed == 2
        fe.close()

    def test_overlap_is_measured(self):
        ht, rt, vals = _tables(K=512)
        fe = ht.serve(backend=_backend("torch_cpu32"), mode="thread",
                      config={"max_batch": 16, "min_window": 1e-5,
                              "max_window": 1e-4})
        for k in np.random.default_rng(7).integers(0, 512, 600):
            fe.get(int(k))
        fe.drain(timeout=30.0)
        rep = fe.report()
        fe.close()
        assert rep["completed"] == 600
        assert 0.0 <= rep["overlap_fraction"] <= 1.0
        assert rep["batches"] >= 600 // 16
        assert rep["session"]["stages"] == rep["batches"] - rep[
            "merged_batches"]

    def test_close_is_idempotent(self):
        ht, rt, vals = _tables()
        fe = ht.serve(backend="numpy", mode="thread")
        fe.get(1)
        fe.close()
        fe.close()
        assert not any(t.is_alive() for t in fe._threads)

    def test_threads_select_the_backend_device(self):
        """The router and executor threads enter the backend's device
        before they run anything: a `torch.cuda.device` scope for a card,
        none on the CPU."""
        ht, rt, vals = _tables()
        fe = ht.serve(backend=_backend("torch_cpu64"), mode="thread")
        assert type(fe._device_scope()).__name__ == "nullcontext"
        fe.close()

        class OnCard:
            class backend:
                device = torch.device("cuda", 3)

        fe.sessions = (OnCard,)
        scope = fe._device_scope()
        assert isinstance(scope, torch.cuda.device) and scope.idx == 3


# ---------------------------------------------------------------------------
# TorchBackend.prefetch / sync
# ---------------------------------------------------------------------------
def _prefetch_stage(dtype):
    store = DataStore.create(40, 4, value_width=3)
    rng = np.random.default_rng(11)
    store.write_rows(np.arange(40), rng.random((40, 3)))
    tasks = TaskBatch(contexts=rng.random((16, 3)) + 1e-9,
                      read_keys=rng.integers(0, 40, 16),
                      origin=TaskBatch.even_origins(16, 4))
    return store, tasks


def _muladd(contexts, vals):
    return {"result": vals * contexts[:, 1:2] + contexts[:, 2:3]}


def test_prefetch_stages_contexts_that_execute_takes():
    store, tasks = _prefetch_stage("float64")
    be = TorchBackend(device="cpu", dtype="float64")
    be.prefetch(tasks, store)
    dtype, t, ev, pinned = tasks.__dict__["_device_ctx"]
    assert (dtype, ev, pinned) == ("float64", None, None)
    np.testing.assert_array_equal(t.numpy(), tasks.contexts)
    assert not np.shares_memory(t.numpy(), tasks.contexts)
    t[:, 2] += 5.0  # mark the staged copy: execute must read it
    out = be.execute(tasks, store, _muladd)
    want = store.values[tasks.read_keys] * tasks.contexts[:, 1:2] \
        + tasks.contexts[:, 2:3] + 5.0
    np.testing.assert_allclose(out["result"], want, rtol=F64_TOL)
    assert "_device_ctx" not in tasks.__dict__  # taken once
    out = be.execute(tasks, store, _muladd)  # the next run uploads
    np.testing.assert_allclose(out["result"], want - 5.0, rtol=F64_TOL)


def test_prefetch_in_another_dtype_uploads_again():
    store, tasks = _prefetch_stage("float64")
    TorchBackend(device="cpu", dtype="float32").prefetch(tasks, store)
    assert tasks.__dict__["_device_ctx"][1].dtype == torch.float32
    be = TorchBackend(device="cpu", dtype="float64")
    got = be.execute(tasks, store, _muladd)["result"]
    want = store.values[tasks.read_keys] * tasks.contexts[:, 1:2] \
        + tasks.contexts[:, 2:3]
    # float64 contexts, not the float32 staging: equal to the last bit
    np.testing.assert_array_equal(got, want)
    assert "_device_ctx" not in tasks.__dict__


def test_prefetch_skips_empty_and_sync_is_a_cpu_noop():
    store, tasks = _prefetch_stage("float64")
    be = TorchBackend(device="cpu", dtype="float64")
    empty = TaskBatch(contexts=np.zeros((0, 3)),
                      read_keys=np.zeros(0, dtype=np.int64),
                      origin=np.zeros(0, dtype=np.int64))
    be.prefetch(empty, store)
    assert "_device_ctx" not in empty.__dict__
    be.sync(store)
    be.sync()
    assert be._copy_stream is None


def test_frontend_results_equal_with_and_without_prefetch(monkeypatch):
    """The staged route and the upload route give the same bits. Thread
    mode (the only mode that stages) forms its batches by timing, so every
    request names its own key: each result is then the same in any
    batching."""
    out = []
    for staged in (True, False):
        ht, rt, vals = _tables()
        be = _backend("torch_cpu32")
        calls = []
        prefetch = be.prefetch

        def spy(tasks, store, prefetch=prefetch, calls=calls):
            calls.append(tasks.n)
            if staged:
                prefetch(tasks, store)

        monkeypatch.setattr(be, "prefetch", spy)
        keys = np.random.default_rng(40).permutation(256)[:120]
        _, is_read, operand = _ycsb_requests(120, 256, 4)
        with ht.serve(backend=be, mode="thread",
                      config={"max_batch": 8, "min_window": 1e-5,
                              "max_window": 1e-4}) as fe:
            futs = _submit_kv(fe, keys, is_read, operand)
            fe.drain(timeout=30.0)
            got = np.stack([f.result(timeout=5.0) for f in futs])
        assert calls and sum(calls) >= 120  # every window was staged
        out.append((got, ht.values.copy()))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)


def test_sync_mode_stages_nothing(monkeypatch):
    """Sync mode runs each batch as soon as it is formed: nothing could
    overlap a staging copy, so the frontend does not prefetch."""
    ht, rt, vals = _tables()
    be = _backend("torch_cpu32")
    calls = []
    monkeypatch.setattr(be, "prefetch",
                        lambda tasks, store: calls.append(tasks.n))
    # a pinned window, as the other sync tests: on the default 50 µs-2 ms
    # window a stall of the submitting thread fires an extra deadline batch
    fe = ht.serve(backend=be, mode="sync",
                  config={"max_batch": 8, "min_window": 1.0,
                          "max_window": 1.0})
    keys, is_read, operand = _ycsb_requests(40, 256, 4)
    futs = _submit_kv(fe, keys, is_read, operand)
    fe.close()
    assert [f.result().shape for f in futs] == [(2,)] * 40
    assert fe.stats.batches == 5 and calls == []
