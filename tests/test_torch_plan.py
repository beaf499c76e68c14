"""The port's declarative `StagePlan`s (`core/plan.py`, `Orchestrator.run_plan`)
and `TorchBackend`'s plan scope, against the JAX package's, on the CPU
(``TorchBackend(device="cpu")``; the reference through ``backend="numpy"``
and, for host syncs, ``backend="jax"``).

- A read-modify-write chain as a plan equals the same `run_stage` loop by
  `assert_session_parity` on every engine, replication on and off, and the
  JAX package's plan (cost exactly; values within 1e-12 in float64 and
  rtol 1e-5 / atol 1e-6 in float32) — `tests/test_plan.py`'s chain case
  on an `Orchestrator` (the kv store is not ported).
- The emission edge cases of `tests/test_plan.py` on the port.
- The plan scope: user callbacks (task factories, emit, until, host
  steps) see flushed host values; a static plan flushes once at exit and
  an emitting plan syncs at most once a round, as many times as the JAX
  backend; nested scopes flush only at the outermost exit; the host route
  and the oracle apply flush before they read the host copy.
"""
import numpy as np
import pytest
import torch

import repro.core as ref
import repro_torch.core as port
from repro_torch.core import CARRY, StagePlan

# one intra-op thread per test process: the suite runs in parallel workers
torch.set_num_threads(1)

P = 4
ENGINES = ["tdorch", "push", "pull", "sort"]
REPLICATION = [None, {"num_hot": 8, "refresh": 2, "min_count": 1.0}]
HOPS = 3


def _rmw(ctx, vals):
    """read-modify-write: v·c0 + c1, returned as update and result."""
    out = vals * ctx[:, 0:1] + ctx[:, 1:2]
    return {"update": out, "result": out}


def _chain_inputs(n=48, K=192):
    rng = np.random.default_rng(2)
    cols = rng.integers(0, K, (n, HOPS))
    op = np.stack([np.full(n, 0.5), rng.standard_normal(n)], axis=1)
    return cols, op


def _chain_store(pkg, K=192):
    store = pkg.DataStore.create(K, P, value_width=2, chunk_words=2)
    store.write_rows(np.arange(K),
                     np.arange(2 * K, dtype=np.float64).reshape(K, 2))
    return store


def _hop(pkg, cols, op, j):
    return pkg.TaskBatch(contexts=op, read_keys=cols[:, j],
                         origin=pkg.TaskBatch.even_origins(len(op), P))


def _chain_plan(pkg, cols, op):
    def emit(state, res):
        j = state.round + 1
        return _hop(pkg, cols, op, j) if j < HOPS else None

    return pkg.StagePlan("chain").loop(
        pkg.StagePlan().stage(pkg.CARRY, _rmw, "write", emit=emit,
                              return_results=True),
        until="empty", max_rounds=HOPS)


def _backend(name):
    if name == "numpy":
        return "numpy"
    return port.TorchBackend(device="cpu", dtype=name)


@pytest.mark.parametrize("replication", REPLICATION, ids=["rep_off", "rep_on"])
@pytest.mark.parametrize("backend", ["float32", "float64", "numpy"])
@pytest.mark.parametrize("engine", ENGINES)
def test_chain_plan_matches_loop_and_reference(engine, backend, replication):
    cols, op = _chain_inputs()
    st_plan, st_loop, st_ref = (_chain_store(port), _chain_store(port),
                                _chain_store(ref))
    s_plan = port.Orchestrator(st_plan, engine=engine,
                               backend=_backend(backend),
                               replication=replication)
    out = s_plan.run_plan(_chain_plan(port, cols, op),
                          carry=_hop(port, cols, op, 0))
    s_loop = port.Orchestrator(st_loop, engine=engine,
                               backend=_backend(backend),
                               replication=replication)
    loop_res = [s_loop.run_stage(_hop(port, cols, op, j), _rmw, "write",
                                 return_results=True) for j in range(HOPS)]
    s_ref = ref.Orchestrator(st_ref, engine=engine, backend="numpy",
                             replication=replication)
    ref_out = s_ref.run_plan(_chain_plan(ref, cols, op),
                             carry=_hop(ref, cols, op, 0))

    assert out.rounds == ref_out.rounds == HOPS
    assert out.loops[0].reason == ref_out.loops[0].reason
    port.assert_session_parity(s_plan.report, s_loop.report)
    ref.assert_session_parity(s_plan.report, s_ref.report)
    rtol, atol = (1e-5, 1e-6) if backend == "float32" else (1e-12, 1e-12)
    for a, b, c in zip(out.results, loop_res, ref_out.results):
        np.testing.assert_array_equal(a.exec_site, c.exec_site)
        np.testing.assert_allclose(a.results, b.results, rtol=rtol, atol=atol)
        np.testing.assert_allclose(a.results, c.results, rtol=rtol, atol=atol)
    np.testing.assert_allclose(st_plan.values, st_loop.values, rtol=rtol,
                               atol=atol)
    np.testing.assert_allclose(st_plan.values, st_ref.values, rtol=rtol,
                               atol=atol)


# ---------------------------------------------------------------------------
# emission edge cases (tests/test_plan.py's, on the port)
# ---------------------------------------------------------------------------
def _store_sess(backend="float32"):
    store = port.DataStore.create(32, P, value_width=1, chunk_words=4,
                                  init=1.0)
    return store, port.Orchestrator(store, engine="tdorch",
                                    backend=_backend(backend))


def _unit_batch(n=8):
    return port.TaskBatch(contexts=np.ones((n, 1)),
                          read_keys=np.arange(n, dtype=np.int64),
                          origin=port.TaskBatch.even_origins(n, P))


def _inc(ctx, vals):
    return {"update": vals * 0.0 + 1.0}


@pytest.mark.parametrize("backend", ["float32", "numpy"])
def test_empty_initial_carry_runs_zero_rounds(backend):
    store, sess = _store_sess(backend)
    out = sess.run_plan(StagePlan().loop(StagePlan().stage(CARRY, _inc, "add"),
                                         until="empty"))
    assert out.rounds == 0 and out.records == []
    assert out.loops[0].reason == "empty"
    assert sess.report.num_stages == 0
    assert np.all(store.values == 1.0)


@pytest.mark.parametrize("backend", ["float32", "numpy"])
def test_zero_emission_and_max_rounds(backend):
    store, sess = _store_sess(backend)
    out = sess.run_plan(StagePlan().loop(
        StagePlan().stage(CARRY, _inc, "add", emit=lambda st, res: None),
        until="empty", max_rounds=10), carry=_unit_batch())
    assert out.rounds == 1 and out.loops[0].reason == "empty"
    out = sess.run_plan(StagePlan().loop(
        StagePlan().stage(CARRY, _inc, "add",
                          emit=lambda st, res: _unit_batch()),
        until="empty", max_rounds=3), carry=_unit_batch())
    assert out.rounds == 3 and out.loops[0].reason == "max_rounds"
    assert np.all(store.values[:8] == 5.0)  # 1 + 1 round + 3 rounds


@pytest.mark.parametrize("backend", ["float32", "numpy"])
def test_until_predicate_and_state_threading(backend):
    store, sess = _store_sess(backend)

    def stop_at_two(state):
        state["seen"] = state.get("seen", 0) + 1
        return state.round >= 2

    out = sess.run_plan(StagePlan().loop(
        StagePlan().stage(lambda st: _unit_batch(), _inc, "add"),
        until=stop_at_two, max_rounds=50))
    assert out.rounds == 2 and out.loops[0].reason == "until"
    assert out.state["seen"] == 2


@pytest.mark.parametrize("backend", ["float32", "numpy"])
def test_plan_errors_match_reference(backend):
    store, sess = _store_sess(backend)
    with pytest.raises(ValueError, match="stopping rule"):
        StagePlan().loop(StagePlan().stage(CARRY, _inc), until=None)
    with pytest.raises(ValueError, match="no tasks to run"):
        sess.run_plan(StagePlan().stage(CARRY, _inc, "add"))
    with pytest.raises(RuntimeError, match="no progress"):
        sess.run_plan(StagePlan().loop(StagePlan().stage(CARRY, _inc, "add"),
                                       until="empty"), carry=_unit_batch())
    with pytest.raises(TypeError, match="loop body"):
        sess.run_plan(StagePlan().loop(lambda st: 3, max_rounds=1,
                                       until=None))


# ---------------------------------------------------------------------------
# the plan scope
# ---------------------------------------------------------------------------
def test_user_callbacks_see_flushed_host_values():
    """Every kind of user callback runs after a flush: the host copy holds
    the device's values of every round so far."""
    store, sess = _store_sess()
    seen = []

    def check(state, tag):
        seen.append(tag)
        np.testing.assert_array_equal(store.values[:8, 0],
                                      1.0 + state.round)

    def factory(state):
        check(state, "factory")
        return _unit_batch()

    def after_stage(state, tag):
        # this round's write is in the host copy already
        seen.append(tag)
        np.testing.assert_array_equal(store.values[:8, 0],
                                      2.0 + state.round)

    def emit(state, res):
        after_stage(state, "emit")

    def until(state):
        check(state, "until")
        return state.round >= 3

    plan = (StagePlan()
            .loop(StagePlan().stage(factory, _inc, "add", emit=emit)
                             .host(lambda st: after_stage(st, "host")),
                  until=until, max_rounds=10)
            .host(lambda st: np.testing.assert_array_equal(
                store.values[:8, 0], 4.0)))
    out = sess.run_plan(plan)
    assert out.rounds == 3
    assert seen == ["factory", "emit", "host", "until"] * 3


@pytest.mark.parametrize("emitting", [False, True], ids=["static", "emitting"])
def test_host_syncs_match_jax_backend(emitting):
    """A static plan flushes once at exit (no user callback reads the
    host); an emitting plan syncs once a round (its emit reads the host).
    Both as many as the JAX backend; the same rounds through run_stage
    sync every stage."""
    syncs = []
    for pkg, backend in ((port, port.TorchBackend(device="cpu")),
                         (ref, "jax")):
        store = pkg.DataStore.create(32, P, value_width=1, chunk_words=4,
                                     init=1.0)
        sess = pkg.Orchestrator(store, engine="tdorch", backend=backend)
        batch = pkg.TaskBatch(contexts=np.ones((8, 1)), read_keys=np.arange(8),
                              origin=pkg.TaskBatch.even_origins(8, P))
        if emitting:
            def emit(state, res, store=store, batch=batch):
                assert np.allclose(store.values[:8], state.round + 2.0)
                return batch if state.round < 3 else None

            plan = pkg.StagePlan().loop(
                pkg.StagePlan().stage(pkg.CARRY, _inc, "add", emit=emit),
                until="empty")
        else:
            plan = pkg.StagePlan().loop(pkg.StagePlan().stage(batch, _inc,
                                                              "add"),
                                        until=None, max_rounds=5)
        before = sess.backend.host_syncs
        out = sess.run_plan(plan, carry=batch)
        syncs.append(sess.backend.host_syncs - before)
        np.testing.assert_allclose(store.values[:8], 1.0 + out.rounds)
        np.testing.assert_allclose(store.values[8:], 1.0)
    assert syncs[0] == syncs[1] == (4 if emitting else 1)
    store, sess = _store_sess()
    for _ in range(5):
        sess.run_stage(_unit_batch(), _inc, "add")
    assert sess.backend.host_syncs == 5


def test_nested_scopes_flush_at_the_outermost_exit():
    store, sess = _store_sess()
    be = sess.backend
    be.begin_plan(store)
    be.begin_plan(store)
    sess.run_stage(_unit_batch(), _inc, "add")
    assert np.all(store.values == 1.0)  # deferred: the host copy is stale
    be.end_plan()
    assert np.all(store.values == 1.0) and be.host_syncs == 0
    sess.run_stage(_unit_batch(4), _inc, "add")
    be.end_plan()
    assert be.host_syncs == 1  # one flush covering both stages' rows
    np.testing.assert_array_equal(store.values[:4, 0], 3.0)
    np.testing.assert_array_equal(store.values[4:8, 0], 2.0)
    np.testing.assert_array_equal(store.values[8:, 0], 1.0)
    # a plan inside a plan's host step opens no second flush point
    inner = StagePlan().stage(_unit_batch(), _inc, "add")
    outer = (StagePlan().stage(_unit_batch(), _inc, "add")
             .host(lambda st: sess.run_plan(inner)))
    sess.run_plan(outer)
    np.testing.assert_array_equal(store.values[:4, 0], 5.0)
    assert be.host_syncs == 3  # before the host step, at the outer exit


def _host_only(ctx, vals):
    # torch cannot run it (a tensor has no astype): it routes to the host
    # numpy path
    return {"update": vals.astype(np.float64) + 1.0}


def test_host_route_and_oracle_apply_flush_first():
    """Inside a scope, a stage that must read the host copy — a lambda
    torch cannot run, or a write-back whose priorities do not fit the
    kernel's int32 order keys (the oracle apply) — sees the deferred
    writes of the stages before it."""
    store, sess = _store_sess()
    wide = _unit_batch()
    wide.priority = np.full(8, 2**40, dtype=np.int64)
    plan = (StagePlan().stage(_unit_batch(), _inc, "add")
            .stage(_unit_batch(), _host_only, "add")
            .stage(_unit_batch(), _inc, "add")
            .stage(wide, _inc, "add"))
    with pytest.warns(RuntimeWarning, match="host numpy path"):
        sess.run_plan(plan)
    # 1 → 2 (+1) → 5 (v + (v + 1), read after the flush) → 6 → 7
    np.testing.assert_array_equal(store.values[:8, 0], 7.0)
    np.testing.assert_array_equal(store.values[8:, 0], 1.0)
    np.testing.assert_array_equal(
        sess.backend.device_values(store).numpy()[:, 0], store.values[:, 0])


def test_run_plan_on_a_session_defaults_to_the_card():
    if torch.cuda.is_available():  # pragma: no cover - needs the card
        pytest.skip("the card is present: the CUDA tests cover it")
    store = port.DataStore.create(32, P, value_width=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.Orchestrator(store, engine="pull")
