"""The port's `TorchBackend` against the JAX package's backends, stage by
stage, on the CPU (``TorchBackend(device="cpu")``: every kernel wrapper
runs its plain PyTorch version there).

Matrix: arity-1 / ragged generic / ragged `fused_read` per read_op x
add/min/max/or/write x replication off/on, two stages per session.
- Against repro's ``backend="numpy"``: per-phase `phase_signature()`,
  `refcount` and `exec_site` exactly, and the port in float64 within 1e-12
  (values and results; sums differ only in their order).
- Against repro's ``backend="jax"``: the port in float32 within rtol 1e-5 /
  atol 1e-6 (both compute in float32; sums differ in order).
Then the machinery around the kernels: the per-lambda host fallback (and
its warning), that a failing kernel wrapper or a device error propagates
out of `run_stage`, that int32 operands never wrap, the device-cache
version tracking, and that no entry point quietly runs on the CPU.
"""
import contextlib
import warnings

import numpy as np
import pytest
import torch

import repro.core as ref
import repro_torch.core as port
from repro_torch.core import torchexec

# one intra-op thread per test process: the suite runs in parallel workers
torch.set_num_threads(1)

F64_TOL = 1e-12
RTOL, ATOL = 1e-5, 1e-6
MERGES = ["add", "min", "max", "or", "write"]
KINDS = ["arity1", "ragged", "fused_add", "fused_min", "fused_max",
         "fused_first"]
REP = {"num_hot": 8, "refresh": 1, "min_count": 1.0}

# one JAX backend per module: its jit caches stay warm across cases
JAX = ref.make_backend("jax")


def _muladd(contexts, vals):
    out = vals * contexts[:, 0:1] + contexts[:, 1:2]
    return {"update": out, "result": out}


def _masked_sum(contexts, vals, mask):
    # generic ragged lambda: the padded (n, A, w) view plus its mask
    s = (vals * mask[..., None]).sum(1)
    return {"update": s * contexts[:, :1], "result": s}


def _scale(contexts, red):
    return red * contexts[:, :1] + contexts[:, 1:2]


def _lambda(pkg, kind):
    if kind == "arity1":
        return _muladd
    if kind == "ragged":
        return _masked_sum
    return pkg.fused_read(kind.split("_")[1], _scale)


def _store_values(K=60, w=3, seed=0):
    return np.random.default_rng(seed).standard_normal((K, w))


def _batches(pkg, kind, K=60, n=48, P=4, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        ctx = rng.standard_normal((n, 2))
        prio = rng.integers(-1000, 1000, n)
        if kind == "arity1":
            keys = rng.integers(0, K, n)
            out.append(pkg.TaskBatch(contexts=ctx, read_keys=keys,
                                     origin=pkg.TaskBatch.even_origins(n, P),
                                     priority=prio))
            continue
        groups = [rng.integers(0, K, rng.integers(0, 5)).tolist()
                  for _ in range(n)]
        wk = np.array([g[-1] if g else -1 for g in groups], dtype=np.int64)
        out.append(pkg.TaskBatch.from_ragged(
            ctx, groups, pkg.TaskBatch.even_origins(n, P), write_keys=wk,
            priority=prio))
    return out


def _run(pkg, backend, kind, merge, replication, values):
    store = pkg.DataStore.create(values.shape[0], 4, value_width=3)
    store.write_rows(np.arange(values.shape[0]), values)
    sess = pkg.Orchestrator(store, backend=backend, replication=replication)
    f = _lambda(pkg, kind)
    res = [sess.run_stage(tb, f, write_back=merge, return_results=True)
           for tb in _batches(pkg, kind)]
    return store, res


def _close(a, b, rtol, atol):
    np.testing.assert_allclose(np.asarray(a, dtype=np.float64),
                               np.asarray(b, dtype=np.float64),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("replicated", [False, True],
                         ids=["rep_off", "rep_on"])
@pytest.mark.parametrize("merge", MERGES)
@pytest.mark.parametrize("kind", KINDS)
def test_stage_parity(kind, merge, replicated):
    rep = REP if replicated else None
    values = _store_values()
    s_np, r_np = _run(ref, "numpy", kind, merge, rep, values)
    s64, r64 = _run(port, port.TorchBackend(device="cpu", dtype="float64"),
                    kind, merge, rep, values)
    s_jx, r_jx = _run(ref, JAX, kind, merge, rep, values)
    s32, r32 = _run(port, port.TorchBackend(device="cpu"), kind, merge, rep,
                    values)
    _close(s64.values, s_np.values, F64_TOL, F64_TOL)
    _close(s32.values, s_jx.values, RTOL, ATOL)
    for a, b, c, d in zip(r_np, r64, r_jx, r32):
        assert b.report.phase_signature() == a.report.phase_signature()
        assert d.report.phase_signature() == a.report.phase_signature()
        assert b.refcount == a.refcount == d.refcount
        np.testing.assert_array_equal(b.exec_site, a.exec_site)
        np.testing.assert_array_equal(d.exec_site, a.exec_site)
        _close(b.results, a.results, F64_TOL, F64_TOL)
        _close(d.results, c.results, RTOL, ATOL)
    if replicated:  # the second stage really ran replica-local pairs
        assert r64[1].report.phase_signature()[0][0] == "replica_refresh"


@contextlib.contextmanager
def _no_warning():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        yield


def _arity1(pkg, seed=9):
    return _batches(pkg, "arity1", seed=seed)


def _oracle_pair(f, merge="add", f_port=None):
    values = _store_values(seed=3)
    out = []
    for pkg, backend, fn in ((ref, "numpy", f),
                             (port, port.TorchBackend(device="cpu"),
                              f_port or f)):
        store = pkg.DataStore.create(60, 4, value_width=3)
        store.write_rows(np.arange(60), values)
        sess = pkg.Orchestrator(store, backend=backend)
        res = [sess.run_stage(tb, fn, write_back=merge, return_results=True)
               for tb in _arity1(pkg)]
        out.append((store, res, backend))
    return out


def test_untraceable_lambda_falls_back():
    """A lambda torch cannot run (numpy's astype on its inputs) is routed
    to the oracle path: same values exactly, same costs, no crash."""

    def hostile(contexts, in_vals):
        v = in_vals.astype(np.float64)
        return {"update": v * 2.0, "result": v}

    with pytest.warns(RuntimeWarning, match="host numpy path"):
        (s_np, r_np, _), (s_pt, r_pt, be) = _oracle_pair(hostile)
    np.testing.assert_array_equal(s_pt.values, s_np.values)
    for a, b in zip(r_np, r_pt):
        assert b.report.phase_signature() == a.report.phase_signature()
    assert id(hostile) in be._host_lambdas


def test_untraceable_finish_falls_back():
    def hostile_finish(contexts, red):
        return red.astype(np.float64) * 2.0

    values = _store_values(seed=4)
    outs = []
    for pkg, backend in ((ref, "numpy"),
                         (port, port.TorchBackend(device="cpu"))):
        store = pkg.DataStore.create(60, 4, value_width=3)
        store.write_rows(np.arange(60), values)
        lam = pkg.fused_read("add", hostile_finish)
        with pytest.warns(RuntimeWarning, match="host numpy path") \
                if pkg is port else _no_warning():
            res = pkg.Orchestrator(store, backend=backend).run_stage(
                _batches(pkg, "ragged")[0], lam, write_back="add",
                return_results=True)
        outs.append((store, res))
    np.testing.assert_array_equal(outs[1][0].values, outs[0][0].values)
    assert outs[1][1].report.phase_signature() == \
        outs[0][1].report.phase_signature()


@pytest.mark.parametrize("target,kind,merge", [
    ("_kernel_combine", "arity1", "add"),
    ("_kernel_combine", "arity1", "write"),
    ("_fused_stage", "fused_min", "min"),
    ("count_ids", "arity1", "add"),
])
def test_kernel_failure_propagates(monkeypatch, target, kind, merge):
    """No try catches a kernel: a wrapper that raises makes the stage
    raise, instead of quietly taking the host path."""

    def boom(*args, **kwargs):
        raise RuntimeError("kernel failed")

    monkeypatch.setattr(torchexec, target, boom)
    values = _store_values()
    store = port.DataStore.create(60, 4, value_width=3)
    store.write_rows(np.arange(60), values)
    be = port.TorchBackend(device="cpu")
    sess = port.Orchestrator(store, backend=be)
    tb = _batches(port, kind, K=60, n=48)[0]
    if target == "count_ids":  # make Phase 1 dense enough for the device
        tb = port.TaskBatch(contexts=np.zeros((4000, 2)),
                            read_keys=np.arange(4000) % 60,
                            origin=port.TaskBatch.even_origins(4000, 4))
    with pytest.raises(RuntimeError, match="kernel failed"):
        sess.run_stage(tb, _lambda(port, kind), write_back=merge)
    assert not be._host_lambdas


@pytest.mark.parametrize("error", torchexec._DEVICE_ERRORS,
                         ids=lambda e: e.__name__)
@pytest.mark.parametrize("kind", ["arity1", "ragged", "fused_add"])
def test_device_error_in_lambda_propagates(error, kind):
    """A device error raised while user code runs (out of memory, a kernel
    fault reported at the lambda's first op) is not the lambda's fault: it
    propagates instead of sending the lambda to the host path."""

    def faulty(*args):
        raise error("device fault")

    lam = port.fused_read("add", faulty) if kind == "fused_add" else faulty
    store = port.DataStore.create(60, 4, value_width=3)
    be = port.TorchBackend(device="cpu")
    with pytest.raises(error, match="device fault"):
        port.Orchestrator(store, backend=be).run_stage(
            _batches(port, kind)[0], lam, write_back="add")
    assert not be._host_lambdas


@pytest.mark.parametrize("bad", [2**31, -2**31 - 1])
def test_int32_operands_never_wrap(bad):
    """Host integer arrays reach the kernels as int32: a value outside it
    raises instead of wrapping into a wrong (unchecked) index."""
    be = port.TorchBackend(device="cpu")
    assert be._di(np.array([0, 2**31 - 1, -2**31])).dtype == torch.int32
    with pytest.raises(OverflowError, match="int32"):
        be._di(np.array([0, bad], dtype=np.int64))


def test_entry_points_default_to_cuda():
    """Without a device argument the port runs on the card, and never on
    the CPU: with no CUDA device, the default backend raises."""
    store = port.DataStore.create(60, 4, value_width=3)
    tb = _arity1(port)[0]
    if torch.cuda.is_available():  # pragma: no cover - needs the card
        assert port.make_backend(None).device.type == "cuda"
        return
    for make in (lambda: port.TorchBackend(),
                 lambda: port.make_backend(None),
                 lambda: port.make_backend("torch"),
                 lambda: port.orchestration(tb, _muladd, store),
                 lambda: port.Orchestrator(store)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_backend_options_rejected():
    with pytest.raises(ValueError, match="no interpret mode"):
        port.TorchBackend(device="cpu", kernel_backend="interpret")
    with pytest.raises(ValueError, match="dtype"):
        port.TorchBackend(device="cpu", dtype="float16")
    for route in ("fused", "padded"):
        with pytest.raises(ValueError, match="kernel_backend"):
            port.TorchBackend(device="cpu", kernel_backend=route)
    store = port.DataStore.create(60, 4, value_width=3)
    with pytest.raises(KeyError, match="unknown engine"):
        port.Orchestrator(store, engine="no_such_engine", backend="numpy")
    # elasticity= is accepted, and a bad spec raises as in the reference
    sess = port.Orchestrator(store, backend="numpy",
                             elasticity={"migration": True})
    assert sess.elastic is not None and sess.elastic.planner is not None
    for bad in ({"migration": 3}, 7):
        with pytest.raises(TypeError, match="bad .*spec"):
            ref.Orchestrator(ref.DataStore.create(60, 4, value_width=3),
                             backend="numpy", elasticity=bad)
        with pytest.raises(TypeError, match="bad .*spec"):
            port.Orchestrator(store, backend="numpy", elasticity=bad)


def test_padded_route_matches_fused_route():
    """The same fused-able lambda through the generic padded gather (a
    plain function wrapping it, so no `fused_spec`) and through the
    stage_fused kernel's route give the same values."""
    values = _store_values(seed=5)
    lam = _lambda(port, "fused_max")
    got = []
    for f in (lam, lambda c, v, m: lam(c, v, m)):
        store = port.DataStore.create(60, 4, value_width=3)
        store.write_rows(np.arange(60), values)
        be = port.TorchBackend(device="cpu", dtype="float64")
        res = port.Orchestrator(store, backend=be).run_stage(
            _batches(port, "ragged")[0], f, write_back="max",
            return_results=True)
        assert not be._host_lambdas
        got.append((store.values, res.results))
    _close(got[0][0], got[1][0], F64_TOL, F64_TOL)
    _close(got[0][1], got[1][1], F64_TOL, F64_TOL)


def test_device_cache_tracks_store_version():
    """Out-of-band store mutations (write_rows between stages) must be seen
    by the backend's device-resident copy."""
    store = port.DataStore.create(60, 4, value_width=3)
    store.write_rows(np.arange(60), _store_values(seed=11))
    be = port.TorchBackend(device="cpu")
    sess = port.Orchestrator(store, backend=be)
    batches = _arity1(port, seed=12)
    sess.run_stage(batches[0], _muladd, write_back="write")
    cached = store._device_values[be._cache_key()]
    assert cached[0] == store.version  # the apply re-pinned the cache
    np.testing.assert_allclose(cached[1].numpy(), store.values, rtol=1e-6,
                               atol=1e-6)
    store.write_rows(np.arange(60), np.full((60, 3), 7.0))
    res = sess.run_stage(batches[1], lambda c, v: {"result": v},
                         return_results=True)
    has = batches[1].read_keys >= 0
    np.testing.assert_array_equal(np.asarray(res.results)[has], 7.0)


def test_transformed_placeholder_is_refused():
    """apply_writes refuses a zero-strided placeholder whose identity no
    longer matches the fused combine (it would write zeros)."""
    store = port.DataStore.create(60, 4, value_width=3)
    be = port.TorchBackend(device="cpu")
    tb = _arity1(port)[0]
    out = be.execute(tb, store, _muladd, port.get_merge_op("add"))
    assert 0 in out["update"].strides
    with pytest.raises(RuntimeError, match="placeholder"):
        be.apply_writes(tb, store, out["update"][:, :],
                        port.get_merge_op("add"), None)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_padded_gather_matches_scatter_form(seed):
    """The one-allocation padded gather against the scatter of an (nnz, w)
    temporary into zeros that it replaced: bit-identical, arity-0 rows
    (all slots zero) included, and values holding inf and -0.0 too."""
    rng = np.random.default_rng(seed)
    values = torch.from_numpy(rng.standard_normal((30, 5)))
    values[3, 1], values[7, 2] = float("inf"), -0.0
    groups = [rng.integers(0, 30, rng.integers(0, 6)).tolist()
              for _ in range(25)]
    groups[0], groups[-1] = [], []
    tb = port.TaskBatch.from_ragged(np.zeros((25, 1)), groups,
                                    port.TaskBatch.even_origins(25, 4))
    n, A = tb.n, tb.max_arity
    row = torch.from_numpy(tb.pair_task)
    col = torch.from_numpy(np.arange(tb.nnz) - tb.read_indptr[:-1][tb.pair_task])
    idx = torch.from_numpy(tb.read_indices)
    mask = torch.zeros((n, A), dtype=torch.bool)
    mask[row, col] = True
    want = torch.zeros((n, A, 5), dtype=values.dtype)
    want[row, col] = values[idx]
    got = torchexec.padded_gather(values, idx, row, col, mask)
    assert got.shape == want.shape
    assert torch.equal(got.view(torch.int64), want.view(torch.int64))
