"""The port's KV store (`repro_torch.kvstore`) against the JAX package's
(`repro.kvstore`), on the same seeded numpy inputs in one process.

The port runs on ``TorchBackend(device="cpu")`` in float64 and float32
(every kernel wrapper takes its plain version there) and on
``backend="numpy"``; the reference on ``backend="numpy"``. Checks:

- `ycsb`: every generator draws the reference's keys, flags and operands
  for the same seed, to the last bit;
- `execute_batch` for YCSB A / B / C / LOAD under every engine, two
  batches a session: `phase_signature()`, `refcount` and `exec_site`
  exactly, fetched values and the table within 1e-12 in float64 and rtol
  1e-5 / atol 1e-6 in float32 (values in [0, 2)), and against
  `DistributedHashTable.oracle`;
- `multi_get`, flat key lists and a CSR pair: the padded values and mask;
- `run_chain`, with a key matrix and with `follow=`: per-hop values, keys,
  hop count and every hop's bill;
- `KVFrontend` against the reference's `KVFrontend` over a mixed stream:
  the same batches, bills and values;
- no batch sends a lambda to the host route, `kernel_backend=` takes only
  "auto", and with no backend named the table runs on the card.
"""
import numpy as np
import pytest
import torch

import repro.kvstore as ref_kv
from repro_torch import kvstore as port_kv
from repro_torch.core import TorchBackend
from repro_torch.kvstore import DistributedHashTable, ycsb

# one intra-op thread per test process: the suite runs in parallel workers
torch.set_num_threads(1)

F64_TOL = 1e-12
RTOL, ATOL = 1e-5, 1e-6
ENGINES = ["tdorch", "push", "pull", "sort", "auto"]
BACKENDS = ["numpy", "torch_cpu64", "torch_cpu32"]


def _backend(name):
    if name == "numpy":
        return "numpy"
    return TorchBackend(device="cpu",
                        dtype="float64" if name == "torch_cpu64"
                        else "float32")


def _tol(name):
    return dict(rtol=F64_TOL, atol=F64_TOL) if name != "torch_cpu32" \
        else dict(rtol=RTOL, atol=ATOL)


def _tables(P=8, K=512, w=2, seed=0):
    init = np.random.default_rng(seed + 7).random((K, w))
    out = []
    for pkg in (port_kv, ref_kv):
        ht = pkg.DistributedHashTable(K, P, value_width=w, seed=seed)
        ht.bulk_load(np.arange(K), init)
        out.append(ht)
    return out[0], out[1], init


def _same_bill(a, b):
    assert a.report.phase_signature() == b.report.phase_signature()
    assert a.refcount == b.refcount


def _no_host_lambdas(backend):
    if not isinstance(backend, str):
        assert not backend._host_lambdas


# ---------------------------------------------------------------------------
# ycsb: the reference's draws, seed for seed
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 3, 17])
def test_ycsb_draws_equal_jax(seed):
    for wl in ("A", "B", "C", "LOAD", ycsb.YCSB_WORKLOADS["B"]):
        ref_wl = wl if isinstance(wl, str) else ref_kv.YCSB_WORKLOADS["B"]
        for a, b in zip(port_kv.make_ycsb_batch(wl, 64, 8, 1000, 1.5, seed),
                        ref_kv.make_ycsb_batch(ref_wl, 64, 8, 1000, 1.5,
                                               seed)):
            np.testing.assert_array_equal(a, b)
    got = list(port_kv.make_ycsb_stream("A", 32, 4, 300, 2.0, seed, 3))
    want = list(ref_kv.make_ycsb_stream("A", 32, 4, 300, 2.0, seed, 3))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
    np.testing.assert_array_equal(port_kv.zipf_keys(5000, 700, 1.2, r1),
                                  ref_kv.zipf_keys(5000, 700, 1.2, r2))
    perm = np.random.default_rng(seed + 1).permutation(700)
    k = port_kv.zipf_keys_stationary(5000, 700, 2.5, r1, perm)
    np.testing.assert_array_equal(
        k, ref_kv.zipf_keys_stationary(5000, 700, 2.5, r2, perm))
    assert k.dtype == np.int64
    assert ycsb.YCSB_WORKLOADS.keys() == ref_kv.YCSB_WORKLOADS.keys()


def test_zipf_sampler_is_skewed_and_permuted():
    keys = port_kv.zipf_keys(100_000, 1000, 2.0, np.random.default_rng(0))
    counts = np.bincount(keys, minlength=1000)
    assert counts.max() > 0.3 * keys.size
    assert counts.argmax() != 0 or counts.argsort()[-2] != 1


# ---------------------------------------------------------------------------
# execute_batch: A / B / C / LOAD under every engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("workload", ["A", "B", "C", "LOAD"])
@pytest.mark.parametrize("engine", ENGINES)
def test_execute_batch_matches_jax(engine, workload, backend):
    ht, rt, init = _tables()
    be = _backend(backend)
    tol = _tol(backend)
    stream = list(port_kv.make_ycsb_stream(workload, 60, 8, 512, 1.5, 3, 2))
    for keys, is_read, operand in stream:
        before = ht.values.copy()
        a = ht.execute_batch(keys, is_read, operand, engine=engine,
                             backend=be)
        b = rt.execute_batch(keys, is_read, operand, engine=engine,
                             backend="numpy")
        _same_bill(a, b)
        np.testing.assert_allclose(a.values, b.values, **tol)
        np.testing.assert_allclose(ht.values, rt.values, **tol)
        want_vals, want_res = DistributedHashTable.oracle(
            before, keys, is_read, operand)
        np.testing.assert_allclose(a.values, want_res, **tol)
        np.testing.assert_allclose(ht.values, want_vals, **tol)
    rep, rrep = (t.session(engine, backend=x).report
                 for t, x in ((ht, be), (rt, "numpy")))
    assert rep.num_stages == rrep.num_stages == 2
    assert [d.choice for d in rep.policy_decisions] == \
        [d.choice for d in rrep.policy_decisions]
    _no_host_lambdas(be)


@pytest.mark.parametrize("replicate", [None, {"num_hot": 8, "refresh": 1,
                                              "min_count": 1.0}])
def test_exec_site_and_replication_match_jax(replicate):
    """The stage the table builds, run through its own cached session:
    `exec_site` exactly, replica-local words equal."""
    ht, rt, init = _tables()
    be = _backend("torch_cpu64")
    for keys, is_read, operand in port_kv.make_ycsb_stream(
            "B", 80, 8, 512, 2.0, 5, 3):
        a = ht.session(backend=be, replicate=replicate).run_stage(
            ht._make_batch(keys, is_read, operand, None),
            port_kv.hashtable._muladd_lambda, write_back="write",
            return_results=True)
        b = rt.session(backend="numpy", replicate=replicate).run_stage(
            rt._make_batch(keys, is_read, operand, None),
            ref_kv.hashtable._muladd_lambda, write_back="write",
            return_results=True)
        _same_bill(a, b)
        np.testing.assert_array_equal(a.exec_site, b.exec_site)
        np.testing.assert_allclose(a.results, b.results, rtol=F64_TOL,
                                   atol=F64_TOL)
    assert ht.session_report(backend=be, replicate=replicate
                             ).replica_local_words == \
        rt.session_report(backend="numpy", replicate=replicate
                          ).replica_local_words
    _no_host_lambdas(be)


def test_hot_key_refcount_surfaces():
    ht, rt, init = _tables(P=8, K=256, w=1)
    keys = np.zeros(5000, dtype=np.int64)
    r = ht.execute_batch(keys, np.ones(5000, dtype=bool),
                         np.tile([1.0, 0.0], (5000, 1)),
                         backend=_backend("torch_cpu64"))
    assert r.refcount.get(0) == 5000


# ---------------------------------------------------------------------------
# multi_get
# ---------------------------------------------------------------------------
def _groups(rng, n=40, K=512, lo=0, hi=7):
    return [rng.integers(0, K, rng.integers(lo, hi)).tolist()
            for _ in range(n)]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("form", ["lists", "csr", "arity1"])
def test_multi_get_matches_jax(form, backend):
    ht, rt, init = _tables()
    be = _backend(backend)
    rng = np.random.default_rng(4)
    groups = _groups(rng, hi=2 if form == "arity1" else 7)
    groups[3] = []  # an empty task reads nothing
    groups[5] = [9, 9, 9]  # duplicates
    if form == "arity1":
        groups[5] = [9]
    if form == "csr":
        indptr = np.zeros(len(groups) + 1, dtype=np.int64)
        np.cumsum([len(g) for g in groups], out=indptr[1:])
        indices = np.concatenate([np.asarray(g, dtype=np.int64)
                                  for g in groups])
        arg = (indptr, indices)
    else:
        arg = groups
    for _ in range(2):
        a = ht.multi_get(arg, backend=be)
        b = rt.multi_get(arg, backend="numpy")
        _same_bill(a, b)
        np.testing.assert_array_equal(a.mask, b.mask)
        assert a.values.shape == b.values.shape
        np.testing.assert_allclose(np.where(a.mask[..., None], a.values, 0),
                                   np.where(b.mask[..., None], b.values, 0),
                                   **_tol(backend))
        for i, g in enumerate(groups):
            np.testing.assert_allclose(a.values[i][a.mask[i]],
                                       init[g].reshape(-1, 2),
                                       **_tol(backend))
    np.testing.assert_array_equal(ht.values, init)  # reads write nothing
    _no_host_lambdas(be)


# ---------------------------------------------------------------------------
# run_chain
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("how", ["matrix", "follow"])
def test_run_chain_matches_jax(how, backend):
    ht, rt, init = _tables(K=256)
    be = _backend(backend)
    rng = np.random.default_rng(8)
    n, hops = 48, 4
    operand = rng.random((n, 2))
    if how == "matrix":
        keys = rng.integers(0, 256, (n, hops))
        kw = {}
    else:
        keys = rng.integers(0, 256, n)

        def follow(vals):  # chase: the next key from the fetched value
            nk = (np.asarray(vals)[:, 0] * 1000).astype(np.int64) % 300
            return np.where(nk < 256, nk, -1)  # >= 256 ends the chain

        kw = dict(follow=follow, max_hops=hops)
    a = ht.run_chain(keys, operand, backend=be, **kw)
    b = rt.run_chain(keys, operand, backend="numpy", **kw)
    assert a.hops == b.hops
    if how == "follow" and backend == "torch_cpu32":
        # a float32 fetch may land the chase elsewhere; hold the first hop
        # (before any chase) exactly and the rest to the reference's keys
        np.testing.assert_array_equal(a.keys[:, 0], b.keys[:, 0])
    else:
        np.testing.assert_array_equal(a.keys, b.keys)
        assert len(a.reports) == len(b.reports) == a.hops
        for ra, rb in zip(a.reports, b.reports):
            assert ra.phase_signature() == rb.phase_signature()
        np.testing.assert_allclose(a.values, b.values, equal_nan=True,
                                   **_tol(backend))
        np.testing.assert_allclose(ht.values, rt.values, **_tol(backend))
    if how == "matrix":
        assert a.hops == hops
    _no_host_lambdas(be)


def test_run_chain_equals_the_execute_batch_loop():
    """The plan form is batch for batch the hand-rolled loop: the same
    bills and the same table."""
    ht, rt, init = _tables(K=128)
    loop, _, _ = _tables(K=128)
    be, be2 = _backend("torch_cpu64"), _backend("torch_cpu64")
    rng = np.random.default_rng(2)
    keys = rng.integers(0, 128, (30, 3))
    operand = rng.random((30, 2))
    out = ht.run_chain(keys, operand, backend=be)
    for j in range(3):
        r = loop.execute_batch(keys[:, j], np.zeros(30, dtype=bool),
                               operand, backend=be2)
        assert r.report.phase_signature() == \
            out.reports[j].phase_signature()
        np.testing.assert_allclose(out.values[:, j], r.values,
                                   rtol=F64_TOL, atol=F64_TOL)
    np.testing.assert_allclose(ht.values, loop.values, rtol=F64_TOL,
                               atol=F64_TOL)


def test_run_chain_argument_errors():
    ht, _, _ = _tables(K=64)
    with pytest.raises(ValueError, match="not both"):
        ht.run_chain(np.zeros((2, 2), dtype=np.int64), np.ones((2, 2)),
                     follow=lambda v: v, backend="numpy")
    with pytest.raises(ValueError, match="follow= and max_hops="):
        ht.run_chain(np.zeros(2, dtype=np.int64), np.ones((2, 2)),
                     backend="numpy")


# ---------------------------------------------------------------------------
# KVFrontend against the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", BACKENDS)
def test_kv_frontend_matches_jax(backend):
    """A mixed stream of GETs, RMWs and multi-gets through both frontends
    (sync mode, size trigger): the same batches, the same bill per buffer,
    the values within tolerance and bit-identical to the port's one-shot
    batches on the same backend."""
    ht, rt, init = _tables(K=256)
    shot, _, _ = _tables(K=256)
    be = _backend(backend)
    cfg = {"max_batch": 16, "min_window": 1.0, "max_window": 1.0}
    fe = ht.serve(backend=be, mode="sync", config=cfg)
    rfe = rt.serve(backend="numpy", mode="sync", config=cfg)
    keys, is_read, operand = ref_kv.make_ycsb_batch("A", 8, 8, 256, 1.5, 6)
    rng = np.random.default_rng(6)
    groups = _groups(rng, n=32, K=256, lo=1, hi=6)
    futs = []
    for front in (fe, rfe):
        kv = [front.get(int(k)) if r else
              front.read_modify_write(int(k), o[0], o[1])
              for k, r, o in zip(keys, is_read, operand)]
        mg = [front.multi_get(g) for g in groups]
        front.flush()
        futs.append((kv, mg))
    tol = _tol(backend)
    for (a, b) in zip(*[[f.result() for f in kv + mg] for kv, mg in futs]):
        np.testing.assert_allclose(a, b, **tol)
    np.testing.assert_allclose(ht.values, rt.values, **tol)
    for s, r in zip(fe.sessions, rfe.sessions):
        assert [x.phase_signature() for x in s.report.stages] == \
            [x.phase_signature() for x in r.report.stages]
    assert fe.report()["session"] == rfe.report()["session"]
    # the same coalesced batches, one shot each, on a twin backend
    be2 = _backend(backend)
    kv, mg = futs[0]
    for i in range(0, keys.size, 16):
        one = shot.execute_batch(keys[i:i + 16], is_read[i:i + 16],
                                 operand[i:i + 16], backend=be2)
        np.testing.assert_array_equal(
            np.stack([f.result() for f in kv[i:i + 16]]), one.values)
    for i in range(0, len(groups), 16):
        one = shot.multi_get(groups[i:i + 16], backend=be2)
        for j, f in enumerate(mg[i:i + 16]):
            np.testing.assert_array_equal(
                f.result(), one.values[j][one.mask[j]].reshape(-1, 2))
    np.testing.assert_array_equal(ht.values, shot.values)
    _no_host_lambdas(be)
    fe.close()
    rfe.close()


# ---------------------------------------------------------------------------
# options and the default device
# ---------------------------------------------------------------------------
def test_kernel_backend_takes_only_auto():
    ht, _, _ = _tables(K=64)
    be = _backend("torch_cpu64")
    assert ht.session(backend=be, kernel_backend="auto") is \
        ht.session(backend=be)
    for route in ("padded", "interpret", "fused"):
        with pytest.raises(ValueError, match="one route 'auto'"):
            ht.session(backend=be, kernel_backend=route)
        with pytest.raises(ValueError, match="one route 'auto'"):
            ht.serve(backend=be, kernel_backend=route, mode="sync")


def test_elasticity_is_refused():
    """Named for the refusal it once pinned: a table session now takes
    `elasticity=`. With a restart recovery (machine 3 dies at batch 2) and
    migration, YCSB-A batches match the JAX table's: bills, fetched values, the table and the elastic counters."""
    ht, rt, _ = _tables(K=64)
    spec = {"recovery": {"injector": {2: [3]}, "checkpoint_every": 2},
            "migration": {"refresh": 2, "min_count": 2.0}}
    be = _backend("torch_cpu64")
    for i in range(5):
        keys, is_read, operand = port_kv.make_ycsb_batch(
            "A", 200, 8, 64, 1.5, seed=40 + i)
        a = ht.execute_batch(keys, is_read, operand, backend=be,
                             elasticity=spec)
        b = rt.execute_batch(keys, is_read, operand, backend="numpy",
                             elasticity=spec)
        _same_bill(a, b)
        np.testing.assert_allclose(a.values, b.values, **_tol("torch_cpu64"))
    np.testing.assert_allclose(ht.values, rt.values, **_tol("torch_cpu64"))
    s, r = ht.session(backend=be, elasticity=spec), \
        rt.session(backend="numpy", elasticity=spec)
    assert s.elastic.counters() == r.elastic.counters()
    assert s.elastic.counters()["recoveries"] == 1
    np.testing.assert_array_equal(ht.store.home, rt.store.home)
    _no_host_lambdas(be)


def test_sessions_are_cached_per_option():
    ht, _, _ = _tables(K=64)
    be = _backend("torch_cpu64")
    s = ht.session(backend=be)
    assert ht.session(backend=be) is s
    assert ht.session(backend=be, engine="push") is not s
    assert ht.session(backend="numpy") is not s
    assert ht.session(config={"backend": be}) is s


def test_table_defaults_to_the_card():
    """With no backend named every entry point runs on the card, and
    never quietly on the CPU: with no CUDA device, each one raises."""
    if torch.cuda.is_available():  # pragma: no cover - needs the card
        ht, _, _ = _tables(K=64)
        assert ht.session().backend.device.type == "cuda"
        return
    ht, _, _ = _tables(K=64)
    keys, is_read, operand = port_kv.make_ycsb_batch("A", 4, 8, 64)
    for call in (lambda: ht.execute_batch(keys, is_read, operand),
                 lambda: ht.multi_get([[1, 2]]),
                 lambda: ht.run_chain(keys[:, None], operand),
                 lambda: ht.serve(mode="sync")):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
