"""The port's parameter-server tier (`repro_torch.paramserve`,
`repro_torch.core.embedding`) held against the JAX package's, on the same
seeded numpy inputs in one process.

Each port object is built from its JAX twin with `from_reference`, so both
hold the same weights and placement. On the CPU the port runs on
``TorchBackend(device="cpu")`` (every kernel wrapper takes its plain
version) and is compared with the JAX package's ``backend="numpy"`` oracle:

- cost: `phase_signature()`, `refcount`, `exec_site` and the work ratios
  exactly (the cost model is host numpy in both packages);
- values: the port in float64 within 1e-12, in float32 within rtol 2e-4 /
  atol 1e-5 (the tolerance `tests/test_paramserve.py` gives the JAX
  package's float32 backends); the naive arm's grouped GEMM within 1e-4
  of the JAX package's `gemm="ref"`, as there;
- the work-ratio gate of `benchmarks/bench_paramserve.py` (orchestrated
  ≤ 1.5, naive ≥ 2×) on the `tests/test_paramserve.py` GATE mix.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.embedding import embed_skew_aware as jax_embed
from repro.core.embedding import init_cache as jax_init_cache
from repro.core.embedding import refresh_cache as jax_refresh_cache
from repro.paramserve import EmbeddingStore as JaxStore
from repro.paramserve import EmbeddingFrontend as JaxEmbeddingFrontend
from repro.paramserve import MoEFrontend as JaxMoEFrontend
from repro.paramserve import MoERouter as JaxRouter
from repro_torch import kernels
from repro_torch.core import TorchBackend
from repro_torch.core.embedding import (embed_skew_aware, init_cache,
                                        refresh_cache)
from repro_torch.kvstore import zipf_keys_stationary
from repro_torch.paramserve import EmbeddingStore, MoERouter
from repro_torch.paramserve.embedding import EmbeddingFrontend
from repro_torch.paramserve.moe import MoEFrontend

# one intra-op thread per test process: the suite runs in parallel workers
torch.set_num_threads(1)

F64_TOL = 1e-12
RTOL, ATOL = 2e-4, 1e-5
GATE = dict(E=16, d=8, f=16, P=8, k=2, T=256, stages=4, alpha=1.2,
            replicate={"num_hot": 4, "refresh": 1, "decay": 0.5,
                       "min_count": 2.0})


@pytest.fixture(autouse=True)
def no_kernel_launch():
    """On the CPU every wrapper takes its plain version: nothing launches."""
    kernels.reset_launches()
    yield
    assert kernels.launches() == {k: 0 for k in kernels.KERNELS}


def _cpu(dtype="float64"):
    return TorchBackend(device="cpu", dtype=dtype)


def _routers(P, *, E=6, d=5, f=7, k=2, layers=1, seed=0):
    ref = JaxRouter(E, d, f, P, num_layers=layers, top_k=k, seed=seed)
    ref.init_weights(seed + 1)
    return ref, MoERouter.from_reference(ref)


def _tables(P, *, V=40, d=6, seed=0):
    ref = JaxStore(V, d, P, seed=seed)
    ref.init_table(seed + 1)
    return ref, EmbeddingStore.from_reference(ref)


def _same_bill(a, b):
    assert a.report.phase_signature() == b.report.phase_signature()
    assert a.refcount == b.refcount
    if hasattr(a, "exec_site"):
        np.testing.assert_array_equal(a.exec_site, b.exec_site)


def _dropped_routing(r):
    """tests/test_paramserve.py::test_decode_ragged_dropped_slots."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, r.d))
    ti = rng.integers(0, r.E, (6, r.k))
    ti[0, 1] = -1          # mid-slot drop: kept gates compact to the front
    ti[2] = -1             # fully dropped token
    ti[4, 0] = -1
    g = rng.uniform(0.2, 1.0, (6, r.k))
    return x, ti, g


# decode cases: (router kwargs, routing, layer, session kwargs)
DECODE_CASES = {
    "zipf": (dict(P=4), lambda r: r.zipf_routing(32, seed=3), 0, {}),
    "dropped": (dict(P=3, E=5, k=3), _dropped_routing, 0, {}),
    "layer1": (dict(P=3, layers=2), lambda r: r.zipf_routing(10, seed=1),
               1, {}),
    "replicated": (dict(P=4, E=8),
                   lambda r: r.zipf_routing(48, alpha=1.5, seed=9), 0,
                   {"replicate": {"num_hot": 3, "refresh": 1,
                                  "min_count": 1.0}}),
}


# ---------------------------------------------------------------------------
# MoERouter
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decode_matches_jax(case, dtype):
    """Two decode steps through one session (the second sees the replica
    directory the first elected): values against the JAX package's numpy
    run, and the same bill."""
    kw, routing, layer, sess_kw = DECODE_CASES[case]
    ref, port = _routers(**kw)
    be = _cpu(dtype)
    tol = (F64_TOL, F64_TOL) if dtype == "float64" else (RTOL, ATOL)
    for _ in range(2):
        x, ti, g = routing(ref)
        a = ref.decode_step(x, ti, g, layer=layer, backend="numpy",
                            **sess_kw)
        b = port.decode_step(x, ti, g, layer=layer, backend=be, **sess_kw)
        assert b.y.dtype == np.dtype(dtype) and b.y.shape == (x.shape[0],
                                                               port.d)
        np.testing.assert_allclose(b.y, a.y, rtol=tol[0], atol=tol[1])
        np.testing.assert_allclose(b.y, ref.oracle(x, ti, g, layer=layer),
                                   rtol=tol[0], atol=tol[1])
        _same_bill(a, b)
    assert not be._host_lambdas
    if case == "dropped":
        np.testing.assert_allclose(b.y[2], 0.0)
    sa = ref.session(backend="numpy", **sess_kw).report
    sb = port.session(backend=be, **sess_kw).report
    assert sa.replica_local_words == sb.replica_local_words
    np.testing.assert_array_equal(sa.per_machine()["work"],
                                  sb.per_machine()["work"])


def test_route_batch_and_layer_bounds_match_jax():
    ref, port = _routers(3, E=5, k=3, layers=2)
    x, ti, g = _dropped_routing(ref)
    a, b = ref.route_batch(x, ti, g, 1), port.route_batch(x, ti, g, 1)
    for field in ("contexts", "origin", "write_keys", "read_indptr",
                  "read_indices"):
        np.testing.assert_array_equal(getattr(b, field), getattr(a, field))
    with pytest.raises(ValueError, match="layer 2 out of range"):
        port.decode_step(x, ti, g, layer=2, backend=_cpu())


def test_zipf_routing_matches_jax():
    ref, port = _routers(4, E=12, d=6, k=3)
    perm = np.random.default_rng(5).permutation(12)
    for rank_perm in (None, perm):
        for a, b in zip(ref.zipf_routing(40, seed=2, rank_perm=rank_perm),
                        port.zipf_routing(40, seed=2, rank_perm=rank_perm)):
            np.testing.assert_array_equal(a, b)


def test_work_per_pair_accounting():
    """Phase-3 compute = ffn_work per kept (token, expert) assignment —
    the same charge as the JAX package's."""
    ref, port = _routers(3, E=5, k=3)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(8, port.d))
    ti = rng.integers(0, 5, (8, 3))
    ti[1, 2] = -1
    g = rng.uniform(0.2, 1.0, (8, 3))
    be = _cpu()
    for r, backend in ((ref, "numpy"), (port, be)):
        r.decode_step(x, ti, g, backend=backend)
        r.decode_step(x, ti, g, backend=backend, work_per_pair=0.0)
    work = port.session(backend=be).report.per_machine()["work"]
    work0 = port.session(backend=be, work_per_pair=0.0
                         ).report.per_machine()["work"]
    np.testing.assert_allclose(work.sum() - work0.sum(),
                               (ti >= 0).sum() * port.ffn_work)
    np.testing.assert_array_equal(
        work, ref.session(backend="numpy").report.per_machine()["work"])


def test_naive_dispatch_matches_jax():
    ref, port = _routers(4, E=6, d=8, f=16)
    x, ti, g = ref.zipf_routing(32, seed=11)
    ti[3, 1] = -1  # a router drop
    want = ref.naive_dispatch(x, ti, g, gemm="ref")
    got = port.naive_dispatch(x, ti, g, gemm="torch", device="cpu")
    np.testing.assert_allclose(got.y, want.y, rtol=1e-4, atol=1e-4)
    assert got.work_ratio == want.work_ratio
    np.testing.assert_array_equal(got.work, want.work)
    assert got.dropped == want.dropped == 1
    oracle = port.naive_dispatch(x, ti, g)  # the float64 oracle arm
    np.testing.assert_allclose(oracle.y, ref.naive_dispatch(x, ti, g).y,
                               rtol=F64_TOL, atol=F64_TOL)
    np.testing.assert_allclose(got.y, oracle.y, rtol=1e-4, atol=1e-4)


def test_naive_dispatch_reads_the_device_rows_in_place(monkeypatch):
    """The naive arm's grouped GEMMs get views of the backend's cached
    float32 copy of the layer (the one decode_step's sessions use), not
    copies of the weights."""
    from repro_torch.paramserve import moe

    ref, port = _routers(3, E=5, d=6, f=4, layers=2)
    x, ti, g = ref.zipf_routing(12, seed=4)
    port.decode_step(x, ti, g, layer=1, backend=_cpu("float32"))
    rows = _cpu("float32").device_values(port.store)
    seen, gemm = [], moe.grouped_gemm

    def spy(x, w, sizes):
        seen.append(w)
        return gemm(x, w, sizes)

    monkeypatch.setattr(moe, "grouped_gemm", spy)
    got = port.naive_dispatch(x, ti, g, layer=1, gemm="torch", device="cpu")
    start = rows[5].data_ptr()  # layer 1's first expert row
    cut = port.d * 2 * port.f * rows.element_size()
    assert [w.data_ptr() - start for w in seen] == [0, cut]
    assert all(w.stride(0) == rows.stride(0) for w in seen)
    np.testing.assert_allclose(got.y, ref.naive_dispatch(
        x, ti, g, layer=1, gemm="ref").y, rtol=1e-4, atol=1e-4)


def _gate_ratios(router, backend):
    """Steady-state work_ratio of the orchestrated arm (measured from the
    second stage on, as `bench_paramserve` reports it) and the naive
    all-to-all arm's worst."""
    c = GATE
    perm = np.random.default_rng(0).permutation(c["E"])
    naive, warm = 0.0, None
    for s in range(c["stages"]):
        x, ti, g = router.zipf_routing(c["T"], alpha=c["alpha"], seed=s,
                                       rank_perm=perm)
        router.decode_step(x, ti, g, backend=backend,
                           replicate=c["replicate"])
        naive = max(naive, router.naive_dispatch(x, ti, g).work_ratio)
        if s == 0:
            warm = router.session(backend=backend, replicate=c["replicate"]
                                  ).report.per_machine()["work"].copy()
    work = router.session(backend=backend, replicate=c["replicate"]
                          ).report.per_machine()["work"] - warm
    return float(work.max() / work.mean()), naive


@pytest.mark.parametrize("port_backend", ["numpy", "torch_cpu"])
def test_work_ratio_gate(port_backend):
    """Definition 1 at α=1.2 / P=8: orchestrated ≤ 1.5 where naive ≥ 2×,
    with ratios equal to the JAX package's to the last bit."""
    c = GATE
    ref = JaxRouter(c["E"], c["d"], c["f"], c["P"], top_k=c["k"], seed=0)
    ref.init_weights(1)
    port = MoERouter.from_reference(ref)
    backend = "numpy" if port_backend == "numpy" else _cpu("float32")
    orch, naive = _gate_ratios(port, backend)
    assert (orch, naive) == _gate_ratios(ref, "numpy")
    assert naive >= 2.0, f"naive baseline unexpectedly balanced: {naive:.2f}"
    assert orch <= 1.5, f"orchestrated work_ratio {orch:.2f} > 1.5"
    assert naive / orch >= 2.0


def test_replication_is_cost_only_moe():
    ref, port_on = _routers(4, E=8)
    port_off = MoERouter.from_reference(ref)
    rep = {"num_hot": 3, "refresh": 1, "min_count": 1.0}
    be_on, be_off = _cpu(), _cpu()
    # the second skewed stage reads the experts the first one elected
    for seed in (9, 10):
        x, ti, g = port_on.zipf_routing(48, alpha=1.5, seed=seed)
        a = port_on.decode_step(x, ti, g, backend=be_on, replicate=rep)
        b = port_off.decode_step(x, ti, g, backend=be_off)
        np.testing.assert_allclose(a.y, b.y, rtol=F64_TOL, atol=F64_TOL)
    sess = port_on.session(backend=be_on, replicate=rep)
    assert sess.report.replica_local_words > 0


# ---------------------------------------------------------------------------
# EmbeddingStore
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_embedding_matches_jax(dtype):
    """lookup / bag-pool / update: values against the JAX package's numpy
    run, the same bill, and the same table after the update."""
    ref, port = _tables(4)
    be = _cpu(dtype)
    tol = (F64_TOL, F64_TOL) if dtype == "float64" else (RTOL, ATOL)
    rng = np.random.default_rng(5)
    ids = rng.integers(0, ref.V, 13)
    bags = [rng.integers(0, ref.V, rng.integers(0, 4)).tolist()
            for _ in range(7)]
    bags[2] = []  # an empty bag pools to zero
    grads = rng.normal(size=(6, ref.d))
    up_ids = np.array([3, 7, 3, 3, 11, 7])  # duplicates ⊗-combine first
    for op in ("lookup", "bags", "update", "lookup"):
        if op == "lookup":
            a, b = ref.lookup(ids, backend="numpy"), port.lookup(ids,
                                                                 backend=be)
            want = EmbeddingStore.oracle_lookup(ref.table, ids)
        elif op == "bags":
            a = ref.lookup_bags(bags, backend="numpy")
            b = port.lookup_bags(bags, backend=be)
            want = EmbeddingStore.oracle_bags(ref.table, bags)
        else:
            want = EmbeddingStore.oracle_update(ref.table, up_ids, grads)
            a = ref.update(up_ids, grads, backend="numpy")
            b = port.update(up_ids, grads, backend=be)
            np.testing.assert_allclose(port.table, want, rtol=tol[0],
                                       atol=tol[1])
        if op != "update":
            np.testing.assert_allclose(b.values, a.values, rtol=tol[0],
                                       atol=tol[1])
            np.testing.assert_allclose(b.values, want, rtol=tol[0],
                                       atol=tol[1])
        _same_bill(a, b)
    np.testing.assert_allclose(port.table, ref.table, rtol=tol[0],
                               atol=tol[1])
    assert not be._host_lambdas


def test_embedding_replicated_hot_rows():
    ref, port = _tables(4, V=64)
    rep = {"num_hot": 6, "refresh": 1, "min_count": 1.0}
    be = _cpu()
    rng = np.random.default_rng(1)
    perm = rng.permutation(port.V)
    for _ in range(3):
        ids = zipf_keys_stationary(256, port.V, 1.8, rng, perm)
        a = ref.lookup(ids, backend="numpy", replicate=rep)
        b = port.lookup(ids, backend=be, replicate=rep)
        np.testing.assert_allclose(
            b.values, EmbeddingStore.oracle_lookup(port.table, ids),
            rtol=F64_TOL, atol=F64_TOL)
        _same_bill(a, b)
    local = port.session(backend=be, replicate=rep).report.replica_local_words
    assert local > 0
    assert local == ref.session(backend="numpy", replicate=rep
                                ).report.replica_local_words


def test_device_cache_matches_jax():
    """The exported directory and the skew-aware gather equal the JAX
    package's: hot ids, slots, histogram, hot rows, embeddings, the
    accumulated histogram and the hit rate."""
    ref, port = _tables(4, V=64, d=8)
    rep = {"num_hot": 6, "refresh": 1, "min_count": 1.0}
    be = _cpu()
    rng = np.random.default_rng(2)
    perm = rng.permutation(port.V)
    for _ in range(3):
        ids = zipf_keys_stationary(512, port.V, 2.0, rng, perm)
        ref.lookup(ids, backend="numpy", replicate=rep)
        port.lookup(ids, backend=be, replicate=rep)
    want = ref.device_cache(backend="numpy", replicate=rep)
    got = port.device_cache(backend=be, replicate=rep, device="cpu")
    assert got.hot_ids.numel() > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    ids = zipf_keys_stationary(512, port.V, 2.0, rng, perm).reshape(2, 256)
    table = torch.from_numpy(port.table.astype(np.float32))
    out, cache, hr = embed_skew_aware(table, torch.from_numpy(ids), got)
    w_out, w_cache, w_hr = jax_embed(jnp.asarray(ref.table),
                                     jnp.asarray(ids, jnp.int32), want)
    assert out.shape == (2, 256, port.d)
    np.testing.assert_array_equal(out.numpy(), np.asarray(w_out))
    np.testing.assert_array_equal(cache.counts.numpy(),
                                  np.asarray(w_cache.counts))
    assert float(hr) == float(w_hr) > 0.5


def test_device_cache_on_a_tensor_table():
    """`cache_from_replicator` keeps a tensor table's device and dtype and
    copies only the hot rows."""
    from repro_torch.core.embedding import cache_from_replicator

    ref, port = _tables(4, V=64, d=8)
    rep = {"num_hot": 6, "refresh": 1, "min_count": 1.0}
    sess = port.session(backend=_cpu(), replicate=rep)
    rng = np.random.default_rng(3)
    for _ in range(2):
        port.lookup(rng.integers(0, 8, 200), backend=sess.backend,
                    replicate=rep)
    table = torch.from_numpy(port.table)
    cache = cache_from_replicator(table, sess.replicator)
    assert cache.hot_rows.dtype == torch.float64
    np.testing.assert_array_equal(
        cache.hot_rows.numpy(), port.table[cache.hot_ids.numpy()])
    np.testing.assert_array_equal(
        cache.hot_ids.numpy(), sess.replicator.replicas.hot_ids)


def test_standalone_cache_path_matches_jax_and_warns():
    rng = np.random.default_rng(4)
    table = rng.normal(size=(16, 4)).astype(np.float32)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        cache = init_cache(torch.from_numpy(table), 3)
        ref_cache = jax_init_cache(jnp.asarray(table), 3)
        counts = rng.integers(0, 9, 16).astype(np.int32)
        got = refresh_cache(torch.from_numpy(table),
                            cache._replace(counts=torch.from_numpy(counts)))
        want = jax_refresh_cache(jnp.asarray(table),
                                 ref_cache._replace(counts=jnp.asarray(counts)))
    ours = [x for x in w if "repro_torch.paramserve" in str(x.message)]
    assert len(ours) == 2
    assert all(issubclass(x.category, DeprecationWarning) for x in ours)
    for g, v in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(v))


def test_device_cache_requires_replication():
    _, port = _tables(2)
    with pytest.raises(ValueError, match="replicating session"):
        port.device_cache(backend="numpy")


# ---------------------------------------------------------------------------
# weights carried across, and what the port refuses
# ---------------------------------------------------------------------------
def test_from_reference_round_trip():
    ref_r, port_r = _routers(3, E=5, layers=2)
    ref_e, port_e = _tables(3)
    for ref, port in ((ref_r, port_r), (ref_e, port_e)):
        for twin in (port, type(port).from_reference(port)):
            np.testing.assert_array_equal(twin.store.values,
                                          ref.store.values)
            np.testing.assert_array_equal(twin.store.home, ref.store.home)
            assert twin.store.chunk_words == ref.store.chunk_words
            assert twin.store.values is not ref.store.values  # a copy
    assert (port_r.E, port_r.d, port_r.f, port_r.k, port_r.num_layers,
            port_r.ffn_work) == (ref_r.E, ref_r.d, ref_r.f, ref_r.k,
                                 ref_r.num_layers, ref_r.ffn_work)
    for layer in (0, 1):
        for a, b in zip(port_r.layer_weights(layer),
                        ref_r.layer_weights(layer)):
            np.testing.assert_array_equal(a, b)
    assert (port_e.V, port_e.d, port_e.P) == (ref_e.V, ref_e.d, ref_e.P)


# ---------------------------------------------------------------------------
# the streaming front doors (MoEFrontend, EmbeddingFrontend)
# ---------------------------------------------------------------------------
SYNC = {"min_window": 1.0, "max_window": 1.0}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", ["zipf", "dropped", "layer1"])
def test_moe_frontend_matches_decode_step_and_jax(case, dtype):
    """Tokens admitted one at a time coalesce into the batches
    `decode_step` builds: per-token outputs bit-identical to the one-shot
    step on the same backend, within tolerance of the JAX package's
    `MoEFrontend` on numpy, and the same bill per buffer session."""
    kw, routing, layer, _ = DECODE_CASES[case]
    ref, port = _routers(**kw)
    x, ti, g = routing(ref)
    T = x.shape[0]
    be = _cpu(dtype)
    cfg = {"max_batch": T, **SYNC}
    fe = port.serve(backend=be, layer=layer, mode="sync", config=cfg)
    rfe = ref.serve(backend="numpy", layer=layer, mode="sync", config=cfg)
    assert isinstance(fe, MoEFrontend) and isinstance(rfe, JaxMoEFrontend)
    futs = [(fe.decode(x[t], ti[t], g[t]), rfe.decode(x[t], ti[t], g[t]))
            for t in range(T)]
    assert fe.stats.batches == rfe.stats.batches == 1
    got = np.stack([f.result() for f, _ in futs])
    one = port.decode_step(x, ti, g, layer=layer, backend=_cpu(dtype))
    np.testing.assert_array_equal(got, one.y)
    tol = (F64_TOL, F64_TOL) if dtype == "float64" else (RTOL, ATOL)
    np.testing.assert_allclose(got, np.stack([r.result() for _, r in futs]),
                               rtol=tol[0], atol=tol[1])
    np.testing.assert_allclose(got, ref.oracle(x, ti, g, layer=layer),
                               rtol=tol[0], atol=tol[1])
    assert fe.sessions[0].report.stages[0].phase_signature() == \
        rfe.sessions[0].report.stages[0].phase_signature()
    assert fe.sessions[0].report.stages[0].phase_signature() == \
        one.report.phase_signature()
    assert not be._host_lambdas
    fe.close()
    rfe.close()


def test_moe_frontend_refuses_bad_tokens():
    _, port = _routers(2, k=2)
    fe = port.serve(backend=_cpu(), mode="sync")
    x = np.zeros(port.d)
    with pytest.raises(ValueError, match="k=2"):
        fe.decode(x, [0, 1, 2], [0.3, 0.3, 0.4])
    with pytest.raises(ValueError, match="one gate each"):
        fe.decode(x, [0, 1], [1.0])
    fe.close()
    with pytest.raises(ValueError, match="layer 1 out of range"):
        port.serve(backend=_cpu(), layer=1, mode="sync")
    with pytest.raises(ValueError, match="one route 'auto'"):
        port.serve(backend=_cpu(), kernel_backend="padded", mode="sync")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_embedding_frontend_matches_one_shot_and_jax(dtype):
    """Lookups, bags and gradient pushes admitted one at a time: lookups
    and bags bit-identical to `lookup` / `lookup_bags` on the same backend,
    the pushes' table equal to `update`'s (one merged batch: the same
    ⊗-combine), every value within tolerance of the JAX package's
    `EmbeddingFrontend` on numpy, and the same bills."""
    ref, port = _tables(4)
    _, twin = _tables(4)
    be = _cpu(dtype)
    tol = (F64_TOL, F64_TOL) if dtype == "float64" else (RTOL, ATOL)
    rng = np.random.default_rng(9)
    ids = rng.integers(0, port.V, 12)
    bags = [rng.integers(0, port.V, rng.integers(0, 5)).tolist()
            for _ in range(10)]
    bags[4] = []
    up_ids = np.array([3, 7, 3, 3, 11, 7, 0, 39])
    grads = rng.normal(size=(up_ids.size, port.d))
    init = port.table.copy()
    fe = port.serve(backend=be, mode="sync", config={"max_batch": 12, **SYNC})
    rfe = ref.serve(backend="numpy", mode="sync",
                    config={"max_batch": 12, **SYNC})
    assert isinstance(fe, EmbeddingFrontend)
    assert isinstance(rfe, JaxEmbeddingFrontend)
    out = []
    for front in (fe, rfe):
        lk = [front.lookup(int(i)) for i in ids]
        bg = [front.lookup_bag(b) for b in bags]
        gr = [front.push_grad(int(i), gv) for i, gv in zip(up_ids, grads)]
        front.flush()
        out.append((lk, bg, gr))
    (lk, bg, gr), (rlk, rbg, rgr) = out
    twin_be = _cpu(dtype)
    want_lk = twin.lookup(ids, backend=twin_be).values
    want_bg = twin.lookup_bags(bags, backend=twin_be).values
    np.testing.assert_array_equal(np.stack([f.result() for f in lk]),
                                  want_lk)
    np.testing.assert_array_equal(np.stack([f.result() for f in bg]),
                                  want_bg)
    assert all(f.result() is None for f in gr)
    twin.update(up_ids, grads, backend=twin_be)
    np.testing.assert_array_equal(port.table, twin.table)
    for mine, theirs in ((lk, rlk), (bg, rbg)):
        np.testing.assert_allclose(np.stack([f.result() for f in mine]),
                                   np.stack([f.result() for f in theirs]),
                                   rtol=tol[0], atol=tol[1])
    np.testing.assert_allclose(port.table, ref.table, rtol=tol[0],
                               atol=tol[1])
    np.testing.assert_allclose(
        port.table, EmbeddingStore.oracle_update(init, up_ids, grads),
        rtol=tol[0], atol=tol[1])
    for s, r in zip(fe.sessions, rfe.sessions):
        assert [x.phase_signature() for x in s.report.stages] == \
            [x.phase_signature() for x in r.report.stages]
    assert fe.stats.batches == rfe.stats.batches == 3
    assert not be._host_lambdas
    fe.close()
    rfe.close()


def test_front_doors_run_on_the_card_by_default():
    """With no backend named both front doors build a session on the
    card, and never quietly on the CPU: with no CUDA device, each
    raises."""
    _, router = _routers(2)
    _, table = _tables(2)
    if torch.cuda.is_available():  # pragma: no cover - needs the card
        for door in (router.serve(mode="sync"), table.serve(mode="sync")):
            assert door.sessions[0].backend.device.type == "cuda"
            door.close()
        return
    for call in (lambda: router.serve(mode="sync"),
                 lambda: table.serve(mode="sync"),
                 lambda: MoEFrontend(router, router.store, mode="sync"),
                 lambda: EmbeddingFrontend(table, table.store, mode="sync")):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


@pytest.mark.parametrize("gemm", ["pallas", "interpret", "ref"])
def test_naive_dispatch_refuses_jax_gemms(gemm):
    _, port = _routers(2)
    x, ti, g = port.zipf_routing(4, seed=0)
    with pytest.raises(ValueError, match="'torch'"):
        port.naive_dispatch(x, ti, g, gemm=gemm)


def test_entry_points_default_to_cuda():
    """Without a device argument the tier runs on the card, and never
    quietly on the CPU: with no CUDA device, each entry point raises."""
    _, port = _routers(2)
    _, table = _tables(2)
    x, ti, g = port.zipf_routing(4, seed=0)
    with pytest.warns(DeprecationWarning):
        cache = init_cache(torch.zeros((4, 2)), 1)
    with pytest.raises(NotImplementedError, match="axis_name"):
        embed_skew_aware(torch.zeros((4, 2)), torch.zeros(3, dtype=torch.int64),
                         cache, axis_name="x")
    if torch.cuda.is_available():  # pragma: no cover - needs the card
        return
    for call in (lambda: port.naive_dispatch(x, ti, g, gemm="torch"),
                 lambda: port.decode_step(x, ti, g),
                 lambda: table.lookup(np.arange(3))):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
