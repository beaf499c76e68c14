"""The port's TDO-GP (`repro_torch.graph`) against the JAX package's
(`repro.graph`), on the same seeded graphs in one process: the port
through ``TorchBackend(device="cpu")``, the reference through its numpy
oracle.

- `ingest` equals the reference's array for array (edge placement,
  vertex homes, CSR and tree groups) and bill for bill.
- BFS, SSSP, CC, PageRank and BC on `tests/test_graph.py`'s BA / ER / grid
  graphs and a star, at its sizes: the reference's rounds, per-round
  `phase_signature()` and modes, and its values — BFS levels, CC labels
  and SSSP distances exactly (host float64 arithmetic, the oracle's min /
  max combines), PageRank and BC within 1e-12 (float64 sums in another
  order). PageRank over a graph big enough for `combine_by_key`'s device
  route (BA 5,000) within the reference's own float32 tolerance of its
  JAX route (rtol 1e-3, atol 1e-7), and within 1e-12 in float64.
- `GraphSession(engine="auto")`'s sparse/dense mode decisions equal the
  reference's.
- `combine_by_key` takes the oracle route on a key set's first sighting,
  builds the routing on the second and runs on the device from then on;
  `torchexec.combine_dense` and `sorted_segment_sum` agree with the JAX
  package's `jaxexec` functions.
"""
import numpy as np
import pytest
import torch

import repro.graph as rg
import repro_torch.graph as tg
from repro.core import assert_session_parity, jaxexec
from repro.core.mergeops import get_merge_op as ref_merge
from repro_torch.core import TorchBackend, torchexec

# one intra-op thread per test process: the suite runs in parallel workers
torch.set_num_threads(1)

ARRAYS = ("vertex_home", "edge_machine", "out_indptr", "out_edges",
          "in_indptr", "in_edges", "src_grp_indptr", "src_grp_machines",
          "dst_grp_indptr", "dst_grp_machines")
GRAPHS = ["ba", "er", "grid", "star"]
TOL = 1e-12


def _cpu(dtype="float64"):
    return TorchBackend(device="cpu", dtype=dtype)


def _graph(pkg, name):
    """tests/test_graph.py's graphs at its sizes, weighted as its SSSP."""
    if name == "ba":
        g = pkg.barabasi_albert(250, attach=3, seed=7)
    elif name == "er":
        g = pkg.erdos_renyi(250, avg_degree=5, seed=8)
    elif name == "grid":
        g = pkg.grid_2d(15, 17)
    else:
        g = pkg.star_graph(300)
    return g.with_weights(seed=3)


def _ingested(name, P=4, seed=1, **kw):
    og_r = rg.ingest(_graph(rg, name), P=P, seed=seed, **kw)
    og_p = tg.ingest(_graph(tg, name), P=P, seed=seed, backend=_cpu(), **kw)
    return og_p, og_r


@pytest.mark.parametrize("n,attach,seed", [(10, 3, 0), (400, 4, 1),
                                           (3000, 8, 24)])
def test_generators_match_reference(n, attach, seed):
    """The port's linear-time Barabási-Albert draws what the reference's
    concatenating loop draws; the other generators are copies."""
    for a, b in ((tg.barabasi_albert(n, attach, seed),
                  rg.barabasi_albert(n, attach, seed)),
                 (tg.erdos_renyi(n, 6, seed), rg.erdos_renyi(n, 6, seed)),
                 (tg.star_graph(n), rg.star_graph(n)),
                 (tg.grid_2d(7, n % 9 + 2), rg.grid_2d(7, n % 9 + 2))):
        a, b = a.with_weights(seed=seed), b.with_weights(seed=seed)
        assert a.n == b.n
        for arr in ("src", "dst", "weights"):
            np.testing.assert_array_equal(getattr(a, arr), getattr(b, arr))


@pytest.mark.parametrize("kw", [{}, {"strategy": "direct"},
                                {"balanced_vertices": False},
                                {"C": 3, "fanout": 2}],
                         ids=["tdorch", "direct", "random_homes", "C3_F2"])
@pytest.mark.parametrize("name", GRAPHS)
def test_ingest_matches_reference(name, kw):
    og_p, og_r = _ingested(name, P=8, seed=0, **kw)
    assert (og_p.n, og_p.m, og_p.P, og_p.C) == (og_r.n, og_r.m, og_r.P,
                                                og_r.C)
    for arr in ARRAYS:
        np.testing.assert_array_equal(getattr(og_p, arr), getattr(og_r, arr))
    if og_r.ingest_report is None:
        assert og_p.ingest_report is None
    else:
        assert og_p.ingest_report.phase_signature() == \
            og_r.ingest_report.phase_signature()


def _run(pkg, alg, og, **kw):
    if alg == "bfs":
        return pkg.bfs(og, 0, **kw)
    if alg == "sssp":
        return pkg.sssp(og, 0, **kw)
    if alg == "cc":
        return pkg.cc(og, **kw)
    if alg == "pagerank":
        return pkg.pagerank(og, max_iter=20, tol=0.0, **kw)
    return pkg.bc(og, 0, **kw)


def _same_rounds(info_p, info_r):
    assert info_p.rounds == info_r.rounds
    assert [s.mode for s in info_p.stats] == [s.mode for s in info_r.stats]
    assert [s.active_edges for s in info_p.stats] == \
        [s.active_edges for s in info_r.stats]
    assert [s.report.phase_signature() for s in info_p.stats] == \
        [s.report.phase_signature() for s in info_r.stats]
    assert_session_parity(info_p.report, info_r.report)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("alg", ["bfs", "sssp", "cc", "pagerank", "bc"])
@pytest.mark.parametrize("name", GRAPHS)
def test_algorithms_match_reference(name, alg, dtype):
    og_p, og_r = _ingested(name)
    be = _cpu(dtype)
    got, info_p = _run(tg, alg, og_p, backend=be)
    want, info_r = _run(rg, alg, og_r)
    _same_rounds(info_p, info_r)
    # below 4,096 edges every combine takes the oracle route
    assert be.host_syncs == 0
    if alg in ("bfs", "sssp", "cc"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dtype,rtol,atol", [("float32", 1e-3, 1e-7),
                                             ("float64", TOL, TOL)])
def test_pagerank_device_route_matches_reference(dtype, rtol, atol):
    """BA 5,000 (~40,000 edges, tests/test_backend_parity.py's graph): every
    round after the first re-reduces the same edge set, so rounds 2..R run
    `sorted_segment_sum` (one counted host sync each)."""
    og_r = rg.ingest(rg.barabasi_albert(5000, 4, seed=3), P=4)
    og_p = tg.ingest(tg.barabasi_albert(5000, 4, seed=3), P=4,
                     backend=_cpu())
    be = _cpu(dtype)
    got, info_p = tg.pagerank(og_p, max_iter=6, tol=0.0, backend=be)
    want, info_r = rg.pagerank(og_r, max_iter=6, tol=0.0)
    _same_rounds(info_p, info_r)
    assert be.host_syncs == 5
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("alg", ["bfs", "pagerank"])
def test_mode_policy_decisions_match_reference(alg):
    traces = []
    for pkg, kw in ((tg, {"backend": _cpu()}), (rg, {})):
        if alg == "bfs":
            og = pkg.ingest(pkg.star_graph(4096), P=32, **kw)
        else:
            og = pkg.ingest(pkg.barabasi_albert(600, 4, seed=3), P=8, **kw)
        sess = pkg.GraphSession(og, engine="auto", **kw)
        _run(pkg, alg, og, session=sess, force_mode=None)
        traces.append(([(d.stage_index, d.choice, d.kind, d.incumbent,
                         d.switched, tuple(sorted(d.predicted.items())),
                         d.predicted_words, d.realized_words, d.policy_words)
                        for d in sess.report.policy_decisions],
                       [st.phase_signature() for st in sess.report.stages]))
    assert traces[0][0] and traces[0] == traces[1]
    if alg == "bfs":
        assert [d[1] for d in traces[0][0][:2]] == ["sparse", "dense"]


def test_direct_edge_map_and_session_options():
    og_p, og_r = _ingested("ba")
    vals = np.arange(og_p.n, dtype=np.float64)
    U = (tg.DistVertexSubset(og_p.n, indices=np.arange(0, og_p.n, 7)),
         rg.DistVertexSubset(og_r.n, indices=np.arange(0, og_r.n, 7)))
    out = []
    for og, u, kw in ((og_p, U[0], {"backend": _cpu()}), (og_r, U[1], {})):
        pkg = tg if og is og_p else rg
        nxt, st = pkg.dist_edge_map(og, u, lambda s, d, w: vals[s],
                                    lambda vs, agg: agg < vals[vs], "min",
                                    force_mode="sparse", **kw)
        out.append((nxt.indices, st.report.phase_signature()))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    assert out[0][1] == out[1][1]
    assert tg.GraphSession(og_p, backend=_cpu(), kernel_backend="auto")
    with pytest.raises(ValueError, match="one route"):
        tg.GraphSession(og_p, backend=_cpu(), kernel_backend="interpret")
    with pytest.raises(ValueError, match="elasticity"):
        tg.GraphSession(og_p, backend=_cpu(),
                        config={"elasticity": {"migration": True}})


def test_graph_front_doors_default_to_the_card():
    if torch.cuda.is_available():  # pragma: no cover - needs the card
        pytest.skip("the card is present: the CUDA tests cover it")
    g = tg.barabasi_albert(100, 3, seed=0)
    og = tg.ingest(g, P=4, backend=_cpu())
    U = tg.DistVertexSubset.single(og.n, 0)
    for call in (lambda: tg.ingest(g, P=4),
                 lambda: tg.GraphSession(og),
                 lambda: tg.bfs(og, 0),
                 lambda: tg.pagerank(og, max_iter=2),
                 lambda: tg.dist_edge_map(og, U, lambda s, d, w: s * 1.0,
                                          lambda vs, agg: agg > 0)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_combine_by_key_routes():
    """First sighting of an add key set: the oracle. Second: the routing
    (stable permutation, segment ends) is built and the sum runs on the
    device. Third: the same routing is reused. Min merges, small batches
    and a new key set take the oracle (a new set is the next candidate)."""
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 900, 5000)
    be, merge = _cpu(), ref_merge("add")

    def oracle(v, k, m=merge):
        uniq, seg = np.unique(k, return_inverse=True)
        return uniq, m.combine_segments(v, seg, uniq.size, np.arange(k.size))

    routes = []
    for sighting in range(3):
        v = rng.standard_normal((keys.size, 1))
        uniq, got = be.combine_by_key(v, keys, 900, merge,
                                      np.arange(keys.size))
        u_want, want = oracle(v, keys)
        np.testing.assert_array_equal(uniq, u_want)
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        routes.append((be.host_syncs, len(be._route), be._route))
    assert [r[:2] for r in routes] == [(0, 1), (1, 4), (2, 4)]
    assert routes[2][2] is routes[1][2]
    # min merges, batches under 4,096 keys: the oracle, no device call
    v = rng.standard_normal((keys.size, 1))
    be.combine_by_key(v, keys, 900, ref_merge("min"), np.arange(keys.size))
    be.combine_by_key(v[:100], keys[:100], 900, merge, np.arange(100))
    assert be.host_syncs == 2
    # a new key set restarts as a candidate
    other = rng.integers(0, 900, 5000)
    be.combine_by_key(v, other, 900, merge, np.arange(other.size))
    assert be.host_syncs == 2 and len(be._route) == 1


@pytest.mark.parametrize("merge", ["add", "min", "max", "or", "write"])
def test_combine_dense_matches_jax(merge):
    rng = np.random.default_rng(3)
    vals = rng.standard_normal((300, 3)).astype(np.float32)
    if merge == "or":
        vals = (vals > 0).astype(np.float32)
    seg = rng.integers(0, 41, 300).astype(np.int32)  # 40: writes nothing
    got = torchexec.combine_dense(torch.from_numpy(vals),
                                  torch.from_numpy(seg), num_segments=40,
                                  merge_name=merge)
    want = jaxexec.combine_dense(vals, seg, num_segments=40,
                                 merge_name=merge)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_sorted_segment_sum_matches_jax(dtype):
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 500, 6000)
    vals = rng.random((keys.size, 2))
    perm = np.argsort(keys, kind="stable")
    sk = keys[perm]
    ends = np.flatnonzero(np.r_[sk[1:] != sk[:-1], True])
    got = torchexec.sorted_segment_sum(
        torch.from_numpy(vals.astype(dtype)), torch.from_numpy(perm),
        torch.from_numpy(ends)).numpy()
    exact = np.zeros((500, 2))
    np.add.at(exact, keys, vals)
    exact = exact[sk[ends]]
    # differences of a prefix sum: each segment's error is reckoned at the
    # prefix's magnitude M at its end, (k + 4)·u·M + u·Σ|terms| for k terms
    # (chip_smoke.py's bound; vals >= 0, so M is the exact prefix)
    prefix = np.cumsum(vals[perm], 0)[ends]
    k = np.diff(np.r_[-1, ends])[:, None]
    u = 2.0 ** (-24 if dtype == "float32" else -53)
    bound = u * ((k + 4) * prefix + exact)
    assert (np.abs(got - exact) <= bound).all()
    if dtype == "float32":
        want = np.asarray(jaxexec.sorted_segment_sum(
            vals.astype(np.float32), perm.astype(np.int32),
            ends.astype(np.int32)))
        assert (np.abs(want - exact) <= bound).all()
