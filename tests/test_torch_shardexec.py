"""The port's mesh and sharded stage (`repro_torch.core.shardexec`) across
shards, on the CPU:

- the stacked mesh's collectives (an all-to-all is a transpose, a psum a
  sum over the shard dimension) and `detect_contention` over a mesh;
- against the JAX package: `tests/test_spmd_backend.py`'s backend at P = 4
  in one subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``
  (as `tests/test_spmd.py` runs its mesh), on four stages — arity-1 add,
  ragged min, a write with duplicate priorities, a replicated add. The
  port's `ShardStageStats` equal the JAX ones field by field; values and
  results within rtol 2e-4 / atol 1e-5;
- the group mesh: one spawn of 4 gloo ranks (in a subprocess) runs the same
  stages; its stats equal the stacked mesh's, its float64 values the
  stacked mesh's within 1e-12, and a group whose world size is not P
  raises;
- the sharded cases of `tests/test_conformance.py`: seeded and
  hypothesis-drawn ragged cases across every engine, merge and fused read
  against the numpy oracle (values, results, `assert_session_parity`),
  replication only moving cost, the `run_chain` plan and the
  parameter-server front doors, and the cross-shard write tie-break
  (lowest priority, then lowest global task row) exactly;
On the card: `tests/test_torch_cuda_spmd.py`.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _hyp import HAVE_HYPOTHESIS, given, settings, st
from repro_torch.core import (DataStore, Orchestrator, TaskBatch,
                              TorchSpmdBackend, assert_cost_parity,
                              assert_session_parity, fused_read)
from repro_torch.core import NumpyBackend, shardexec, torchexec
from repro_torch.core.fusedlam import FUSED_READ_OPS

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
P = 4
RTOL, ATOL = 2e-4, 1e-5
TOL64 = 1e-12
ENGINES = ["tdorch", "pull", "push", "sort", "auto"]
MERGES = ["add", "min", "max", "or", "write"]
STAT_FIELDS = shardexec.ShardStageStats._fields


# ---------------------------------------------------------------------------
# the stacked mesh's collectives
# ---------------------------------------------------------------------------
def test_stacked_mesh_collectives():
    m = shardexec.StackedMesh(3, "cpu")
    x = torch.arange(3 * 3 * 2).reshape(3, 3, 2)
    y = m.all_to_all(x)
    for s in range(3):
        for p in range(3):
            assert torch.equal(y[s, p], x[p, s])  # what p sent to s
    assert m.a2a_bytes == x.numel() * x.element_size()
    ps = m.psum(x.to(torch.int32))
    assert ps.dtype == torch.int32 and ps.shape == x.shape
    assert torch.equal(ps[1], x.sum(0).to(torch.int32))
    g = m.all_gather(x)
    assert g.shape == (3, 9, 2) and torch.equal(g[2], x.reshape(9, 2))
    assert torch.equal(shardexec.everywhere(m, x), x)
    assert torch.equal(m.axis_index(), torch.arange(3, dtype=torch.int32))
    assert shardexec.get_mesh(5, "cpu").kind == "stacked"


def test_detect_contention_sums_over_the_mesh():
    rng = np.random.default_rng(3)
    ids = rng.integers(-2, 12, (4, 50))  # out-of-range ids are dropped
    m = shardexec.StackedMesh(4, "cpu")
    got = torchexec.detect_contention(torch.from_numpy(ids), 10, m)
    inside = ids[(ids >= 0) & (ids < 10)]
    want = np.bincount(inside, minlength=10)
    assert got.shape == (4, 10)
    for s in range(4):
        np.testing.assert_array_equal(got[s].numpy(), want)
    one = torchexec.detect_contention(torch.from_numpy(ids), 10)
    np.testing.assert_array_equal(one.numpy(), want)


# ---------------------------------------------------------------------------
# the cross-package scenario: four stages at P = 4
# ---------------------------------------------------------------------------
def _muladd(contexts, vals):
    return {"update": vals * contexts[:, 1:2] + contexts[:, 2:3],
            "result": vals}


def _scale(contexts, reduced):
    return reduced * contexts[:, :1]


REPLICATED = {"num_hot": 8, "refresh": 1, "min_count": 1.0}


def cross_stages(pkg, K=64, n=96, seed=5):
    """The stages held across packages, built from one seed with either
    package's `TaskBatch`: [(tag, batch, lambda, merge, replication,
    stages)]."""
    rng = np.random.default_rng(seed)
    origin = pkg.TaskBatch.even_origins(n, P)
    TB = pkg.TaskBatch
    a = TB(contexts=rng.standard_normal((n, 3)),
           read_keys=rng.integers(0, K, n),
           write_keys=rng.integers(-1, K, n), origin=origin)
    groups = [rng.integers(0, K, rng.integers(0, 5)).tolist()
              for _ in range(n)]
    b = TB.from_ragged(rng.standard_normal((n, 1)), groups, origin,
                       write_keys=np.array([g[0] if g else -1
                                            for g in groups]))
    # writes to 8 keys from tasks on every machine, priorities 0-2: ties
    # of priority across shards go to the lowest global task row
    c = TB(contexts=rng.standard_normal((n, 3)),
           read_keys=rng.integers(0, K, n),
           write_keys=rng.integers(0, 8, n), origin=origin,
           priority=rng.integers(0, 3, n))
    d = TB(contexts=rng.standard_normal((n, 3)),
           read_keys=(rng.zipf(1.5, n) - 1) % K,
           write_keys=(rng.zipf(1.5, n) - 1) % K, origin=origin)
    return [("add", a, _muladd, "add", None, 1),
            ("ragged_min", b, pkg.fused_read("min", _scale), "min", None, 1),
            ("write_ties", c, _muladd, "write", None, 1),
            ("replicated", d, _muladd, "add", REPLICATED, 2)]


def run_cross(pkg, backend, K=64, w=3, seed=5):
    """Run `cross_stages` through `backend`; returns (stats (stages, 9, P)
    int64, store values after each stage, results of each stage)."""
    rng = np.random.default_rng(seed + 1)
    store = pkg.DataStore.create(K, P, value_width=w, chunk_words=w)
    store.write_rows(np.arange(K), rng.standard_normal((K, w)))
    values, results, stats = [], [], []
    for _, tasks, f, merge, rep, k in cross_stages(pkg, K, seed=seed):
        sess = pkg.Orchestrator(store, engine="tdorch", backend=backend,
                                replication=rep)
        for _ in range(k):
            before = len(backend.stage_stats)
            res = sess.run_stage(tasks, f, write_back=merge,
                                 return_results=True)
            assert len(backend.stage_stats) == before + 1, "not sharded"
            stats.append(np.stack([np.asarray(x, dtype=np.int64)
                                   for x in backend.stage_stats[-1]]))
            values.append(np.asarray(store.values, dtype=np.float64).copy())
            results.append(np.asarray(res.results, dtype=np.float64)
                           .reshape(tasks.n, -1))
    return np.stack(stats), values, results


_JAX_SCRIPT = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path[:0] = [{src!r}, {tests!r}]
import numpy as np
import repro.core as ref
import test_torch_shardexec as t
stats, values, results = t.run_cross(ref, ref.make_backend("jax_spmd"))
np.savez({out!r}, stats=stats, values=np.stack(values),
         **{{f"r{{i}}": r for i, r in enumerate(results)}})
print("OK")
"""


def _run_script(code: str, timeout: int = 300) -> None:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0 and "OK" in out.stdout, \
        out.stdout[-2000:] + out.stderr[-4000:]


@pytest.fixture(scope="module")
def jax_cross(tmp_path_factory):
    """The JAX package's `jax_spmd` on a 4-device mesh, one subprocess."""
    out = tmp_path_factory.mktemp("jax_cross") / "jax.npz"
    _run_script(_JAX_SCRIPT.format(src=str(ROOT / "src"),
                                   tests=str(ROOT / "tests"), out=str(out)))
    return np.load(out)


def test_stats_and_values_match_the_jax_mesh(jax_cross):
    be = TorchSpmdBackend(device="cpu")
    import repro_torch.core as port

    stats, values, results = run_cross(port, be)
    want = jax_cross["stats"]
    assert stats.shape == want.shape == (5, len(STAT_FIELDS), P)
    for i in range(stats.shape[0]):
        for j, name in enumerate(STAT_FIELDS):
            np.testing.assert_array_equal(
                stats[i, j], want[i, j], err_msg=f"stage {i}: {name}")
    for i, v in enumerate(values):
        np.testing.assert_allclose(v, jax_cross["values"][i], rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(results[i], jax_cross[f"r{i}"],
                                   rtol=RTOL, atol=ATOL)
    # the stages really crossed shards and read replicas
    assert want[:, STAT_FIELDS.index("fetch_recv")].sum() > 0
    assert want[-1, STAT_FIELDS.index("replica_local")].sum() > 0


def test_write_ties_break_by_global_row_exactly():
    """The duplicate-priority write stage, from the same starting values,
    in float64 is the oracle's exactly: each written key keeps the row of
    lowest priority, ties to the lowest global task row, whichever shard
    it executed on."""
    import repro_torch.core as port

    _, tasks, f, merge, _, _ = cross_stages(port)[2]
    rng = np.random.default_rng(9)
    init = rng.standard_normal((64, 3))
    out = []
    for be in (_NumpyStats(), TorchSpmdBackend(device="cpu",
                                                 dtype="float64")):
        store = DataStore.create(64, P, value_width=3, chunk_words=3)
        store.write_rows(np.arange(64), init)
        res = Orchestrator(store, backend=be).run_stage(
            tasks, f, write_back=merge, return_results=True)
        out.append((store.values.copy(), np.asarray(res.results), res))
    np.testing.assert_array_equal(out[1][0], out[0][0])
    np.testing.assert_array_equal(out[1][1], out[0][1])
    assert_cost_parity(out[0][2].report, out[1][2].report)
    # the stage does cross shards with tied priorities
    wk, pr = tasks.write_keys, tasks.priority
    site = out[1][2].exec_site
    ties = [k for k in range(8)
            if len(set(site[(wk == k) & (pr == pr[wk == k].min())])) > 1]
    assert ties


class _NumpyStats(NumpyBackend):
    """The numpy oracle with a `stage_stats` that grows by one a stage, so
    `run_cross` runs it as it runs the sharded backends."""

    def __init__(self):
        self.stage_stats = []

    def execute(self, *a, **k):
        self.stage_stats.append(np.zeros((9, P), dtype=np.int64))
        return super().execute(*a, **k)


# ---------------------------------------------------------------------------
# the group mesh: one machine a gloo rank
# ---------------------------------------------------------------------------
def _group_worker(rank, world, port, out):
    import torch.distributed as dist

    import repro_torch.core as core

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        be = core.TorchSpmdBackend(device="cpu", dtype="float64")
        stats, values, results = run_cross(core, be)
        mesh = be.mesh(P)
        try:  # a group whose world size is not the store's P
            core.Orchestrator(core.DataStore.create(16, 2 * world),
                              backend=be)
            refused = ""
        except RuntimeError as exc:
            refused = str(exc)
        if rank == 0:
            np.savez(out, stats=stats, values=np.stack(values),
                     **{f"r{i}": r for i, r in enumerate(results)})
            Path(str(out) + ".json").write_text(json.dumps(
                {"kind": mesh.kind, "refused": refused}))
    finally:
        dist.destroy_process_group()


_GROUP_SCRIPT = """
import socket, sys
sys.path[:0] = [{src!r}, {tests!r}]
import torch.multiprocessing as mp
import test_torch_shardexec as t
s = socket.socket(); s.bind(("localhost", 0)); port = s.getsockname()[1]
s.close()
mp.spawn(t._group_worker, args=(4, port, {out!r}), nprocs=4)
print("OK")
"""


@pytest.fixture(scope="module")
def group_cross(tmp_path_factory):
    out = tmp_path_factory.mktemp("group") / "group.npz"
    _run_script(_GROUP_SCRIPT.format(src=str(ROOT / "src"),
                                     tests=str(ROOT / "tests"),
                                     out=str(out)))
    return np.load(out), json.loads(Path(str(out) + ".json").read_text())


def test_group_mesh_matches_the_stacked_mesh(group_cross):
    got, info = group_cross
    assert info["kind"] == "group"
    import repro_torch.core as port

    stats, values, results = run_cross(
        port, TorchSpmdBackend(device="cpu", dtype="float64"))
    np.testing.assert_array_equal(got["stats"], stats)
    for i, v in enumerate(values):
        np.testing.assert_allclose(got["values"][i], v, rtol=TOL64,
                                   atol=TOL64)
        np.testing.assert_allclose(got[f"r{i}"], results[i], rtol=TOL64,
                                   atol=TOL64)


def test_group_of_the_wrong_size_raises(group_cross):
    _, info = group_cross
    assert "P=8" in info["refused"] and "4 ranks" in info["refused"]
    assert "world_size=8" in info["refused"]


# ---------------------------------------------------------------------------
# sharded conformance cases (tests/test_conformance.py's, on torch_spmd)
# ---------------------------------------------------------------------------
SPMD64 = TorchSpmdBackend(device="cpu", dtype="float64")
SPMD32 = TorchSpmdBackend(device="cpu")
_LAMBDAS = {}


def _mk_lambda(w):
    def f(contexts, vals, mask):
        flat = vals.reshape(vals.shape[0], -1) if vals.ndim == 3 else vals
        upd = flat[:, :w] * contexts[:, :1] + contexts[:, 1:2]
        return {"update": upd, "result": flat}
    return f


def _finish_muladd(c, r):
    return r * c[:, :1] + c[:, 1:2]


def _lambda_for(case):
    ro = case.get("read_op")
    if ro:
        return fused_read(ro, _finish_muladd)
    return _LAMBDAS.setdefault(case["w"], _mk_lambda(case["w"]))


def _build_batch(case, P):
    key_lists = case["key_lists"]
    n = len(key_lists)
    rng = np.random.default_rng(case["seed"])
    ctx = rng.standard_normal((n, 2))
    origin = np.asarray(case["origins"], dtype=np.int64) % max(P, 1)
    wk = np.asarray(case["write_keys"], dtype=np.int64)
    kw = {}
    if case.get("priorities") is not None:
        kw["priority"] = np.asarray(case["priorities"], dtype=np.int64)
    return TaskBatch.from_ragged(ctx, key_lists, origin, write_keys=wk, **kw)


def _run_session(case, engine, backend):
    P = case["P"]
    rng = np.random.default_rng(case["seed"] + 1)
    store = DataStore.create(case["K"], P, value_width=case["w"],
                             chunk_words=case["w"])
    store.write_rows(np.arange(case["K"]),
                     rng.standard_normal((case["K"], case["w"])))
    rep = ({"num_hot": 4, "refresh": 1, "min_count": 1.0}
           if case["replicated"] else None)
    sess = Orchestrator(store, engine=engine, backend=backend,
                        replication=rep)
    f = _lambda_for(case)
    results = [sess.run_stage(_build_batch(case, P), f,
                              write_back=case["merge"], return_results=True)
               for _ in range(case["stages"])]
    return store, results, sess


def run_case(case, engine, backend=SPMD64, tol=(TOL64, TOL64)):
    """One case on `backend` against the numpy oracle; raises on any
    divergence (`repr(case)` + this function = a repro)."""
    s_np, r_np, sess_np = _run_session(case, engine, "numpy")
    s_bk, r_bk, sess_bk = _run_session(case, engine, backend)
    assert np.allclose(s_np.values, s_bk.values, rtol=tol[0], atol=tol[1]), \
        f"store values diverged: {case!r}"
    assert_session_parity(sess_np.report, sess_bk.report)
    for a, b in zip(r_np, r_bk):
        assert np.array_equal(a.exec_site, b.exec_site), "exec_site diverged"
        assert a.refcount == b.refcount, "Phase-1 refcounts diverged"
        if a.results is not None:
            n = np.asarray(a.results).shape[0]
            assert np.allclose(
                np.asarray(a.results, dtype=np.float64).reshape(n, -1),
                np.asarray(b.results, dtype=np.float64).reshape(n, -1),
                rtol=tol[0], atol=tol[1]), f"results diverged: {case!r}"


def _random_case(rng) -> dict:
    hi = rng.random() < 0.3  # a task of 32+ reads among thin ones
    n = int(rng.integers(1, 6 if hi else 16))
    K = int(rng.choice([12, 24]))
    key_lists = [rng.integers(0, K, rng.integers(0, 4)).tolist()
                 for _ in range(n)]
    if hi:
        key_lists[0] = rng.integers(0, K, int(rng.integers(32, 37))).tolist()
    if n > 1 and rng.random() < 0.4:
        key_lists[-1] = []
    return {
        "P": int(rng.integers(1, 5)),
        "K": K,
        "w": int(rng.choice([1, 3])),
        "key_lists": key_lists,
        "write_keys": rng.integers(-1, K, n).tolist(),
        "origins": rng.integers(0, 8, n).tolist(),
        "priorities": (rng.integers(0, 6, n).tolist()
                       if rng.random() < 0.5 else None),
        "merge": str(rng.choice(MERGES)),
        "replicated": bool(rng.random() < 0.5),
        "read_op": (str(rng.choice(FUSED_READ_OPS))
                    if rng.random() < 0.5 else None),
        "stages": 2,
        "seed": int(rng.integers(0, 2**31)),
    }


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_seeded_differential_matrix(engine, dtype):
    rng = np.random.default_rng(2026)
    backend, tol = ((SPMD64, (TOL64, TOL64)) if dtype == "float64"
                    else (SPMD32, (RTOL, ATOL)))
    for _ in range(6):
        run_case(_random_case(rng), engine, backend, tol)


if HAVE_HYPOTHESIS:
    @st.composite
    def _cases(draw):
        K = draw(st.sampled_from([12, 24]))
        hi = draw(st.booleans())
        n = draw(st.integers(min_value=1, max_value=5 if hi else 14))
        key_lists = draw(st.lists(
            st.lists(st.integers(0, K - 1), min_size=0, max_size=3),
            min_size=n, max_size=n))
        if hi:
            key_lists[0] = draw(st.lists(st.integers(0, K - 1),
                                         min_size=32, max_size=36))
        if n > 1 and draw(st.booleans()):
            key_lists[-1] = []
        return {
            "P": draw(st.integers(1, 4)), "K": K,
            "w": draw(st.sampled_from([1, 3])), "key_lists": key_lists,
            "write_keys": draw(st.lists(st.integers(-1, K - 1),
                                        min_size=n, max_size=n)),
            "origins": draw(st.lists(st.integers(0, 7), min_size=n,
                                     max_size=n)),
            # duplicate priorities: the cross-shard write tie-break
            "priorities": draw(st.one_of(
                st.none(), st.lists(st.integers(0, 5), min_size=n,
                                    max_size=n))),
            "merge": draw(st.sampled_from(MERGES)),
            "replicated": draw(st.booleans()),
            "read_op": draw(st.one_of(st.none(),
                                      st.sampled_from(FUSED_READ_OPS))),
            "stages": 2,
            "seed": draw(st.integers(0, 2**31 - 1)),
        }

    CASES = _cases()
else:  # the shim's `given` skips the test; the strategy is never drawn
    CASES = None


@settings(max_examples=6, deadline=None, derandomize=True)
@given(case=CASES)
def test_conformance_vs_oracle_torch_spmd(case):
    for engine in ENGINES:
        run_case(case, engine)


@settings(max_examples=6, deadline=None, derandomize=True)
@given(case=CASES)
def test_replication_is_cost_only(case):
    """Replication changes where the cost model says bytes come from, never
    values or results."""
    s_on, r_on, _ = _run_session(dict(case, replicated=True), "tdorch",
                                 SPMD64)
    s_off, r_off, _ = _run_session(dict(case, replicated=False), "tdorch",
                                   SPMD64)
    assert np.allclose(s_on.values, s_off.values, rtol=TOL64, atol=TOL64)
    for a, b in zip(r_on, r_off):
        if a.results is not None:
            assert np.allclose(np.asarray(a.results, dtype=np.float64),
                               np.asarray(b.results, dtype=np.float64),
                               rtol=TOL64, atol=TOL64)


@pytest.mark.parametrize("engine", ["tdorch", "auto"])
def test_plan_emission_conformance(engine):
    """`run_chain` (a StagePlan with an emitting continuation) is
    hop-for-hop the oracle's on the mesh: values, keys, bills."""
    from repro_torch.kvstore import DistributedHashTable

    rng = np.random.default_rng(31)
    keys, op, K = rng.integers(0, 40, (12, 3)), rng.standard_normal(
        (12, 2)), 40
    out = {}
    for name, bk in [("numpy", "numpy"), ("spmd", SPMD64)]:
        ht = DistributedHashTable(K, 4, value_width=3, seed=3)
        ht.bulk_load(np.arange(K),
                     np.random.default_rng(7).standard_normal((K, 3)))
        out[name] = ht.run_chain(keys, op, engine=engine, backend=bk)
    a, b = out["numpy"], out["spmd"]
    assert a.hops == b.hops
    assert np.array_equal(a.keys, b.keys)
    assert np.allclose(np.nan_to_num(a.values), np.nan_to_num(b.values),
                       rtol=TOL64, atol=TOL64)
    for ra, rb in zip(a.reports, b.reports):
        assert_cost_parity(ra, rb)


def test_paramserve_front_door_conformance():
    """The MoERouter decode stage (a generic gathered-SwiGLU lambda) and the
    EmbeddingStore ops (fused reads, merge-able gradient writes) on the
    mesh against the numpy oracle."""
    from repro_torch.paramserve import EmbeddingStore, MoERouter

    rng = np.random.default_rng(17)
    routers = [MoERouter(6, 5, 7, P, top_k=3, seed=2) for _ in range(2)]
    for r in routers:
        r.init_weights(3)
    x, ti, g = routers[0].zipf_routing(20, alpha=1.4, seed=4)
    ti[3, 1] = -1
    ti[9] = -1
    a = routers[0].decode_step(x, ti, g, backend="numpy")
    b = routers[1].decode_step(x, ti, g, backend=SPMD64)
    assert np.allclose(a.y, b.y, rtol=TOL64, atol=TOL64)
    assert np.array_equal(a.exec_site, b.exec_site)
    assert a.refcount == b.refcount
    assert_cost_parity(a.report, b.report)

    stores = [EmbeddingStore(30, 3, P, seed=5) for _ in range(2)]
    for es in stores:
        es.init_table(6)
    ids = rng.integers(0, 30, 11)
    bags = [rng.integers(0, 30, rng.integers(0, 4)).tolist()
            for _ in range(8)]
    up_ids = np.array([4, 9, 4])
    grads = rng.normal(size=(3, 3))
    outs = []
    for es, bk in zip(stores, ["numpy", SPMD64]):
        look = es.lookup(ids, backend=bk)
        bag = es.lookup_bags(bags, backend=bk)
        upd = es.update(up_ids, grads, backend=bk)
        outs.append((look, bag, upd, es.table))
    for va, vb in zip(outs[0][:2], outs[1][:2]):
        assert np.allclose(va.values, vb.values, rtol=TOL64, atol=TOL64)
    assert np.allclose(outs[0][3], outs[1][3], rtol=TOL64, atol=TOL64)
    for i in range(3):
        assert outs[0][i].refcount == outs[1][i].refcount
        assert_cost_parity(outs[0][i].report, outs[1][i].report)
