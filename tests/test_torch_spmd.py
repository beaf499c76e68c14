"""The port's SPMD MoE dispatch (`repro_torch.core.spmd`), its routing
primitives (`repro_torch.core.torchexec`) and `embed_skew_aware` on a mesh,
against the JAX package's `core/spmd.py` (`tests/test_spmd.py`'s cases):

- `TestDispatchEngines` / `TestRoutingPrimitives` with no mesh, on the same
  inputs as the JAX functions: outputs within atol 1e-5 (float32), drop
  counts, expert counts and the routing (order, destination, slot, keep)
  exactly;
- the 4-way push-pull equivalence of `tests/test_spmd.py`: `moe_push_pull`,
  `moe_direct_push` and `moe_direct_pull` on a 4-shard stacked mesh and on
  a group mesh (one spawn of 4 gloo ranks, in a subprocess), against the
  JAX functions under `shard_map` on 4 host devices (one subprocess) at
  atol 1e-4, with the same drop counts and expert counts;
- `embed_skew_aware` on a 4-shard mesh against the JAX `axis_name` form in
  the same subprocess: embeddings exactly, the summed histogram, the
  per-shard hit rates.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import spmd as jspmd
from repro_torch.core import spmd, torchexec
from repro_torch.core.shardexec import StackedMesh
from test_torch_spmd_mesh import MESH_CASES, P, run_port_mesh

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-5
ATOL_MESH = 1e-4


def _workload(seed, T=64, d=16, f=32, E=8, k=2, hot_expert=3, bias=3.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, d)).astype(np.float32)
    w_in = (rng.normal(size=(E, d, 2 * f)) * 0.1).astype(np.float32)
    w_out = (rng.normal(size=(E, f, d)) * 0.1).astype(np.float32)
    logits = rng.normal(size=(T, E))
    if hot_expert is not None:
        logits[:, hot_expert] += bias
    top = np.argsort(-logits, axis=1)[:, :k].astype(np.int32)
    gates = np.full((T, k), 1.0 / k, dtype=np.float32)
    return x, top, gates, w_in, w_out


def _jax(fn, args, cfg):
    return fn(*(jnp.asarray(a) for a in args), cfg)


def _port(fn, args, cfg):
    return fn(*(torch.from_numpy(a) for a in args), cfg)


def _pair(E, k, **kw):
    return (jspmd.MoEDispatchConfig(num_experts=E, top_k=k, ep_size=1, **kw),
            spmd.MoEDispatchConfig(num_experts=E, top_k=k, **kw))


# ---------------------------------------------------------------------------
# one device (no mesh), against the JAX functions
# ---------------------------------------------------------------------------
class TestDispatchEngines:
    @pytest.mark.parametrize("impl", ["ragged", "binned"])
    def test_push_pull_matches_jax_and_dense(self, impl):
        args = _workload(0)
        jcfg, pcfg = _pair(8, 2, capacity_factor=8.0, num_hot=2,
                           gemm_impl=impl)
        y_j, aux_j = _jax(jspmd.moe_push_pull, args, jcfg)
        y_p, aux_p = _port(spmd.moe_push_pull, args, pcfg)
        np.testing.assert_allclose(y_p.numpy(), np.asarray(y_j), atol=ATOL)
        ref = spmd.moe_reference(*(torch.from_numpy(a) for a in args))
        np.testing.assert_allclose(y_p.numpy(), ref.numpy(), atol=ATOL)
        assert int(aux_p.dropped_assignments) == 0
        np.testing.assert_array_equal(aux_p.expert_counts.numpy(),
                                      np.asarray(aux_j.expert_counts))
        np.testing.assert_array_equal(aux_p.hot_ids.numpy(),
                                      np.asarray(aux_j.hot_ids))

    def test_pull_baseline_matches_jax(self):
        args = _workload(1)
        jcfg, pcfg = _pair(8, 2)
        y_j, _ = _jax(jspmd.moe_direct_pull, args, jcfg)
        y_p, aux = _port(spmd.moe_direct_pull, args, pcfg)
        np.testing.assert_allclose(y_p.numpy(), np.asarray(y_j), atol=ATOL)
        assert int(aux.dropped_assignments) == 0

    def test_reference_matches_jax(self):
        args = _workload(4)
        want = jspmd.moe_reference(*(jnp.asarray(a) for a in args))
        got = spmd.moe_reference(*(torch.from_numpy(a) for a in args))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)

    def test_hot_expert_rescued_from_drops(self):
        """§3.3 in MoE form: tight capacity drops the hot expert's tokens
        under direct push; push-pull serves them by replication. The drop
        counts are the JAX package's exactly."""
        args = _workload(2, bias=5.0)
        jcfg, pcfg = _pair(8, 2, capacity_factor=0.4, num_hot=2)
        drops = {}
        for name in ("moe_push_pull", "moe_direct_push"):
            y_j, aux_j = _jax(getattr(jspmd, name), args, jcfg)
            y_p, aux_p = _port(getattr(spmd, name), args, pcfg)
            np.testing.assert_allclose(y_p.numpy(), np.asarray(y_j),
                                       atol=ATOL)
            assert int(aux_p.dropped_assignments) \
                == int(aux_j.dropped_assignments)
            drops[name] = int(aux_p.dropped_assignments)
        assert drops["moe_direct_push"] > 20
        assert drops["moe_push_pull"] < drops["moe_direct_push"] // 3

    def test_contention_histogram_exact(self):
        _, ti, _, _, _ = _workload(3)
        counts = torchexec.detect_contention(torch.from_numpy(ti), 8)
        want = np.asarray(jspmd.detect_contention(jnp.asarray(ti), 8))
        np.testing.assert_array_equal(counts.numpy(), want)

    def test_select_hot_threshold(self):
        counts = np.array([100, 1, 0, 50, 2, 0, 0, 0], np.int32)
        hot, lookup, valid = torchexec.select_hot(torch.from_numpy(counts),
                                                  2, min_count=10)
        j_hot, j_lookup, j_valid = jspmd.select_hot(jnp.asarray(counts), 2,
                                                    min_count=10)
        np.testing.assert_array_equal(hot.numpy(), np.asarray(j_hot))
        np.testing.assert_array_equal(lookup.numpy(), np.asarray(j_lookup))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(j_valid))

    @pytest.mark.parametrize("seed,k,E", [(7, 1, 4), (13, 2, 8)])
    def test_push_pull_vs_jax_across_shapes(self, seed, k, E):
        args = _workload(seed, E=E, k=k, hot_expert=seed % E, bias=4.0)
        jcfg, pcfg = _pair(E, k, capacity_factor=16.0, num_hot=min(2, E))
        y_j, _ = _jax(jspmd.moe_push_pull, args, jcfg)
        y_p, _ = _port(spmd.moe_push_pull, args, pcfg)
        np.testing.assert_allclose(y_p.numpy(), np.asarray(y_j), atol=1e-4,
                                   rtol=1e-4)


class TestRoutingPrimitives:
    @pytest.mark.parametrize("seed,nb,cap,n", [(0, 5, 12, 80),
                                               (1, 5, 12, 80),
                                               (2, 1, 40, 30),
                                               (3, 8, 3, 30)])
    def test_routing_matches_jax(self, seed, nb, cap, n):
        rng = np.random.default_rng(seed)
        dest = rng.integers(0, nb, n).astype(np.int32)
        active = rng.random(n) < 0.9
        rows = rng.normal(size=(n, 3)).astype(np.float32)
        jr = jspmd.bucket_routing(jnp.asarray(dest), nb, cap,
                                  jnp.asarray(active))
        pr = torchexec.bucket_routing(torch.from_numpy(dest), nb, cap,
                                      torch.from_numpy(active))
        for a, b in zip(pr, jr):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        buf = torchexec.scatter_to_buckets(torch.from_numpy(rows), pr, nb,
                                           cap)
        jbuf = jspmd.scatter_to_buckets(jnp.asarray(rows), jr, nb, cap)
        np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
        back = torchexec.gather_from_buckets(buf, pr, n)
        np.testing.assert_array_equal(
            back.numpy(), np.asarray(jspmd.gather_from_buckets(jbuf, jr, n)))
        kept = spmd._kept_mask(pr).numpy()
        np.testing.assert_array_equal(back.numpy()[kept], rows[kept])
        assert (back.numpy()[~kept] == 0).all()

    def test_capacity_respected(self):
        r = torchexec.bucket_routing(torch.zeros(100, dtype=torch.int32), 4,
                                     10, torch.ones(100, dtype=torch.bool))
        assert int(r.keep.sum()) == 10

    def test_batched_routing_is_per_shard(self):
        """A leading shard dimension routes each shard independently."""
        rng = np.random.default_rng(5)
        dest = torch.from_numpy(rng.integers(0, 3, (4, 30)))
        active = torch.from_numpy(rng.random((4, 30)) < 0.8)
        rows = torch.from_numpy(rng.normal(size=(4, 30, 2)))
        r = torchexec.bucket_routing(dest, 3, 7, active)
        buf = torchexec.scatter_to_buckets(rows, r, 3, 7, fill=-1.0)
        back = torchexec.gather_from_buckets(buf, r, 30)
        for s in range(4):
            r1 = torchexec.bucket_routing(dest[s], 3, 7, active[s])
            b1 = torchexec.scatter_to_buckets(rows[s], r1, 3, 7, fill=-1.0)
            assert torch.equal(buf[s], b1)
            assert torch.equal(back[s],
                               torchexec.gather_from_buckets(b1, r1, 30))

    def test_sort_by_group_and_inverse(self):
        ids = torch.tensor([3, 0, 2, 0, 3, 1, 4])  # 4 = the sentinel group
        order, sizes = torchexec.sort_by_group(ids, 4)
        j_order, j_sizes = jspmd._sort_by_group(jnp.asarray(ids.numpy()), 4)
        np.testing.assert_array_equal(order.numpy(), np.asarray(j_order))
        np.testing.assert_array_equal(sizes.numpy(), np.asarray(j_sizes))
        inv = torchexec.inverse_permutation(order)
        assert torch.equal(order[inv], torch.arange(7))


# ---------------------------------------------------------------------------
# 4 shards: stacked mesh, group mesh, JAX shard_map (the cases and the gloo
# workers live in test_torch_spmd_mesh.py, which imports no JAX)
# ---------------------------------------------------------------------------
_JAX_SCRIPT = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path[:0] = [{src!r}, {tests!r}]
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as PS
from repro.core import spmd
from repro.core.embedding import EmbedCache, embed_skew_aware
from repro.launch.compat import make_mesh
import test_torch_spmd_mesh as t
mesh = make_mesh((4,), ("model",))
inp = t.mesh_inputs()
E = inp["w_in"].shape[0]
a = [jnp.asarray(inp[k]) for k in ("x", "top", "gates", "w_in", "w_out")]
out = {{}}
dropped = []
for i, (name, cf, hot) in enumerate(t.MESH_CASES):
    cfg = spmd.MoEDispatchConfig(num_experts=E, top_k=2, capacity_factor=cf,
                                 num_hot=hot, axis_name="model", ep_size=4)
    def body(*args, _f=getattr(spmd, name), _cfg=cfg):
        y, aux = _f(*args, _cfg)
        return y, aux.dropped_assignments[None], aux.expert_counts[None]
    fn = jax.jit(jax.shard_map(body, mesh=mesh,
                               in_specs=(PS("model"),) * 5,
                               out_specs=(PS("model"),) * 3))
    y, dr, cn = fn(*a)
    out[f"y{{i}}"] = np.asarray(y)
    out[f"counts{{i}}"] = np.asarray(cn)
    dropped.append(np.asarray(dr))
cache = EmbedCache(hot_ids=jnp.asarray(inp["hot"]),
                   hot_rows=jnp.asarray(inp["table"][inp["hot"]]),
                   lookup=jnp.asarray(inp["lookup"]),
                   counts=jnp.asarray(inp["counts"]))
def ebody(table, ids, c):
    e, c2, h = embed_skew_aware(table, ids, c, axis_name="model")
    return e, c2.counts, h[None]
efn = jax.jit(jax.shard_map(ebody, mesh=mesh,
                            in_specs=(PS(), PS("model"), PS()),
                            out_specs=(PS("model"), PS(), PS("model")),
                            check_vma=False))
e, c2, h = efn(jnp.asarray(inp["table"]), jnp.asarray(inp["ids"].reshape(-1)),
               cache)
out["emb"] = np.asarray(e)
out["emb_counts"] = np.asarray(c2)
out["hit"] = np.asarray(h)
out["dropped"] = np.stack(dropped)
np.savez({out_path!r}, **out)
print("OK")
"""


_GROUP_SCRIPT = """
import socket, sys
sys.path[:0] = [{src!r}, {tests!r}]
import torch.multiprocessing as mp
import test_torch_spmd_mesh as t
s = socket.socket(); s.bind(("localhost", 0)); port = s.getsockname()[1]
s.close()
mp.spawn(t._group_worker, args=(4, port, {out_path!r}), nprocs=4)
print("OK")
"""


def _run_script(template: str, out_path: Path) -> dict:
    code = template.format(src=str(ROOT / "src"), tests=str(ROOT / "tests"),
                           out_path=str(out_path))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "OK" in res.stdout, \
        res.stdout[-2000:] + res.stderr[-4000:]
    return dict(np.load(out_path))


@pytest.fixture(scope="module")
def jax_mesh(tmp_path_factory):
    return _run_script(_JAX_SCRIPT,
                       tmp_path_factory.mktemp("jax") / "jax.npz")


@pytest.fixture(scope="module")
def group_mesh(tmp_path_factory):
    return _run_script(_GROUP_SCRIPT,
                       tmp_path_factory.mktemp("group") / "group.npz")


def _assert_mesh_matches(got, want):
    for i, (name, cf, _) in enumerate(MESH_CASES):
        np.testing.assert_allclose(got[f"y{i}"], want[f"y{i}"],
                                   atol=ATOL_MESH, err_msg=f"{name} cf {cf}")
        np.testing.assert_array_equal(got[f"counts{i}"], want[f"counts{i}"])
    np.testing.assert_array_equal(got["dropped"].reshape(len(MESH_CASES), -1),
                                  want["dropped"].reshape(len(MESH_CASES),
                                                          -1))
    np.testing.assert_array_equal(got["emb"], want["emb"])
    np.testing.assert_array_equal(got["emb_counts"], want["emb_counts"])
    np.testing.assert_allclose(got["hit"], want["hit"], rtol=1e-6)


def test_stacked_mesh_matches_jax_shard_map(jax_mesh):
    got = run_port_mesh(StackedMesh(P, "cpu"))
    _assert_mesh_matches(got, jax_mesh)
    # the tight cases dropped, and push-pull dropped fewer than direct push
    assert got["dropped"][2].max() > got["dropped"][1].max() > 0


def test_group_mesh_matches_jax_shard_map(group_mesh, jax_mesh):
    assert str(group_mesh.pop("kind")) == "group"
    _assert_mesh_matches(group_mesh, jax_mesh)


def test_config_takes_its_shards_from_the_mesh():
    cfg = spmd.MoEDispatchConfig(num_experts=8, top_k=2)
    assert cfg.ep_size == 1
    cfg = dataclasses.replace(cfg, mesh=StackedMesh(4, "cpu"))
    assert cfg.ep_size == 4
    assert spmd._capacity(cfg, 32) == 20
