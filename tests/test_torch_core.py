"""The port's host core against the JAX package's, on the same seeded
numpy inputs in one process.

Placement, hashing, validation messages, merge operators and the
communication forest are plain numpy copies and must agree exactly. The
torch pieces — the padded-view reduction of `FusedStageLambda` on tensors,
the replication electorate and the routing sort — must agree exactly too:
they select or reorder, and the decayed histogram is float32 arithmetic in
both packages. The last test checks, in a fresh interpreter, that the port
and `chip_smoke.py` import neither `jax` nor `repro`.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref
from repro.core import comm_forest as ref_forest
from repro.core import hashing as ref_hashing
from repro.core.jaxexec import select_hot as jax_select_hot
from repro.core.replication import decayed_election as jax_decayed_election
import repro_torch.core as port
from repro_torch.core import comm_forest as port_forest
from repro_torch.core import hashing as port_hashing
from repro_torch.core import torchexec
from repro_torch.core.replication import decayed_election

# one intra-op thread per test process: the suite runs in parallel workers
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("num_keys,P,salt", [(1000, 16, 0), (37, 3, 5),
                                             (1, 1, 0), (4096, 7, 123)])
def test_placement_and_hashing_identical(num_keys, P, salt):
    keys = np.arange(num_keys)
    np.testing.assert_array_equal(port_hashing.chunk_home(keys, P, salt),
                                  ref_hashing.chunk_home(keys, P, salt))
    x = np.random.default_rng(salt).integers(0, 2**62, 257, dtype=np.int64)
    np.testing.assert_array_equal(port_hashing.splitmix64(x),
                                  ref_hashing.splitmix64(x))
    np.testing.assert_array_equal(port_hashing.hash_combine(x, x[::-1]),
                                  ref_hashing.hash_combine(x, x[::-1]))
    np.testing.assert_array_equal(
        port_hashing.vm_to_pm(x % P, x % 11, P),
        ref_hashing.vm_to_pm(x % P, x % 11, P))
    a = port.DataStore.create(num_keys, P, value_width=3, salt=salt)
    b = ref.DataStore.create(num_keys, P, value_width=3, salt=salt)
    np.testing.assert_array_equal(a.home, b.home)
    np.testing.assert_array_equal(a.storage_per_machine(),
                                  b.storage_per_machine())


@pytest.mark.parametrize("P", [2, 5, 16, 64])
def test_comm_forest_identical(P):
    a, b = port_forest.CommForest.build(P), ref_forest.CommForest.build(P)
    assert (a.F, a.height) == (b.F, b.height)
    nodes = np.arange(a.first_at_depth(a.height + 1))
    roots = nodes % P
    np.testing.assert_array_equal(a.parent(nodes[1:]), b.parent(nodes[1:]))
    np.testing.assert_array_equal(a.physical(roots, nodes),
                                  b.physical(roots, nodes))
    np.testing.assert_array_equal(a.leaf_node(np.arange(P)),
                                  b.leaf_node(np.arange(P)))


def test_datastore_from_reference():
    src = ref.DataStore.create(50, 4, value_width=3, chunk_words=7)
    src.write_rows(np.arange(50), np.random.default_rng(0).normal(
        size=(50, 3)))
    st = port.DataStore.from_reference(src)
    assert (st.chunk_words, st.P, st.version) == (7, 4, src.version)
    np.testing.assert_array_equal(st.values, src.values)
    np.testing.assert_array_equal(st.home, src.home)
    st.values[0, 0] = 99.0  # a copy, not a view
    assert src.values[0, 0] != 99.0
    src.home = src.home.astype(np.int32)
    with pytest.raises(ValueError, match="home must be int64"):
        port.DataStore.from_reference(src)
    src.home = src.home.astype(np.int64)
    src.values = src.values[:, 0]
    with pytest.raises(ValueError, match="2-D float"):
        port.DataStore.from_reference(src)


def _break(tb, how):
    if how == "indptr_len":
        tb.read_indptr = tb.read_indptr[:-1]
    elif how == "indptr_end":
        tb.read_indptr = tb.read_indptr.copy()
        tb.read_indptr[-1] += 1
    elif how == "indptr_order":
        tb.read_indptr = tb.read_indptr.copy()
        tb.read_indptr[2] = tb.read_indptr[-1]
    elif how == "origin_len":
        tb.origin = tb.origin[:-1]
    elif how == "neg_index":
        tb.read_indices = tb.read_indices.copy()
        tb.read_indices[1] = -3
    elif how == "bad_write":
        tb.write_keys = tb.write_keys.copy()
        tb.write_keys[2] = -4
    elif how == "index_range":
        tb.read_indices = tb.read_indices.copy()
        tb.read_indices[3] = 10_000
    elif how == "write_range":
        tb.write_keys = tb.write_keys.copy()
        tb.write_keys[1] = 10_000
    elif how == "origin_range":
        tb.origin = tb.origin.copy()
        tb.origin[4] = 99
    return tb


@pytest.mark.parametrize("how", [
    "indptr_len", "indptr_end", "indptr_order", "origin_len", "neg_index",
    "bad_write", "index_range", "write_range", "origin_range"])
def test_validate_messages_identical(how):
    groups = [[1, 2], [3], [], [4, 5, 6], [7], [8, 9]]
    msgs = []
    for pkg in (port, ref):
        store = pkg.DataStore.create(20, 4, value_width=2)
        tb = pkg.TaskBatch.from_ragged(np.zeros((6, 2)), groups,
                                       pkg.TaskBatch.even_origins(6, 4))
        with pytest.raises(ValueError) as exc:
            _break(tb, how).validate(store)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("name", ["add", "min", "max", "or", "write"])
def test_merge_ops_identical(name):
    rng = np.random.default_rng(3)
    vals = rng.normal(size=(40, 3))
    seg = rng.integers(0, 9, 40)
    order = rng.integers(-5, 5, 40)
    a, b = port.get_merge_op(name), ref.get_merge_op(name)
    ca = a.combine_segments(vals, seg, 9, order)
    np.testing.assert_array_equal(ca, b.combine_segments(vals, seg, 9,
                                                         order))
    old = rng.normal(size=(9, 3))
    np.testing.assert_array_equal(a.apply(old, ca), b.apply(old, ca))
    assert a.identity == b.identity


@pytest.mark.parametrize("read_op", ["add", "min", "max", "first"])
def test_fused_lambda_padded_view_on_tensors(read_op):
    """`FusedStageLambda` on torch tensors equals the JAX package's on
    numpy arrays: the padded-view reduction, arity-0 rows and all."""
    rng = np.random.default_rng(5)
    vals = rng.normal(size=(9, 4, 3))
    mask = rng.random((9, 4)) < 0.6
    mask[2] = False  # an arity-0 row
    ctx = rng.normal(size=(9, 2))

    def fin(c, r):
        return r * c[:, :1]

    want = ref.FusedStageLambda(read_op, fin)(ctx, vals, mask)["update"]
    got = port.FusedStageLambda(read_op, fin)(
        torch.from_numpy(ctx), torch.from_numpy(vals),
        torch.from_numpy(mask))["update"]
    np.testing.assert_array_equal(got.numpy(), want)
    flat = port.FusedStageLambda(read_op)(ctx, vals[:, 0], mask[:, 0])
    np.testing.assert_array_equal(
        flat["update"],
        ref.FusedStageLambda(read_op)(ctx, vals[:, 0], mask[:, 0])["update"])


def test_select_hot_breaks_ties_like_top_k():
    counts = np.array([3, 7, 7, 1, 7, 0, 3, 3], dtype=np.int32)
    for num_hot in (1, 3, 5, 8):
        got = torchexec.select_hot(torch.from_numpy(counts), num_hot,
                                   min_count=2)
        want = jax_select_hot(jnp.asarray(counts), num_hot, min_count=2)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", [0, 1])
def test_decayed_election_identical(seed):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 6, 300).astype(np.float64) * 1.5  # many ties
    got = decayed_election(counts, 16, 0.5, min_count=2.0)
    want = jax_decayed_election(counts, 16, 0.5, min_count=2.0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_stable_argsort_matches_numpy():
    keys = np.random.default_rng(2).integers(0, 7, 1000)
    np.testing.assert_array_equal(
        torchexec.stable_argsort(torch.from_numpy(keys)).numpy(),
        np.argsort(keys, kind="stable"))


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import sys, pkgutil, importlib\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'repro.')) or m == 'repro')\n"
        "assert not bad, bad\n"
        "print(' '.join(m for m in sys.modules "
        "if m.startswith('repro_torch')))\n")
    env = dict(os.environ, PYTHONPATH=f"{REPO / 'src'}{os.pathsep}{REPO}")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    walked = set(out.stdout.split())
    assert len(walked) >= 75  # every module was imported
    assert {"repro_torch.core.baselines", "repro_torch.core.policy",
            "repro_torch.core.plan", "repro_torch.graph.algorithms",
            "repro_torch.graph.distedgemap", "repro_torch.graph.partition",
            "repro_torch.graph.session", "repro_torch.kvstore.hashtable",
            "repro_torch.kvstore.ycsb", "repro_torch.serve.batching",
            "repro_torch.serve.frontend", "repro_torch.serve.futures",
            "repro_torch.serve.stats", "repro_torch.core.shardexec",
            "repro_torch.core.spmd"} <= walked
