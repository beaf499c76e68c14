"""The mesh-sharded path on the card (marked `cuda`; imports no JAX, skips
without a CUDA device):

- the stacked mesh's stages against `backend="torch"` and the numpy
  oracle: bills equal, values within the float32 gate, the histogram and
  the segment combine launched by the sharded path;
- the owner side's write combine (rows of every shard ranked by priority,
  then global task row) on the card against its plain version, bit for
  bit;
- the MoE dispatch on a stacked mesh on the card against its plain run on
  the CPU, the grouped GEMM launched.

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_spmd.py
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import (DataStore, Orchestrator, TaskBatch,
                              assert_cost_parity, shardexec, spmd)

pytestmark = pytest.mark.cuda

P = 4
RTOL, ATOL = 2e-4, 1e-5
REP = {"num_hot": 8, "refresh": 2, "min_count": 1.0}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _muladd(contexts, vals):
    return {"update": vals * contexts[:, 1:2] + contexts[:, 2:3],
            "result": vals}


def _masked_sum(contexts, vals, mask):
    flat = vals.reshape(vals.shape[0], -1) if vals.ndim == 3 else vals
    return {"update": flat[:, :3] + contexts[:, :1], "result": flat}


def _batches(K=60, n=72, seed=31):
    rng = np.random.default_rng(seed)
    flat = [TaskBatch(contexts=rng.standard_normal((n, 3)),
                      read_keys=rng.integers(0, K, n),
                      write_keys=rng.integers(-1, K, n),
                      origin=TaskBatch.even_origins(n, P),
                      priority=rng.integers(0, 3, n)) for _ in range(3)]
    groups = [rng.integers(0, K, rng.integers(0, 4)).tolist()
              for _ in range(n)]
    ragged = TaskBatch.from_ragged(
        rng.standard_normal((n, 2)), groups, TaskBatch.even_origins(n, P),
        write_keys=np.array([g[0] if g else -1 for g in groups]))
    return flat, ragged


def _run(backend, batches, f, merge, rep=None):
    store = DataStore.create(60, P, value_width=3, chunk_words=3)
    store.write_rows(np.arange(60),
                     np.random.default_rng(0).standard_normal((60, 3)))
    sess = Orchestrator(store, backend=backend, replication=rep)
    return store, [sess.run_stage(t, f, write_back=merge,
                                  return_results=True) for t in batches]


def _close(a, b):
    assert np.allclose(a.values, b.values, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("merge", ["add", "min", "write"])
def test_stacked_mesh_matches_torch_on_the_card(card, merge):
    flat, ragged = _batches()
    s_t, r_t = _run("torch", flat, _muladd, merge, REP)
    kernels.reset_launches()
    s_s, r_s = _run("torch_spmd", flat, _muladd, merge, REP)
    ran = kernels.launches()
    assert ran["histogram"] >= 3 and ran["segment_combine"] == 6
    s_n, r_n = _run("numpy", flat, _muladd, merge, REP)
    _close(s_s, s_t)
    _close(s_s, s_n)
    for a, b in zip(r_n, r_s):
        assert_cost_parity(a.report, b.report)
        assert np.array_equal(a.exec_site, b.exec_site)
        assert np.allclose(np.asarray(a.results), np.asarray(b.results),
                           rtol=RTOL, atol=ATOL)
    s_n, r_n = _run("numpy", [ragged], _masked_sum, "add")
    s_s, r_s = _run("torch_spmd", [ragged], _masked_sum, "add")
    _close(s_s, s_n)
    assert_cost_parity(r_n[0].report, r_s[0].report)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_owner_write_combine_kernel_matches_plain(card, dtype):
    from repro_torch.kernels.segment_combine.ops import combine

    rng = np.random.default_rng(41)
    S, Pm, T, K_max, w = 4, 4, 256, 64, 16
    n = S * Pm * T
    rows = torch.tensor(rng.standard_normal((n, w)), dtype=dtype)
    slot = rng.integers(-1, K_max, (S, Pm * T))
    seg = shardexec._flat_segments(
        torch.from_numpy(np.where(slot >= 0, slot, K_max)), K_max)
    order = torch.tensor(rng.integers(0, 3, n), dtype=torch.int32)
    grow = torch.tensor(rng.permutation(n), dtype=torch.int32)
    rank = shardexec._rank_order(order, grow)
    want = combine(rows, seg, S * K_max, op="write", order=rank)
    kernels.reset_launches()
    got = combine(rows.to(card), seg.to(card), S * K_max, op="write",
                  order=shardexec._rank_order(order.to(card),
                                              grow.to(card)))
    assert kernels.launches()["segment_combine"] == 1
    assert torch.equal(got.cpu(), want)


def test_moe_dispatch_on_the_card(card):
    rng = np.random.default_rng(3)
    S, T, d, f, E, k = 4, 32, 64, 32, 8, 2
    x = rng.normal(size=(S, T, d)).astype(np.float32)
    w_in = (rng.normal(size=(S, E // S, d, 2 * f)) * 0.1).astype(np.float32)
    w_out = (rng.normal(size=(S, E // S, f, d)) * 0.1).astype(np.float32)
    ti = np.stack([np.stack([rng.choice(E, k, replace=False)
                             for _ in range(T)]) for _ in range(S)])
    g = np.full((S, T, k), 0.5, dtype=np.float32)
    args = [x, ti, g, w_in, w_out]
    outs = []
    for dev in ("cpu", card):
        cfg = spmd.MoEDispatchConfig(num_experts=E, top_k=k,
                                     capacity_factor=4.0, num_hot=2,
                                     mesh=shardexec.StackedMesh(S, dev))
        kernels.reset_launches()
        y, aux = spmd.moe_push_pull(*(torch.from_numpy(a).to(dev)
                                      for a in args), cfg)
        outs.append((y.cpu(), int(aux.dropped_assignments[0]),
                     kernels.launches()["moe_gemm"]))
    assert outs[1][2] == 4 and outs[0][2] == 0
    assert outs[0][1] == outs[1][1] == 0
    torch.testing.assert_close(outs[1][0], outs[0][0], atol=1e-5, rtol=1e-5)
