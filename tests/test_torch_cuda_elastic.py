"""Checkpoints and elastic sessions on the card: `save_async` of a card
tensor the caller updates in place right after the call, restore onto the
card, and a restart recovery whose stages run on the card. Every test is
marked `cuda` and skips without a CUDA device. This file imports no JAX,
so it runs on a machine with the card alone:

    python -m pytest -m cuda tests/test_torch_cuda_elastic.py

Values are float32 on the card against the float64 numpy backend: rtol
1e-5 / atol 1e-5 (a few stages of v*0.5 + c over uniform keys).
"""
import numpy as np
import pytest
import torch

from repro_torch.checkpoint import (CheckpointManager, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.core import (ELASTIC_PHASES, DataStore, Orchestrator,
                              TaskBatch, assert_session_parity)

pytestmark = pytest.mark.cuda
RTOL = ATOL = 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: card tensors, their device→host "
                    "copies and the kernels exist only on the card")
    return torch.device("cuda", torch.cuda.current_device())


def test_save_async_of_a_card_tensor_updated_right_after(card, tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    for step in range(3):
        t = torch.randn(4096, 1024, device=card)
        b = torch.randn(512, device=card).to(torch.bfloat16)
        # work queued ahead of the snapshot, so its copy is ordered behind
        # it, and updates queued right after it returns
        t.mul_(2.0).add_(1.0)
        want_t, want_b = t.cpu().clone(), b.cpu().clone()
        mgr.save_async(step, {"t": t, "b": b})
        t.fill_(-7.0)
        b.zero_()
        mgr.wait()
        out, _ = restore_checkpoint(mgr.path_for(step),
                                    {"t": want_t, "b": want_b})
        assert torch.equal(out["t"], want_t)
        assert torch.equal(out["b"].view(torch.int16),
                           want_b.view(torch.int16))


def test_restore_onto_the_card(card, tmp_path):
    rng = np.random.default_rng(2)
    tree = {"a": rng.standard_normal((64, 3)),
            "w": torch.tensor(rng.standard_normal((8, 8)),
                              dtype=torch.bfloat16)}
    path = save_checkpoint(str(tmp_path), 0, tree)
    like = {"a": torch.zeros(64, 3, device=card),
            "w": torch.zeros(8, 8, dtype=torch.bfloat16, device=card)}
    out, _ = restore_checkpoint(path, like)
    assert out["a"].device == card and out["a"].dtype == torch.float32
    assert torch.equal(out["a"].cpu(),
                       torch.tensor(tree["a"], dtype=torch.float32))
    assert out["w"].device == card and out["w"].dtype == torch.bfloat16
    assert torch.equal(out["w"].cpu().view(torch.int16),
                       tree["w"].view(torch.int16))
    # device= moves CPU-shaped targets onto the card
    cpu_like = {"a": torch.zeros(64, 3, dtype=torch.float64),
                "w": torch.zeros(8, 8, dtype=torch.bfloat16)}
    out, _ = restore_checkpoint(path, cpu_like, device=card)
    assert out["a"].device == card and out["a"].dtype == torch.float64
    assert torch.equal(out["a"].cpu(), torch.tensor(tree["a"]))


K, P, N = 4096, 8, 8192


def _store():
    st = DataStore.create(K, P, value_width=4, chunk_words=4, salt=3)
    st.write_rows(np.arange(K),
                  np.random.default_rng(42).standard_normal((K, 4)))
    return st


def _batch(i):
    r = np.random.default_rng(1000 + i)
    keys = r.integers(0, K, size=N)
    return TaskBatch(contexts=r.standard_normal((N, 1)), read_keys=keys,
                     write_keys=keys.copy(), origin=r.integers(0, P, size=N))


def _muladd(ctx, vals):
    return {"update": vals * 0.5 + ctx[:, :1]}


def test_restart_recovery_on_the_card(card, tmp_path):
    spec = {"recovery": {"injector": {3: [2, 5]}, "checkpoint_every": 2,
                         "directory": str(tmp_path / "card")}}
    oracle_spec = {"recovery": dict(spec["recovery"],
                                    directory=str(tmp_path / "numpy"))}
    card_sess = Orchestrator(_store(), backend="torch", elasticity=spec)
    plain = Orchestrator(_store(), backend="torch")
    oracle = Orchestrator(_store(), backend="numpy", elasticity=oracle_spec)
    assert card_sess.backend.device.type == "cuda"
    for i in range(6):
        a = card_sess.run_stage(_batch(i), _muladd)
        plain.run_stage(_batch(i), _muladd)
        b = oracle.run_stage(_batch(i), _muladd)
        assert a.report.phase_signature() == b.report.phase_signature()
        np.testing.assert_array_equal(a.exec_site, b.exec_site)
    np.testing.assert_allclose(card_sess.store.values, oracle.store.values,
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(card_sess.store.values, plain.store.values,
                               rtol=RTOL, atol=ATOL)
    assert_session_parity(plain.report, card_sess.report,
                          ignore=ELASTIC_PHASES)
    c = card_sess.elastic.counters()
    assert c["recoveries"] == 2 and c["chunks_restored"] > 0
    assert c == oracle.elastic.counters()
    assert not card_sess.backend._host_lambdas
