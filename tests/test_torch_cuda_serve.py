"""The serve tier's CUDA path on the card: `TorchBackend.prefetch` stages
contexts on the backend's side stream and `execute` picks them up behind
the copy's event; `sync` waits for the copy stream and for the work queued
behind the store's values; a thread-mode frontend with no backend named
runs on the card. Every test is marked `cuda` and skips without a CUDA
device. This file imports no JAX, so it runs on a machine with the card
alone:

    python -m pytest -m cuda tests/test_torch_cuda_serve.py

Values are float32 on the card against float64 numpy: rtol 1e-5 /
atol 1e-6 (values in [0, 2)).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import DataStore, TaskBatch, TorchBackend
from repro_torch.kvstore import DistributedHashTable

pytestmark = pytest.mark.cuda
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the side-stream copy and its "
                    "event exist only on the card")
    return torch.device("cuda", torch.cuda.current_device())


def _stage():
    store = DataStore.create(40, 4, value_width=3)
    rng = np.random.default_rng(11)
    store.write_rows(np.arange(40), rng.random((40, 3)))
    tasks = TaskBatch(contexts=rng.random((16, 3)),
                      read_keys=rng.integers(0, 40, 16),
                      origin=TaskBatch.even_origins(16, 4))
    return store, tasks


def _muladd(contexts, vals):
    return {"result": vals * contexts[:, 1:2] + contexts[:, 2:3]}


def _want(store, tasks):
    return store.values[tasks.read_keys] * tasks.contexts[:, 1:2] \
        + tasks.contexts[:, 2:3]


def test_prefetch_side_stream_copy(card):
    store, tasks = _stage()
    be = TorchBackend(device=card)
    be.prefetch(tasks, store)
    dtype, t, ev, pinned = tasks.__dict__["_device_ctx"]
    assert dtype == "float32" and t.device == card and pinned.is_pinned()
    assert be._copy_stream is not None
    cur = torch.cuda.current_stream(card)
    assert be._copy_stream != cur
    cur.wait_event(ev)  # the copy lands before the mark below
    t[:, 2] += 5.0  # mark the staged copy: execute reads it
    out = be.execute(tasks, store, _muladd)["result"]
    np.testing.assert_allclose(out, _want(store, tasks) + 5.0, rtol=RTOL,
                               atol=ATOL)
    assert ev.query()
    assert "_device_ctx" not in tasks.__dict__
    out = be.execute(tasks, store, _muladd)["result"]  # uploads again
    np.testing.assert_allclose(out, _want(store, tasks), rtol=RTOL,
                               atol=ATOL)


def test_prefetch_in_float64_uploads_again_for_float32(card):
    store, tasks = _stage()
    TorchBackend(device=card, dtype="float64").prefetch(tasks, store)
    out = TorchBackend(device=card).execute(tasks, store, _muladd)["result"]
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, _want(store, tasks), rtol=RTOL,
                               atol=ATOL)
    assert "_device_ctx" not in tasks.__dict__


def test_sync_waits_for_the_copy_stream_and_the_store(card):
    store, tasks = _stage()
    be = TorchBackend(device=card)
    be.sync(store)  # no stream, nothing cached: returns at once
    for _ in range(3):
        be.prefetch(tasks, store)
    be.sync()
    assert be._copy_stream.query()
    dv = be.device_values(store)
    torch.cuda._sleep(50_000_000)  # queue work behind the store's values
    dv.add_(1.0)
    be.sync(store)
    assert torch.cuda.current_stream(card).query()


def test_thread_frontend_runs_on_the_card(card):
    ht = DistributedHashTable(num_keys=512, num_machines=4, value_width=2)
    vals = np.random.default_rng(3).random((512, 2))
    ht.bulk_load(np.arange(512), vals)
    with ht.serve(mode="thread", config={"max_batch": 32}) as fe:
        be = fe.sessions[0].backend
        assert be.device == card
        futs = [(int(k), fe.get(int(k)))
                for k in np.random.default_rng(4).integers(0, 512, 300)]
        fe.drain(timeout=60.0)
        for k, f in futs:
            np.testing.assert_allclose(f.result(timeout=5.0), vals[k],
                                       rtol=RTOL, atol=ATOL)
    assert not be._host_lambdas
    assert be._copy_stream is not None
