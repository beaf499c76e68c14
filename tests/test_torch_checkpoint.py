"""The port's checkpoints (`repro_torch.checkpoint`) on trees of torch
tensors and numpy arrays, case by case with `tests/test_checkpoint.py`
(atomic commit, integrity hash, bf16 round trip, retention, async
snapshots), plus what only the port has to get right:

- interchange: a checkpoint the JAX package writes restores through the
  port and the reverse, every leaf bit-exact (bf16 included);
- `save_async` of a CPU tensor the caller updates in place right after the
  call keeps the old values (`Tensor.cpu()` aliases a CPU tensor);
- restore gives each leaf the type of the matching `like` leaf: a tensor
  with its dtype on its device, numpy for numpy; `device=` overrides.

The durable restore onto a smaller fleet is in `tests/test_torch_elastic.py`.
"""
import json
import os
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.checkpoint import manager as ref_ckpt
from repro_torch import checkpoint
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_checkpoint, save_checkpoint)


def _tree(seed=0):
    r = np.random.default_rng(seed)
    return {"values": r.standard_normal((32, 4)),
            "home": r.integers(0, 8, size=32).astype(np.int64)}


def _mixed(seed=0):
    """Every kind of leaf the port saves: tensors of several dtypes (bf16
    too) nested in dicts, lists and tuples, numpy arrays, a scalar."""
    r = np.random.default_rng(seed)
    return {
        "w": torch.tensor(r.standard_normal((16, 8)), dtype=torch.bfloat16),
        "layers": [torch.tensor(r.standard_normal((3, 5)),
                                dtype=torch.float32),
                   (torch.tensor(r.integers(-9, 9, 7)), r.random(4))],
        "step": np.int64(seed + 3),
        "mask": torch.tensor(r.random(6) > 0.5),
        "none": None,
    }


def _bits(x):
    """A leaf's raw bytes and shape, whatever its kind."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        x = x.numpy()
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        a = a.view(np.uint16)
    return a.shape, a.tobytes()


# ---------------------------------------------------------------------------
# atomic commit / torn writes
# ---------------------------------------------------------------------------
class TestAtomicCommit:
    def test_save_restore_round_trip(self, tmp_path):
        tree = _tree()
        path = save_checkpoint(str(tmp_path), 3, tree, extra={"stage": 3})
        out, manifest = restore_checkpoint(path, like=_tree(seed=1))
        assert manifest["step"] == 3
        assert manifest["extra"] == {"stage": 3}
        np.testing.assert_array_equal(out["values"], tree["values"])
        np.testing.assert_array_equal(out["home"], tree["home"])
        assert pathlib.Path(path).name == "step_00000003"

    def test_torn_write_is_never_a_checkpoint(self, tmp_path):
        tmp = tmp_path / "step_00000005.tmp"
        tmp.mkdir()
        (tmp / "arrays.npz").write_bytes(b"partial garbage")
        assert latest_step(str(tmp_path)) is None
        mgr = CheckpointManager(str(tmp_path))
        assert mgr.restore_latest(like=_tree()) is None

    def test_corrupted_payload_fails_integrity_check(self, tmp_path):
        path = save_checkpoint(str(tmp_path), 1, _tree())
        npz = pathlib.Path(path) / "arrays.npz"
        data = bytearray(npz.read_bytes())
        data[len(data) // 2] ^= 0xFF
        npz.write_bytes(bytes(data))
        with pytest.raises(IOError, match="integrity"):
            restore_checkpoint(path, like=_tree())

    def test_recommit_replaces_previous_step(self, tmp_path):
        save_checkpoint(str(tmp_path), 2, _tree(seed=0))
        t2 = _tree(seed=9)
        path = save_checkpoint(str(tmp_path), 2, t2)
        out, _ = restore_checkpoint(path, like=_tree())
        np.testing.assert_array_equal(out["values"], t2["values"])

    def test_shape_mismatch_raises(self, tmp_path):
        path = save_checkpoint(str(tmp_path), 0, {"v": np.zeros((4, 2))})
        with pytest.raises(ValueError, match="shape mismatch"):
            restore_checkpoint(path, like={"v": np.zeros((5, 2))})
        with pytest.raises(ValueError, match="shape mismatch"):
            restore_checkpoint(path, like={"v": torch.zeros(4, 3)})

    def test_manifest_and_keys_as_the_reference_writes_them(self, tmp_path):
        tree = {"b": [np.zeros(2), np.ones(3)], "a": {"z": np.arange(4),
                                                      "y": np.zeros(1)}}
        p = save_checkpoint(str(tmp_path / "port"), 7, tree, extra={"k": 1})
        r = ref_ckpt.save_checkpoint(str(tmp_path / "ref"), 7, tree,
                                     extra={"k": 1})
        mp = json.load(open(os.path.join(p, "manifest.json")))
        mr = json.load(open(os.path.join(r, "manifest.json")))
        assert mp["keys"] == mr["keys"] == ["a/y", "a/z", "b/0", "b/1"]
        assert {k: v for k, v in mp.items() if k != "sha256"} == \
            {k: v for k, v in mr.items() if k != "sha256"}


# ---------------------------------------------------------------------------
# bf16 round-trip
# ---------------------------------------------------------------------------
def test_bf16_round_trip_is_bit_exact(tmp_path):
    r = np.random.default_rng(3)
    vals = torch.tensor(r.standard_normal((16, 8)), dtype=torch.bfloat16)
    tree = {"w": vals, "b": np.arange(5, dtype=np.float64)}
    path = save_checkpoint(str(tmp_path), 0, tree)
    out, manifest = restore_checkpoint(
        path, like={"w": torch.zeros((16, 8), dtype=torch.bfloat16),
                    "b": np.zeros(5)})
    assert "w::bf16" in manifest["keys"]
    assert out["w"].dtype == torch.bfloat16
    assert torch.equal(out["w"].view(torch.int16), vals.view(torch.int16))
    np.testing.assert_array_equal(out["b"], tree["b"])
    # numpy has no bf16: a numpy `like` gets the values widened exactly
    out, _ = restore_checkpoint(path, like={"w": np.zeros((16, 8)),
                                            "b": np.zeros(5)})
    assert out["w"].dtype == np.float32
    np.testing.assert_array_equal(out["w"], vals.float().numpy())


# ---------------------------------------------------------------------------
# interchange with the JAX package's checkpoints
# ---------------------------------------------------------------------------
def test_jax_writes_port_restores_bit_exact(tmp_path):
    r = np.random.default_rng(4)
    w = jnp.asarray(r.standard_normal((16, 8)), dtype=jnp.bfloat16)
    tree = {"w": w, "layers": [np.float32(r.standard_normal((3, 5))),
                               (np.arange(7), r.random(4))],
            "values": r.standard_normal((32, 4))}
    path = ref_ckpt.save_checkpoint(str(tmp_path), 2, tree)
    like = {"w": torch.zeros(16, 8, dtype=torch.bfloat16),
            "layers": [torch.zeros(3, 5), (np.zeros(7, dtype=np.int64),
                                           np.zeros(4))],
            "values": torch.zeros(32, 4, dtype=torch.float64)}
    out, manifest = checkpoint.restore_checkpoint(path, like)
    assert manifest["step"] == 2
    assert _bits(out["w"]) == _bits(w)
    assert out["layers"][0].dtype == torch.float32
    assert _bits(out["layers"][0]) == _bits(np.float32(tree["layers"][0]))
    assert isinstance(out["layers"][1], tuple)
    assert _bits(out["layers"][1][0]) == _bits(tree["layers"][1][0])
    assert _bits(out["layers"][1][1]) == _bits(tree["layers"][1][1])
    assert _bits(out["values"]) == _bits(tree["values"])


def test_port_writes_jax_restores_bit_exact(tmp_path):
    tree = _mixed(seed=5)
    path = save_checkpoint(str(tmp_path), 4, tree)
    like = {"w": np.zeros((16, 8), dtype=jnp.bfloat16),
            "layers": [np.zeros((3, 5), np.float32),
                       (np.zeros(7, np.int64), np.zeros(4))],
            "step": np.int64(0), "mask": np.zeros(6, bool), "none": None}
    out, manifest = ref_ckpt.restore_checkpoint(path, like)
    assert manifest["step"] == 4
    assert out["w"].dtype == jnp.bfloat16
    assert _bits(out["w"]) == _bits(tree["w"])
    assert _bits(out["layers"][0]) == _bits(tree["layers"][0])
    assert _bits(out["layers"][1][0]) == _bits(tree["layers"][1][0])
    assert _bits(out["layers"][1][1]) == _bits(tree["layers"][1][1])
    assert _bits(out["step"]) == _bits(tree["step"])
    assert _bits(out["mask"]) == _bits(tree["mask"])
    # and the port reads its own checkpoint back into torch leaves
    back, _ = restore_checkpoint(path, _mixed(seed=6))
    for a, b in ((back["w"], tree["w"]),
                 (back["layers"][0], tree["layers"][0]),
                 (back["layers"][1][0], tree["layers"][1][0]),
                 (back["mask"], tree["mask"])):
        assert a.dtype == b.dtype and _bits(a) == _bits(b)
    assert back["none"] is None


# ---------------------------------------------------------------------------
# restore onto `like`'s types
# ---------------------------------------------------------------------------
def test_restore_takes_likes_dtype_and_device(tmp_path):
    tree = {"a": np.random.default_rng(1).standard_normal((4, 3)),
            "b": torch.arange(6, dtype=torch.int32)}
    path = save_checkpoint(str(tmp_path), 0, tree)
    like = {"a": torch.zeros(4, 3, dtype=torch.float32),
            "b": np.zeros(6, dtype=np.int32)}
    out, _ = restore_checkpoint(path, like)
    assert isinstance(out["a"], torch.Tensor)
    assert out["a"].dtype == torch.float32 and out["a"].device.type == "cpu"
    torch.testing.assert_close(out["a"], torch.tensor(tree["a"],
                                                      dtype=torch.float32),
                               rtol=0, atol=0)
    assert isinstance(out["b"], np.ndarray) and out["b"].dtype == np.int32
    np.testing.assert_array_equal(out["b"], np.arange(6))
    out, _ = restore_checkpoint(path, like, device="cpu")
    assert out["a"].device == torch.device("cpu")
    # a restored tensor owns its memory: writing it leaves the file alone
    out["a"].fill_(7.0)
    again, _ = restore_checkpoint(path, like)
    assert not torch.equal(again["a"], out["a"])


# ---------------------------------------------------------------------------
# manager: async saves, retention, latest
# ---------------------------------------------------------------------------
class TestManager:
    def test_save_async_then_restore_latest(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=3)
        trees = {s: _tree(seed=s) for s in (0, 1, 2)}
        for s in (0, 1, 2):
            mgr.save_async(s, trees[s])
        restored = mgr.restore_latest(like=_tree())
        assert restored is not None
        step, tree, manifest = restored
        assert step == 2 and manifest["step"] == 2
        np.testing.assert_array_equal(tree["values"], trees[2]["values"])
        assert mgr.latest() == 2

    def test_retention_gc(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=2)
        for s in range(5):
            mgr.save_async(s, _tree(seed=s))
        mgr.wait()
        kept = sorted(n for n in os.listdir(tmp_path)
                      if n.startswith("step_"))
        assert kept == ["step_00000003", "step_00000004"]

    def test_snapshot_taken_before_async_write(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        tree = _tree()
        want = tree["values"].copy()
        mgr.save_async(0, tree)
        tree["values"][:] = -1.0
        mgr.wait()
        out, _ = restore_checkpoint(mgr.path_for(0), like=_tree())
        np.testing.assert_array_equal(out["values"], want)

    def test_snapshot_of_cpu_tensors_before_in_place_update(self, tmp_path):
        """`Tensor.cpu()` of a CPU tensor is the same storage: the snapshot
        must clone, or the in-place update right after the call lands in
        the checkpoint."""
        mgr = CheckpointManager(str(tmp_path))
        tree = _mixed(seed=8)
        want = {k: _bits(tree[k]) for k in ("w", "mask")}
        want_l0 = _bits(tree["layers"][0])
        mgr.save_async(1, tree)
        tree["w"].add_(1.0)
        tree["mask"].logical_not_()
        tree["layers"][0].mul_(-3.0)
        mgr.wait()
        out, _ = restore_checkpoint(mgr.path_for(1), _mixed(seed=9))
        assert {k: _bits(out[k]) for k in ("w", "mask")} == want
        assert _bits(out["layers"][0]) == want_l0

    def test_write_error_surfaces_at_wait(self, tmp_path):
        blocker = tmp_path / "not_a_dir"
        blocker.write_text("x")
        mgr = CheckpointManager(str(blocker))
        mgr.save_async(0, _tree())
        with pytest.raises(OSError):
            mgr.wait()
        mgr.wait()  # the error is raised once
