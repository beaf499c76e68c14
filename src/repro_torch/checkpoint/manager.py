"""Fault-tolerant checkpointing of trees of torch tensors and numpy arrays:
atomic commits, async writes, integrity hashes, and elastic restore
(placement re-derived from the restore target, never stored).

Layout: <dir>/step_<k:08d>/ {manifest.json, arrays.npz}; a checkpoint exists
iff its directory was atomically renamed from a tmp name AND the manifest
hash verifies — a torn write can never be mistaken for a valid checkpoint.

The format is the JAX package's (`repro.checkpoint`), so a checkpoint either
package writes restores in the other: leaves are keyed by their tree path
(dict keys sorted, sequence indices as numbers, joined by "/"), and a bf16
leaf is stored as its raw 16 bits under ``<key>::bf16`` (numpy has no bf16).
A tree is any nesting of dict / list / tuple whose leaves are tensors
(any device), numpy arrays or Python scalars; None is an empty subtree.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["CheckpointManager", "latest_step", "restore_checkpoint",
           "save_checkpoint"]

_BF16 = "::bf16"


def _leaves(tree, prefix: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """(path, leaf) pairs in the JAX package's flattening order: dict keys
    sorted, sequences by index, None an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_leaves(tree[k], prefix + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out.extend(_leaves(v, prefix + (i,)))
        return out
    return [(prefix, tree)]


def _key(path: Tuple) -> str:
    return "/".join(str(p) for p in path)


def _is_bf16(arr: np.ndarray) -> bool:
    # a numpy bf16 (ml_dtypes, as the JAX package hands it over)
    return arr.dtype.itemsize == 2 and arr.dtype.name == "bfloat16"


def _host_copy(leaf) -> Tuple[np.ndarray, bool]:
    """A host numpy copy of one leaf that shares no memory with it, and
    whether it holds bf16 bits (as uint16). A card tensor's device→host
    copy has finished when this returns, so the caller may update the
    tensor in place right after."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
            # copy=True: `.cpu()` of a CPU tensor returns the same storage
            return t.to("cpu", copy=True).numpy().view(np.uint16), True
        return t.to("cpu", copy=True).numpy(), False
    arr = np.array(leaf, copy=True)
    if _is_bf16(arr):
        return arr.view(np.uint16), True
    return arr, False


def _snapshot(tree) -> Dict[str, np.ndarray]:
    """The npz payload of `tree`: key → host array, bf16 under `::bf16`."""
    flat = {}
    for path, leaf in _leaves(tree):
        arr, bf16 = _host_copy(leaf)
        flat[_key(path) + (_BF16 if bf16 else "")] = arr
    return flat


def _commit(directory: str, step: int, flat: Dict[str, np.ndarray],
            extra: Optional[Dict]) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    npz_path = os.path.join(tmp, "arrays.npz")
    np.savez(npz_path, **flat)
    with open(npz_path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    manifest = {
        "step": step,
        "sha256": digest,
        "keys": sorted(flat.keys()),
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    return final


def save_checkpoint(directory: str, step: int, tree,
                    extra: Optional[Dict] = None) -> str:
    """Synchronous atomic save. Returns the committed path."""
    return _commit(directory, step, _snapshot(tree), extra)


def _restore_leaf(key: str, data, like, device):
    """The stored array of `key`, typed as `like`: a tensor where `like` is
    one (its dtype, on `device` or its device), else numpy."""
    bf16 = key + _BF16 in data
    arr = data[key + _BF16] if bf16 else data[key]
    shape = tuple(like.shape) if isinstance(like, torch.Tensor) \
        else np.shape(like)
    if tuple(arr.shape) != tuple(shape):
        raise ValueError(f"shape mismatch for {key}: "
                         f"{arr.shape} vs {shape}")
    if isinstance(like, torch.Tensor):
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16) \
            if bf16 else torch.from_numpy(arr)
        return t.to(device=like.device if device is None else device,
                    dtype=like.dtype)
    if not bf16:
        return arr
    like_dtype = np.asarray(like).dtype
    if _is_bf16(np.empty(0, like_dtype)):
        return arr.view(like_dtype)
    # numpy has no bf16 of its own: widen exactly through float32
    return torch.from_numpy(arr.view(np.int16)).view(
        torch.bfloat16).float().numpy()


def _rebuild(like, it):
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(like[k], it) for k in sorted(like)}
    if isinstance(like, list):
        return [_rebuild(v, it) for v in like]
    if isinstance(like, tuple):
        return tuple(_rebuild(v, it) for v in like)
    return next(it)


def restore_checkpoint(path: str, like, device=None):
    """Restore into the structure of `like`. Each leaf takes the type of the
    matching `like` leaf: a tensor with its dtype on its device where `like`
    holds a tensor, numpy where it holds numpy. `device=` overrides the
    device of every tensor leaf (elastic restore: placement is re-derived,
    not stored). Returns (tree, manifest). Raises IOError when the payload
    fails its hash, ValueError on a shape mismatch."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    npz_path = os.path.join(path, "arrays.npz")
    with open(npz_path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    if digest != manifest["sha256"]:
        raise IOError(f"checkpoint {path} failed integrity check")
    with np.load(npz_path) as data:
        leaves = [_restore_leaf(_key(p), data, leaf, device)
                  for p, leaf in _leaves(like)]
    return _rebuild(like, iter(leaves)), manifest


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, "manifest.json")):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


class CheckpointManager:
    """Async checkpointing off the critical path + retention."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save_async(self, step: int, tree, extra=None) -> None:
        """Copy `tree` to the host now, write and commit it on a thread.
        The copy is finished when this returns (card tensors included), so
        the caller may mutate every leaf right after."""
        self.wait()  # one in flight at a time
        flat = _snapshot(tree)

        def work():
            try:
                _commit(self.directory, step, flat, extra)
                self._gc()
            except BaseException as e:  # pragma: no cover
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def latest(self) -> Optional[int]:
        return latest_step(self.directory)

    def path_for(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def restore_latest(self, like, device=None):
        """(step, tree, manifest) of the newest checkpoint, or None."""
        self.wait()
        step = self.latest()
        if step is None:
            return None
        tree, manifest = restore_checkpoint(self.path_for(step), like, device)
        return step, tree, manifest

    def _gc(self) -> None:
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.directory)
            if n.startswith("step_") and not n.endswith(".tmp"))
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
