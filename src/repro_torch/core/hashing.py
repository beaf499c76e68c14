"""Deterministic hashing used for data placement and transit-VM mapping.

The paper (§2.2) places each data chunk on a uniformly random machine to get
adversary-resistant load balance (Sanders' balls-into-bins argument), and maps
virtual transit machines VM(root, bfs_id) onto physical machines via a hash
known to every machine (Fig. 2 uses h(x, y) = (x + 3y) mod 8 + 1).

We use splitmix64 — a high-quality, stateless 64-bit mixer — so placement is
reproducible across hosts without any coordination (a requirement at
1000+-node scale: every worker must compute identical placement locally).
"""
from __future__ import annotations

import numpy as np

_U64 = np.uint64


def splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer. Input/output uint64."""
    x = np.asarray(x).astype(np.uint64, copy=True)
    with np.errstate(over="ignore"):
        x += _U64(0x9E3779B97F4A7C15)
        z = x
        z = (z ^ (z >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> _U64(27))) * _U64(0x94D049BB133111EB)
        z = z ^ (z >> _U64(31))
    return z


def hash_combine(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Combine two uint64 streams into one (order-sensitive)."""
    a = np.asarray(a).astype(np.uint64)
    b = np.asarray(b).astype(np.uint64)
    with np.errstate(over="ignore"):
        return splitmix64(a * _U64(0x9E3779B97F4A7C15) ^ splitmix64(b))


def chunk_home(keys: np.ndarray, num_machines: int, salt: int = 0) -> np.ndarray:
    """Random (hashed) home machine for each data chunk key (§2.2).

    Randomized placement is what makes Lemma 1 (weighted balls-into-bins)
    applicable: storage and *access* load are both balanced whp for any
    fixed (even adversarial) key distribution.
    """
    h = splitmix64(np.asarray(keys, dtype=np.uint64) + _U64(salt * 0x51ED2701 + 1))
    return (h % _U64(num_machines)).astype(np.int64)


def vm_to_pm(root: np.ndarray, node_id: np.ndarray, num_machines: int) -> np.ndarray:
    """Map virtual transit machine (root, bfs node id) -> physical machine.

    The tree root (node_id == 0) *is* the machine storing the chunk, per
    Fig. 2 ("a physical machine can simultaneously serve as both a leaf and
    an internal node"; the root of tree i is machine i). Interior nodes are
    hashed — the paper notes static transit choice + random chunk placement
    is equivalent to dynamic transit selection.
    """
    root = np.asarray(root, dtype=np.int64)
    node_id = np.asarray(node_id, dtype=np.int64)
    h = hash_combine(root.astype(np.uint64), node_id.astype(np.uint64) + _U64(1))
    pm = (h % _U64(num_machines)).astype(np.int64)
    return np.where(node_id == 0, root, pm)
