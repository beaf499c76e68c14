"""Graph generators for the §6 evaluation.

The paper's datasets (Twitter-2010, uk-2005, Road-USA, …) are not shippable
offline, so we generate graphs covering the same characteristic axes:
  * Erdős–Rényi — unskewed degree (the paper's Fig. 9 weak-scaling baseline),
  * Barabási–Albert — power-law/skewed (Fig. 9 uses γ = 2.2, "consistent with
    the measured skew in natural graphs reported by PowerGraph"),
  * 2-D grid — high-diameter, road-network-like (the Road-USA regime where
    work-efficiency dominates, §6.2),
  * star — the adversarial single-hot-vertex contention case.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Graph:
    """Directed edge list; undirected graphs carry both orientations (§5
    "we represent each undirected edge {u,v} as two directed edges")."""

    n: int
    src: np.ndarray
    dst: np.ndarray
    weights: np.ndarray | None = None

    def __post_init__(self):
        self.src = np.asarray(self.src, dtype=np.int64)
        self.dst = np.asarray(self.dst, dtype=np.int64)
        if self.weights is not None:
            self.weights = np.asarray(self.weights, dtype=np.float64)

    @property
    def m(self) -> int:
        return self.src.shape[0]

    def out_degrees(self) -> np.ndarray:
        return np.bincount(self.src, minlength=self.n)

    def with_weights(self, seed: int = 0, low: float = 1.0, high: float = 10.0) -> "Graph":
        rng = np.random.default_rng(seed)
        return Graph(self.n, self.src, self.dst,
                     rng.uniform(low, high, size=self.m))


def _dedup_symmetrize(n: int, s: np.ndarray, d: np.ndarray) -> Graph:
    keep = s != d
    s, d = s[keep], d[keep]
    lo, hi = np.minimum(s, d), np.maximum(s, d)
    pairs = np.unique(lo * np.int64(n) + hi)
    lo, hi = pairs // n, pairs % n
    return Graph(n, np.concatenate([lo, hi]), np.concatenate([hi, lo]))


def erdos_renyi(n: int, avg_degree: float, seed: int = 0) -> Graph:
    """G(n, m)-style ER graph: unskewed degrees."""
    rng = np.random.default_rng(seed)
    m_target = int(n * avg_degree / 2)
    s = rng.integers(0, n, size=int(m_target * 1.1) + 8)
    d = rng.integers(0, n, size=s.size)
    return _dedup_symmetrize(n, s, d)


def barabasi_albert(n: int, attach: int = 8, seed: int = 0) -> Graph:
    """Preferential attachment — power-law (skewed) degree distribution.
    Uses the repeated-nodes sampling trick: O(m) expected time."""
    rng = np.random.default_rng(seed)
    if n <= attach:
        raise ValueError("n must exceed attach count")
    # seed clique among the first attach+1 vertices
    srcs, dsts = [], []
    repeated: list[int] = []
    for v in range(attach + 1):
        for u in range(v):
            srcs.append(v)
            dsts.append(u)
            repeated += [u, v]
    # the repeated-nodes list grows in place inside one buffer sized for
    # its largest length (each vertex adds at most 2·attach entries), so a
    # vertex costs O(attach), not a copy of the list; the draws are the
    # same as growing it by concatenation
    size = len(repeated)
    rep = np.empty(size + 2 * attach * (n - attach - 1), dtype=np.int64)
    rep[:size] = repeated
    out_s = [np.array(srcs, dtype=np.int64)]
    out_d = [np.array(dsts, dtype=np.int64)]
    for v in range(attach + 1, n):
        targets = rep[rng.integers(0, size, size=attach)]
        targets = np.unique(targets)
        out_s.append(np.full(targets.size, v, dtype=np.int64))
        out_d.append(targets)
        k = targets.size
        rep[size:size + k] = targets
        rep[size + k:size + 2 * k] = v
        size += 2 * k
    return _dedup_symmetrize(n, np.concatenate(out_s), np.concatenate(out_d))


def grid_2d(rows: int, cols: int) -> Graph:
    """Road-network-like: diameter Θ(rows+cols), max degree 4."""
    idx = np.arange(rows * cols, dtype=np.int64).reshape(rows, cols)
    right_s, right_d = idx[:, :-1].ravel(), idx[:, 1:].ravel()
    down_s, down_d = idx[:-1, :].ravel(), idx[1:, :].ravel()
    s = np.concatenate([right_s, down_s])
    d = np.concatenate([right_d, down_d])
    return Graph(rows * cols, np.concatenate([s, d]), np.concatenate([d, s]))


def star_graph(n: int) -> Graph:
    """Adversarial contention: every edge touches vertex 0."""
    leaves = np.arange(1, n, dtype=np.int64)
    hub = np.zeros(n - 1, dtype=np.int64)
    return Graph(n, np.concatenate([hub, leaves]), np.concatenate([leaves, hub]))
