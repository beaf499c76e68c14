"""DistVertexSubset (§5, D.2): a distributed vertex subset with dual
representations — sparse (index list; the paper upgrades Ligra's array to a
phase-concurrent hash table) and dense (bitmap; the paper upgrades Ligra's
boolean map to a concurrent bitmap). Representation switching is what makes
EdgeMap direction-optimizing."""
from __future__ import annotations

import numpy as np


class DistVertexSubset:
    def __init__(self, n: int, indices: np.ndarray | None = None,
                 mask: np.ndarray | None = None):
        self.n = int(n)
        self._indices = None if indices is None else np.asarray(indices, dtype=np.int64)
        self._mask = None if mask is None else np.asarray(mask, dtype=bool)
        if self._indices is None and self._mask is None:
            raise ValueError("need indices or mask")

    # ---- constructors -----------------------------------------------------
    @staticmethod
    def single(n: int, v: int) -> "DistVertexSubset":
        return DistVertexSubset(n, indices=np.array([v], dtype=np.int64))

    @staticmethod
    def full(n: int) -> "DistVertexSubset":
        return DistVertexSubset(n, mask=np.ones(n, dtype=bool))

    @staticmethod
    def empty(n: int) -> "DistVertexSubset":
        return DistVertexSubset(n, indices=np.empty(0, dtype=np.int64))

    @staticmethod
    def from_mask(mask: np.ndarray) -> "DistVertexSubset":
        return DistVertexSubset(mask.shape[0], mask=mask)

    # ---- dual representation ----------------------------------------------
    @property
    def indices(self) -> np.ndarray:
        if self._indices is None:
            self._indices = np.flatnonzero(self._mask)
        return self._indices

    @property
    def mask(self) -> np.ndarray:
        if self._mask is None:
            self._mask = np.zeros(self.n, dtype=bool)
            self._mask[self._indices] = True
        return self._mask

    def __len__(self) -> int:
        return int(self._mask.sum()) if self._indices is None else self._indices.size

    @property
    def is_empty(self) -> bool:
        return len(self) == 0

    def sum_degrees(self, out_indptr: np.ndarray) -> int:
        idx = self.indices
        return int((out_indptr[idx + 1] - out_indptr[idx]).sum())

    def per_machine(self, vertex_home: np.ndarray, P: int) -> np.ndarray:
        out = np.zeros(P, dtype=np.int64)
        np.add.at(out, vertex_home[self.indices], 1)
        return out
