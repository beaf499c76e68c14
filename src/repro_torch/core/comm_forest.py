"""Communication forest (§3.1): P balanced F-ary trees, one rooted per machine.

Geometry only — message/merge semantics live in `engine.py`. Nodes use BFS
numbering with the root at index 0; children of node v are
F·v + 1 … F·v + F. The P leaves sit at depth `height` (the first P node
slots of that depth), one per physical machine. Interior (transit) virtual
machines are mapped to physical machines by `hashing.vm_to_pm`.

Fanout default follows the paper's theory-guided choice
F = Θ(log P / log log P) (§3.1, §3.5), clamped to ≥2.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from . import hashing


def theory_fanout(num_machines: int) -> int:
    """F = Θ(log P / log log P), the §3.5 setting; ≥2 always."""
    P = max(int(num_machines), 2)
    lp = math.log(max(P, 3))
    llp = math.log(max(lp, math.e ** 1.0))
    return max(2, int(round(lp / max(llp, 1e-9))))


@dataclasses.dataclass(frozen=True)
class CommForest:
    """Shared geometry of every tree in the forest (all P trees are congruent;
    only the root machine / transit hashing differs per tree)."""

    P: int
    F: int
    height: int  # leaf depth; phase 1 takes `height` BSP rounds (Fig. 2)

    @staticmethod
    def build(num_machines: int, fanout: int | None = None) -> "CommForest":
        P = int(num_machines)
        if P < 1:
            raise ValueError("need at least one machine")
        F = int(fanout) if fanout is not None else theory_fanout(P)
        F = max(2, F)
        height = 0
        while F**height < P:
            height += 1
        return CommForest(P=P, F=F, height=height)

    # -- node arithmetic (vectorized, BFS numbering, root = 0) -------------
    def first_at_depth(self, depth: int) -> int:
        # (F^d - 1) / (F - 1)
        return (self.F**depth - 1) // (self.F - 1)

    def leaf_node(self, machine: np.ndarray) -> np.ndarray:
        return self.first_at_depth(self.height) + np.asarray(machine, dtype=np.int64)

    def parent(self, node: np.ndarray) -> np.ndarray:
        node = np.asarray(node, dtype=np.int64)
        return np.where(node > 0, (node - 1) // self.F, 0)

    def physical(self, root_machine: np.ndarray, node: np.ndarray) -> np.ndarray:
        """Physical machine hosting VM(root, node)."""
        return hashing.vm_to_pm(root_machine, node, self.P)

    def leaf_machine_of(self, root_machine: np.ndarray, machine: np.ndarray) -> np.ndarray:
        """Leaves are identity-mapped: leaf m of every tree is machine m."""
        return np.asarray(machine, dtype=np.int64)
