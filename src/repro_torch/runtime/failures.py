"""Failure detection and straggler mitigation (simulated hardware layer).

On a real cluster these hooks bind to the platform's health APIs; here the same
control logic runs against a deterministic `FailureInjector` so the
recovery paths (stage-boundary restore and shrink, straggler drains in
`core/elasticity.py`) are *exercised by tests*, not just designed. Plain
Python: no torch, no numpy.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Set


@dataclasses.dataclass
class FailureInjector:
    """Deterministic fault schedule: {step: [node_ids]} to kill."""

    schedule: Dict[int, List[int]] = dataclasses.field(default_factory=dict)
    dead: Set[int] = dataclasses.field(default_factory=set)

    def tick(self, step: int) -> List[int]:
        died = [n for n in self.schedule.get(step, []) if n not in self.dead]
        self.dead.update(died)
        return died


class HeartbeatMonitor:
    """Tracks last-seen times per node; nodes silent > timeout are failed.
    In simulation, `beat` is driven by the caller between stages; in
    production, by the per-host agent."""

    def __init__(self, nodes: List[int], timeout: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout = timeout
        self.clock = clock
        self.last_seen = {n: clock() for n in nodes}

    def beat(self, node: int, at: Optional[float] = None) -> None:
        self.last_seen[node] = self.clock() if at is None else at

    def failed_nodes(self, now: Optional[float] = None) -> List[int]:
        now = self.clock() if now is None else now
        return [n for n, t in self.last_seen.items()
                if now - t > self.timeout]


class StragglerDetector:
    """Per-node step-duration tracker; a node whose recent mean exceeds the
    fleet median by `threshold`× is a straggler (systematic, not transient:
    needs `min_samples` before reporting). TD-Orch removes the *data-skew*
    stragglers; this catches the *hardware* ones."""

    def __init__(self, window: int = 16, threshold: float = 1.5,
                 min_samples: int = 4):
        self.window = window
        self.threshold = threshold
        self.min_samples = min_samples
        self.hist: Dict[int, collections.deque] = {}

    def record(self, node: int, duration: float) -> None:
        self.hist.setdefault(
            node, collections.deque(maxlen=self.window)).append(duration)

    def stragglers(self) -> List[int]:
        means = {n: sum(d) / len(d) for n, d in self.hist.items()
                 if len(d) >= self.min_samples}
        if len(means) < 2:
            return []
        med = sorted(means.values())[len(means) // 2]
        return [n for n, m in means.items() if m > self.threshold * med]
