"""Serving-layer accounting: `ServeStats` extends the SessionReport idea —
measured, not assumed, quantities — to the streaming tier.

`SessionReport` bills the *orchestration* (per-phase words/rounds/work per
machine); `ServeStats` bills the *serving pipeline* wrapped around it:

* throughput   — requests admitted/completed, sustained tasks/s;
* latency      — submit→resolve per request, p50/p99 over a bounded ring;
* batching     — batches fired, mean occupancy (batch size / max_batch),
                 size- vs deadline-triggered split, current window length;
* overlap      — fraction of executor-busy time during which the admission/
                 routing stage was simultaneously busy on the *next* batch
                 (the double-buffering win; 0 in sync mode by construction);
* queue depth  — current and high-water pending admission;
* SLO          — requests resolved past their deadline;
* backpressure — admissions refused with `QueueFullError`.

`report()` folds in the underlying buffer sessions' `SessionReport`s
(summed across the double buffers), so one dict carries the serving metrics
*and* the orchestration words/rounds they cost, plus an "elastic" block of
the elasticity counters when the sessions run elastic. The keys are the JAX
package's.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np


class OverlapClock:
    """Measures wall-clock overlap between two pipeline roles.

    Each role ("route" — admission/coalescing/staging, "exec" — session
    execution) brackets its busy intervals with `begin`/`end`; the clock
    accumulates per-role busy time and the time both were busy at once.
    Thread-safe; the overlap fraction is overlapped-time / exec-busy-time.
    """

    ROLES = ("route", "exec")

    def __init__(self):
        self._lock = threading.Lock()
        self._since: Dict[str, Optional[float]] = {r: None for r in self.ROLES}
        self.busy: Dict[str, float] = {r: 0.0 for r in self.ROLES}
        self.overlapped = 0.0
        self._both_since: Optional[float] = None

    def begin(self, role: str, now: float) -> None:
        with self._lock:
            self._since[role] = now
            other = self.ROLES[1 - self.ROLES.index(role)]
            if self._since[other] is not None:
                self._both_since = now

    def end(self, role: str, now: float) -> None:
        with self._lock:
            start = self._since[role]
            if start is None:
                return
            self._since[role] = None
            self.busy[role] += now - start
            if self._both_since is not None:
                self.overlapped += max(now - self._both_since, 0.0)
                self._both_since = None

    def overlap_fraction(self) -> float:
        with self._lock:
            ex = self.busy["exec"]
            return float(self.overlapped / ex) if ex > 0 else 0.0


class ServeStats:
    """Cross-request accounting for one `Frontend` (thread-safe)."""

    LATENCY_RING = 1 << 16  # most recent resolutions kept for percentiles

    def __init__(self, max_batch: int, clock):
        self._lock = threading.Lock()
        self._clock = clock
        self._max_batch = max_batch
        self.started_at = clock()
        self.overlap = OverlapClock()
        # counters
        self.submitted = 0
        self.completed = 0
        self.rejected = 0  # QueueFullError admissions
        self.failed = 0  # futures rejected with an error
        self.deadline_misses = 0
        self.batches = 0
        self.batches_by_trigger: Dict[str, int] = {"size": 0, "deadline": 0,
                                                   "flush": 0}
        self.batched_tasks = 0  # sum of fired batch sizes
        self.merged_batches = 0  # prepared batches merged by concat
        self.queue_depth = 0
        self.queue_peak = 0
        self._latencies: List[float] = []
        self._lat_pos = 0

    # -- recording (frontend-internal) --------------------------------------
    def note_submit(self, depth: int) -> None:
        with self._lock:
            self.submitted += 1
            self.queue_depth = depth
            self.queue_peak = max(self.queue_peak, depth)

    def note_reject(self) -> None:
        with self._lock:
            self.rejected += 1

    def note_batch(self, size: int, trigger: str) -> None:
        with self._lock:
            self.batches += 1
            self.batched_tasks += size
            self.batches_by_trigger[trigger] = \
                self.batches_by_trigger.get(trigger, 0) + 1

    def note_merge(self) -> None:
        """A staged batch absorbed a newly fired window (TaskBatch.concat)."""
        with self._lock:
            self.merged_batches += 1

    def note_resolved(self, future, failed: bool = False) -> None:
        with self._lock:
            if failed:
                self.failed += 1
                return
            self.completed += 1
            if (future.deadline is not None
                    and future.t_submit + future.latency > future.deadline):
                self.deadline_misses += 1
            if len(self._latencies) < self.LATENCY_RING:
                self._latencies.append(future.latency)
            else:  # ring: keep the most recent window of resolutions
                self._latencies[self._lat_pos] = future.latency
                self._lat_pos = (self._lat_pos + 1) % self.LATENCY_RING

    # -- reading -------------------------------------------------------------
    def latency_percentiles(self) -> Dict[str, float]:
        with self._lock:
            lat = np.asarray(self._latencies, dtype=np.float64)
        if lat.size == 0:
            return {"p50_s": 0.0, "p99_s": 0.0, "mean_s": 0.0}
        return {"p50_s": float(np.percentile(lat, 50)),
                "p99_s": float(np.percentile(lat, 99)),
                "mean_s": float(lat.mean())}

    def occupancy(self) -> float:
        """Mean fired-batch size as a fraction of `max_batch`."""
        with self._lock:
            if self.batches == 0:
                return 0.0
            return self.batched_tasks / (self.batches * self._max_batch)

    def report(self, sessions=(), window: Optional[float] = None) -> Dict:
        """One dict of serving metrics; pass the frontend's buffer sessions
        to fold their orchestration `SessionReport`s in (summed words /
        rounds / stages across the double buffers)."""
        now = self._clock()
        elapsed = max(now - self.started_at, 1e-12)
        out: Dict = {
            "submitted": self.submitted,
            "completed": self.completed,
            "rejected": self.rejected,
            "failed": self.failed,
            "deadline_misses": self.deadline_misses,
            "tasks_per_s": self.completed / elapsed,
            "batches": self.batches,
            "batches_by_trigger": dict(self.batches_by_trigger),
            "merged_batches": self.merged_batches,
            "batch_occupancy": self.occupancy(),
            "overlap_fraction": self.overlap.overlap_fraction(),
            "queue_depth": self.queue_depth,
            "queue_peak": self.queue_peak,
            "elapsed_s": elapsed,
        }
        out.update(self.latency_percentiles())
        if window is not None:
            out["window_s"] = window
        if sessions:
            stages = words = rounds = 0
            local = mig = steal = rec = 0.0
            stolen = 0
            for s in sessions:
                rep = s.report
                stages += rep.num_stages
                words += float(rep.sent.sum())
                rounds += rep.rounds
                local += rep.replica_local_words
                mig += rep.migration_words
                steal += rep.steal_words
                rec += rep.recovery_words
                stolen += int(rep.stolen_out.sum())
            out["session"] = {"stages": stages, "total_words": words,
                              "rounds": rounds, "replica_local_words": local,
                              "migration_words": mig, "steal_words": steal,
                              "recovery_words": rec, "stolen_tasks": stolen}
            # elastic-subsystem counters: the buffer sessions share one
            # ElasticityManager (Orchestrator.fork), so dedupe by identity
            managers = {id(e): e for e in
                        (getattr(s, "elastic", None) for s in sessions)
                        if e is not None}
            if managers:
                elastic: Dict[str, int] = {}
                for e in managers.values():
                    for k, v in e.counters().items():
                        if k == "machines_alive":
                            elastic[k] = min(elastic.get(k, v), v)
                        else:
                            elastic[k] = elastic.get(k, 0) + v
                out["elastic"] = elastic
        return out
