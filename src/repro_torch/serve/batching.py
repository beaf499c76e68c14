"""Adaptive batching window: when does an unbounded request stream become a
`TaskBatch`?

The ingest layer decouples request *arrival* from execution *cadence* (the
Dask comm/scheduler split): requests land in a per-tag `BatchWindow` and a
batch fires on whichever trigger comes first —

* **size** — the window holds `max_batch` requests (device-efficiency bound);
* **deadline** — the oldest request has waited out the adaptive window, or
  some request's SLO deadline (minus the EWMA service-time estimate) is
  about to pass (latency bound).

The window length itself is *auto-tuned from the observed arrival rate*: it
is the time a full batch takes to accumulate at the current EWMA rate,
clamped to ``[min_window, max_window]``. A fast stream therefore fires
size-triggered full batches with a short deadline backstop; a trickle fires
small deadline-triggered batches instead of stalling until `max_batch`.

All trigger logic takes an explicit ``now`` (and the window an injectable
clock epoch), so trigger semantics are unit-testable with a fake clock —
no sleeps, no flaky timing (`tests/test_torch_serve.py`).

Backpressure is a **loud error**: when `max_queue` requests are already
pending admission, `push` raises `QueueFullError` instead of silently
dropping or unboundedly buffering — an open-loop client sees the overload
immediately and can shed or retry.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, List, Optional

import numpy as np


class QueueFullError(RuntimeError):
    """Raised on admission when the bounded ingest queue is full — the
    frontend never silently drops a request."""


@dataclasses.dataclass(frozen=True)
class BatchingConfig:
    """Knobs of the adaptive batching window (the same knobs as the JAX
    package's, `docs/serving.md`).

    max_batch      — size trigger: coalesce at most this many requests/batch.
    min_window     — adaptive-window floor (s): never fire *earlier* than
                     this on the age trigger, so a burst still coalesces.
    max_window     — adaptive-window ceiling (s): the worst-case queueing
                     delay a request can see before its batch fires.
    max_queue      — bounded ingest queue; admission past it raises
                     `QueueFullError` (backpressure, not silent drop).
    default_deadline — per-request SLO (s after submit) applied when
                     `submit(deadline=)` is not given; None = no SLO, only
                     the adaptive window bounds latency.
    rate_halflife  — EWMA half-life (in arrivals) of the inter-arrival-gap
                     estimate the window length is tuned from.
    """

    max_batch: int = 256
    min_window: float = 50e-6
    max_window: float = 2e-3
    max_queue: int = 8192
    default_deadline: Optional[float] = None
    rate_halflife: float = 64.0

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.max_queue < self.max_batch:
            raise ValueError(
                f"max_queue ({self.max_queue}) must be >= max_batch "
                f"({self.max_batch}) or no full batch could ever be admitted")
        if not (0.0 <= self.min_window <= self.max_window):
            raise ValueError(
                f"need 0 <= min_window <= max_window, got "
                f"[{self.min_window}, {self.max_window}]")


@dataclasses.dataclass
class ServeRequest:
    """One admitted request, parked in a window until its batch fires."""

    tag: str
    keys: np.ndarray  # (arity,) requested chunk keys, int64
    ctx: np.ndarray  # (ctx_width,) lambda context row
    write_key: int  # -1 = writes nothing
    future: object  # RequestFuture
    t_submit: float
    deadline: Optional[float]  # absolute, or None


class BatchWindow:
    """Per-tag pending queue + the size/deadline trigger state machine.

    Pure host-side logic with explicit time: `push(req, now)` admits,
    `ready(now)` asks whether a batch should fire, `next_due(now)` reports
    the absolute instant the deadline trigger would fire on its own (for
    the batcher thread's wait timeout), and `take(now)` pops the batch's
    requests in admission order.
    """

    def __init__(self, config: BatchingConfig):
        self.config = config
        self.pending: Deque[ServeRequest] = deque()
        # EWMA of inter-arrival gaps -> the arrival-rate estimate the
        # window length adapts to; seeded pessimistically at max_window so
        # a cold stream starts latency-bound, not size-bound
        self._ema_gap: float = config.max_window
        self._ema_alpha = 1.0 - 0.5 ** (1.0 / max(config.rate_halflife, 1.0))
        self._last_arrival: Optional[float] = None
        # EWMA of per-batch service time, fed back by the frontend: the
        # slack reserved before a request's SLO deadline
        self._ema_service: float = 0.0
        self._min_deadline: Optional[float] = None

    # -- observability -------------------------------------------------------
    @property
    def depth(self) -> int:
        return len(self.pending)

    @property
    def window(self) -> float:
        """Current adaptive window length (s): time for `max_batch` arrivals
        at the EWMA rate, clamped to [min_window, max_window]."""
        est = self._ema_gap * self.config.max_batch
        return float(min(max(est, self.config.min_window),
                         self.config.max_window))

    @property
    def service_estimate(self) -> float:
        return self._ema_service

    # -- admission -----------------------------------------------------------
    def push(self, req: ServeRequest, now: float) -> None:
        if len(self.pending) >= self.config.max_queue:
            raise QueueFullError(
                f"serve ingest queue for tag {req.tag!r} is full "
                f"({self.config.max_queue} pending) — the executor is not "
                "keeping up with the offered load; shed requests, raise "
                "max_queue, or widen the batch")
        if self._last_arrival is not None:
            gap = max(now - self._last_arrival, 0.0)
            self._ema_gap += self._ema_alpha * (gap - self._ema_gap)
        self._last_arrival = now
        if req.deadline is not None:
            self._min_deadline = (req.deadline if self._min_deadline is None
                                  else min(self._min_deadline, req.deadline))
        self.pending.append(req)

    def note_service(self, seconds: float) -> None:
        """Feed back a measured batch execution time (EWMA'd into the slack
        reserved ahead of SLO deadlines)."""
        if self._ema_service == 0.0:
            self._ema_service = seconds
        else:
            self._ema_service += self._ema_alpha * (seconds - self._ema_service)

    # -- triggers ------------------------------------------------------------
    def _fire_at(self) -> Optional[float]:
        """Absolute instant the deadline trigger fires: the oldest request's
        age reaching the adaptive window, or the earliest SLO deadline minus
        the service-time slack — whichever is sooner."""
        if not self.pending:
            return None
        due = self.pending[0].t_submit + self.window
        if self._min_deadline is not None:
            due = min(due, self._min_deadline - self._ema_service)
        return due

    def ready(self, now: float) -> bool:
        if len(self.pending) >= self.config.max_batch:
            return True  # size trigger
        due = self._fire_at()
        return due is not None and now >= due  # deadline trigger

    def next_due(self, now: float) -> Optional[float]:
        """When the deadline trigger would fire with no further arrivals
        (None if the window is empty). Never in the past: an already-due
        window reports `now`."""
        due = self._fire_at()
        return None if due is None else max(due, now)

    # -- batch formation -----------------------------------------------------
    def take(self, now: float) -> List[ServeRequest]:
        """Pop up to `max_batch` requests in admission order."""
        out = [self.pending.popleft()
               for _ in range(min(len(self.pending), self.config.max_batch))]
        # recompute the SLO horizon over what stayed behind
        rest = [r.deadline for r in self.pending if r.deadline is not None]
        self._min_deadline = min(rest) if rest else None
        return out
