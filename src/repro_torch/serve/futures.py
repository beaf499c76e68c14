"""Per-request futures: how results stream back out of coalesced batches.

A `RequestFuture` is handed to the submitter the moment a request is
admitted, before any batch exists. When the adaptive window coalesces the
request into a ragged `TaskBatch` and an Orchestrator session executes it,
the frontend slices the batch's result array back apart and resolves each
future with exactly its own rows — request identity survives coalescing,
batch merging (`TaskBatch.concat`), and double-buffer reordering because the
future, not a batch offset, is the delivery address.
"""
from __future__ import annotations

import threading
from typing import Optional


class RequestFuture:
    """A single request's pending result.

    `result(timeout=)` blocks until the serving pipeline resolves the
    request, returning the request's own result rows (shape depends on the
    tag: `(value_width,)` for row requests, `(arity, value_width)` for
    ragged multi-gets). If the stage's lambda raised — or the frontend was
    closed with the request still queued — `result()` re-raises that error
    here, on the consumer.
    """

    __slots__ = ("tag", "seq", "t_submit", "deadline", "latency",
                 "_event", "_value", "_error")

    def __init__(self, tag: str, seq: int, t_submit: float,
                 deadline: Optional[float] = None):
        self.tag = tag
        self.seq = seq  # admission order, frontend-global
        self.t_submit = t_submit  # frontend-clock admission instant
        self.deadline = deadline  # absolute frontend-clock SLO, or None
        self.latency: Optional[float] = None  # set at resolution
        self._event = threading.Event()
        self._value = None
        self._error: Optional[BaseException] = None

    # -- consumer side ------------------------------------------------------
    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.tag}#{self.seq} unresolved after {timeout}s "
                "— is the frontend running (thread mode) or flushed (sync "
                "mode)?")
        if self._error is not None:
            raise self._error
        return self._value

    # -- frontend side ------------------------------------------------------
    def _resolve(self, value, now: float) -> None:
        self._value = value
        self.latency = now - self.t_submit
        self._event.set()

    def _reject(self, error: BaseException, now: float) -> None:
        self._error = error
        self.latency = now - self.t_submit
        self._event.set()
