"""`serve.Frontend` — the streaming front door over long-lived Orchestrator
sessions, on the torch port.

The paper's interface takes a pre-built `TaskBatch`; a serving tier takes an
*unbounded stream* of single requests with latency SLOs. The Frontend admits
requests one at a time (`submit`, or the kv conveniences layered on top),
parks them in per-tag adaptive `BatchWindow`s, and turns each fired window
into a ragged CSR `TaskBatch` executed on a **pinned session pair**:

    submit → BatchWindow (size- OR deadline-triggered, auto-tuned width)
           → coalesce: one ragged TaskBatch, admission-ordered priorities
           → [router] validate + contention pre-scan + device staging
           → [executor] Orchestrator.run_stage on the current buffer
           → slice results back per request → RequestFuture resolution

**Double buffering** (`mode="thread"`): the router thread assembles, scans,
and stages batch k+1 (`TorchBackend.prefetch` copies its contexts to the
card on the backend's side stream) while the executor thread runs batch k's
session stage — `ServeStats` measures the realized overlap fraction. The
executor thread selects the backend's device itself: PyTorch's current
device and current stream are per thread. Execution itself is serialized (BSP
write-backs of batch k are visible to batch k+1's reads, exactly as if the
batches were submitted back-to-back), so per-request results are
bit-identical to hand-building the same sequence of batches.

`mode="sync"` runs the same pipeline inline on the submitting thread, less
the device staging (the batch runs next, so nothing would overlap it) —
deterministic (no timing, no threads), which is what the tests, docs, and
closed-loop benchmark controls use; triggers are evaluated at `submit` /
`pump` / `flush` time against the injected clock.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..core import TaskBatch
from .batching import BatchingConfig, BatchWindow, QueueFullError, ServeRequest
from .futures import RequestFuture
from .stats import ServeStats

# staged-batch depth between router and executor: one in flight, one staged
# — the double buffer. A third ready window merges into the staged batch
# (TaskBatch.concat) instead of queueing behind it.
_STAGE_DEPTH = 1


@dataclasses.dataclass(frozen=True)
class TagSpec:
    """One registered request kind: the lambda it runs and how its batch
    results slice back into per-request values."""

    name: str
    fn: Callable
    write_back: str
    ctx_width: int
    # "row": request i owns result row i, shape (result_width,).
    # "ragged": the lambda returns padded flat rows (n, max_arity * w);
    #           request i owns reshape(max_arity, w)[:arity_i].
    result: str = "row"


@dataclasses.dataclass
class _Prepared:
    """A coalesced batch staged for execution (router → executor handoff)."""

    spec: TagSpec
    tasks: TaskBatch
    requests: List[ServeRequest]
    hot_keys: np.ndarray  # router's contention pre-scan (top keys, by count)


class FrontendClosedError(RuntimeError):
    """Raised on submission to a closed frontend."""


class Frontend:
    """Streaming request admission over double-buffered Orchestrator
    sessions.

    `session` is the pinned buffer-A session (any engine/backend) — or a
    bare `DataStore`, in which case `session_config=` (a `SessionConfig`,
    core/config.py) shapes the session the Frontend constructs; the default
    config runs the torch backend on the CUDA card. With
    `double_buffer=True` (default) buffer B is `session.fork()` — same
    store, shared engine/forest/device caches/replication/elasticity state,
    its own cost ledger — and fired batches alternate between the two.

    Request kinds are registered with `register(tag, fn, ...)`; `submit`
    admits one request under that tag and returns a `RequestFuture`
    immediately. See `repro_torch.kvstore.DistributedHashTable.serve()` for
    the ready-made GET / MULTI-GET / read-modify-write serving mode.
    """

    def __init__(self, session, *, config: BatchingConfig | dict | None = None,
                 session_config=None,
                 mode: str = "thread", double_buffer: bool = True,
                 clock: Callable[[], float] = time.monotonic):
        if not hasattr(session, "run_stage"):
            # a bare DataStore: build the buffer-A session here from the
            # unified SessionConfig (core/config.py) — the same config=
            # every other front door takes
            from ..core.session import Orchestrator
            session = Orchestrator(session, config=session_config)
        elif session_config is not None:
            raise ValueError(
                "session_config= shapes a session the Frontend constructs — "
                "pass the DataStore, or configure the prebuilt session "
                "yourself and drop session_config=")
        if isinstance(config, dict):
            config = BatchingConfig(**config)
        self.config = config or BatchingConfig()
        if mode not in ("thread", "sync"):
            raise ValueError(f"mode must be 'thread' or 'sync', got {mode!r}")
        self.mode = mode
        self.sessions = (session, session.fork()) if double_buffer \
            else (session,)
        self.store = session.store
        self._clock = clock
        self._buf = 0  # which buffer session executes the next batch
        self._tags: Dict[str, TagSpec] = {}
        self._windows: Dict[str, BatchWindow] = {}
        self._seq = 0
        self.stats = ServeStats(self.config.max_batch, clock)
        self.last_hot_keys: np.ndarray = np.empty(0, dtype=np.int64)

        self._lock = threading.Lock()  # windows + seq + closed
        self._wake = threading.Condition(self._lock)  # router wakeups
        self._closed = False
        # router → executor staging (thread mode)
        self._staged: deque = deque()
        self._stage_cond = threading.Condition()
        self._exec_busy = False
        # windows the router has taken and not yet staged: drain() waits for
        # them as for staged batches
        self._routing = 0
        self._threads: List[threading.Thread] = []
        if mode == "thread":
            self._threads = [
                threading.Thread(target=self._router_loop, daemon=True,
                                 name="serve-router"),
                threading.Thread(target=self._executor_loop, daemon=True,
                                 name="serve-executor"),
            ]
            for t in self._threads:
                t.start()

    # -- lifecycle -----------------------------------------------------------
    def __enter__(self) -> "Frontend":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self, drain: bool = True) -> None:
        """Stop serving. With `drain` (default) every admitted request is
        flushed and resolved first; otherwise still-pending futures are
        rejected with `FrontendClosedError`."""
        with self._lock:
            if self._closed:
                return
        if drain:
            self.drain()
        with self._wake:
            self._closed = True
            self._wake.notify_all()
        with self._stage_cond:
            self._stage_cond.notify_all()
        for t in self._threads:
            t.join(timeout=30.0)
        now = self._clock()
        for win in self._windows.values():
            while win.pending:
                req = win.pending.popleft()
                req.future._reject(
                    FrontendClosedError("frontend closed before this request "
                                        "was batched"), now)
                self.stats.note_resolved(req.future, failed=True)

    # -- registration --------------------------------------------------------
    def register(self, tag: str, fn: Callable, *, write_back: str = "add",
                 ctx_width: int = 1, result: str = "row") -> None:
        """Register a request kind: `fn`/`write_back` exactly as
        `Orchestrator.run_stage` takes them; `result` declares how batch
        results slice back per request (`TagSpec`). Requests only coalesce
        with same-tag requests — one tag, one lambda, one stage."""
        if result not in ("row", "ragged"):
            raise ValueError(f"result must be 'row' or 'ragged', got {result!r}")
        with self._lock:
            if tag in self._tags:
                raise ValueError(f"tag {tag!r} already registered")
            self._tags[tag] = TagSpec(tag, fn, write_back, int(ctx_width),
                                      result)
            self._windows[tag] = BatchWindow(self.config)

    # -- admission -----------------------------------------------------------
    def submit(self, tag: str, keys, ctx=None, *, write_key: int = -1,
               deadline: Optional[float] = None) -> RequestFuture:
        """Admit one request: `keys` is the (possibly empty, possibly
        duplicated) sequence of chunk keys it reads, `ctx` its lambda
        context row, `write_key` the chunk it writes (-1 = none),
        `deadline` its SLO in seconds from now (None → the config default).
        Returns the request's future immediately; raises `QueueFullError`
        when the bounded ingest queue is full."""
        spec = self._tags.get(tag)
        if spec is None:
            raise KeyError(f"unregistered tag {tag!r} "
                           f"(registered: {sorted(self._tags)})")
        keys = np.atleast_1d(np.asarray(keys, dtype=np.int64))
        if ctx is None:
            ctx = np.zeros(spec.ctx_width)
        ctx = np.asarray(ctx, dtype=np.float64).reshape(spec.ctx_width)
        now = self._clock()
        if deadline is None:
            deadline = self.config.default_deadline
        abs_deadline = None if deadline is None else now + float(deadline)
        with self._wake:
            if self._closed:
                raise FrontendClosedError("frontend is closed")
            fut = RequestFuture(tag, self._seq, now, abs_deadline)
            self._seq += 1
            req = ServeRequest(tag=tag, keys=keys, ctx=ctx,
                               write_key=int(write_key), future=fut,
                               t_submit=now, deadline=abs_deadline)
            try:
                self._windows[tag].push(req, now)
            except QueueFullError:
                self.stats.note_reject()
                raise
            self.stats.note_submit(self._total_depth())
            self._wake.notify()
        if self.mode == "sync":
            self.pump()
        return fut

    def _total_depth(self) -> int:
        return sum(w.depth for w in self._windows.values())

    # -- sync-mode driving ---------------------------------------------------
    def pump(self) -> int:
        """Fire every window whose size/deadline trigger is due *now* and
        (sync mode) execute the batches inline; returns the number of
        batches fired. In thread mode this just nudges the router."""
        if self.mode == "thread":
            with self._wake:
                self._wake.notify()
            return 0
        fired = 0
        while True:
            taken = None
            with self._lock:
                now = self._clock()
                for tag, win in self._windows.items():
                    if win.ready(now):
                        trigger = ("size" if win.depth >= self.config.max_batch
                                   else "deadline")
                        taken = (self._tags[tag], win.take(now), trigger)
                        break
            if taken is None:
                return fired
            prepared = self._prepare(*taken)
            self._execute(prepared)
            fired += 1

    def flush(self) -> None:
        """Force every pending request into a batch now, regardless of
        triggers (counted as trigger="flush"). Sync mode executes inline;
        thread mode stages the batches and returns without waiting — use
        `drain()` to also wait for resolution."""
        while True:
            taken = None
            with self._lock:
                now = self._clock()
                for tag, win in self._windows.items():
                    if win.depth:
                        taken = (self._tags[tag], win.take(now), "flush")
                        break
            if taken is None:
                return
            prepared = self._prepare(*taken)
            if self.mode == "sync":
                self._execute(prepared)
            else:
                self._stage(prepared)

    def drain(self, timeout: Optional[float] = None) -> None:
        """Flush, then block until every admitted request has resolved and
        pending device work is done — the quiescence point benchmarks and
        tests measure at."""
        if self.mode == "thread":
            deadline = None if timeout is None else time.monotonic() + timeout
            while True:
                self.flush()  # windows may refill between waits
                with self._stage_cond:
                    if not (self._staged or self._exec_busy
                            or self._total_depth() or self._routing):
                        break
                    left = None if deadline is None \
                        else deadline - time.monotonic()
                    if left is not None and left <= 0:
                        raise TimeoutError("drain timed out")
                    self._stage_cond.wait(timeout=0.05 if left is None
                                          else min(left, 0.05))
        else:
            self.flush()
        backend = self.sessions[0].backend
        if backend is not None:
            backend.sync(self.store)

    # -- router: window → prepared batch -------------------------------------
    def _device_scope(self):
        """The backend's CUDA device as the calling thread's current device:
        a new thread starts on device 0 and its default stream, so the
        router and executor threads select the device themselves."""
        dev = getattr(self.sessions[0].backend, "device", None)
        if dev is not None and dev.type == "cuda":
            return torch.cuda.device(dev)
        return contextlib.nullcontext()

    def _router_loop(self) -> None:
        with self._device_scope():
            self._router_run()

    def _router_run(self) -> None:
        while True:
            taken = None
            with self._wake:
                while not self._closed:
                    now = self._clock()
                    for tag, win in self._windows.items():
                        if win.ready(now):
                            trigger = ("size"
                                       if win.depth >= self.config.max_batch
                                       else "deadline")
                            # counted before the window empties, so that
                            # drain() sees the requests in one or the other
                            self._routing += 1
                            taken = (self._tags[tag], win.take(now), trigger)
                            break
                    if taken is not None:
                        break
                    dues = [d for d in (w.next_due(now)
                                        for w in self._windows.values())
                            if d is not None]
                    self._wake.wait(timeout=min(dues) - now if dues else None)
                if taken is None:  # closed, nothing ready
                    return
            clk = self._clock
            self.stats.overlap.begin("route", clk())
            try:
                prepared = self._prepare(*taken)
            except BaseException:
                with self._stage_cond:
                    self._routing -= 1
                    self._stage_cond.notify_all()
                raise
            finally:
                self.stats.overlap.end("route", clk())
            self._stage(prepared, routed=True)

    def _prepare(self, spec: TagSpec, reqs: List[ServeRequest],
                 trigger: str) -> _Prepared:
        """Coalesce one fired window into a ragged CSR TaskBatch and run the
        admission-side routing work: geometry validation, the Phase-1-style
        contention pre-scan, and, in thread mode, non-blocking device
        staging (`backend.prefetch`). This is the work that overlaps batch
        k's device execution under double buffering; sync mode runs the
        batch next, so it has nothing to overlap and stages nothing."""
        n = len(reqs)
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum([r.keys.size for r in reqs], out=indptr[1:])
        indices = (np.concatenate([r.keys for r in reqs]) if indptr[-1]
                   else np.empty(0, dtype=np.int64))
        tasks = TaskBatch(
            contexts=np.stack([r.ctx for r in reqs]),
            origin=TaskBatch.even_origins(n, self.store.P),
            write_keys=np.asarray([r.write_key for r in reqs], dtype=np.int64),
            read_indptr=indptr, read_indices=indices,
        )
        tasks.validate(self.store)
        # admission-side contention detection: the serving layer's own view
        # of in-flight hot keys (the engine re-detects with full cost
        # accounting inside run_stage)
        if indices.size:
            uniq, counts = np.unique(indices, return_counts=True)
            self.last_hot_keys = uniq[np.argsort(counts, kind="stable")[::-1][:16]]
        backend = self.sessions[0].backend
        if backend is not None and self.mode == "thread":
            backend.prefetch(tasks, self.store)
        self.stats.note_batch(n, trigger)
        return _Prepared(spec, tasks, reqs, self.last_hot_keys)

    def _stage(self, prepared: _Prepared, routed: bool = False) -> None:
        """Hand a prepared batch to the executor. If the stage slot is
        occupied by a same-tag batch and the merge still fits `max_batch`,
        coalesce the two with `TaskBatch.concat` instead of queueing — the
        staged batch absorbs the new window. `routed`: the router's batch,
        which leaves its in-routing count here, under the staging lock."""
        with self._stage_cond:
            while True:
                if (self._staged
                        and self._staged[-1].spec.name == prepared.spec.name
                        and self._staged[-1].tasks.n + prepared.tasks.n
                        <= self.config.max_batch):
                    head = self._staged[-1]
                    merged = TaskBatch.concat([head.tasks, prepared.tasks],
                                              self.store)
                    backend = self.sessions[0].backend
                    if backend is not None:
                        backend.prefetch(merged, self.store)
                    self._staged[-1] = _Prepared(
                        head.spec, merged, head.requests + prepared.requests,
                        prepared.hot_keys)
                    self.stats.note_merge()
                    self._routing -= routed
                    self._stage_cond.notify_all()
                    return
                if len(self._staged) < _STAGE_DEPTH or self._closed:
                    self._staged.append(prepared)
                    self._routing -= routed
                    self._stage_cond.notify_all()
                    return
                self._stage_cond.wait()

    # -- executor: prepared batch → session stage → futures -------------------
    def _executor_loop(self) -> None:
        with self._device_scope():
            self._executor_run()

    def _executor_run(self) -> None:
        while True:
            with self._stage_cond:
                while not self._staged and not self._closed:
                    self._stage_cond.wait()
                if not self._staged:
                    return  # closed and drained
                prepared = self._staged.popleft()
                self._exec_busy = True
                self._stage_cond.notify_all()
            try:
                self._execute(prepared)
            finally:
                with self._stage_cond:
                    self._exec_busy = False
                    self._stage_cond.notify_all()

    def _execute(self, prepared: _Prepared) -> None:
        sess = self.sessions[self._buf % len(self.sessions)]
        self._buf += 1
        spec, tasks, reqs = prepared.spec, prepared.tasks, prepared.requests
        win = self._windows[spec.name]
        clk = self._clock
        t0 = clk()
        self.stats.overlap.begin("exec", t0)
        try:
            res = sess.run_stage(tasks, spec.fn, write_back=spec.write_back,
                                 return_results=True)
        except Exception as exc:  # reject the whole batch, keep serving
            now = clk()
            self.stats.overlap.end("exec", now)
            for r in reqs:
                r.future._reject(exc, now)
                self.stats.note_resolved(r.future, failed=True)
            return
        t1 = clk()
        self.stats.overlap.end("exec", t1)
        win.note_service(t1 - t0)
        results = res.results
        w = self.store.value_width
        A = max(tasks.max_arity, 1)
        arity = tasks.arity
        for i, r in enumerate(reqs):
            if results is None:
                val = None
            elif spec.result == "ragged":
                val = results[i].reshape(A, w)[:arity[i]].copy()
            else:
                val = results[i].copy()
            r.future._resolve(val, t1)
            self.stats.note_resolved(r.future)

    # -- observability -------------------------------------------------------
    def window(self, tag: str) -> BatchWindow:
        return self._windows[tag]

    def report(self) -> Dict:
        """ServeStats report with the buffer sessions' orchestration costs
        folded in (see `serve/stats.py`)."""
        win = next(iter(self._windows.values()), None)
        return self.stats.report(sessions=self.sessions,
                                 window=win.window if win else None)


__all__ = ["Frontend", "FrontendClosedError", "TagSpec"]
