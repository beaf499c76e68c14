"""Declarative StagePlan dataflow programs — multi-round orchestration as data.

`run_stage` executes ONE stage and hands control back to user code, so every
multi-round workload (the five §5 TDO-GP algorithms, YCSB read-modify-write
chains, embedding refresh) ends up hand-rolling its own Python loop
with a host synchronization after every stage. A `StagePlan` lifts that loop
into the framework: the application declares *what* each stage needs (tasks +
data pointers, exactly the paper's Fig. 1 contract) plus how each stage
**emits continuation tasks**, and the session owns *how* rounds execute —
reusing the CommForest and replica directory across rounds and (on the
torch backend) keeping store/state arrays device-resident with at most one
host sync per round.

Combinators (each returns the plan, so they chain)::

    plan = StagePlan("chase")
    plan.loop(
        StagePlan().stage(CARRY, f, "write", emit=next_hop,
                          return_results=True),
        until="empty", max_rounds=8)
    out = sess.run_plan(plan, carry=first_batch)

* ``plan.stage(tasks, f, write_back, emit=..., **opts)`` — one orchestration
  stage run through ``session.run_stage``. `tasks` is a `TaskBatch`, the
  `CARRY` sentinel (consume the loop's carried emission), or a factory
  ``state -> TaskBatch`` rebuilt per round. The **emission contract**: after
  the stage executes, ``emit(state, result)`` produces the next round's
  `TaskBatch` *inside the framework* (return None to emit nothing); the
  framework threads it into ``state.carry``.
* ``plan.edge_map(frontier, f, write_back, merge_value, ...)`` — one
  DistEdgeMap round run through ``session.edge_map`` (GraphSession plans).
  Its emission is implicit — the returned next frontier — unless ``emit=``
  post-processes it.
* ``plan.host(fn)`` — a host-side step between stages (e.g. preparing the
  backward pass of BC). Like every user callback, it observes flushed,
  up-to-date host store values.
* ``plan.loop(body, until="empty" | <predicate>, max_rounds=k)`` — the
  fixpoint combinator. ``until="empty"`` stops *before* a round whose carried
  emission is empty (frontier-driven algorithms); a callable ``until`` is a
  convergence predicate evaluated *after* each round (PageRank's delta);
  ``max_rounds`` (int, or ``state -> int`` resolved at loop entry) bounds the
  round count. `body` is a sub-plan, or a factory ``state -> sub-plan`` for
  bodies whose lambdas close over per-round values.

Execution (`sess.run_plan(plan, carry=..., state=...)`) drives the whole
program against ONE session, so per-phase cost reports are **bit-identical**
to the equivalent hand-rolled `run_stage`/`edge_map` loop (pinned by
`tests/test_torch_plan.py`): the plan runner calls exactly the same session
entry points in exactly the same order. What changes is the execution *policy* the
framework may now apply: on the torch backend, `Orchestrator.run_plan`
opens a plan scope in which write-backs stay device-resident (the host store
copy is refreshed lazily — always *before* any user callback runs, and once
at plan exit). Eager PyTorch runs every batch size with the same kernels,
so nothing is padded to static shapes. The mesh-sharded backend
(``backend="torch_spmd"``) runs plans too: its owner shards apply each
stage's write-backs and the host copy catches up every stage, so its plan
scope never defers.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional


class _Carry:
    """Sentinel: "this stage consumes the loop's carried emission"."""

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return "CARRY"


CARRY = _Carry()


def _carry_is_empty(carry) -> bool:
    """Duck-typed emptiness: None, an empty TaskBatch (n == 0), an empty
    DistVertexSubset (is_empty), or any empty sized container."""
    if carry is None:
        return True
    if hasattr(carry, "is_empty"):
        return bool(carry.is_empty)
    n = getattr(carry, "n", None)
    if n is not None:
        return int(n) == 0
    try:
        return len(carry) == 0
    except TypeError:
        return False


class PlanState:
    """Mutable state threaded through a plan run.

    * ``state.carry`` — the current continuation payload (a `TaskBatch`
      emitted by the previous stage, or a `DistVertexSubset` frontier).
    * ``state.round`` — rounds completed so far in the innermost active loop
      (0 inside the first round's factories).
    * ``state["name"]`` — user slots (dict-style), e.g. PageRank's rank
      vector or BC's recorded frontiers.
    """

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        self.carry: Any = None
        self.round: int = 0
        self.data: Dict[str, Any] = dict(data or {})

    def __getitem__(self, key: str) -> Any:
        return self.data[key]

    def __setitem__(self, key: str, value: Any) -> None:
        self.data[key] = value

    def __contains__(self, key: str) -> bool:
        return key in self.data

    def get(self, key: str, default: Any = None) -> Any:
        return self.data.get(key, default)


@dataclasses.dataclass
class StageRecord:
    """One executed plan op: `kind` is "stage" (result: OrchestrationResult),
    "edge_map" (result: EdgeMapStats), or "host" (result: the callback's
    return value); `round` is the loop round it ran in (-1 = top level)."""

    kind: str
    name: str
    round: int
    result: Any


@dataclasses.dataclass
class LoopRecord:
    """One completed loop: how many rounds ran and why it stopped
    ("empty" — carried emission drained; "until" — predicate satisfied;
    "max_rounds" — round bound hit)."""

    name: str
    rounds: int
    reason: str


@dataclasses.dataclass
class PlanResult:
    """What `run_plan` returns. Cost lives on the session's report (exactly
    as it would for a hand-rolled loop); this carries the program-level
    outcome: per-op records, per-loop round counts/stop reasons, and the
    final `PlanState`."""

    records: List[StageRecord]
    loops: List[LoopRecord]
    state: PlanState

    @property
    def rounds(self) -> int:
        """Total loop rounds executed (summed over the plan's loops)."""
        return sum(lp.rounds for lp in self.loops)

    @property
    def stats(self) -> List[Any]:
        """EdgeMapStats of every edge-map op, in execution order."""
        return [r.result for r in self.records if r.kind == "edge_map"]

    @property
    def results(self) -> List[Any]:
        """OrchestrationResults of every task stage, in execution order."""
        return [r.result for r in self.records if r.kind == "stage"]


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _StageOp:
    kind = "stage"
    tasks: Any  # TaskBatch | CARRY | callable(state) -> TaskBatch | None
    f: Callable
    write_back: Any
    emit: Optional[Callable]
    name: str
    opts: Dict[str, Any]

    def run(self, rn: "_PlanRunner", state: PlanState, round_idx: int) -> None:
        tasks = self.tasks
        if isinstance(tasks, _Carry):
            tasks = state.carry
        elif callable(tasks):
            tasks = rn.user(tasks, state)
        if tasks is None:
            raise ValueError(
                f"plan stage {self.name!r} has no tasks to run: its CARRY/"
                "factory resolved to None. Frontier-driven stages belong in "
                "a loop(until='empty') so the plan stops before an empty "
                "round.")
        res = rn.sess.run_stage(tasks, self.f, write_back=self.write_back,
                                **self.opts)
        rn.records.append(StageRecord("stage", self.name, round_idx, res))
        if self.emit is not None:
            state.carry = rn.user(self.emit, state, res)
            rn.carry_touched = True


@dataclasses.dataclass
class _EdgeMapOp:
    kind = "edge_map"
    frontier: Any  # DistVertexSubset | CARRY | callable(state) -> subset
    f: Callable
    write_back: Callable
    merge_value: str
    filter_dst: Optional[Callable]
    emit: Optional[Callable]
    name: str
    opts: Dict[str, Any]

    def run(self, rn: "_PlanRunner", state: PlanState, round_idx: int) -> None:
        fr = self.frontier
        if isinstance(fr, _Carry):
            fr = state.carry
        elif callable(fr):
            fr = rn.user(fr, state)
        if fr is None:
            raise ValueError(
                f"plan edge_map {self.name!r} has no frontier: its CARRY/"
                "factory resolved to None. Frontier-driven rounds belong in "
                "a loop(until='empty').")
        nxt, st = rn.sess.edge_map(fr, self.f, self.write_back,
                                   self.merge_value, self.filter_dst,
                                   **self.opts)
        rn.records.append(StageRecord("edge_map", self.name, round_idx, st))
        state.carry = nxt if self.emit is None else rn.user(self.emit, state,
                                                            nxt)
        rn.carry_touched = True


@dataclasses.dataclass
class _HostOp:
    kind = "host"
    fn: Callable
    name: str

    def run(self, rn: "_PlanRunner", state: PlanState, round_idx: int) -> None:
        out = rn.user(self.fn, state)
        rn.records.append(StageRecord("host", self.name, round_idx, out))


@dataclasses.dataclass
class _LoopOp:
    kind = "loop"
    body: Any  # StagePlan | single op | callable(state) -> either
    until: Any  # "empty" | callable(state) -> bool | None
    max_rounds: Any  # int | callable(state) -> int | None
    name: str

    def run(self, rn: "_PlanRunner", state: PlanState, round_idx: int) -> None:
        max_r = self.max_rounds
        if max_r is not None and callable(max_r):
            max_r = int(rn.user(max_r, state))
        outer_round = state.round
        state.round = rounds = 0
        reason = "max_rounds"
        while True:
            if self.until == "empty" and _carry_is_empty(state.carry):
                reason = "empty"
                break
            if max_r is not None and rounds >= max_r:
                reason = "max_rounds"
                break
            body = self.body
            if callable(body) and not isinstance(body, StagePlan):
                body = rn.user(body, state)
            rn.carry_touched = False
            rn.run_ops(_as_ops(body), state, rounds)
            if self.until == "empty" and not rn.carry_touched:
                # no op in the body emitted a continuation, so the carried
                # batch can never drain — re-running it forever is always a
                # bug; fail loudly instead of hanging
                raise RuntimeError(
                    f"loop {self.name!r} (until='empty') made no progress: "
                    "no stage in the body has emit= and no edge_map round "
                    "ran, so the carried emission can never become empty. "
                    "Add an emit= continuation, or use until=None with "
                    "max_rounds= for a fixed-round loop.")
            rounds += 1
            state.round = rounds
            if callable(self.until) and rn.user(self.until, state):
                reason = "until"
                break
        rn.loops.append(LoopRecord(self.name, rounds, reason))
        state.round = outer_round


def _as_ops(body) -> List[Any]:
    if isinstance(body, StagePlan):
        return body._ops
    if hasattr(body, "run") and hasattr(body, "kind"):
        return [body]
    raise TypeError(
        f"a loop body must be a StagePlan (or a factory returning one), "
        f"got {type(body).__name__}")


# ---------------------------------------------------------------------------
# the plan and its combinators
# ---------------------------------------------------------------------------
class StagePlan:
    """An ordered dataflow program over one session (see module docstring).

    Combinators return ``self`` so plans read as chained declarations. A plan
    is inert data until handed to ``Orchestrator.run_plan`` /
    ``GraphSession.run_plan`` (or another session exposing the same entry
    points); the same plan object may be re-run.
    """

    def __init__(self, name: str = "plan"):
        self.name = name
        self._ops: List[Any] = []

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        kinds = ",".join(op.kind for op in self._ops)
        return f"StagePlan({self.name!r}: [{kinds}])"

    @property
    def num_ops(self) -> int:
        return len(self._ops)

    # -- combinators -------------------------------------------------------
    def stage(self, tasks, f, write_back="add", *, emit=None, name=None,
              **opts) -> "StagePlan":
        """Append one orchestration stage (``session.run_stage``).

        `tasks`: a `TaskBatch`, `CARRY`, or a factory ``state -> TaskBatch``.
        `emit`: ``(state, OrchestrationResult) -> TaskBatch | None`` — the
        continuation contract; the return value becomes ``state.carry``.
        Extra ``opts`` (e.g. ``return_results=True``) forward to
        ``run_stage`` unchanged.
        """
        self._ops.append(_StageOp(tasks, f, write_back, emit,
                                  name or f"stage{len(self._ops)}", opts))
        return self

    def edge_map(self, frontier, f, write_back, merge_value="min", *,
                 filter_dst=None, emit=None, name=None, **opts) -> "StagePlan":
        """Append one DistEdgeMap round (``session.edge_map``). The next
        frontier it returns is the implicit emission; ``emit(state, nxt)``
        may observe/replace it. Extra ``opts`` (``force_mode=``,
        ``account=``, ...) forward to ``edge_map`` unchanged."""
        self._ops.append(_EdgeMapOp(frontier, f, write_back, merge_value,
                                    filter_dst, emit,
                                    name or f"edge_map{len(self._ops)}", opts))
        return self

    def host(self, fn, *, name=None) -> "StagePlan":
        """Append a host-side step ``fn(state)`` between stages. Runs with
        host store values flushed/up-to-date (device-resident plan scopes
        synchronize before it)."""
        self._ops.append(_HostOp(fn, name or f"host{len(self._ops)}"))
        return self

    def loop(self, body, *, until="empty", max_rounds=None,
             name=None) -> "StagePlan":
        """Append a fixpoint loop over `body` (a sub-plan, or a factory
        ``state -> sub-plan``). ``until="empty"`` re-checks the carried
        emission before every round; a callable ``until`` is evaluated after
        each round; ``max_rounds`` (int or ``state -> int``, resolved at loop
        entry) caps the rounds. At least one stopping rule is required."""
        if until is None and max_rounds is None:
            raise ValueError(
                "loop() needs a stopping rule: until='empty', a callable "
                "until-predicate, and/or max_rounds=")
        if until is not None and until != "empty" and not callable(until):
            raise ValueError(
                f"until must be 'empty', a callable predicate, or None — "
                f"got {until!r}")
        self._ops.append(_LoopOp(body, until, max_rounds,
                                 name or f"loop{len(self._ops)}"))
        return self


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------
class _PlanRunner:
    def __init__(self, sess):
        self.sess = sess
        self.backend = getattr(sess, "backend", None)
        self.records: List[StageRecord] = []
        self.loops: List[LoopRecord] = []
        # set by emitting ops; loops use it to detect no-progress rounds
        self.carry_touched = False

    def user(self, fn: Callable, *args):
        """Invoke a user callback (task/body factory, emit, until predicate,
        host step) with host state guaranteed fresh: a device-resident plan
        scope flushes pending write-backs to the host store first."""
        bk = self.backend
        if bk is not None:
            flush = getattr(bk, "plan_flush", None)
            if flush is not None:
                flush()
        return fn(*args)

    def run_ops(self, ops: List[Any], state: PlanState,
                round_idx: int) -> None:
        for op in ops:
            op.run(self, state, round_idx)


def execute_plan(sess, plan: StagePlan, *, carry=None,
                 state: Optional[Dict[str, Any]] = None) -> PlanResult:
    """Run `plan` against `sess` (the shared machinery behind
    ``Orchestrator.run_plan`` and ``GraphSession.run_plan``).

    When the session owns a store and its backend supports device-resident
    plan scopes (the torch backend), the whole program runs inside one
    scope: write-backs stay on device, and the host copy is refreshed before
    any user callback and once at exit. Cost reports are unaffected — they
    are computed host-side from the same inputs either way.
    """
    st = PlanState(state)
    st.carry = carry
    rn = _PlanRunner(sess)
    bk = rn.backend
    store = getattr(sess, "store", None)
    scoped = (store is not None and bk is not None
              and hasattr(bk, "begin_plan"))
    if scoped:
        bk.begin_plan(store)
    try:
        rn.run_ops(plan._ops, st, -1)
    finally:
        if scoped:
            bk.end_plan()
    return PlanResult(records=rn.records, loops=rn.loops, state=st)
