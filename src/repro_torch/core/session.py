"""Reusable orchestration sessions — the single front door for every workload.

An `Orchestrator` is constructed once per `(store, engine, opts)` and reused
across stages: the engine instance (and with it the `CommForest`, which only
depends on P and the fanout) is built exactly once, `run_stage` chains
stages against the same store, and a cross-stage `SessionReport` accumulates
per-phase words/rounds/work over the whole run. This is what lets TDO-GP-style
algorithms (§5) run dozens of rounds without re-planning the topology, and
what makes the repro usable as a platform rather than a one-shot solver.

    sess = Orchestrator(store, engine="tdorch")
    r1 = sess.run_stage(tasks_a, f)               # write_back="add"
    r2 = sess.run_stage(tasks_b, g, write_back="min")
    sess.report.phase_totals()                    # summed across both stages

`orchestration(...)` in `interface.py` remains as a thin one-shot shim over a
throwaway session, and `run_plan` runs a whole declarative multi-round
`StagePlan` (core/plan.py) against the session.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

from .backend import make_backend
from .config import SessionConfig, resolve_session_config
from .cost import SessionReport, StageReport
from .datastore import DataStore, TaskBatch
from .engine import OrchestrationResult
from .mergeops import MergeOp
from .registry import make_engine
from .replication import make_replicator


class Orchestrator:
    """A long-lived scheduling session over one store and one engine.

    `backend=` selects the numeric execution backend threaded into the
    engine: None/"torch" — the PyTorch pipeline with the CUDA kernels, on
    the card (the default; raises without one); "numpy" — the float64
    reference oracle. Also accepts a backend instance, to share device
    caches across sessions or to run on the CPU
    (``TorchBackend(device="cpu")``). Cost reports are bit-identical across
    backends.

    `replication=` turns on the session-owned hot-chunk subsystem
    (`core.replication`): pass True for defaults, a dict / `ReplicationConfig`
    for knobs, or an existing `HotChunkReplicator` to share state. The
    session persists the demand histogram and replica directory across
    stages — refreshing the electorate when due (charged as the separate
    ``replica_refresh`` phase on that stage's report), handing the directory
    to the engine, and folding each stage's Phase-1 refcounts back into the
    histogram.

    `config=` accepts a `SessionConfig` (core/config.py) carrying all of the
    above in one object — the same config `orchestration()` takes. The
    per-kwarg spellings remain as a compatibility shim resolved through the
    same alias table; passing a kwarg that contradicts the config raises.

    `elasticity=` (or `SessionConfig.elasticity`) is not ported yet: any
    value but None raises `NotImplementedError`.
    """

    def __init__(self, store: DataStore, engine=None, *, config=None,
                 backend=None, replication=None, replicate=None,
                 elasticity=None, **engine_opts):
        cfg = resolve_session_config(
            config, engine_opts=engine_opts, engine=engine, backend=backend,
            replication=replication, replicate=replicate,
            elasticity=elasticity)
        if cfg.elasticity is not None:
            raise NotImplementedError(
                "elasticity= is not ported to the torch package yet "
                "(migration, work stealing and recovery); run elastic "
                "sessions on the JAX package")
        self.config: SessionConfig = cfg
        self.store = store
        engine = cfg.engine
        self.engine_name = engine if isinstance(engine, str) else type(engine).__name__
        if isinstance(engine, str):
            self.engine = make_engine(
                engine, store.P,
                backend=make_backend(cfg.backend),
                **cfg.engine_opts)
        else:
            if cfg.backend is not None:
                raise ValueError(
                    "pass backend= to the engine's constructor when handing "
                    "Orchestrator an engine instance — a session cannot "
                    "swap the backend of a prebuilt engine")
            self.engine = engine
        self.replicator = make_replicator(cfg.replication, store.home,
                                          store.P, store.chunk_words)
        self._report = SessionReport(store.P)

    # ------------------------------------------------------------------
    @property
    def P(self) -> int:
        return self.store.P

    @property
    def forest(self):
        """The session's cached CommForest (None for forest-free engines)."""
        return getattr(self.engine, "forest", None)

    @property
    def backend(self):
        """The engine's numeric execution backend (torch / numpy oracle)."""
        return getattr(self.engine, "backend", None)

    @property
    def report(self) -> SessionReport:
        """Cross-stage cost accumulation (per-phase words/rounds/work)."""
        return self._report

    @property
    def num_stages(self) -> int:
        return self._report.num_stages

    @property
    def replicas(self):
        """The session's current replica directory (None if replication off)."""
        return self.replicator.replicas if self.replicator is not None else None

    # ------------------------------------------------------------------
    def fork(self) -> "Orchestrator":
        """A sibling session over the same store that SHARES the engine
        instance (and with it the CommForest and the backend's device
        caches) and the replication state, while accumulating its own
        `SessionReport`.

        This is the double-buffer handoff a serving frontend is built on:
        batch k executes on one buffer while batch k+1 is admitted,
        coalesced, and staged against the other, and the pair behaves like
        a single long-lived session — one forest plan, one device-resident
        value cache, one demand histogram — with per-buffer cost ledgers.
        Stages on the two buffers must not run concurrently (the engine's
        execute→apply carry is single-slot); a serving frontend serializes
        execution and overlaps only the host-side admission work.
        """
        return Orchestrator(self.store, engine=self.engine,
                            replication=self.replicator)

    # ------------------------------------------------------------------
    def run_stage(
        self,
        tasks: TaskBatch,
        f: Callable[..., Dict[str, Optional[np.ndarray]]],
        write_back: str | MergeOp = "add",
        *,
        return_results: bool = False,
    ) -> OrchestrationResult:
        """Run one orchestration stage against the session's store and fold
        its cost report into the session report."""
        pre: List[StageReport] = []
        tasks.validate(self.store)
        extra: Dict[str, object] = {}
        ref_report: Optional[StageReport] = None
        if self.replicator is not None:
            ref_report = self.replicator.maybe_refresh()
            extra["replicas"] = self.replicator.replicas
        if ref_report is not None:
            pre.append(ref_report)
        res = self.engine.run_stage(tasks, self.store, f, write_back=write_back,
                                    return_results=return_results, **extra)
        decision = getattr(res, "decision", None)
        if decision is not None:
            # engine="auto": keep the stage's PolicyDecision on the session
            # ledger, indexed by the stage it decided
            decision.stage_index = self._report.num_stages
            self._report.record_decision(decision)
        if self.replicator is not None:
            # feed the demand histogram: Phase-1 meta-task counts when the
            # engine reports them (tdorch), the batch's requested keys as
            # the equivalent fallback for engines without contention
            # detection (same totals — refcounts sum to nnz)
            if res.refcount:
                self.replicator.observe(res.refcount)
            else:
                self.replicator.observe_keys(tasks.read_indices)
        if pre:
            # boundary work (the replica refresh) belongs
            # to this stage's bill, each as its own phase — phase_totals()
            # and the SessionReport phase splits keep them separable
            res.report = StageReport(
                res.report.P,
                [ph for r in pre for ph in r.phases] + res.report.phases)
        self._report.add(res.report)
        return res

    # ------------------------------------------------------------------
    def run_plan(self, plan, *, carry=None, state=None):
        """Execute a declarative `StagePlan` (core/plan.py) — the whole
        multi-round program in one call against this session.

        `carry` seeds the plan's continuation slot (the first round's
        `TaskBatch` for CARRY-consuming stages); `state` seeds user slots on
        the threaded `PlanState`. Stage-by-stage this calls `run_stage`
        exactly as a hand-rolled loop would — per-phase cost reports
        are bit-identical — but on the torch backend the plan runs inside a
        device-residency scope: write-backs stay on the device, and the host
        store copy is refreshed only at flush points (before user callbacks,
        at plan exit). Returns a `PlanResult` (records, per-loop rounds/stop
        reasons, final state).
        """
        from .plan import execute_plan  # local: plan.py is engine-agnostic
        return execute_plan(self, plan, carry=carry, state=state)

    # ------------------------------------------------------------------
    def reset_report(self) -> SessionReport:
        """Detach and return the accumulated report, starting a fresh one."""
        out, self._report = self._report, SessionReport(self.store.P)
        return out


# ---------------------------------------------------------------------------
# the session cache every front door keeps (kvstore, paramserve)
# ---------------------------------------------------------------------------
def _spec_sig(spec):
    """Hashable session-cache key for a config spec (None/False → off,
    dicts by sorted items, live objects by id)."""
    if spec is None or spec is False:
        return None
    if spec is True:
        return True
    if isinstance(spec, dict):
        return tuple(sorted((k, _spec_sig(v)) for k, v in spec.items()))
    try:
        hash(spec)
    except TypeError:
        return id(spec)
    return spec


def cached_session(cache: Dict[tuple, Orchestrator], store,
                   cfg: SessionConfig) -> Orchestrator:
    """The session of `cache` for `cfg`, made on first use: one long-lived
    `Orchestrator` per resolved config. Engine and backend instances key by
    identity, specs by value."""
    sig = (cfg.engine if isinstance(cfg.engine, str) else id(cfg.engine),
           _spec_sig(cfg.replication),
           cfg.backend if isinstance(cfg.backend, (str, type(None)))
           else id(cfg.backend),
           _spec_sig(cfg.elasticity),
           tuple(sorted(cfg.engine_opts.items())))
    sess = cache.get(sig)
    if sess is None:
        sess = cache[sig] = Orchestrator(store, config=cfg)
    return sess
