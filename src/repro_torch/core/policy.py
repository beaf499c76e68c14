"""Cost-model-driven per-stage engine selection — `engine="auto"` (§4).

The paper's central claim is that TD-Orch *adapts*: Phase-1 contention
detection tells the orchestrator how demand is distributed, and the
orchestrator — not the caller — decides whether tasks should push to their
data, pull their data in, or ride the forest. This module closes that loop
for the reproduction. Until now the caller picked one of the four registered
engines per session; `engine="auto"` makes the session pick per stage, from
the same word-counting rules the engines already charge:

  * every engine exposes `estimate_cost(histogram, layout) ->
    PhaseCostEstimate` — an analytic replay of its own charging paths
    against the stage's `StageLayout` (task batch, store placement, replica
    directory, result/update widths). The estimate is bit-identical to the
    realized stage report whenever the layout's documented assumptions hold
    (lambda returns `update_width`-wide updates for every declared write
    key, `result_width`-wide results when requested);
  * `StagePolicy` picks the argmin engine under a configurable objective
    (total words by default; a BSP `max_comm + L·rounds` objective for
    latency-bound stages), with hysteresis so fixpoint loops don't thrash
    between engines whose bills are within noise of each other;
  * `AutoEngine` (registered as `"auto"`) wires the two into the ordinary
    engine interface, so every front door that resolves engines through
    `SessionConfig` — `orchestration()`, `Orchestrator`, `run_plan` rounds,
    the paramserve tier — gets the adaptive loop by spelling
    `engine="auto"`, and `GraphSession(engine="auto")` arms the same policy
    over the edge-map's sparse/dense modes.

Decisions are deterministic and backend-independent: the demand histogram
is a plain `np.bincount` of the batch's requested keys, and the only
backend calls the estimators make (TD-Orch's Phase-1 `key_counts`, sort's
`argsort_stable` for its run placement) are parity-pinned across numpy and
torch. Each decision is recorded on the session's
`SessionReport.policy_decisions` (chosen engine, per-candidate predicted
bills, predicted vs. realized words), and the cost
of *deciding* — per-machine demand sketches to a coordinator plus the
decision broadcast — is charged under the dedicated `policy` phase
(`cost.POLICY_PHASE`), so parity tests can compare an auto stage against
the chosen fixed engine with `assert_cost_parity(..., ignore=("policy",))`.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Dict, Optional, Tuple

import numpy as np

from .backend import make_backend
from .baselines import DirectPullEngine, DirectPushEngine, SortBasedEngine
from .cost import POLICY_PHASE, CostAccumulator, StageReport
from .datastore import DataStore, TaskBatch
from .engine import TDOrchEngine
from .registry import register_engine
from .replication import ReplicaSet

__all__ = [
    "StageLayout", "PhaseCostEstimate", "PolicyConfig", "PolicyDecision",
    "StagePolicy", "AutoEngine", "make_policy_config", "decision_phase",
    "POLICY_PHASE",
]


@dataclasses.dataclass(frozen=True)
class StageLayout:
    """The cost-relevant projection of one stage, handed to estimators.

    Holds *references* to the live batch/store/directory (estimators replay
    charging formulas against them; nothing is copied or mutated) plus the
    width assumptions that stand in for the not-yet-executed lambda:

    sigma           context words per task (σ) — `tasks.ctx_words`.
    update_width    words per ⊗-combined update row the lambda will return
                    (`store.value_width` unless overridden).
    result_width    words per result row when `return_results` is set.
    assume_updates  whether the lambda returns updates at all — defaults to
                    "it writes iff the batch declares write keys".

    These assumptions are the estimator's documented tolerance: a lambda
    returning wider/narrower rows (e.g. a ragged reduce emitting
    `(n, max_arity·w)` results) realizes a bill that differs from the
    estimate exactly by the width delta on the affected sends.
    """

    tasks: TaskBatch
    store: DataStore
    replicas: Optional[ReplicaSet] = None
    return_results: bool = False
    sigma: int = 0
    update_width: int = 1
    result_width: int = 1
    assume_updates: bool = False

    @staticmethod
    def capture(tasks: TaskBatch, store: DataStore, *, replicas=None,
                return_results: bool = False, update_width=None,
                result_width=None, assume_updates=None) -> "StageLayout":
        w = store.value_width
        return StageLayout(
            tasks=tasks, store=store, replicas=replicas,
            return_results=bool(return_results),
            sigma=int(tasks.ctx_words),
            update_width=int(w if update_width is None else update_width),
            result_width=int(w if result_width is None else result_width),
            assume_updates=bool((tasks.write_keys >= 0).any()
                                if assume_updates is None else assume_updates),
        )


@dataclasses.dataclass(frozen=True)
class PhaseCostEstimate:
    """One engine's predicted bill for one stage: a full per-phase
    `StageReport` produced by replaying the engine's charging paths, so a
    conformance test can pin prediction against realization with
    `assert_cost_parity` — not just compare scalars."""

    engine: str
    report: StageReport

    @property
    def total_words(self) -> float:
        return float(self.report.sent.sum())

    @property
    def max_comm(self) -> float:
        return self.report.comm_time

    @property
    def rounds(self) -> int:
        return self.report.rounds

    @property
    def max_compute(self) -> float:
        return self.report.compute_time

    def objective_value(self, objective: str = "total_words",
                        round_latency: float = 0.0) -> float:
        """The scalar the policy minimizes. "total_words" — network volume
        (the §4 comparison metric); "bsp" — `max_comm + L·rounds`, the
        Appendix-A BSP time with per-round latency L (what separates a
        1-round broadcast from a log-depth tree when their volumes tie)."""
        if objective == "total_words":
            return self.total_words
        if objective == "bsp":
            return self.max_comm + round_latency * self.rounds
        raise ValueError(f"unknown policy objective {objective!r} "
                         f"(known: 'total_words', 'bsp')")


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    """Knobs of the stage policy (all deterministic).

    candidates      engine names considered, in tie-break priority order.
    objective       "total_words" (default) or "bsp" — see
                    `PhaseCostEstimate.objective_value`.
    round_latency   L of the "bsp" objective; ignored for "total_words".
    hysteresis      the incumbent engine is kept unless a challenger's
                    predicted bill beats it by MORE than this fraction —
                    fixpoint loops whose per-round bills jitter across the
                    decision boundary then stop thrashing. 0.05 keeps the
                    worst-case realized bill within 1/(1-0.05) ≈ 1.053x of
                    the per-stage argmin, comfortably inside the 1.1x gate
                    `tests/test_policy.py` enforces.
    sketch_words    words each active machine sends the coordinator per
                    decision (its demand-histogram sketch).
    decision_words  words the coordinator broadcasts back (chosen engine +
                    epoch). Both are charged under the `policy` phase.
    """

    candidates: Tuple[str, ...] = ("tdorch", "pull", "push", "sort")
    objective: str = "total_words"
    round_latency: float = 0.0
    hysteresis: float = 0.05
    sketch_words: float = 4.0
    decision_words: float = 2.0


def make_policy_config(spec) -> PolicyConfig:
    """None → defaults; dict → kwargs; PolicyConfig → itself."""
    if spec is None:
        return PolicyConfig()
    if isinstance(spec, PolicyConfig):
        return spec
    if isinstance(spec, dict):
        spec = dict(spec)
        if "candidates" in spec:
            spec["candidates"] = tuple(spec["candidates"])
        return PolicyConfig(**spec)
    raise TypeError(f"policy= must be None, a dict, or a PolicyConfig, "
                    f"got {type(spec).__name__}")


@dataclasses.dataclass
class PolicyDecision:
    """One recorded stage decision (`SessionReport.policy_decisions`).

    choice           candidate the policy selected ("tdorch"/"pull"/... for
                     engine decisions; "sparse"/"dense" for the graph
                     session's edge-map mode decisions).
    predicted        per-candidate objective values the choice was made on.
    predicted_words  the chosen candidate's predicted total words.
    realized_words   the stage's realized total words (policy phase
                     excluded), filled after the stage runs.
    policy_words     decision-latency words charged under the `policy` phase.
    incumbent        previous stage's choice (None on the first decision).
    switched         whether this decision changed engines.
    kind             "engine" | "edge_map_mode".
    """

    choice: str
    predicted: Dict[str, float]
    predicted_words: float
    realized_words: float = float("nan")
    policy_words: float = 0.0
    objective: str = "total_words"
    incumbent: Optional[str] = None
    switched: bool = False
    stage_index: int = -1
    kind: str = "engine"
    estimate: Optional[PhaseCostEstimate] = None

    @property
    def engine(self) -> str:
        return self.choice


class StagePolicy:
    """Deterministic argmin-with-hysteresis chooser over candidate bills.

    Stateful: remembers the incumbent across stages (one policy per
    session-lived `AutoEngine`), which is exactly the memory hysteresis
    needs. Ties break by `candidates` order, so decisions are
    bit-reproducible across runs and — because every estimator input is
    parity-pinned — across backends.
    """

    def __init__(self, config: PolicyConfig | None = None):
        self.config = make_policy_config(config)
        self.incumbent: Optional[str] = None

    def choose(self, estimates: Dict[str, PhaseCostEstimate],
               kind: str = "engine") -> PolicyDecision:
        cfg = self.config
        order = [nm for nm in cfg.candidates if nm in estimates]
        if not order:
            raise ValueError(
                f"no candidate estimates: have {sorted(estimates)}, "
                f"policy considers {cfg.candidates}")
        vals = {nm: float(estimates[nm].objective_value(cfg.objective,
                                                        cfg.round_latency))
                for nm in order}
        best = min(order, key=vals.__getitem__)  # stable: first-in-order tie
        choice = best
        inc = self.incumbent
        if inc is not None and inc in vals \
                and vals[best] >= vals[inc] * (1.0 - cfg.hysteresis):
            choice = inc  # challenger not decisively better — don't thrash
        decision = PolicyDecision(
            choice=choice, predicted=vals,
            predicted_words=float(estimates[choice].total_words),
            objective=cfg.objective, incumbent=inc,
            switched=(inc is not None and choice != inc),
            kind=kind, estimate=estimates[choice])
        self.incumbent = choice
        return decision


def decision_phase(P: int, active_machines: np.ndarray,
                   config: PolicyConfig) -> StageReport:
    """The bill for *making* a decision, as its own one-phase report:
    every machine with tasks this stage sends its `sketch_words` demand
    sketch to the coordinator (machine 0), which runs the argmin (one work
    unit) and broadcasts the `decision_words` verdict to all P machines —
    two BSP rounds. Self-sends (the coordinator's own rows) are free, as
    everywhere in the cost model."""
    cost = CostAccumulator(P)
    cost.begin(POLICY_PHASE)
    active = np.asarray(active_machines, dtype=np.int64).ravel()
    if active.size:
        cost.send(active, np.zeros(active.size, dtype=np.int64),
                  config.sketch_words)
        cost.work(np.zeros(1, dtype=np.int64), 1.0)
        cost.send(np.zeros(P, dtype=np.int64), np.arange(P, dtype=np.int64),
                  config.decision_words)
        cost.tick(2)
    cost.end()
    return cost.totals()


@register_engine("auto")
class AutoEngine:
    """The adaptive orchestrator: per stage, estimate every candidate
    engine's bill from the demand histogram and the stage layout, pick the
    argmin (with hysteresis), charge the decision under the `policy` phase,
    and delegate the stage to the winner.

    Drop-in at every front door: registered under `"auto"` in the engine
    registry, so `engine="auto"` (or `SessionConfig(engine="auto")`) works
    anywhere a fixed engine name does. The four sub-engines share one
    numeric backend instance — device caches, forest plans, and the
    execute→apply carry behave exactly as a fixed-engine session's.
    """

    def __init__(self, num_machines: int, *, fanout=None, C=None, sigma=None,
                 work_per_task: float = 1.0, work_per_pair: float = 0.0,
                 backend=None, policy=None):
        self.P = int(num_machines)
        self.backend = make_backend(backend)
        self.policy = StagePolicy(make_policy_config(policy))
        common = dict(work_per_task=work_per_task,
                      work_per_pair=work_per_pair, backend=self.backend)
        makers = {
            "tdorch": lambda: TDOrchEngine(self.P, fanout=fanout, C=C,
                                           sigma=sigma, **common),
            "pull": lambda: DirectPullEngine(self.P, **common),
            "push": lambda: DirectPushEngine(self.P, **common),
            "sort": lambda: SortBasedEngine(self.P, **common),
        }
        unknown = [nm for nm in self.policy.config.candidates
                   if nm not in makers]
        if unknown:
            raise ValueError(f"auto policy candidates {unknown} are not "
                             f"estimable engines (known: {sorted(makers)})")
        self.engines = {nm: makers[nm]()
                        for nm in self.policy.config.candidates}
        # sessions reach the forest through the engine; expose tdorch's
        tdorch = self.engines.get("tdorch")
        self.forest = getattr(tdorch, "forest", None)

    # ------------------------------------------------------------------
    def run_stage(self, tasks, store, f, write_back="add",
                  return_results=False, replicas=None, stealer=None):
        layout = StageLayout.capture(tasks, store, replicas=replicas,
                                     return_results=return_results)
        # Phase-1 demand histogram, decision input — plain numpy bincount so
        # the decision is bit-reproducible across runs and backends
        if tasks.nnz:
            histogram = np.bincount(tasks.read_indices,
                                    minlength=store.num_keys)
        else:
            histogram = np.zeros(store.num_keys, dtype=np.int64)
        estimates = {nm: eng.estimate_cost(histogram, layout)
                     for nm, eng in self.engines.items()}
        decision = self.policy.choose(estimates)
        policy_report = decision_phase(
            self.P, np.unique(tasks.origin), self.policy.config)
        decision.policy_words = float(policy_report.sent.sum())
        engine = self.engines[decision.choice]
        # only an engine that declares the hook takes the stealer (pull
        # executes at the origins, sort is balanced by construction)
        extra = {}
        if stealer is not None and "stealer" in inspect.signature(
                engine.run_stage).parameters:
            extra["stealer"] = stealer
        res = engine.run_stage(tasks, store, f, write_back=write_back,
                               return_results=return_results,
                               replicas=replicas, **extra)
        decision.realized_words = float(res.report.sent.sum())
        # the decision bill rides this stage's report as its own phase
        res.report = StageReport(res.report.P,
                                 policy_report.phases + res.report.phases)
        res.decision = decision
        return res
