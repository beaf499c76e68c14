"""Per-graph orchestration sessions for TDO-GP (§5).

Graph algorithms run dozens of DistEdgeMap rounds against the SAME
ingestion-time topology, so the tree machinery is session state, not
per-call state:

  * `TreeCharger` precomputes — once — the parent machine of every member of
    every C-ary source tree (the heap layout over [root, m0, m1, ...] that
    `dist_edge_map` previously re-derived from the CSR on every round).
  * `GraphSession` owns the chargers for one `OrchestratedGraph` and folds
    every round's `StageReport` into one cross-round `SessionReport`
    (per-phase words/rounds/work summed), mirroring
    `core.session.Orchestrator` for the kv/orchestration side.

Algorithms construct one session per run (`GraphSession(og, **opts)`) and
call `session.edge_map(...)` per round; calling `dist_edge_map` directly
still works — it borrows the graph's cached default session for the tree
machinery without recording into it.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from ..core.backend import make_backend
from ..core.config import check_kernel_backend, resolve_session_config
from ..core.cost import CostAccumulator, SessionReport
from ..core.replication import make_replicator

VALUE_WORDS = 2  # one vertex value + vertex id per message


def _expand_csr(indptr: np.ndarray, select: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Flatten CSR slices for `select` rows -> (flat positions, counts)."""
    counts = indptr[select + 1] - indptr[select]
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64), counts
    starts = indptr[select]
    # position r within each slice via the classic repeat/arange trick
    offs = np.repeat(np.cumsum(counts) - counts, counts)
    r = np.arange(total, dtype=np.int64) - offs
    return np.repeat(starts, counts) + r, counts


class TreeCharger:
    """Cost-charging machinery for one family of C-ary trees (§5.1).

    Each group (vertex) owns a tree whose root is the vertex's home machine
    and whose nodes are the sorted machine list storing the group's edges in
    heap layout [root, m0, m1, ...]. The parent machine of every member is
    precomputed once per session; per-round charging is then a flat gather.
    """

    def __init__(self, roots: np.ndarray, indptr: np.ndarray,
                 machines: np.ndarray, C: int):
        self.roots = np.asarray(roots, dtype=np.int64)
        self.indptr = np.asarray(indptr, dtype=np.int64)
        self.machines = np.asarray(machines, dtype=np.int64)
        self.C = int(C)
        counts = np.diff(self.indptr)
        grp = np.repeat(np.arange(counts.size, dtype=np.int64), counts)
        starts = np.repeat(self.indptr[:-1], counts)
        rank = np.arange(self.machines.size, dtype=np.int64) - starts
        parent_seq = rank // self.C
        self.parents = np.where(parent_seq == 0, self.roots[grp],
                                self.machines[starts + np.maximum(parent_seq - 1, 0)])

    def charge(self, cost: CostAccumulator, select: np.ndarray, words: float,
               upward: bool) -> int:
        """Charge one sweep of the selected groups' trees — downward = value
        broadcast (source tree), upward = write-back combine (destination
        tree). Returns the max tree height (BSP rounds)."""
        flat, counts = _expand_csr(self.indptr, select)
        if flat.size == 0:
            return 0
        child = self.machines[flat]
        parent = self.parents[flat]
        if upward:
            cost.send(child, parent, words)
        else:
            cost.send(parent, child, words)
        kmax = int(counts.max(initial=0))
        height = (int(np.ceil(np.log(kmax + 1) / np.log(max(self.C, 2)))) + 1
                  if kmax else 0)
        return height

    def direct_broadcast(self, cost: CostAccumulator, select: np.ndarray,
                         words: float) -> None:
        """T1 destination-aware broadcast: each selected group's root sends
        one copy straight to every machine in its member list (1 hop)."""
        flat, counts = _expand_csr(self.indptr, select)
        if flat.size == 0:
            return
        cost.send(np.repeat(self.roots[select], counts),
                  self.machines[flat], words)


@dataclasses.dataclass
class GraphSession:
    """A long-lived DistEdgeMap session over one orchestrated graph.

    `replication=` opts rounds driven through this session into adaptive
    hot-vertex replication (`repro_torch.core.replication`): the session learns
    per-vertex demand — weighted by how many machines need the value each
    round — and keeps the hottest vertices' values resident everywhere, so
    their source-tree broadcasts become machine-local reads. Write-backs
    still ⊗-combine to the vertex home, then write-through to holders.

    `backend=` selects the numeric execution backend for the per-round
    edge-value combine: None/"torch" — the PyTorch pipeline on the CUDA
    card (the default; raises without one), "numpy" — the float64 oracle,
    or a backend instance (``TorchBackend(device="cpu")`` for the CPU);
    cost reports are bit-identical either way. `kernel_backend=` exists for
    the JAX package's spelling only: the port has the one route "auto", and
    any other value raises.

    `config=` accepts the same `SessionConfig` every other front door takes;
    its shared fields (backend / replication) resolve through the one alias
    table, and a kwarg that contradicts the config raises. Graph rounds
    never reach exec-site assignment or the Orchestrator stage boundary, so
    `elasticity=` in the config is rejected here rather than silently
    ignored.

    `engine=` (or `SessionConfig.engine`): tree-structured edge maps have
    no pluggable engine, so fixed engine names are irrelevant here and stay
    ignored — EXCEPT `engine="auto"`, which arms the session's per-round
    sparse/dense *mode* policy (the graph-side half of the adaptive loop,
    `repro_torch.core.policy`): each `edge_map` round with `force_mode=None`
    estimates both propagation modes' bills exactly and picks the argmin
    under the BSP objective (with hysteresis), replacing the static Ligra
    direction threshold. Decisions land on `report.policy_decisions`, and
    decision latency is charged under the `policy` phase. Policy knobs ride
    `SessionConfig.engine_opts["policy"]` (a `PolicyConfig` kwargs dict).
    """

    og: "OrchestratedGraph"  # noqa: F821 — forward ref, avoids import cycle
    defaults: dict = dataclasses.field(default_factory=dict)
    replication: object = None  # None | True | dict | ReplicationConfig
    backend: object = None  # None/"torch" the card | "numpy" | instance
    kernel_backend: object = None  # None / "auto", the port's one route
    config: object = None  # SessionConfig | dict — the unified spelling
    replicate: object = None  # legacy alias for replication
    engine: object = None  # "auto" arms the sparse/dense mode policy

    def __post_init__(self):
        og = self.og
        check_kernel_backend(self.kernel_backend)
        cfg = resolve_session_config(
            self.config, backend=self.backend,
            replication=self.replication, replicate=self.replicate,
            engine=self.engine)
        if cfg.elasticity is not None:
            raise ValueError(
                "GraphSession does not support elasticity: DistEdgeMap "
                "rounds charge source/destination trees directly and never "
                "reach the Orchestrator stage boundary where migration/"
                "stealing/recovery plug in. Drive the workload through an "
                "Orchestrator (core/session.py) for elastic execution.")
        self.backend = cfg.backend
        self.replication = cfg.replication
        # engine="auto": the per-round sparse/dense mode policy. The BSP
        # objective is what separates the modes — their propagation *volumes*
        # tie under T1 dedup (one copy per tree member either way); what
        # differs is tree depth (rounds) vs. root fan-out (max_comm), so the
        # decision needs max_comm + L·rounds, not total words.
        self.mode_policy = None
        if cfg.engine == "auto":
            from ..core.policy import StagePolicy, make_policy_config
            spec = cfg.engine_opts.get("policy")
            if spec is None or isinstance(spec, dict):
                spec = dict(spec or {})
                spec.setdefault("candidates", ("sparse", "dense"))
                spec.setdefault("objective", "bsp")
                spec.setdefault("round_latency", 4.0)
            self.mode_policy = StagePolicy(make_policy_config(spec))
        self.src_charger = TreeCharger(og.vertex_home, og.src_grp_indptr,
                                       og.src_grp_machines, og.C)
        self.replicator = make_replicator(self.replication, og.vertex_home,
                                          og.P, VALUE_WORDS)
        self.backend = make_backend(self.backend)
        self._report = SessionReport(og.P)
        self.stats: List = []

    # ------------------------------------------------------------------
    @property
    def P(self) -> int:
        return self.og.P

    @property
    def C(self) -> int:
        return self.og.C

    @property
    def report(self) -> SessionReport:
        """Cross-round cost accumulation (per-phase words/rounds/work)."""
        return self._report

    @property
    def num_rounds(self) -> int:
        return len(self.stats)

    def ensure_replicator(self, spec=True):
        """Create the session's replicator on first use (for
        `dist_edge_map(..., replicate=...)` opt-in on a plain session).
        The first spec wins: later calls reuse the existing replicator
        (its learned histogram is the point) and ignore a differing spec."""
        if self.replicator is None:
            self.replicator = make_replicator(spec, self.og.vertex_home,
                                              self.og.P, VALUE_WORDS)
        return self.replicator

    # ------------------------------------------------------------------
    def edge_map(self, U, f, write_back, merge_value: str = "min",
                 filter_dst=None, **kw):
        """Run one DistEdgeMap round through this session, folding its stats
        and cost report into the session."""
        from .distedgemap import dist_edge_map  # local: avoids import cycle

        opts = {**self.defaults, **kw}
        nxt, st = dist_edge_map(self.og, U, f, write_back, merge_value,
                                filter_dst, session=self, **opts)
        self.stats.append(st)
        if st.report is not None:
            self._report.add(st.report)
        return nxt, st

    # ------------------------------------------------------------------
    def run_plan(self, plan, *, carry=None, state=None):
        """Execute a declarative `StagePlan` (core/plan.py) of
        `edge_map` rounds against this session — the whole frontier-driven
        algorithm in one call, with the next frontier carried between rounds
        by the framework. Round-by-round this calls `edge_map` exactly as a
        hand-rolled loop would, so per-round stats and per-phase cost
        reports are bit-identical (the five `graph.algorithms` functions are
        such plans). `carry` seeds the first frontier; `state` seeds user
        slots. Returns a `PlanResult`.
        """
        from ..core.plan import execute_plan  # local: avoids import cycle
        return execute_plan(self, plan, carry=carry, state=state)

    def reset_report(self) -> SessionReport:
        out, self._report = self._report, SessionReport(self.og.P)
        self.stats = []
        return out


def session_for(og, **defaults) -> GraphSession:
    """The graph's cached default session (tree machinery shared by direct
    `dist_edge_map` calls; does not record rounds). Its backend is never
    used: a direct call runs its numerics on the backend it names, else on
    the card."""
    sess = getattr(og, "_default_session", None)
    if sess is None or sess.og is not og:
        sess = GraphSession(og, defaults, backend="numpy")
        og._default_session = sess
    return sess
