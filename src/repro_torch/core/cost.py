"""BSP cost accounting (§2.2, Appendix A).

The BSP model charges a superstep by the *maximum* over machines of
computation work and of communication volume (h-relation), which is why load
balance — not just total volume — is the quantity TD-Orch optimizes
(Definition 1: a stage with total work W and total communication I is
load-balanced iff every machine incurs O(W/P) work and O(I/P) communication).

Every engine in `repro_torch.core` (TD-Orch, and the baselines once
ported) threads a
`CostAccumulator` through its phases so benchmarks and property tests can
read measured — not assumed — per-machine loads.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

# Phase name under which the replication subsystem (core/replication.py)
# charges hot-chunk refresh broadcasts. A dedicated name means
# `SessionReport.phase_totals()` — and the refresh/steady-state split below —
# separate the amortized replication investment from serving traffic.
REPLICA_REFRESH_PHASE = "replica_refresh"

# Elasticity phases (core/elasticity.py). Each is charged as its own named
# phase on the stage it happens in, so the migration/steal/recovery
# investment stays separable from serving traffic exactly like
# `replica_refresh` — and so parity tests can compare an elastic run against
# an uninterrupted one with `assert_cost_parity(..., ignore=ELASTIC_PHASES)`.
MIGRATION_PHASE = "migration"
STEAL_PHASE = "phase3_steal"
RECOVERY_PHASE = "recovery"
ELASTIC_PHASES = (MIGRATION_PHASE, STEAL_PHASE, RECOVERY_PHASE)

# Decision-latency phase of the engine="auto" stage policy (core/policy.py):
# per-stage demand sketches to the coordinator plus the decision broadcast
# are charged here, so `SessionReport.policy_words` — and parity tests via
# `assert_cost_parity(..., ignore=(POLICY_PHASE,))` — keep the cost of
# *choosing* an engine separable from the cost of running it.
POLICY_PHASE = "policy"


@dataclasses.dataclass
class PhaseCost:
    """Per-machine costs of one named phase (may span several BSP rounds)."""

    name: str
    sent: np.ndarray  # words sent, per machine
    recv: np.ndarray  # words received, per machine
    compute: np.ndarray  # work units, per machine
    local: np.ndarray  # words served from a machine-local replica (no wire)
    rounds: int = 0

    @property
    def comm(self) -> np.ndarray:
        # BSP h-relation uses max(in, out) per machine; we report the max of
        # the two directions which upper-bounds either convention.
        return np.maximum(self.sent, self.recv)

    def summary(self) -> Dict[str, float]:
        return {
            "phase": self.name,
            "rounds": self.rounds,
            "total_words": float(self.sent.sum()),
            "local_words": float(self.local.sum()),
            "max_comm": float(self.comm.max(initial=0.0)),
            "mean_comm": float(self.comm.mean()) if self.comm.size else 0.0,
            "max_compute": float(self.compute.max(initial=0.0)),
            "mean_compute": float(self.compute.mean()) if self.compute.size else 0.0,
        }


class CostAccumulator:
    """Accumulates per-machine sent/recv words and compute work by phase."""

    def __init__(self, num_machines: int):
        self.P = int(num_machines)
        self.phases: List[PhaseCost] = []
        self._open: Optional[PhaseCost] = None

    # -- phase lifecycle ---------------------------------------------------
    def begin(self, name: str) -> PhaseCost:
        if self._open is not None:
            raise RuntimeError(f"phase {self._open.name!r} still open")
        self._open = PhaseCost(
            name=name,
            sent=np.zeros(self.P, dtype=np.float64),
            recv=np.zeros(self.P, dtype=np.float64),
            compute=np.zeros(self.P, dtype=np.float64),
            local=np.zeros(self.P, dtype=np.float64),
        )
        return self._open

    def end(self) -> PhaseCost:
        if self._open is None:
            raise RuntimeError("no open phase")
        ph, self._open = self._open, None
        self.phases.append(ph)
        return ph

    # -- recording ---------------------------------------------------------
    def send(self, src: np.ndarray, dst: np.ndarray, words) -> None:
        """Record messages src->dst of `words` words each. Self-sends free
        (Fig. 2 dashed edges: a PM does not message itself)."""
        ph = self._require()
        src = np.asarray(src, dtype=np.int64).ravel()
        dst = np.asarray(dst, dtype=np.int64).ravel()
        words = np.broadcast_to(np.asarray(words, dtype=np.float64).ravel(), src.shape)
        remote = src != dst
        if not remote.any():
            return
        np.add.at(ph.sent, src[remote], words[remote])
        np.add.at(ph.recv, dst[remote], words[remote])

    def work(self, machine: np.ndarray, units) -> None:
        ph = self._require()
        machine = np.asarray(machine, dtype=np.int64).ravel()
        units = np.broadcast_to(np.asarray(units, dtype=np.float64).ravel(), machine.shape)
        np.add.at(ph.compute, machine, units)

    def local(self, machine: np.ndarray, words) -> None:
        """Record words served from a machine-local replica: a memory read,
        not a message — tracked separately so benchmarks can report how much
        traffic replication absorbed (never enters `comm`)."""
        ph = self._require()
        machine = np.asarray(machine, dtype=np.int64).ravel()
        words = np.broadcast_to(np.asarray(words, dtype=np.float64).ravel(),
                                machine.shape)
        np.add.at(ph.local, machine, words)

    def ingress(self, machine: np.ndarray, words) -> None:
        """Record words arriving from OUTSIDE the mesh (durable storage,
        e.g. a checkpoint restore during failure recovery): received by
        `machine`, sent by nobody — no peer's send budget is charged."""
        ph = self._require()
        machine = np.asarray(machine, dtype=np.int64).ravel()
        words = np.broadcast_to(np.asarray(words, dtype=np.float64).ravel(),
                                machine.shape)
        np.add.at(ph.recv, machine, words)

    def tick(self, rounds: int = 1) -> None:
        self._require().rounds += rounds

    def _require(self) -> PhaseCost:
        if self._open is None:
            raise RuntimeError("no open phase; call begin() first")
        return self._open

    # -- aggregation --------------------------------------------------------
    def totals(self) -> "StageReport":
        return StageReport(self.P, list(self.phases))


@dataclasses.dataclass
class StageReport:
    """Aggregated cost report for one orchestration stage."""

    P: int
    phases: List[PhaseCost]

    def _sum(self, field: str) -> np.ndarray:
        out = np.zeros(self.P, dtype=np.float64)
        for ph in self.phases:
            out += getattr(ph, field)
        return out

    @property
    def sent(self) -> np.ndarray:
        return self._sum("sent")

    @property
    def recv(self) -> np.ndarray:
        return self._sum("recv")

    @property
    def compute(self) -> np.ndarray:
        return self._sum("compute")

    @property
    def local(self) -> np.ndarray:
        """Per-machine words served from local replicas (no wire traffic)."""
        return self._sum("local")

    @property
    def comm(self) -> np.ndarray:
        return np.maximum(self.sent, self.recv)

    @property
    def rounds(self) -> int:
        return sum(ph.rounds for ph in self.phases)

    # BSP communication time ~ max over machines (Definition 1 denominators)
    @property
    def comm_time(self) -> float:
        return float(self.comm.max(initial=0.0))

    @property
    def compute_time(self) -> float:
        return float(self.compute.max(initial=0.0))

    def bsp_time(self, g: float = 1.0, t: float = 1.0, L: float = 0.0) -> float:
        """Formal BSP cost g·h + t·w + L·rounds (Appendix A)."""
        return g * self.comm_time + t * self.compute_time + L * self.rounds

    def imbalance(self) -> Dict[str, float]:
        """max/mean ratios — 1.0 is perfectly balanced (Definition 1)."""
        comm, comp = self.comm, self.compute
        return {
            "comm": float(comm.max() / max(comm.mean(), 1e-12)),
            "compute": float(comp.max() / max(comp.mean(), 1e-12)),
        }

    def phase_signature(self):
        """The stage's full cost content as a comparable value: per phase,
        (name, rounds, sent, recv, compute, local) with per-machine arrays
        as tuples. Two backends honoring the parity contract produce EQUAL
        signatures — this is what `assert_cost_parity` (and the
        `tests/test_backend_parity.py` suite) pins, bit-for-bit."""
        return [
            (ph.name, ph.rounds, tuple(ph.sent), tuple(ph.recv),
             tuple(ph.compute), tuple(ph.local))
            for ph in self.phases
        ]

    def summary(self) -> Dict[str, float]:
        return {
            "P": self.P,
            "rounds": self.rounds,
            "total_words": float(self.sent.sum()),
            "comm_time": self.comm_time,
            "compute_time": self.compute_time,
            "comm_imbalance": self.imbalance()["comm"],
            "compute_imbalance": self.imbalance()["compute"],
        }


def assert_cost_parity(a: "StageReport", b: "StageReport",
                       ignore=()) -> None:
    """The backend-parity contract, executable: two stage reports must carry
    identical per-phase words/rounds/work — exact equality, no tolerance.
    Raises AssertionError naming the first differing phase/field.

    `ignore` names phases dropped from BOTH sides before comparing — what
    lets a recovered run (extra `recovery`/`migration` phases) be pinned
    bit-identical to an uninterrupted one on everything else."""
    if ignore:
        a = StageReport(a.P, [ph for ph in a.phases if ph.name not in ignore])
        b = StageReport(b.P, [ph for ph in b.phases if ph.name not in ignore])
    names_a = [ph.name for ph in a.phases]
    names_b = [ph.name for ph in b.phases]
    assert names_a == names_b, f"phase lists differ: {names_a} vs {names_b}"
    for pa, pb in zip(a.phases, b.phases):
        assert pa.rounds == pb.rounds, \
            f"{pa.name}: rounds {pa.rounds} != {pb.rounds}"
        for field in ("sent", "recv", "compute", "local"):
            va, vb = getattr(pa, field), getattr(pb, field)
            assert np.array_equal(va, vb), \
                f"{pa.name}: per-machine {field} differ ({va} vs {vb})"


def assert_session_parity(a: "SessionReport", b: "SessionReport",
                          ignore=()) -> None:
    """Session-level parity: same number of stages, and every stage's
    per-phase words/rounds/work bit-identical. This is what pins a
    plan-driven run against its hand-rolled `run_stage`/`edge_map` loop
    (`tests/test_plan.py`): the StagePlan runner must hit the session's
    entry points in exactly the same order with exactly the same batches.
    `ignore` forwards to `assert_cost_parity` (elastic-phase exclusion)."""
    assert a.num_stages == b.num_stages, \
        f"stage counts differ: {a.num_stages} vs {b.num_stages}"
    for i, (sa, sb) in enumerate(zip(a.stages, b.stages)):
        try:
            assert_cost_parity(sa, sb, ignore=ignore)
        except AssertionError as e:
            raise AssertionError(f"stage {i}: {e}") from None


@dataclasses.dataclass
class SessionReport:
    """Cross-stage cost accumulation for one `Orchestrator` session.

    Stages run sequentially under BSP, so session time is the *sum* of stage
    times (per Definition 1's denominators each stage is individually
    max-over-machines). Per-phase totals are summed over stages by phase
    name, which is what lets a multi-round algorithm (TDO-GP §5) report one
    words/rounds/work breakdown for the whole run.
    """

    P: int
    stages: List[StageReport] = dataclasses.field(default_factory=list)
    # per-machine stolen-task tallies (filled by record_steals; None = no
    # stealing happened, so reports stay cheap when elasticity is off)
    _stolen_out: Optional[np.ndarray] = None
    _stolen_in: Optional[np.ndarray] = None
    # engine="auto" stage decisions (core/policy.py PolicyDecision records:
    # chosen engine, predicted vs. realized words, decision latency) —
    # empty for fixed-engine sessions
    policy_decisions: List[object] = dataclasses.field(default_factory=list)

    def add(self, report: StageReport) -> None:
        if report.P != self.P:
            raise ValueError(f"stage ran on P={report.P}, session has P={self.P}")
        self.stages.append(report)

    @property
    def num_stages(self) -> int:
        return len(self.stages)

    def _sum(self, field: str) -> np.ndarray:
        out = np.zeros(self.P, dtype=np.float64)
        for st in self.stages:
            out += getattr(st, field)
        return out

    @property
    def sent(self) -> np.ndarray:
        return self._sum("sent")

    @property
    def recv(self) -> np.ndarray:
        return self._sum("recv")

    @property
    def compute(self) -> np.ndarray:
        return self._sum("compute")

    @property
    def local(self) -> np.ndarray:
        return self._sum("local")

    @property
    def comm(self) -> np.ndarray:
        """Per-machine communication, summed across the session's stages."""
        return self._sum("comm")

    @property
    def rounds(self) -> int:
        return sum(st.rounds for st in self.stages)

    # ---- replication accounting (core/replication.py) --------------------
    @property
    def replica_refresh_words(self) -> float:
        """Words spent broadcasting newly elected hot chunks (the amortized
        replication investment, charged under `replica_refresh`)."""
        return sum(float(ph.sent.sum()) for st in self.stages
                   for ph in st.phases if ph.name == REPLICA_REFRESH_PHASE)

    @property
    def steady_state_words(self) -> float:
        """Total words minus replica-refresh words: the serving traffic."""
        return float(self.sent.sum()) - self.replica_refresh_words

    @property
    def replica_local_words(self) -> float:
        """Words served from machine-local replicas instead of the wire."""
        return float(self.local.sum())

    # ---- elasticity accounting (core/elasticity.py) -----------------------
    def _phase_words(self, name: str) -> float:
        return sum(float(ph.sent.sum()) for st in self.stages
                   for ph in st.phases if ph.name == name)

    @property
    def migration_words(self) -> float:
        """Words spent moving re-homed chunks (the `migration` phase)."""
        return self._phase_words(MIGRATION_PHASE)

    @property
    def steal_words(self) -> float:
        """Words spent shipping stolen task tiles (the `phase3_steal` phase)."""
        return self._phase_words(STEAL_PHASE)

    @property
    def recovery_words(self) -> float:
        """Words spent restoring a lost machine's chunks — peer transfers
        from replica holders plus checkpoint-storage ingress (recv with no
        in-mesh sender), both under the `recovery` phase. Counted on the
        receive side so the two restore sources add up consistently."""
        return sum(float(ph.recv.sum()) for st in self.stages
                   for ph in st.phases if ph.name == RECOVERY_PHASE)

    # ---- adaptive-policy accounting (core/policy.py) ----------------------
    @property
    def policy_words(self) -> float:
        """Words spent *deciding* (demand sketches + decision broadcasts,
        charged under the `policy` phase by the engine="auto" policy)."""
        return self._phase_words(POLICY_PHASE)

    def record_decision(self, decision) -> None:
        """Append one engine="auto" stage decision (a PolicyDecision)."""
        self.policy_decisions.append(decision)

    def record_steals(self, src: np.ndarray, dst: np.ndarray) -> None:
        """Fold one stage's stolen-task movements (donor machine per task,
        thief machine per task) into the per-machine steal counters that
        `per_machine()` surfaces."""
        if self._stolen_out is None:
            self._stolen_out = np.zeros(self.P, dtype=np.int64)
            self._stolen_in = np.zeros(self.P, dtype=np.int64)
        self._stolen_out += np.bincount(np.asarray(src, dtype=np.int64),
                                        minlength=self.P)
        self._stolen_in += np.bincount(np.asarray(dst, dtype=np.int64),
                                       minlength=self.P)

    @property
    def stolen_out(self) -> np.ndarray:
        """(P,) tasks each machine donated to Phase-3 work stealing."""
        out = self._stolen_out
        return out if out is not None else np.zeros(self.P, dtype=np.int64)

    @property
    def stolen_in(self) -> np.ndarray:
        """(P,) tasks each machine stole before Phase-3 execution."""
        out = self._stolen_in
        return out if out is not None else np.zeros(self.P, dtype=np.int64)

    @property
    def comm_time(self) -> float:
        return sum(st.comm_time for st in self.stages)

    @property
    def compute_time(self) -> float:
        return sum(st.compute_time for st in self.stages)

    def bsp_time(self, g: float = 1.0, t: float = 1.0, L: float = 0.0) -> float:
        return sum(st.bsp_time(g, t, L) for st in self.stages)

    def phase_totals(self) -> Dict[str, Dict[str, float]]:
        """Per-phase words/rounds/work summed over all stages, by phase name."""
        out: Dict[str, Dict[str, float]] = {}
        for st in self.stages:
            for ph in st.phases:
                agg = out.setdefault(ph.name, {
                    "rounds": 0, "total_words": 0.0, "local_words": 0.0,
                    "work": 0.0, "max_comm": 0.0, "stages": 0,
                })
                agg["rounds"] += ph.rounds
                agg["total_words"] += float(ph.sent.sum())
                agg["local_words"] += float(ph.local.sum())
                agg["work"] += float(ph.compute.sum())
                agg["max_comm"] += float(ph.comm.max(initial=0.0))
                agg["stages"] += 1
        return out

    def imbalance(self) -> Dict[str, float]:
        comm, comp = self.comm, self.compute
        return {
            "comm": float(comm.max() / max(comm.mean(), 1e-12)),
            "compute": float(comp.max() / max(comp.mean(), 1e-12)),
        }

    def per_machine(self) -> Dict[str, object]:
        """Per-machine load breakdown across the whole session — the
        paper's load-balance claim (Definition 1) as an asserted quantity:
        `work` is each machine's summed compute, `h_relation` its BSP
        communication volume (max of words in/out per stage, summed), and
        the `*_ratio` fields are max/mean over machines (1.0 = perfectly
        balanced; Theorem 1 promises O(1) under TD-Orch). Bit-identical
        across execution backends, like every other cost quantity."""
        work, sent, recv = self.compute, self.sent, self.recv
        h = self.comm
        mean_work = float(work.mean()) if work.size else 0.0
        mean_h = float(h.mean()) if h.size else 0.0
        return {
            "work": work, "sent": sent, "recv": recv, "h_relation": h,
            "max_work": float(work.max(initial=0.0)),
            "mean_work": mean_work,
            "work_ratio": float(work.max(initial=0.0) / max(mean_work, 1e-12)),
            "max_h": float(h.max(initial=0.0)),
            "mean_h": mean_h,
            "h_ratio": float(h.max(initial=0.0) / max(mean_h, 1e-12)),
            "stolen_in": self.stolen_in, "stolen_out": self.stolen_out,
            "stolen_tasks": int(self.stolen_in.sum()),
        }

    def summary(self) -> Dict[str, float]:
        return {
            "P": self.P,
            "stages": self.num_stages,
            "rounds": self.rounds,
            "total_words": float(self.sent.sum()),
            "replica_refresh_words": self.replica_refresh_words,
            "steady_state_words": self.steady_state_words,
            "replica_local_words": self.replica_local_words,
            "migration_words": self.migration_words,
            "steal_words": self.steal_words,
            "recovery_words": self.recovery_words,
            "stolen_tasks": int(self.stolen_in.sum()),
            "comm_time": self.comm_time,
            "compute_time": self.compute_time,
            "comm_imbalance": self.imbalance()["comm"],
            "compute_imbalance": self.imbalance()["compute"],
        }
