"""Elastic sessions: live chunk migration, Phase-3 work stealing, and
stage-boundary failure recovery.

Replication (`core/replication.py`) copies hot chunks; this module is the
rest of the elasticity story the DPA-style load balancers need:

  * **`MigrationPlanner`** — live chunk re-homing. The planner keeps its own
    decayed per-(chunk, origin) demand histogram (fed by the same Phase-1
    request stream the replicator observes) and, every `refresh` stages,
    elects chunks whose sustained demand concentrates on one requesting
    machine: those chunks *move* (`DataStore.rehome`) to the dominant
    requester, charged as the dedicated ``migration`` phase (old home ships
    the chunk value to the new home, B+1 words — or a 1-word directory
    update when the target already holds a replica). Because `rehome`
    mutates `home` in place and bumps the store version, the replicator's
    aliased placement map, every engine's routing, and the torch backend's
    device copy of the values follow the move with no further plumbing
    (the next stage re-uploads the table).

  * **`WorkStealer`** — Phase-3 work stealing. After an engine's cost model
    assigns `exec_site`s, machines left holding more than
    ``ceil(threshold × mean)`` task tiles donate their highest-index tiles
    to under-loaded machines (deterministic greedy: most-loaded donors
    shed, least-loaded thieves fill). The move is charged under the
    ``phase3_steal`` phase — one (σ + value + header)-word message per
    stolen tile — *before* Phase-2 secondary forwarding, so a multi-get
    task's other values are forwarded straight to the thief. A
    `StragglerDetector` (or a dead machine in shrink-mode recovery) forces
    a machine's capacity to zero, draining it entirely. Stolen-task counts
    per machine surface in `SessionReport.per_machine()`.

  * **`RecoveryManager`** — stage-boundary failure recovery. A
    `FailureInjector` schedule (and/or a `HeartbeatMonitor`) declares
    machines dead at the start of a stage. BSP semantics mean no partial
    stage state exists: survivors are at the last stage boundary, and only
    the dead machine's homed chunks need restoring. The manager keeps a
    boundary snapshot every `checkpoint_every` stages — durably via
    `checkpoint/manager.py` when `directory=` is set, in-memory otherwise —
    plus a per-stage write-log, so the boundary value of every lost chunk is
    reconstructable exactly. Lost rows are genuinely clobbered and then
    restored (the recovery data path is exercised, not assumed); billing
    under the ``recovery`` phase distinguishes chunks re-derived from a
    surviving replica holder (peer send, B+1 words) from checkpoint-storage
    reads (`cost.ingress`, no in-mesh sender). Two modes:

      - ``on_failure="restart"`` (default): the machine is replaced in
        place — homes unchanged, lost chunks restored, and the interrupted
        stage replays from the boundary. Everything except the extra
        ``recovery`` phase is bit-identical to an uninterrupted run (final
        values AND per-phase cost signatures) — pinned by
        `tests/test_torch_elastic.py`. On the card the values agree within
        the float sums' order (the segment combine's atomics), the bills
        bit for bit.
      - ``on_failure="shrink"``: the machine is gone for good. Its chunks
        re-home onto survivors (hashed placement over the shrunken fleet),
        future task origins remap off the dead machine, and work stealing
        drains any exec-site assignment that still lands there. Transit-VM
        hashing still maps over all P machines (a documented
        approximation — the forest is not re-built).

All three are deterministic, host-side numpy control logic: numerics stay
the backend's execute/apply pass, so elastic runs remain bit-identical in
*values* to inelastic ones on the CPU, and cost parity across backends holds
with elasticity on (the simulation-fidelity contract of `core/engine.py`).

The torch backend's plan scope (`core/backend.py`, `core/plan.py`) keeps a
plan's write-backs on the device until a flush. Host code that reads
`store.values` (the boundary snapshot, the write-log, recovery) or bumps the
store version (`rehome`, recovery's restore) flushes first: a version bump
re-uploads the table from the host copy, which must then be current.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import hashing
from .cost import (MIGRATION_PHASE, RECOVERY_PHASE, STEAL_PHASE,
                   CostAccumulator, StageReport)
from .datastore import DataStore, TaskBatch
from .replication import ReplicaSet
from ..runtime.failures import (FailureInjector, HeartbeatMonitor,
                                StragglerDetector)

__all__ = [
    "MigrationConfig", "StealConfig", "RecoveryConfig", "ElasticityConfig",
    "MigrationPlanner", "WorkStealer", "RecoveryManager",
    "ElasticityManager", "make_elasticity",
    "MIGRATION_PHASE", "STEAL_PHASE", "RECOVERY_PHASE",
]


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MigrationConfig:
    """Knobs of live chunk re-homing (all deterministic).

    refresh    consider moves every `refresh` observed stages.
    decay      demand-histogram multiplier applied at each election.
    min_count  decayed demand a chunk needs to be a move candidate.
    max_moves  at most this many chunks move per election.
    affinity   share of a chunk's demand its dominant requesting machine
               must account for before the chunk moves there — below it,
               demand is diffuse and replication (not migration) is the
               right tool.
    imbalance  load guard: a move is skipped when it would push the target
               machine's homed-demand above `imbalance × mean`, unless the
               target is still lighter than the current home.
    """

    refresh: int = 4
    decay: float = 0.5
    min_count: float = 8.0
    max_moves: int = 16
    affinity: float = 0.5
    imbalance: float = 1.5


@dataclasses.dataclass(frozen=True)
class StealConfig:
    """Knobs of Phase-3 work stealing.

    threshold  donors are machines assigned more than ceil(threshold × mean)
               tiles; thieves fill up to floor(mean).
    min_tasks  batches smaller than this are never rebalanced (the fixed
               per-steal message cost isn't worth it).
    detector   optional `StragglerDetector` — machines it flags are treated
               as capacity-zero (hardware stragglers drain fully), on top
               of the data-skew histogram trigger.
    """

    threshold: float = 1.25
    min_tasks: int = 16
    detector: Optional[StragglerDetector] = None


@dataclasses.dataclass(frozen=True)
class RecoveryConfig:
    """Knobs of stage-boundary failure recovery.

    injector          `FailureInjector` or its {stage: [machines]} schedule.
    monitor           optional `HeartbeatMonitor`; nodes it reports failed
                      are recovered exactly like injected deaths.
    checkpoint_every  boundary-snapshot period in stages; between snapshots
                      a per-stage write-log keeps restores exact.
    directory         durable checkpoints via `checkpoint/manager.py`
                      (atomic commit + integrity hash). None = in-memory
                      boundary snapshot (same recovery semantics, no disk).
    on_failure        "restart" — machine replaced in place, bit-identical
                      replay; "shrink" — machine permanently removed,
                      chunks/origins re-homed onto survivors.
    keep              durable checkpoint retention (forwarded to
                      `CheckpointManager`).
    """

    injector: object = None
    monitor: Optional[HeartbeatMonitor] = None
    checkpoint_every: int = 1
    directory: Optional[str] = None
    on_failure: str = "restart"
    keep: int = 3

    def __post_init__(self):
        if self.on_failure not in ("restart", "shrink"):
            raise ValueError(
                f"on_failure must be 'restart' or 'shrink', "
                f"got {self.on_failure!r}")


@dataclasses.dataclass(frozen=True)
class ElasticityConfig:
    """The one elasticity umbrella `SessionConfig.elasticity` carries.

    Each field accepts None/False (off), True (defaults), a kwargs dict, or
    the corresponding config instance. Shrink-mode recovery auto-enables
    stealing (a dead machine's exec-site assignments must drain somewhere).
    """

    migration: object = None  # None | True | dict | MigrationConfig
    stealing: object = None  # None | True | dict | StealConfig
    recovery: object = None  # None | True | dict | RecoveryConfig


def _coerce(spec, cls):
    if spec is None or spec is False:
        return None
    if spec is True:
        return cls()
    if isinstance(spec, cls):
        return spec
    if isinstance(spec, dict):
        return cls(**spec)
    raise TypeError(f"bad {cls.__name__} spec: {spec!r}")


# ---------------------------------------------------------------------------
# migration
# ---------------------------------------------------------------------------
class MigrationPlanner:
    """Elects and executes live chunk moves from sustained demand.

    Keeps a decayed per-(chunk, origin) request histogram. An election
    (every `refresh` observed stages) greedily walks move candidates in
    demand order: a chunk moves to its dominant requesting machine when
    that machine accounts for ≥ `affinity` of its demand, subject to the
    `imbalance` load guard and the `max_moves` cap. Executed moves go
    through `DataStore.rehome` — one atomic placement update every engine
    and backend observes — and are charged under the ``migration`` phase.
    """

    def __init__(self, store: DataStore,
                 config: Optional[MigrationConfig] = None):
        self.config = config or MigrationConfig()
        self.P = int(store.P)
        self.num_keys = int(store.num_keys)
        # (K, P) decayed demand split by requesting machine; its row sums
        # are the total-demand histogram the electorate ranks by
        self.by_origin = np.zeros((self.num_keys, self.P), dtype=np.float64)
        self.stage_idx = 0
        self._last_election = 0
        self.num_elections = 0
        self.num_migrations = 0  # chunks moved, cumulative
        self.moves: List[Tuple[int, int, int]] = []  # (key, old, new) log

    # ---- demand feed -----------------------------------------------------
    def observe(self, keys: np.ndarray, origins: np.ndarray) -> None:
        """Fold one stage's (requested key, requesting machine) pairs into
        the histogram. One call per stage."""
        keys = np.asarray(keys, dtype=np.int64)
        origins = np.asarray(origins, dtype=np.int64)
        if keys.size:
            np.add.at(self.by_origin, (keys, origins), 1.0)
        self.stage_idx += 1

    @property
    def due(self) -> bool:
        return self.stage_idx - self._last_election >= self.config.refresh

    # ---- election + charged move -----------------------------------------
    def maybe_migrate(self, store: DataStore,
                      replicas: Optional[ReplicaSet] = None,
                      backend=None) -> Optional[StageReport]:
        """Run an election if due. Returns the charged ``migration`` report
        when any chunk actually moved, None otherwise (not due, or the
        electorate produced no moves — the histogram still decays)."""
        if not self.due:
            return None
        cfg = self.config
        self._last_election = self.stage_idx
        self.num_elections += 1
        demand = self.by_origin.sum(axis=1)
        cand = np.flatnonzero(demand >= cfg.min_count)
        report = None
        if cand.size:
            report = self._execute(cand[np.argsort(-demand[cand],
                                                   kind="stable")],
                                   demand, store, replicas, backend)
        self.by_origin *= cfg.decay
        return report

    def _execute(self, order, demand, store, replicas, backend=None):
        cfg = self.config
        home = store.home
        # per-machine homed demand: the owner-load half of the election
        load = np.bincount(home, weights=demand, minlength=self.P)
        mean_load = max(float(load.mean()), 1e-12)
        keys: List[int] = []
        dsts: List[int] = []
        for k in order:
            row = self.by_origin[k]
            dst = int(np.argmax(row))
            src = int(home[k])
            d = float(demand[k])
            if dst == src or row[dst] < cfg.affinity * d:
                continue
            if (load[dst] + d > cfg.imbalance * mean_load
                    and load[dst] + d > load[src]):
                continue  # would make a strictly hotter spot elsewhere
                # (equal load is fine: the dominant requester's reads turn
                # local, a strict words win at the same balance)
            keys.append(int(k))
            dsts.append(dst)
            load[src] -= d
            load[dst] += d
            if len(keys) >= cfg.max_moves:
                break
        if not keys:
            return None
        keys_a = np.asarray(keys, dtype=np.int64)
        dst_a = np.asarray(dsts, dtype=np.int64)
        src_a = home[keys_a].copy()
        cost = CostAccumulator(self.P)
        cost.begin(MIGRATION_PHASE)
        # the move ships the chunk value (B+1 words) old→new home — unless
        # the new home already holds a replica of it, in which case only a
        # 1-word directory update travels (the copy is promoted in place)
        words = np.full(keys_a.size, store.chunk_words + 1, dtype=np.float64)
        if replicas is not None and replicas.hot_ids.size:
            words[replicas.holds(keys_a, dst_a)] = 1.0
        cost.send(src_a, dst_a, words)
        cost.work(dst_a, 1.0)
        cost.tick()
        cost.end()
        # atomic placement update: home mutates in place (replicator alias
        # stays coherent), shard layout + device caches invalidate — so a
        # plan's deferred device writes reach the host copy first
        if backend is not None:
            backend.plan_flush()
        store.rehome(keys_a, dst_a)
        self.num_migrations += keys_a.size
        self.moves.extend(zip(keys_a.tolist(), src_a.tolist(),
                              dst_a.tolist()))
        return cost.totals()


# ---------------------------------------------------------------------------
# work stealing
# ---------------------------------------------------------------------------
class WorkStealer:
    """Deterministic pre-Phase-3 task-tile rebalancer.

    `steal()` is called by an engine after `exec_site` assignment with an
    open ``phase3_steal`` phase: it plans donor→thief moves from the
    per-machine assignment histogram (plus straggler/dead-machine drains),
    charges one (σ + value + header)-word message per stolen tile, and
    returns the updated `exec_site`. The session drains `(src, dst)` pairs
    afterwards into `SessionReport.record_steals`.
    """

    def __init__(self, num_machines: int,
                 config: Optional[StealConfig] = None, *,
                 alive: Optional[np.ndarray] = None):
        self.config = config or StealConfig()
        self.P = int(num_machines)
        # shared, externally-owned liveness mask (shrink-mode recovery);
        # None = everything up
        self._alive = alive
        self.stolen_tasks = 0
        self.num_rebalances = 0
        self._pending: List[Tuple[np.ndarray, np.ndarray]] = []

    def bind_alive(self, alive: np.ndarray) -> None:
        self._alive = alive

    # ---- planning --------------------------------------------------------
    def plan(self, exec_site: np.ndarray,
             eligible: Optional[np.ndarray] = None
             ) -> Tuple[np.ndarray, np.ndarray]:
        """Deterministic steal plan: (stolen task indices, thief machine per
        stolen task). Empty when the batch is small or already balanced."""
        cfg = self.config
        n = int(exec_site.size)
        empty = (np.empty(0, dtype=np.int64),) * 2
        up = np.ones(self.P, dtype=bool) if self._alive is None \
            else np.asarray(self._alive, dtype=bool)
        drained = ~up
        if cfg.detector is not None:
            for m in cfg.detector.stragglers():
                if 0 <= int(m) < self.P:
                    drained[int(m)] = True
        if n < cfg.min_tasks and not drained.any():
            return empty
        counts = np.bincount(exec_site, minlength=self.P)
        healthy = ~drained
        n_healthy = max(int(healthy.sum()), 1)
        mean = n / n_healthy
        cap = np.where(healthy, math.ceil(cfg.threshold * mean), 0)
        surplus = np.maximum(counts - cap, 0)
        # skew balancing fills thieves to floor(mean) (never overfill past
        # balance); with a drained machine the thieves must absorb its WHOLE
        # assignment, so the fill target rounds up instead
        want = math.ceil(mean) if drained.any() else int(mean)
        deficit = np.where(healthy, np.maximum(want - counts, 0), 0)
        if surplus.sum() == 0 or deficit.sum() == 0:
            return empty
        # thief slots, least-loaded machines first (stable on machine id)
        thieves = np.flatnonzero(deficit > 0)
        thieves = thieves[np.argsort(counts[thieves], kind="stable")]
        slots = np.repeat(thieves, deficit[thieves])
        # donor tiles: per donor machine, its highest-index eligible tasks
        # — drained machines first, so slot truncation never strands a tile
        # on a dead/straggling donor in favor of a merely-hot one
        donors = np.flatnonzero(surplus > 0)
        donors = np.concatenate([donors[drained[donors]],
                                 donors[~drained[donors]]])
        parts: List[np.ndarray] = []
        for m in donors:
            cand = np.flatnonzero(exec_site == m) if eligible is None \
                else np.flatnonzero(eligible & (exec_site == m))
            take = min(int(surplus[m]), cand.size)
            if take:
                parts.append(cand[-take:])
        if not parts:
            return empty
        moved = np.concatenate(parts)
        k = min(moved.size, slots.size)
        return moved[:k], slots[:k]

    # ---- charged execution ----------------------------------------------
    def steal(self, tasks: TaskBatch, exec_site: np.ndarray,
              cost: CostAccumulator, *, value_width: int,
              eligible: Optional[np.ndarray] = None) -> np.ndarray:
        """Apply the plan inside an open ``phase3_steal`` phase: charge the
        tile moves, mutate a copy of `exec_site`, record the movement for
        the session's per-machine counters."""
        moved, dst = self.plan(exec_site, eligible)
        if moved.size == 0:
            return exec_site
        src = exec_site[moved].copy()
        exec_site = exec_site.copy()
        exec_site[moved] = dst
        # a stolen tile ships its σ-word context + (key, count) header, plus
        # the primary value already resident at the old site for readers
        has_read = tasks.arity[moved] > 0
        words = tasks.ctx_words + 2 + np.where(has_read, value_width, 0)
        cost.send(src, dst, words)
        cost.tick()
        self.note(src, dst)
        return exec_site

    def note(self, src: np.ndarray, dst: np.ndarray) -> None:
        """Record a steal an engine charged itself (the push baseline's
        redirected-RPC model): counters + the session drain queue."""
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        self.stolen_tasks += int(src.size)
        self.num_rebalances += 1
        self._pending.append((src, dst))

    def drain(self) -> List[Tuple[np.ndarray, np.ndarray]]:
        """(src, dst) machine pairs of steals since the last drain — the
        session folds these into `SessionReport.record_steals`."""
        out, self._pending = self._pending, []
        return out


# ---------------------------------------------------------------------------
# failure recovery
# ---------------------------------------------------------------------------
class RecoveryManager:
    """Stage-boundary checkpoint/restore driven by injected/monitored
    failures. See the module docstring for the recovery semantics."""

    def __init__(self, store: DataStore,
                 config: Optional[RecoveryConfig] = None):
        self.config = config or RecoveryConfig()
        cfg = self.config
        self.P = int(store.P)
        inj = cfg.injector
        if isinstance(inj, dict):
            inj = FailureInjector(schedule={
                int(s): list(ms) for s, ms in inj.items()})
        self.injector = inj
        self.monitor = cfg.monitor
        self.alive = np.ones(self.P, dtype=bool)
        self.num_recoveries = 0  # machines recovered, cumulative
        self.chunks_restored = 0
        self._mgr = None
        if cfg.directory is not None:
            from ..checkpoint.manager import CheckpointManager
            self._mgr = CheckpointManager(cfg.directory, keep=cfg.keep)
        self._snap_stage = -1
        self._snap_values: Optional[np.ndarray] = None
        # write-log since the last snapshot: per stage, (written keys, their
        # post-stage rows) — replaying it over the snapshot reconstructs the
        # last stage boundary exactly
        self._log: List[Tuple[np.ndarray, np.ndarray]] = []
        self._seen_monitor: set = set()

    # ---- stage-boundary hook ---------------------------------------------
    def on_stage_start(self, stage: int, store: DataStore,
                       replicas: Optional[ReplicaSet] = None,
                       backend=None) -> Optional[StageReport]:
        """Take the boundary snapshot when due, then process any machines
        that died at this boundary. Returns the charged ``recovery`` report
        when a recovery ran, None otherwise."""
        cfg = self.config
        if (self._snap_stage < 0
                or stage - self._snap_stage >= max(cfg.checkpoint_every, 1)):
            self._snapshot(stage, store, backend)
        deaths: set = set()
        if self.injector is not None:
            deaths.update(int(m) for m in self.injector.tick(stage))
        if self.monitor is not None:
            fresh = set(self.monitor.failed_nodes()) - self._seen_monitor
            self._seen_monitor.update(fresh)
            deaths.update(int(m) for m in fresh)
        deaths = {m for m in deaths if 0 <= m < self.P and self.alive[m]}
        if not deaths:
            return None
        return self._recover(sorted(deaths), store, replicas, backend)

    def after_stage(self, tasks: TaskBatch, store: DataStore,
                    backend=None) -> None:
        """Append the stage's write-set rows to the boundary log (only
        needed between snapshots)."""
        if self.config.checkpoint_every <= 1:
            return
        wk = tasks.write_keys
        keys = np.unique(wk[wk >= 0])
        if keys.size:
            if backend is not None:
                backend.plan_flush()  # the rows may live only on the device
            self._log.append((keys, store.values[keys].copy()))

    # ---- snapshot / reconstruct ------------------------------------------
    def _snapshot(self, stage: int, store: DataStore, backend=None) -> None:
        if backend is not None:
            backend.plan_flush()  # host copy must be current before we copy it
        if self._mgr is not None:
            self._mgr.save_async(stage, {"values": store.values,
                                         "home": store.home})
            self._mgr.wait()  # a boundary snapshot is a barrier, keep it exact
        else:
            self._snap_values = store.values.copy()
        self._snap_stage = stage
        self._log = []

    def _boundary_rows(self, keys: np.ndarray, store: DataStore) -> np.ndarray:
        """Reconstruct the last-stage-boundary value rows for `keys` from
        the snapshot plus the write-log — never from the live store."""
        if self._mgr is not None:
            restored = self._mgr.restore_latest(
                like={"values": store.values, "home": store.home})
            if restored is None:  # pragma: no cover - snapshot always taken
                raise RuntimeError("no checkpoint available for recovery")
            base = restored[1]["values"]
        else:
            base = self._snap_values
        rows = np.array(base[keys], dtype=store.values.dtype, copy=True)
        lookup = np.full(store.num_keys, -1, dtype=np.int64)
        lookup[keys] = np.arange(keys.size, dtype=np.int64)
        for lk, lrows in self._log:
            pos = lookup[lk]
            hit = pos >= 0
            if hit.any():
                rows[pos[hit]] = lrows[hit]
        return rows

    # ---- the recovery itself ---------------------------------------------
    def _recover(self, dead: List[int], store: DataStore,
                 replicas: Optional[ReplicaSet], backend=None) -> StageReport:
        cfg = self.config
        if backend is not None:
            backend.plan_flush()  # about to mutate store.values host-side
        cost = CostAccumulator(self.P)
        cost.begin(RECOVERY_PHASE)
        lost = np.flatnonzero(np.isin(store.home, dead))
        if lost.size:
            rows = self._boundary_rows(lost, store)
            # the loss is simulated for real: clobber, then restore through
            # the recovery data path — a restore bug cannot hide
            store.values[lost] = 0
            store.touch()
            if cfg.on_failure == "shrink":
                self.alive[dead] = False
                alive_ids = np.flatnonzero(self.alive)
                if alive_ids.size == 0:
                    raise RuntimeError("every machine is dead")
                targets = alive_ids[hashing.chunk_home(
                    lost, alive_ids.size, salt=self.num_recoveries + 1)]
            else:
                targets = store.home[lost].copy()  # replaced in place
            B = store.chunk_words
            # billing: replicated chunks with a surviving holder re-derive
            # from that peer (replicas never go stale — write-through); the
            # rest stream in from checkpoint storage (ingress, no sender)
            from_holder = np.zeros(lost.size, dtype=bool)
            donor = np.zeros(lost.size, dtype=np.int64)
            if replicas is not None and replicas.hot_ids.size:
                slot = replicas.lookup[lost]
                hit = np.flatnonzero(slot >= 0)
                if hit.size:
                    holders = replicas.holders[slot[hit]].copy()
                    holders[:, dead] = False
                    has = holders.any(axis=1)
                    from_holder[hit[has]] = True
                    donor[hit[has]] = np.argmax(holders[has], axis=1)
            if from_holder.any():
                cost.send(donor[from_holder], targets[from_holder], B + 1)
            if (~from_holder).any():
                cost.ingress(targets[~from_holder], B + 1)
            cost.work(targets, 1.0)
            cost.tick()
            store.write_rows(lost, rows)
            if cfg.on_failure == "shrink":
                store.rehome(lost, targets)
        elif cfg.on_failure == "shrink":
            self.alive[dead] = False
        self.num_recoveries += len(dead)
        self.chunks_restored += int(lost.size)
        cost.end()
        return cost.totals()

    # ---- shrink-mode batch adaptation ------------------------------------
    def adapt_batch(self, tasks: TaskBatch) -> TaskBatch:
        """Remap task origins off permanently-dead machines (shrink mode):
        deterministic round-robin over the survivors."""
        if self.alive.all():
            return tasks
        bad = ~self.alive[tasks.origin]
        if not bad.any():
            return tasks
        alive_ids = np.flatnonzero(self.alive)
        origin = tasks.origin.copy()
        origin[bad] = alive_ids[origin[bad] % alive_ids.size]
        return TaskBatch(
            contexts=tasks.contexts, origin=origin,
            write_keys=tasks.write_keys, priority=tasks.priority,
            ctx_words=tasks.ctx_words, read_indptr=tasks.read_indptr,
            read_indices=tasks.read_indices)


# ---------------------------------------------------------------------------
# the session-facing bundle
# ---------------------------------------------------------------------------
class ElasticityManager:
    """One object bundling the three elastic subsystems for a session.

    Shared across `Orchestrator.fork()` siblings exactly like the
    replicator: one demand histogram, one liveness mask, one stage clock.
    """

    def __init__(self, store: DataStore, config: ElasticityConfig):
        self.config = config
        self.P = int(store.P)
        mig = _coerce(config.migration, MigrationConfig)
        ste = _coerce(config.stealing, StealConfig)
        rec = _coerce(config.recovery, RecoveryConfig)
        if rec is not None and rec.on_failure == "shrink" and ste is None:
            ste = StealConfig()  # dead exec sites must drain somewhere
        self.planner = MigrationPlanner(store, mig) if mig else None
        self.recovery = RecoveryManager(store, rec) if rec else None
        self.stealer = WorkStealer(store.P, ste) if ste else None
        if self.stealer is not None and self.recovery is not None:
            self.stealer.bind_alive(self.recovery.alive)
        self.stage_idx = 0

    @property
    def alive(self) -> np.ndarray:
        return self.recovery.alive if self.recovery is not None \
            else np.ones(self.P, dtype=bool)

    def adapt_batch(self, tasks: TaskBatch) -> TaskBatch:
        return self.recovery.adapt_batch(tasks) \
            if self.recovery is not None else tasks

    def on_stage_start(self, store: DataStore, replicas, backend
                       ) -> List[StageReport]:
        """Recovery tick + migration election, in that order (a recovered
        store is what the election sees). Returns the charged reports of
        whatever actually happened this boundary."""
        reports: List[StageReport] = []
        if self.recovery is not None:
            rep = self.recovery.on_stage_start(self.stage_idx, store,
                                               replicas, backend)
            if rep is not None:
                reports.append(rep)
        if self.planner is not None:
            rep = self.planner.maybe_migrate(store, replicas, backend)
            if rep is not None:
                reports.append(rep)
        return reports

    def observe(self, tasks: TaskBatch) -> None:
        if self.planner is not None:
            self.planner.observe(tasks.read_indices,
                                 tasks.origin[tasks.pair_task])

    def after_stage(self, tasks: TaskBatch, store: DataStore,
                    backend=None) -> None:
        if self.recovery is not None:
            self.recovery.after_stage(tasks, store, backend)
        self.stage_idx += 1

    def counters(self) -> Dict[str, float]:
        """The elastic counters `serve.ServeStats` folds into its report."""
        out: Dict[str, float] = {}
        if self.planner is not None:
            out["migrations"] = self.planner.num_migrations
            out["migration_elections"] = self.planner.num_elections
        if self.stealer is not None:
            out["stolen_tasks"] = self.stealer.stolen_tasks
            out["steal_rebalances"] = self.stealer.num_rebalances
        if self.recovery is not None:
            out["recoveries"] = self.recovery.num_recoveries
            out["chunks_restored"] = self.recovery.chunks_restored
            out["machines_alive"] = int(self.recovery.alive.sum())
        return out


def make_elasticity(spec, store: DataStore) -> Optional[ElasticityManager]:
    """Coerce a user-facing `elasticity=` spec into a manager.

    None/False → off; an `ElasticityConfig` / kwargs dict → a fresh manager;
    an existing `ElasticityManager` is adopted as-is (shared state across
    forked sessions)."""
    if spec is None or spec is False:
        return None
    if isinstance(spec, ElasticityManager):
        return spec
    if isinstance(spec, dict):
        spec = ElasticityConfig(**spec)
    if not isinstance(spec, ElasticityConfig):
        raise TypeError(f"bad elasticity spec: {spec!r}")
    if spec.migration is None and spec.stealing is None \
            and spec.recovery is None:
        return None
    return ElasticityManager(store, spec)
