"""Adaptive hot-chunk replication: the §3 push-pull engine made *persistent*.

Within one stage, TD-Orch resolves a data hot spot by broadcasting the
contended chunk down its meta-task tree (Phase 2 "pull") — and then throws
that knowledge away. Real request streams are skewed the same way stage
after stage (the §4 Zipf workloads, hot vertices in §5 graphs), so a
session that *learns* the skew can keep copies of the hottest chunks
resident everywhere and serve them without any forest traffic at all.
This module is that subsystem:

  * a **decayed per-chunk request histogram**, fed by the Phase-1 meta-task
    counts every stage (the contention detection the engine already runs —
    observing demand is free);
  * a **`select_hot`-based electorate** (the top-H election of
    `core/torchexec.py`): every `refresh` stages the top-H chunks by
    decayed demand are re-elected;
  * a **replica directory** — `ReplicaSet`, a chunk→machine bitmap living
    alongside the `DataStore`'s `home` placement map — that every engine
    consults: Phase 2 serves replicated chunks from the local replica
    (recorded as *replica-local* words, not network words), Phase 4 still
    ⊗-combines write-backs to the authoritative home copy and then
    write-through-propagates the combined update to the replica holders so
    replicas never go stale.

Cost accounting is explicit: electing a new chunk charges its home machine
a broadcast of the chunk value to every holder under the dedicated
``replica_refresh`` phase (`cost.REPLICA_REFRESH_PHASE`), so
`SessionReport.replica_refresh_words` / `steady_state_words` separate the
amortized replication investment from steady-state serving traffic.

Numerics are untouched by design: the simulator's single vectorized
execute/apply pass reads the authoritative store, so replicated runs are
bit-identical to unreplicated ones — replication only changes *where the
cost model says the bytes come from* (the simulation-fidelity contract in
`core/engine.py`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from .cost import REPLICA_REFRESH_PHASE, CostAccumulator, StageReport

__all__ = [
    "ReplicationConfig", "ReplicaSet", "HotChunkReplicator",
    "make_replicator", "decayed_election", "charge_write_through",
    "REPLICA_REFRESH_PHASE",
]


@dataclasses.dataclass(frozen=True)
class ReplicationConfig:
    """Knobs of the hot-chunk subsystem (all deterministic).

    num_hot   H: electorate size — at most H chunks replicated at a time.
    refresh   re-elect every `refresh` stages (the first election happens
              after the first observed stage, so stage 0 always runs cold).
    decay     histogram multiplier applied at each election: the memory of
              the demand stream (0.5 = half-life of one refresh interval).
    min_count decayed demand a chunk must reach to be electable — keeps a
              uniform workload from replicating chunks nobody is hot for.
    """

    num_hot: int = 64
    refresh: int = 4
    decay: float = 0.5
    min_count: float = 2.0


@dataclasses.dataclass
class ReplicaSet:
    """The replica directory: which machines hold a copy of which chunk.

    Lives alongside `DataStore.home` — `home[k]` is where chunk k's
    authoritative copy is, `holders[lookup[k]]` is the machine bitmap of
    its replicas (this PR's electorate replicates to every machine; the
    bitmap keeps the directory general for partial replication).
    """

    hot_ids: np.ndarray  # (H,) replicated chunk keys
    lookup: np.ndarray  # (num_keys,) -> slot in hot_ids, -1 = not replicated
    holders: np.ndarray  # (H, P) bool bitmap: holders[s, m] = replica at m

    @staticmethod
    def empty(num_keys: int, num_machines: int) -> "ReplicaSet":
        return ReplicaSet(
            hot_ids=np.empty(0, dtype=np.int64),
            lookup=np.full(int(num_keys), -1, dtype=np.int64),
            holders=np.zeros((0, int(num_machines)), dtype=bool),
        )

    @property
    def num_replicated(self) -> int:
        return int(self.hot_ids.size)

    def holds(self, keys: np.ndarray, machines: np.ndarray) -> np.ndarray:
        """Elementwise: is chunk `keys[i]` replicated at `machines[i]`?"""
        keys = np.asarray(keys, dtype=np.int64)
        machines = np.asarray(machines, dtype=np.int64)
        out = np.zeros(keys.shape, dtype=bool)
        if self.hot_ids.size == 0:
            return out
        slot = self.lookup[keys]
        hit = slot >= 0
        if hit.any():
            out[hit] = self.holders[slot[hit], machines[hit]]
        return out


def decayed_election(counts, num_hot: int, decay: float, min_count=1):
    """One election step of the shared electorate: `select_hot` over the
    demand histogram (the same top-H election `core/torchexec.py` offers
    the device paths), then decay the histogram.

    Accepts a numpy array or a torch tensor and returns torch tensors
    ``(hot_ids, lookup, valid, decayed_counts)`` on the input's device
    (host-side state stays on the CPU). A float histogram is ranked by its
    float32 image and decayed in float32, exactly as the JAX package does,
    so both packages elect the same chunks and carry the same counts.
    """
    from .torchexec import select_hot

    num_hot = min(int(num_hot), int(counts.shape[0]))  # top-k needs k ≤ n
    counts = torch.as_tensor(counts)
    rank_key = counts if not counts.is_floating_point() \
        else counts.to(torch.float32)
    hot_ids, lookup, valid = select_hot(rank_key, num_hot,
                                        min_count=min_count)
    decayed = (counts.to(torch.float32) * decay).to(counts.dtype)
    return hot_ids, lookup, valid, decayed


class HotChunkReplicator:
    """Session-owned adaptive replication state (histogram + directory).

    Owned by an `Orchestrator` / `GraphSession`; persists across
    `run_stage` calls. Per stage the owner calls, in order:

      1. ``maybe_refresh()`` — if an election is due, re-elect the top-H
         electorate and return a `StageReport` charging the broadcast of
         *newly* replicated chunks (home → every holder, B+1 words each)
         under the ``replica_refresh`` phase. Already-resident chunks are
         not re-shipped; dropped chunks are discarded for free.
      2. run the stage with ``replicas`` (the current directory);
      3. ``observe(refcount)`` / ``observe_keys(keys)`` — fold the stage's
         Phase-1 meta-task counts into the histogram.
    """

    def __init__(self, home: np.ndarray, num_machines: int, chunk_words: int,
                 config: Optional[ReplicationConfig] = None):
        self.home = np.asarray(home, dtype=np.int64)
        self.P = int(num_machines)
        self.chunk_words = int(chunk_words)
        self.config = config or ReplicationConfig()
        self.num_keys = int(self.home.shape[0])
        self.counts = np.zeros(self.num_keys, dtype=np.float64)
        self.replicas = ReplicaSet.empty(self.num_keys, self.P)
        self.stage_idx = 0  # stages observed so far
        self.num_elections = 0
        self._last_election: Optional[int] = None

    # ---- Phase-1 demand feed ---------------------------------------------
    def observe(self, refcount: Dict[int, int]) -> None:
        """Fold one stage's Phase-1 meta-task counts (the engine's observed
        per-chunk refcounts) into the histogram. One call per stage."""
        if refcount:
            keys = np.fromiter(refcount.keys(), dtype=np.int64,
                               count=len(refcount))
            cnts = np.fromiter(refcount.values(), dtype=np.float64,
                               count=len(refcount))
            self.counts[keys] += cnts
        self.stage_idx += 1

    def observe_keys(self, keys: np.ndarray, weights=1.0) -> None:
        """Demand feed for callers without a refcount dict (baseline engines,
        graph rounds): histogram the requested keys directly. One call per
        stage."""
        keys = np.asarray(keys, dtype=np.int64)
        if keys.size:
            np.add.at(self.counts, keys,
                      np.broadcast_to(np.asarray(weights, dtype=np.float64),
                                      keys.shape))
        self.stage_idx += 1

    # ---- election + refresh broadcast ------------------------------------
    @property
    def due(self) -> bool:
        if self.stage_idx == 0:
            return False  # nothing observed yet: stage 0 runs cold
        if self._last_election is None:
            return True  # first election right after the first stage
        return self.stage_idx - self._last_election >= self.config.refresh

    def maybe_refresh(self) -> Optional[StageReport]:
        """Re-elect if due. Returns the refresh-broadcast cost report
        (a single ``replica_refresh`` phase), or None when not due."""
        return self.refresh() if self.due else None

    def refresh(self) -> StageReport:
        cfg = self.config
        hot_ids, _lookup, valid, decayed = decayed_election(
            self.counts, cfg.num_hot, cfg.decay, cfg.min_count)
        hot_ids = hot_ids[valid].numpy().astype(np.int64)
        prev = self.replicas

        lookup = np.full(self.num_keys, -1, dtype=np.int64)
        lookup[hot_ids] = np.arange(hot_ids.size, dtype=np.int64)
        self.replicas = ReplicaSet(
            hot_ids=hot_ids,
            lookup=lookup,
            holders=np.ones((hot_ids.size, self.P), dtype=bool),
        )

        cost = CostAccumulator(self.P)
        cost.begin(REPLICA_REFRESH_PHASE)
        newly = hot_ids[prev.lookup[hot_ids] < 0] if hot_ids.size \
            else hot_ids
        if newly.size:
            # pull, made persistent: each new chunk's home broadcasts the
            # value to every holder (self-sends are free; one BSP round)
            src = np.repeat(self.home[newly], self.P)
            dst = np.tile(np.arange(self.P, dtype=np.int64), newly.size)
            cost.send(src, dst, self.chunk_words + 1)
            cost.work(self.home[newly], 1.0)
            cost.tick()
        cost.end()

        self.counts = decayed.numpy().astype(np.float64)
        self._last_election = self.stage_idx
        self.num_elections += 1
        return cost.totals()


def make_replicator(spec, home: np.ndarray, num_machines: int,
                    chunk_words: int) -> Optional[HotChunkReplicator]:
    """Coerce a user-facing `replication=` spec into a replicator.

    None/False → off; True → default `ReplicationConfig`; a dict → config
    kwargs; a `ReplicationConfig` → itself; an existing `HotChunkReplicator`
    is adopted as-is (shared state across sessions).
    """
    if spec is None or spec is False:
        return None
    if isinstance(spec, HotChunkReplicator):
        return spec
    if spec is True:
        cfg = ReplicationConfig()
    elif isinstance(spec, ReplicationConfig):
        cfg = spec
    elif isinstance(spec, dict):
        cfg = ReplicationConfig(**spec)
    else:
        raise TypeError(f"bad replication spec: {spec!r}")
    return HotChunkReplicator(home, num_machines, chunk_words, cfg)


def charge_write_through(cost: CostAccumulator, home: np.ndarray,
                         replicas: Optional[ReplicaSet], written_keys,
                         words: float) -> None:
    """Phase-4 replica maintenance: after write-backs ⊗-combine to the home
    copy, each written *replicated* chunk's home propagates the combined
    update (words+1 per message) to its other holders, keeping replicas
    fresh so the next stage's reads stay replica-local. One BSP round."""
    if cost is None or replicas is None or replicas.hot_ids.size == 0:
        return
    keys = np.unique(np.asarray(written_keys, dtype=np.int64))
    slot = replicas.lookup[keys]
    keys, slot = keys[slot >= 0], slot[slot >= 0]
    if keys.size == 0:
        return
    P = replicas.holders.shape[1]
    held = replicas.holders[slot].ravel()
    src = np.repeat(np.asarray(home, dtype=np.int64)[keys], P)[held]
    dst = np.tile(np.arange(P, dtype=np.int64), keys.size)[held]
    # home's own authoritative ⊙ is charged by apply_writes — bill only the
    # genuinely remote holders (whose sends are the non-self rows anyway)
    remote = src != dst
    cost.send(src[remote], dst[remote], words + 1)
    cost.work(dst[remote], 1.0)  # apply ⊙ at each remote holder
    cost.tick()
