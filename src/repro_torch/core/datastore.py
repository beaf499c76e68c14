"""Distributed data-chunk store (§2.2 "Data Storage").

Data are partitioned into chunks of B words; each chunk lives on a hashed
(≈ uniformly random) home machine. The store keeps the authoritative copy of
every chunk value plus the placement map. For the BSP simulator the values
live in one dense array indexed by chunk key; *placement* is what the cost
model charges against.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import hashing


def stable_bucket_slots(bucket_ids: np.ndarray, num_buckets: int):
    """Each element's position within its bucket, preserving input order —
    the slotting rule shared by the shard-residency layout and the mesh
    task/pair placement (`core/shardexec.py`). Returns ``(slot, counts)``:
    element i lands at row ``slot[i]`` of bucket ``bucket_ids[i]``, whose
    total population is ``counts[bucket_ids[i]]``."""
    bucket_ids = np.asarray(bucket_ids, dtype=np.int64)
    counts = np.bincount(bucket_ids, minlength=num_buckets)
    order = np.argsort(bucket_ids, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.zeros(bucket_ids.size, dtype=np.int64)
    slot[order] = np.arange(bucket_ids.size, dtype=np.int64) \
        - starts[bucket_ids[order]]
    return slot, counts


@dataclasses.dataclass(frozen=True)
class ShardLayout:
    """Sharded-residency geometry: how the store's chunks partition over a
    device mesh whose shard m IS machine m (`core/shardexec.py`).

    Each shard materializes only the chunk rows it homes, as a dense
    (slab_rows, value_width) slab: chunk k lives on shard ``owner[k]`` at
    slab row ``local_slot[k]``; ``slab_keys[m, s]`` is the inverse map
    (padded with ``num_keys`` past machine m's last chunk). Pure placement
    metadata — the float values themselves are materialized per shard by
    the execution backend.
    """

    owner: np.ndarray  # (num_keys,) == DataStore.home
    local_slot: np.ndarray  # (num_keys,) row within the owner's slab
    slab_keys: np.ndarray  # (P, slab_rows) chunk key per slab row
    counts: np.ndarray  # (P,) chunks homed per machine

    @property
    def slab_rows(self) -> int:
        return int(self.slab_keys.shape[1])


@dataclasses.dataclass
class DataStore:
    """num_keys chunks, each `chunk_words` (=B) words wide, values float64.

    `home[k]` is the physical machine storing chunk k. Values are the
    authoritative copies; reads during a stage see the pre-stage snapshot
    (BSP semantics) and write-backs land once at the end of the stage.
    """

    values: np.ndarray  # (num_keys, value_width)
    home: np.ndarray  # (num_keys,) int64
    chunk_words: int  # B — words charged when a chunk moves
    P: int
    # monotonic write counter: execution backends that keep a device-resident
    # copy of `values` (core/backend.py JaxBackend) key their cache on it, so
    # every mutation must go through write_rows()/touch()
    version: int = 0

    @staticmethod
    def create(
        num_keys: int,
        num_machines: int,
        value_width: int = 1,
        chunk_words: int | None = None,
        init: float = 0.0,
        salt: int = 0,
        dtype=np.float64,
    ) -> "DataStore":
        values = np.full((num_keys, value_width), init, dtype=dtype)
        home = hashing.chunk_home(np.arange(num_keys), num_machines, salt=salt)
        B = int(chunk_words) if chunk_words is not None else int(value_width)
        return DataStore(values=values, home=home, chunk_words=B, P=int(num_machines))

    @staticmethod
    def from_reference(store) -> "DataStore":
        """A port store holding the same state as a JAX-package `DataStore`.

        Reads `values`, `home`, `chunk_words`, `P` and `version` by
        attribute (so this package never imports the reference), copies the
        arrays, and checks their shapes and dtypes."""
        values = np.array(store.values, copy=True)
        home = np.array(store.home, copy=True)
        if values.ndim != 2 or values.dtype.kind != "f":
            raise ValueError(
                f"store.values must be a 2-D float array, got {values.dtype} "
                f"of shape {values.shape}")
        if home.shape != (values.shape[0],) or home.dtype != np.int64:
            raise ValueError(
                f"store.home must be int64 of shape ({values.shape[0]},), got "
                f"{home.dtype} of shape {home.shape}")
        P = int(store.P)
        if home.size and (home.min() < 0 or home.max() >= P):
            raise ValueError(f"store.home names machines outside [0, {P})")
        return DataStore(values=values, home=home,
                         chunk_words=int(store.chunk_words), P=P,
                         version=int(store.version))

    @property
    def num_keys(self) -> int:
        return self.values.shape[0]

    @property
    def value_width(self) -> int:
        return self.values.shape[1]

    def write_rows(self, keys: np.ndarray, rows: np.ndarray) -> None:
        """Authoritative row update. The single mutation path all engines and
        loaders use — bumps `version` so device-side value caches invalidate
        (or incrementally apply) instead of serving stale chunks."""
        self.values[np.asarray(keys, dtype=np.int64)] = rows
        self.version += 1

    def touch(self) -> None:
        """Declare an out-of-band mutation of `values` (direct array writes
        by user code): invalidates any backend device cache."""
        self.version += 1

    def rehome(self, keys: np.ndarray, new_home: np.ndarray) -> None:
        """Atomically move chunks to new home machines (live migration /
        shrink-mode recovery of the elasticity subsystem).

        Mutates `home` IN PLACE — subsystems that alias the placement map
        (the replicator's `HotChunkReplicator.home`, a cached `ShardLayout`'s
        `owner`) see the move without re-plumbing — then drops the cached
        shard layout (its slot/slab geometry is stale) and bumps `version`
        so device-resident value/replica caches keyed on it rebuild against
        the new placement. Values are untouched: migration moves ownership,
        not data content.
        """
        keys = np.asarray(keys, dtype=np.int64)
        if keys.size == 0:
            return
        new_home = np.broadcast_to(
            np.asarray(new_home, dtype=np.int64).ravel(), keys.shape)
        if (new_home < 0).any() or (new_home >= self.P).any():
            raise ValueError(
                f"rehome targets must be machine ids in [0, {self.P})")
        self.home[keys] = new_home
        self.__dict__.pop("_shard_layout", None)
        self.version += 1

    def snapshot(self) -> np.ndarray:
        return self.values.copy()

    def shard_layout(self) -> ShardLayout:
        """The store's sharded-residency geometry (cached; `rehome()` is the
        one mutation path and drops the cache). Shard m's slab holds exactly
        the chunks with
        ``home == m``, in ascending key order; the padding rows that square
        the slabs off to the largest per-machine count are addressed by
        nobody (their key is ``num_keys``)."""
        lay = self.__dict__.get("_shard_layout")
        if lay is not None:
            return lay
        K, P = self.num_keys, self.P
        local_slot, counts = stable_bucket_slots(self.home, P)
        rows = max(int(counts.max(initial=1)), 1)
        slab_keys = np.full((P, rows), K, dtype=np.int64)
        slab_keys[self.home, local_slot] = np.arange(K, dtype=np.int64)
        lay = ShardLayout(owner=self.home, local_slot=local_slot,
                          slab_keys=slab_keys, counts=counts)
        self.__dict__["_shard_layout"] = lay
        return lay

    def storage_per_machine(self) -> np.ndarray:
        out = np.zeros(self.P, dtype=np.int64)
        np.add.at(out, self.home, 1)
        return out


@dataclasses.dataclass
class TaskBatch:
    """A batch of lambda-tasks (Fig. 1), vectorized — each task requesting
    *one or more* data items (§2.1).

    The canonical read layout is a CSR pair (`read_indptr`, `read_indices`):
    task i requests chunks `read_indices[read_indptr[i]:read_indptr[i+1]]`
    (possibly zero, possibly with duplicates). `read_keys` — a flat `(n,)`
    array with -1 meaning "no read" — is kept as a constructor convenience
    for arity-1 batches and remains available as a flat view whenever
    `max_arity <= 1` (it is None for genuinely ragged batches).

    Each task runs the stage's lambda on (context, gathered values),
    optionally writing back to `write_keys[i]` (default: same as the task's
    first read key). `origin[i]` is the machine initially holding the task;
    `ctx_words` = σ. `priority` resolves deterministic-overwrite races
    (Definition 2 case (iv)).
    """

    contexts: np.ndarray  # (n, ctx_width)
    read_keys: np.ndarray | None = None  # (n,) int64, -1 = no read (arity ≤ 1)
    origin: np.ndarray | None = None  # (n,) int64 machine ids
    write_keys: np.ndarray | None = None  # (n,) int64, -1 = no write
    priority: np.ndarray | None = None  # (n,) tie-break order
    ctx_words: int | None = None  # σ; defaults to ctx width
    read_indptr: np.ndarray | None = None  # (n+1,) CSR row pointers
    read_indices: np.ndarray | None = None  # (nnz,) requested chunk keys

    def __post_init__(self):
        n = self.contexts.shape[0]
        if self.origin is None:
            raise ValueError("TaskBatch needs `origin` machine ids")
        self.origin = np.asarray(self.origin, dtype=np.int64)

        if (self.read_indptr is None) != (self.read_indices is None):
            raise ValueError("read_indptr and read_indices must be given together")
        if self.read_indptr is not None:
            if self.read_keys is not None:
                raise ValueError("pass either read_keys or read_indptr/read_indices")
            self.read_indptr = np.asarray(self.read_indptr, dtype=np.int64)
            self.read_indices = np.asarray(self.read_indices, dtype=np.int64)
            if self.read_indptr.shape[0] != n + 1:
                raise ValueError(
                    f"read_indptr length {self.read_indptr.shape[0]} != n+1 {n + 1}")
            if self.read_indptr[0] != 0 or self.read_indptr[-1] != self.read_indices.shape[0]:
                raise ValueError("read_indptr must start at 0 and end at nnz")
            if (np.diff(self.read_indptr) < 0).any():
                raise ValueError("read_indptr must be non-decreasing")
            if self.read_indices.size and (self.read_indices < 0).any():
                raise ValueError("read_indices must be non-negative chunk keys")
            # flat convenience view exists only for arity-≤1 batches
            if self.max_arity <= 1:
                flat = np.full(n, -1, dtype=np.int64)
                has = np.diff(self.read_indptr) > 0
                flat[has] = self.read_indices
                self.read_keys = flat
        else:
            if self.read_keys is None:
                self.read_keys = np.full(n, -1, dtype=np.int64)
            self.read_keys = np.asarray(self.read_keys, dtype=np.int64)
            if self.read_keys.shape[0] != n:
                raise ValueError(f"read_keys length {self.read_keys.shape[0]} != n {n}")
            has = self.read_keys >= 0
            self.read_indptr = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(has, out=self.read_indptr[1:])
            self.read_indices = self.read_keys[has].copy()

        if self.write_keys is None:
            self.write_keys = self.primary_read.copy()
        self.write_keys = np.asarray(self.write_keys, dtype=np.int64)
        if self.priority is None:
            self.priority = np.arange(n, dtype=np.int64)
        if self.ctx_words is None:
            self.ctx_words = int(self.contexts.shape[1]) if self.contexts.ndim > 1 else 1
        for arr, nm in [(self.origin, "origin"),
                        (self.write_keys, "write_keys"), (self.priority, "priority")]:
            if arr.shape[0] != n:
                raise ValueError(f"{nm} length {arr.shape[0]} != n {n}")

    @property
    def n(self) -> int:
        return self.contexts.shape[0]

    # ---- fail-fast validation --------------------------------------------
    def validate(self, store: "DataStore | None" = None, *,
                 num_keys: int | None = None,
                 num_machines: int | None = None) -> "TaskBatch":
        """Check the batch's CSR geometry and key/machine ranges, raising
        `ValueError` with an actionable message instead of letting a
        malformed batch surface as a cryptic numpy index error deep inside
        an engine. Called by `Orchestrator.run_stage` on every batch (cheap,
        vectorized); re-checks constructor invariants too, since the arrays
        are plain ndarrays a caller may have mutated since `__init__`.

        `store` (or explicit `num_keys`/`num_machines`) supplies the bounds;
        without either, only the store-independent geometry is checked.
        Returns the batch so call sites can chain it.
        """
        if store is not None:
            num_keys = store.num_keys if num_keys is None else num_keys
            num_machines = store.P if num_machines is None else num_machines
        n = self.n
        indptr, indices = self.read_indptr, self.read_indices
        if indptr.shape[0] != n + 1:
            raise ValueError(
                f"TaskBatch.read_indptr has {indptr.shape[0]} entries for a "
                f"batch of {n} tasks — a CSR row-pointer array needs n+1 "
                f"= {n + 1}")
        if indptr[0] != 0 or indptr[-1] != indices.shape[0]:
            raise ValueError(
                f"TaskBatch.read_indptr must run from 0 to nnz "
                f"({indices.shape[0]}), got [{indptr[0]} .. {indptr[-1]}] — "
                "the pointer array does not cover read_indices")
        steps = np.diff(indptr)
        if (steps < 0).any():
            t = int(np.flatnonzero(steps < 0)[0])
            raise ValueError(
                f"TaskBatch.read_indptr must be non-decreasing: task {t} has "
                f"indptr[{t}]={int(indptr[t])} > indptr[{t + 1}]="
                f"{int(indptr[t + 1])} — each task's key slice must follow "
                "the previous one")
        for arr, nm in [(self.origin, "origin"), (self.write_keys,
                        "write_keys"), (self.priority, "priority")]:
            if arr.shape[0] != n:
                raise ValueError(
                    f"TaskBatch.{nm} has {arr.shape[0]} entries for a batch "
                    f"of {n} tasks — every per-task array must have length n")
        if indices.size and (indices < 0).any():
            p = int(np.flatnonzero(indices < 0)[0])
            raise ValueError(
                f"TaskBatch.read_indices[{p}] = {int(indices[p])} is "
                "negative — requested chunk keys must be >= 0 (omit a task's "
                "reads by giving it an empty CSR slice, not a sentinel)")
        if (self.write_keys < -1).any():
            t = int(np.flatnonzero(self.write_keys < -1)[0])
            raise ValueError(
                f"TaskBatch.write_keys[{t}] = {int(self.write_keys[t])} is "
                "invalid — use -1 for 'writes nothing', >= 0 for a chunk key")
        if num_keys is not None:
            if indices.size and (indices >= num_keys).any():
                p = int(np.flatnonzero(indices >= num_keys)[0])
                raise ValueError(
                    f"TaskBatch.read_indices[{p}] = {int(indices[p])} is out "
                    f"of range for a store with {num_keys} chunks (task "
                    f"{int(np.searchsorted(indptr, p, side='right')) - 1})")
            if (self.write_keys >= num_keys).any():
                t = int(np.flatnonzero(self.write_keys >= num_keys)[0])
                raise ValueError(
                    f"TaskBatch.write_keys[{t}] = {int(self.write_keys[t])} "
                    f"is out of range for a store with {num_keys} chunks")
        if num_machines is not None and self.origin.size:
            bad = (self.origin < 0) | (self.origin >= num_machines)
            if bad.any():
                t = int(np.flatnonzero(bad)[0])
                raise ValueError(
                    f"TaskBatch.origin[{t}] = {int(self.origin[t])} is not a "
                    f"machine id in [0, {num_machines})")
        return self

    # ---- ragged-read geometry --------------------------------------------
    @property
    def arity(self) -> np.ndarray:
        """(n,) number of chunks each task requests."""
        return np.diff(self.read_indptr)

    @property
    def max_arity(self) -> int:
        return int(self.arity.max(initial=0))

    @property
    def nnz(self) -> int:
        """Total number of (task, requested-key) pairs."""
        return int(self.read_indices.shape[0])

    @property
    def pair_task(self) -> np.ndarray:
        """(nnz,) task index of each (task, key) pair, CSR order."""
        return np.repeat(np.arange(self.n, dtype=np.int64), self.arity)

    @property
    def primary_read(self) -> np.ndarray:
        """(n,) each task's first requested key (-1 if it reads nothing).

        The primary key is the one whose tree decides where the task
        executes and whose reverse meta-task tree same-key write-backs ride;
        secondary keys are gathered to the execution site.
        """
        out = np.full(self.n, -1, dtype=np.int64)
        has = self.arity > 0
        out[has] = self.read_indices[self.read_indptr[:-1][has]]
        return out

    @classmethod
    def concat(cls, batches, store: "DataStore | None" = None) -> "TaskBatch":
        """Merge ragged CSR batches into one, preserving order: batch j's
        tasks precede batch j+1's, CSR offsets are shifted onto one
        `read_indices` array, and priorities are rebased (order-preserving,
        per batch, each batch offset past the previous one) so Definition 2
        write races resolve exactly as "batch j before batch j+1, original
        order within each batch" — what a serving coalescer needs when it
        merges admission windows. Context widths and `ctx_words` must agree
        across batches. The result is `validate()`-checked (against `store`
        when given) before it is returned, so a bad offset surfaces here,
        not deep inside an engine."""
        batches = list(batches)
        if not batches:
            raise ValueError("TaskBatch.concat needs at least one batch")
        widths = {b.contexts.shape[1:] for b in batches}
        if len(widths) > 1:
            raise ValueError(
                f"TaskBatch.concat: context widths differ across batches "
                f"({sorted(widths)}) — coalesce only like-shaped tasks")
        sigmas = {int(b.ctx_words) for b in batches}
        if len(sigmas) > 1:
            raise ValueError(
                f"TaskBatch.concat: ctx_words differ across batches "
                f"({sorted(sigmas)})")
        indptr_parts, off = [batches[0].read_indptr], 0
        for b in batches[1:]:
            off += batches[len(indptr_parts) - 1].nnz
            indptr_parts.append(b.read_indptr[1:] + off)
        pr_parts, pr_off = [], 0
        for b in batches:
            p = np.asarray(b.priority, dtype=np.int64)
            if p.size:
                # order-preserving rebase: priorities are ordinal (lowest
                # wins), so only relative order within a batch is kept
                p = p - p.min() + pr_off
                pr_off = int(p.max()) + 1
            pr_parts.append(p)
        out = cls(
            contexts=np.concatenate([b.contexts for b in batches]),
            origin=np.concatenate([b.origin for b in batches]),
            write_keys=np.concatenate([b.write_keys for b in batches]),
            priority=np.concatenate(pr_parts),
            read_indptr=np.concatenate(indptr_parts),
            read_indices=np.concatenate([b.read_indices for b in batches]),
            ctx_words=batches[0].ctx_words,
        )
        return out.validate(store)

    @staticmethod
    def from_ragged(contexts, key_lists, origin, **kw) -> "TaskBatch":
        """Build a multi-get batch from per-task key sequences."""
        indptr = np.zeros(len(key_lists) + 1, dtype=np.int64)
        np.cumsum([len(k) for k in key_lists], out=indptr[1:])
        indices = (np.concatenate([np.asarray(k, dtype=np.int64) for k in key_lists])
                   if indptr[-1] else np.empty(0, dtype=np.int64))
        return TaskBatch(contexts=contexts, origin=origin,
                         read_indptr=indptr, read_indices=indices, **kw)

    @staticmethod
    def even_origins(n: int, num_machines: int) -> np.ndarray:
        """Round-robin initial task placement: Θ(n/P) per machine (§2.2)."""
        return np.arange(n, dtype=np.int64) % num_machines
