"""`EmbeddingStore` — a sharded embedding table as an orchestration workload.

Embedding serving is the paper's KV-store case study (§4) with the LM
stack's semantics: `lookup(ids)` is multi-get with an ⊕-read (the fused
"first"/"add" reductions), `update(ids, grads)` is the ⊙-apply with the
"add" merge (gradient push), and Zipfian token frequency is the hot-chunk
regime verbatim. One vocab row = one chunk; the backend and hot-row
replication arrive through the same `SessionConfig` as everywhere else, and
by default the stages run on `TorchBackend()`, the CUDA card.

The session's `HotChunkReplicator` directory (fed by Phase-1 contention
detection, elected by `replication.decayed_election`) is the one hot-row
electorate: `device_cache()` exports it as the `EmbedCache` view that
`core.embedding.embed_skew_aware` consumes.

The streaming front door (`serve()`, `EmbeddingFrontend`) admits single
lookups, bags and gradient pushes and coalesces them into the exact batches
the one-shot methods build (`serve.Frontend`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np

from ..core import DataStore, Orchestrator, TaskBatch, fused_read, \
    resolve_session_config
from ..core.config import check_kernel_backend
from ..core.session import cached_session
from ..serve import Frontend, RequestFuture

__all__ = ["EmbeddingStore", "EmbeddingFrontend", "LookupResult",
           "UpdateResult"]


def _grad_update(contexts, vals):
    """The ⊙-apply push lambda: each task's context IS its gradient row;
    the "add" merge ⊗-combines duplicate ids, then one authoritative ⊙ per
    row applies the sum."""
    return {"update": contexts}


@dataclasses.dataclass
class LookupResult:
    values: np.ndarray  # (n, d) fetched rows (or ⊕-pooled bag sums)
    report: object  # StageReport
    refcount: Dict[int, int]  # Phase-1 per-row demand


@dataclasses.dataclass
class UpdateResult:
    report: object  # StageReport
    refcount: Dict[int, int]


class EmbeddingStore:
    """`vocab` rows of `dim` words, random machine placement — the
    parameter-server half of the serving tier.

    `lookup` and `update` run as orchestration stages on the store's cached
    sessions; with `replicate=` the session keeps the hottest rows
    replicated everywhere, and `report.replica_local_words` measures the
    traffic the replicas absorbed.
    """

    def __init__(self, vocab: int, dim: int, num_machines: int, *,
                 seed: int = 0):
        self._attach(DataStore.create(int(vocab), num_machines,
                                      value_width=dim, chunk_words=dim,
                                      salt=seed))

    def _attach(self, store: DataStore) -> None:
        self.V, self.d = store.values.shape
        self.P = int(store.P)
        self.store = store
        self._sessions: Dict[tuple, Orchestrator] = {}

    @classmethod
    def from_reference(cls, ref) -> "EmbeddingStore":
        """A port store holding the same table and placement as a
        JAX-package `EmbeddingStore` (read by attribute, never imported)."""
        self = cls.__new__(cls)
        self._attach(DataStore.from_reference(ref.store))
        if (self.V, self.d) != (int(ref.V), int(ref.d)):
            raise ValueError(f"reference store holds {(self.V, self.d)}, "
                             f"expected {(ref.V, ref.d)}")
        return self

    # ---- table -------------------------------------------------------------
    @property
    def table(self) -> np.ndarray:
        """The authoritative (V, d) table (mutate via `load`/`update`)."""
        return self.store.values

    def load(self, table: np.ndarray) -> None:
        table = np.asarray(table, dtype=np.float64)
        if table.shape != (self.V, self.d):
            raise ValueError(f"table shape {table.shape} != "
                             f"{(self.V, self.d)}")
        self.store.write_rows(np.arange(self.V, dtype=np.int64), table)

    def init_table(self, seed: int = 0, scale: float = 1.0) -> None:
        rng = np.random.default_rng(seed)
        self.load(rng.normal(0, scale, (self.V, self.d)))

    # ---- sessions ----------------------------------------------------------
    def session(self, engine=None, *, config=None, backend=None,
                replication=None, replicate=None, elasticity=None,
                **engine_opts) -> Orchestrator:
        """The store's cached long-lived session (same alias resolution and
        caching as every other front door)."""
        cfg = resolve_session_config(
            config, engine_opts=engine_opts, engine=engine, backend=backend,
            replication=replication, replicate=replicate,
            elasticity=elasticity)
        return cached_session(self._sessions, self.store, cfg)

    # ---- lookup: multi-get with ⊕-read ------------------------------------
    def _lookup_batch(self, indptr: np.ndarray, indices: np.ndarray,
                      origin) -> TaskBatch:
        n = indptr.shape[0] - 1
        if origin is None:
            origin = TaskBatch.even_origins(n, self.P)
        # pure reads: write_keys must be pinned to -1 (fused lambdas return
        # update == result, and the default write_keys is the primary read)
        return TaskBatch(contexts=np.zeros((n, 1)), origin=origin,
                         write_keys=np.full(n, -1, dtype=np.int64),
                         read_indptr=np.asarray(indptr, dtype=np.int64),
                         read_indices=np.asarray(indices, dtype=np.int64))

    def lookup(self, ids: np.ndarray, *, engine=None, config=None,
               origin=None, **kw) -> LookupResult:
        """Fetch rows `table[ids]` — one arity-1 task per id (the ⊕ = first
        fused read)."""
        ids = np.atleast_1d(np.asarray(ids, dtype=np.int64))
        n = ids.shape[0]
        indptr = np.arange(n + 1, dtype=np.int64)
        tasks = self._lookup_batch(indptr, ids, origin)
        res = self.session(engine, config=config, **kw).run_stage(
            tasks, fused_read("first"), write_back="add",
            return_results=True)
        return LookupResult(values=np.asarray(res.results),
                            report=res.report, refcount=res.refcount)

    def lookup_bags(self, bags: Sequence[Sequence[int]] |
                    Tuple[np.ndarray, np.ndarray], *, engine=None,
                    config=None, origin=None, **kw) -> LookupResult:
        """Pooled bag lookup: task i fetches `sum(table[bags[i]])` — ragged
        multi-get with the ⊕ = add fused read (CBOW / DLRM-style pooling),
        which runs the stage_fused kernel on the card. `bags` is per-task id
        sequences or a prebuilt CSR pair."""
        if (isinstance(bags, tuple) and len(bags) == 2
                and isinstance(bags[0], np.ndarray)):
            indptr, indices = bags
        else:
            indptr = np.zeros(len(bags) + 1, dtype=np.int64)
            np.cumsum([len(b) for b in bags], out=indptr[1:])
            indices = (np.concatenate(
                [np.asarray(b, dtype=np.int64) for b in bags])
                if indptr[-1] else np.empty(0, dtype=np.int64))
        tasks = self._lookup_batch(indptr, indices, origin)
        res = self.session(engine, config=config, **kw).run_stage(
            tasks, fused_read("add"), write_back="add", return_results=True)
        return LookupResult(values=np.asarray(res.results),
                            report=res.report, refcount=res.refcount)

    # ---- update: ⊙-apply with the "add" merge ------------------------------
    def update(self, ids: np.ndarray, grads: np.ndarray, *, engine=None,
               config=None, origin=None, **kw) -> UpdateResult:
        """Push gradients: `table[ids[i]] += grads[i]`, duplicates
        ⊗-combined in-network (the segment-combine kernel on the card)
        before the single authoritative ⊙ per row."""
        ids = np.atleast_1d(np.asarray(ids, dtype=np.int64))
        grads = np.asarray(grads, dtype=np.float64).reshape(ids.shape[0],
                                                            self.d)
        n = ids.shape[0]
        if origin is None:
            origin = TaskBatch.even_origins(n, self.P)
        tasks = TaskBatch(contexts=grads, origin=origin,
                          read_keys=np.full(n, -1, dtype=np.int64),
                          write_keys=ids)
        res = self.session(engine, config=config, **kw).run_stage(
            tasks, _grad_update, write_back="add")
        return UpdateResult(report=res.report, refcount=res.refcount)

    # ---- numpy oracles (tests) --------------------------------------------
    @staticmethod
    def oracle_lookup(table: np.ndarray, ids: np.ndarray) -> np.ndarray:
        return np.asarray(table)[np.asarray(ids, dtype=np.int64)]

    @staticmethod
    def oracle_bags(table: np.ndarray, bags) -> np.ndarray:
        table = np.asarray(table)
        return np.stack([table[np.asarray(b, dtype=np.int64)].sum(axis=0)
                         if len(b) else np.zeros(table.shape[1])
                         for b in bags])

    @staticmethod
    def oracle_update(table: np.ndarray, ids: np.ndarray,
                      grads: np.ndarray) -> np.ndarray:
        out = np.asarray(table, dtype=np.float64).copy()
        np.add.at(out, np.asarray(ids, dtype=np.int64),
                  np.asarray(grads, dtype=np.float64))
        return out

    # ---- device-cache export ----------------------------------------------
    def device_cache(self, engine=None, *, config=None, device=None, **kw):
        """Export the session's replica directory as the `EmbedCache` that
        `core.embedding.embed_skew_aware` consumes — the same
        `decayed_election` electorate realized as a cache of hot rows on
        `device` (None: the CUDA card). The session must be replicating
        (pass `replicate=`/`replication=`/`config=`)."""
        sess = self.session(engine, config=config, **kw)
        if sess.replicator is None:
            raise ValueError(
                "device_cache exports a replicating session's directory — "
                "opt the session into replication (replicate=True or a "
                "SessionConfig with replication=)")
        from ..core.embedding import cache_from_replicator
        return cache_from_replicator(self.table, sess.replicator,
                                     device=device)

    # ---- streaming serving mode -------------------------------------------
    def serve(self, *, engine=None, backend=None, kernel_backend=None,
              replicate=None, config=None, session_config=None,
              mode: str = "thread", double_buffer: bool = True,
              **kw) -> "EmbeddingFrontend":
        """Streaming front door: single lookups / bag-pools / gradient
        pushes admitted one at a time, coalesced into the exact batches the
        one-shot methods build, on the pinned double-buffered session pair
        — on the card unless the session's backend says otherwise.
        `kernel_backend=` takes only the port's one route, "auto"."""
        check_kernel_backend(kernel_backend)
        sess = self.session(engine, replicate=replicate, backend=backend,
                            config=session_config)
        return EmbeddingFrontend(self, sess, config=config, mode=mode,
                                 double_buffer=double_buffer, **kw)


class EmbeddingFrontend(Frontend):
    """`serve.Frontend` specialized to the embedding request kinds (built by
    `EmbeddingStore.serve()`):

    * ``lookup(id)`` — future of the row `(d,)`;
    * ``lookup_bag(ids)`` — future of the ⊕-pooled `(d,)` bag sum;
    * ``push_grad(id, grad)`` — the ⊙-apply gradient push (future resolves
      to None once the write has landed).
    """

    def __init__(self, table: EmbeddingStore, session, **kw):
        super().__init__(session, **kw)
        self.table = table
        self.register("lookup", fused_read("first"), write_back="add",
                      ctx_width=1, result="row")
        self.register("bag", fused_read("add"), write_back="add",
                      ctx_width=1, result="row")
        self.register("grad", _grad_update, write_back="add",
                      ctx_width=table.d, result="row")

    def lookup(self, row_id: int, *, deadline=None) -> RequestFuture:
        return self.submit("lookup", [int(row_id)], deadline=deadline)

    def lookup_bag(self, ids, *, deadline=None) -> RequestFuture:
        return self.submit("bag", ids, deadline=deadline)

    def push_grad(self, row_id: int, grad, *, deadline=None
                  ) -> RequestFuture:
        grad = np.asarray(grad, dtype=np.float64).reshape(self.table.d)
        return self.submit("grad", np.empty(0, dtype=np.int64), ctx=grad,
                           write_key=int(row_id), deadline=deadline)
