"""Distributed hash table on the orchestration interface (§2.1, §4), on the
torch port: by default every batch runs on `TorchBackend()`, the CUDA card.

One batch of GET/UPDATE/MULTI-GET operations is one orchestration stage run
through a long-lived `Orchestrator` session: the table keeps one session per
engine, so the communication forest is planned once and every subsequent
batch reuses it while the session report accumulates per-phase costs across
batches. The `engine` kwarg switches the scheduling strategy (TD-Orch vs
§2.3 baselines) with zero change to this application code — which is the
abstraction's claim.

Concurrent-update semantics: updates to the same key in one batch resolve by
the deterministic decision process of Definition 2 case (iv) — lowest task
priority (issue order) wins — matching a linearizable batch where the first
writer's multiply-and-add lands. (The paper's hash-table runs one stage per
batch, so chained same-key updates belong to later batches.)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core import (CARRY, DataStore, OrchestrationResult, Orchestrator,
                    SessionReport, StagePlan, TaskBatch,
                    resolve_session_config)
from ..core.config import check_kernel_backend
from ..core.session import cached_session
from ..serve import Frontend, RequestFuture  # noqa: F401 (RequestFuture: API)


def _muladd_lambda(contexts, in_vals):
    """The §4 GET/UPDATE lambda (multiply-and-add). Slices and arithmetic
    only, so it runs on numpy arrays (the oracle) and on torch tensors (the
    torch backend) alike: no batch takes the backend's host route."""
    mul = contexts[:, 1:2]
    add = contexts[:, 2:3]
    return {"update": in_vals * mul + add, "result": in_vals}


def _flatten_lambda(contexts, vals, mask):
    """Multi-get gather lambda: padded (n, A, w) view -> flat (n, A*w) rows
    (`reshape` on numpy arrays and torch tensors alike)."""
    flat = vals.reshape(vals.shape[0], -1) if vals.ndim == 3 else vals
    return {"result": flat}


@dataclasses.dataclass
class KVResult:
    values: np.ndarray  # per-op fetched (pre-update) values
    report: object  # StageReport
    refcount: Dict[int, int]


@dataclasses.dataclass
class MultiGetResult:
    values: np.ndarray  # (n, max_arity, value_width) gathered values, padded
    mask: np.ndarray  # (n, max_arity) True where a slot holds a requested key
    report: object  # StageReport
    refcount: Dict[int, int]


@dataclasses.dataclass
class ChainResult:
    """A `run_chain` outcome: per-task, per-hop fetched (pre-update) values
    and the key each hop touched (-1 / NaN where a task's chain had already
    ended)."""

    values: np.ndarray  # (n, hops, value_width) fetched values per hop
    keys: np.ndarray  # (n, hops) key touched per hop, -1 = chain ended
    hops: int  # rounds actually executed
    reports: List[object]  # per-hop StageReports, in order


class DistributedHashTable:
    """num_keys buckets of `value_width` words each, random machine placement."""

    def __init__(
        self,
        num_keys: int,
        num_machines: int,
        value_width: int = 8,
        chunk_words: int | None = None,
        seed: int = 0,
    ):
        self.store = DataStore.create(
            num_keys,
            num_machines,
            value_width=value_width,
            chunk_words=chunk_words or value_width,
            salt=seed,
        )
        self.P = num_machines
        self._sessions: Dict[tuple, Orchestrator] = {}

    @property
    def values(self) -> np.ndarray:
        return self.store.values

    def bulk_load(self, keys: np.ndarray, values: np.ndarray) -> None:
        self.store.write_rows(keys, values)

    # ---- sessions ----------------------------------------------------------
    def session(self, engine=None, replicate=None, backend=None, *,
                config=None, kernel_backend=None, replication=None,
                elasticity=None, **engine_opts) -> Orchestrator:
        """The table's cached long-lived session for `engine` (+opts): the
        engine and its CommForest are constructed once, then reused by every
        batch routed through it.

        `replicate=` opts the session into adaptive hot-chunk replication
        (True / dict of `ReplicationConfig` knobs): the session learns the
        key-demand histogram across batches and keeps the hottest chunks
        replicated on every machine — subsequent batches read them locally.

        `backend=` selects the numeric execution backend: None/"torch" — the
        PyTorch pipeline on the CUDA card (the default; raises without
        one), "numpy" — the float64 oracle, or a backend instance
        (``TorchBackend(device="cpu")`` for the CPU); sessions are cached
        per backend, and a torch session keeps the table's values on the
        device across batches. `kernel_backend=` exists for the JAX
        package's spelling only: the port has the one route "auto", and any
        other value raises.

        `config=` carries all of the above as one `SessionConfig` — every
        kwarg here resolves through the same alias table the core session
        uses, so `replicate=` and `replication=` can never drift, and a
        kwarg that contradicts the config raises. `elasticity=` is not
        ported: a session refuses any value but None.
        """
        check_kernel_backend(kernel_backend)
        cfg = resolve_session_config(
            config, engine_opts=engine_opts, engine=engine, backend=backend,
            replication=replication, replicate=replicate,
            elasticity=elasticity)
        return cached_session(self._sessions, self.store, cfg)

    def session_report(self, engine=None, replicate=None,
                       backend=None, **kw) -> SessionReport:
        """Accumulated cross-batch costs for the session keyed by `engine`
        (+the same opts the batches were run with)."""
        return self.session(engine, replicate=replicate, backend=backend,
                            **kw).report

    # ---- single-key batches ------------------------------------------------
    def _make_batch(self, keys: np.ndarray, is_read: np.ndarray,
                    operand: np.ndarray,
                    origin: Optional[np.ndarray]) -> TaskBatch:
        """The §4 GET/UPDATE TaskBatch — the one construction `execute_batch`
        and every `run_chain` hop share, so plan-driven chains are
        batch-for-batch identical to a hand-rolled loop over
        `execute_batch`."""
        n = keys.shape[0]
        keys = np.asarray(keys, dtype=np.int64)
        is_read = np.asarray(is_read, dtype=bool)
        if origin is None:
            origin = TaskBatch.even_origins(n, self.P)
        # context = (is_read_flag, multiplier, addend): σ = 3 words
        ctx = np.concatenate(
            [is_read[:, None].astype(np.float64),
             np.asarray(operand, dtype=np.float64)],
            axis=1,
        )
        # UPDATE tasks write back to their key; GETs write nowhere (-1)
        write_keys = np.where(is_read, np.int64(-1), keys)
        return TaskBatch(contexts=ctx, read_keys=keys, write_keys=write_keys,
                         origin=origin)

    def execute_batch(
        self,
        keys: np.ndarray,
        is_read: np.ndarray,
        operand: np.ndarray,
        *,
        engine: str = None,
        origin: Optional[np.ndarray] = None,
        replicate=None,
        backend=None,
        config=None,
        **engine_opts,
    ) -> KVResult:
        """Run one YCSB-style batch: GETs return values; UPDATEs write
        multiply-and-add results back. `replicate=` routes the batch through
        the table's replicating session for this engine (see `session`);
        `backend=` through its numpy-oracle or torch session;
        `config=` carries the whole session spec as one `SessionConfig`."""
        tasks = self._make_batch(keys, is_read, operand, origin)
        res: OrchestrationResult = self.session(
            engine, replicate=replicate, backend=backend, config=config,
            **engine_opts
        ).run_stage(tasks, _muladd_lambda, write_back="write",
                    return_results=True)
        return KVResult(values=res.results, report=res.report, refcount=res.refcount)

    # ---- dependent read-modify-write chains --------------------------------
    def run_chain(
        self,
        keys: np.ndarray,
        operand: np.ndarray,
        *,
        follow=None,
        max_hops: Optional[int] = None,
        engine: str = None,
        replicate=None,
        backend=None,
        config=None,
        **engine_opts,
    ) -> ChainResult:
        """YCSB-style dependent read-modify-write chains as ONE `StagePlan`:
        hop j applies the §4 multiply-and-add update to each live task's
        current key, then the framework emits hop j+1's `TaskBatch` — from
        the next column of a `(n, hops)` key matrix, or from
        ``follow(fetched_values) -> next_keys`` (−1 ends a task's chain) for
        value-dependent chases (pointer chasing, secondary-index hops).

        Pre-plan, this workload hand-rolled a loop over `execute_batch`
        with a host sync per hop; the plan form runs the
        whole chain against the table's cached session in one call, with
        identical batches (and so bit-identical per-phase cost reports).

        `keys`: either `(n, hops)` — every task's key sequence up front — or
        `(n,)` first keys with `follow=` + `max_hops=`. `operand` is the
        `(n, 2)` (multiplier, addend) pair applied at every hop.
        """
        keys = np.asarray(keys, dtype=np.int64)
        operand = np.asarray(operand, dtype=np.float64)
        if keys.ndim == 2:
            if follow is not None:
                raise ValueError(
                    "pass either a (n, hops) key matrix or follow=, not both")
            depth = keys.shape[1]
            first = keys[:, 0]
        else:
            if follow is None or max_hops is None:
                raise ValueError(
                    "1-D first keys need follow= and max_hops= to bound the "
                    "chase")
            depth = int(max_hops)
            first = keys
        n = first.shape[0]
        w = self.store.value_width
        fetched = np.full((n, depth, w), np.nan)
        touched = np.full((n, depth), -1, dtype=np.int64)
        sess = self.session(engine, replicate=replicate, backend=backend,
                            config=config, **engine_opts)

        def emit(state, res):
            j = state.round
            alive = state["alive"]
            fetched[alive, j] = res.results
            touched[alive, j] = state["keys"]
            if j + 1 >= depth:
                return None
            if follow is None:
                nk = keys[alive, j + 1]
            else:
                nk = np.asarray(follow(res.results), dtype=np.int64)
            keep = nk >= 0
            if not keep.any():
                return None
            state["alive"] = alive = alive[keep]
            state["keys"] = nk = nk[keep]
            live = np.zeros(nk.size, dtype=bool)
            return self._make_batch(nk, live, operand[alive], None)

        plan = StagePlan("kv-chain").loop(
            StagePlan().stage(CARRY, _muladd_lambda, "write", emit=emit,
                              return_results=True),
            until="empty", max_rounds=depth)
        out = sess.run_plan(
            plan,
            carry=self._make_batch(first, np.zeros(n, dtype=bool), operand,
                                   None),
            state={"alive": np.arange(n, dtype=np.int64), "keys": first})
        return ChainResult(values=fetched, keys=touched, hops=out.rounds,
                           reports=[r.report for r in out.results])

    # ---- multi-get batches -------------------------------------------------
    def multi_get(
        self,
        key_groups: Sequence[Sequence[int]] | Tuple[np.ndarray, np.ndarray],
        *,
        engine: str = None,
        origin: Optional[np.ndarray] = None,
        replicate=None,
        backend=None,
        config=None,
        **engine_opts,
    ) -> MultiGetResult:
        """One ragged multi-get batch: task i fetches every key in
        `key_groups[i]` (arity 0..k, duplicates allowed) in a single
        orchestration stage — the §2.1 "one or more data items" workload.

        `key_groups` is either a sequence of per-task key sequences or a
        prebuilt CSR `(read_indptr, read_indices)` pair. Returns the padded
        `(n, max_arity, value_width)` gathered view plus its validity mask.
        """
        if (isinstance(key_groups, tuple) and len(key_groups) == 2
                and isinstance(key_groups[0], np.ndarray)):
            indptr = np.asarray(key_groups[0], dtype=np.int64)
            indices = np.asarray(key_groups[1], dtype=np.int64)
            n = indptr.shape[0] - 1
            if origin is None:
                origin = TaskBatch.even_origins(n, self.P)
            tasks = TaskBatch(contexts=np.zeros((n, 1)), origin=origin,
                              read_indptr=indptr, read_indices=indices)
        else:
            n = len(key_groups)
            if origin is None:
                origin = TaskBatch.even_origins(n, self.P)
            tasks = TaskBatch.from_ragged(np.zeros((n, 1)), key_groups, origin)

        A = max(tasks.max_arity, 1)
        w = self.store.value_width

        res = self.session(
            engine, replicate=replicate, backend=backend, config=config,
            **engine_opts
        ).run_stage(tasks, _flatten_lambda, write_back="add",
                    return_results=True)
        values = res.results.reshape(n, A, w) if A > 1 else res.results[:, None, :]
        if tasks.max_arity <= 1:
            mask = (tasks.arity > 0)[:, None]
        else:
            mask = np.zeros((n, A), dtype=bool)
            row = tasks.pair_task
            col = np.arange(tasks.nnz, dtype=np.int64) - tasks.read_indptr[:-1][row]
            mask[row, col] = True
        return MultiGetResult(values=values, mask=mask, report=res.report,
                              refcount=res.refcount)

    # ---- streaming serving mode (serve/) -----------------------------------
    def serve(self, *, engine: str = None, backend=None,
              kernel_backend=None, replicate=None, config=None,
              session_config=None,
              mode: str = "thread", double_buffer: bool = True,
              **kw) -> "KVFrontend":
        """The table's streaming front door: a `serve.Frontend` over a
        pinned session pair, admitting GET / read-modify-write / MULTI-GET
        requests one at a time and coalescing them into the exact batches
        `execute_batch` / `multi_get` would build — so per-request results
        are bit-identical to the one-shot path for the same request
        sequence.

        `engine=`/`backend=`/`kernel_backend=`/`replicate=` select the
        session exactly as `session()` does (the frontend forks it for the
        second buffer); `session_config=` carries the same selection as one
        `SessionConfig`;
        `config` takes `serve.BatchingConfig` knobs (or a dict);
        `mode="sync"` runs the pipeline inline and deterministic, `"thread"`
        (default) runs the double-buffered router/executor pair. Close the
        frontend (or use it as a context manager) when done.
        """
        sess = self.session(engine, replicate=replicate, backend=backend,
                            kernel_backend=kernel_backend,
                            config=session_config)
        return KVFrontend(self, sess, config=config, mode=mode,
                          double_buffer=double_buffer, **kw)

    # ---- sequential oracle for tests --------------------------------------
    @staticmethod
    def oracle(values, keys, is_read, operand):
        """First-writer-wins batch semantics over a snapshot."""
        values = values.copy()
        snapshot = values.copy()
        results = snapshot[keys].copy()
        written = np.zeros(values.shape[0], dtype=bool)
        for i in np.argsort(np.arange(keys.size), kind="stable"):
            k = keys[i]
            if not is_read[i] and not written[k]:
                values[k] = snapshot[k] * operand[i, 0] + operand[i, 1]
                written[k] = True
        return values, results


class KVFrontend(Frontend):
    """`serve.Frontend` specialized to the hash table's §4 request
    kinds (built by `DistributedHashTable.serve()`):

    * ``get(key)`` — future of the key's `(value_width,)` row;
    * ``read_modify_write(key, mul, add)`` — the §4 multiply-and-add UPDATE;
      future of the *pre-update* row (first-writer-wins within a batch,
      exactly `execute_batch`'s semantics);
    * ``multi_get(keys)`` — ragged multi-get; future of the
      `(len(keys), value_width)` gathered rows.

    GETs and RMWs share one ``"kv"`` tag (one lambda, so they coalesce into
    the same batches `execute_batch` builds); multi-gets ride the separate
    ``"mget"`` tag with the `multi_get` flatten lambda.
    """

    def __init__(self, table: DistributedHashTable, session, **kw):
        super().__init__(session, **kw)
        self.table = table
        self.register("kv", _muladd_lambda, write_back="write", ctx_width=3,
                      result="row")
        self.register("mget", _flatten_lambda, write_back="add", ctx_width=1,
                      result="ragged")

    def get(self, key: int, *, deadline=None) -> "RequestFuture":
        return self.submit("kv", [key], ctx=[1.0, 1.0, 0.0],
                           deadline=deadline)

    def read_modify_write(self, key: int, mul: float, add: float, *,
                          deadline=None) -> "RequestFuture":
        return self.submit("kv", [key], ctx=[0.0, float(mul), float(add)],
                           write_key=int(key), deadline=deadline)

    def multi_get(self, keys, *, deadline=None) -> "RequestFuture":
        return self.submit("mget", keys, deadline=deadline)
