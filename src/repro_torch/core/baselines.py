"""Baseline orchestration strategies (§2.3): direct-pull, direct-push, and
the sort-based MPC scheme. All share the vectorized execute/apply path with
TD-Orch (`core/execution.py`, or the torch backend's device pass) so the
four engines produce the same stores — only the cost profile (and thus
load balance) differs, exactly the comparison in §4/Fig. 5.

Ragged multi-get batches: each (task, requested-key) pair is a fetch/ship
unit. Direct-pull fetches every pair's chunk to the task's origin; direct-push
ships the task to its *primary* key's home and pulls the remaining chunks
there; sort-based sorts by primary key and broadcasts every requested chunk
to the sorted runs. Arity-1 batches follow the exact original cost paths.

All three consult the session's hot-chunk `ReplicaSet` when one is passed
(core/replication.py): reads of chunks replicated at the consuming machine
are served locally (replica-local words), and writes to replicated chunks
are write-through-propagated home → holders — so replication benefits are
comparable engine-to-engine on the same directory.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np

from .backend import make_backend
from .cost import CostAccumulator
from .datastore import DataStore, TaskBatch
from .engine import OrchestrationResult, _L0_HEADER
from .execution import update_width
from .mergeops import MergeOp, get_merge_op
from .registry import register_engine
from .replication import charge_write_through


def _split_replica_local(cost, store, replicas, machines, keys):
    """Drop (machine, key) pairs served by a local replica, charging their
    reads as replica-local words; returns the remaining remote pairs. Every
    engine consults the session's directory through this one helper."""
    if replicas is None or replicas.hot_ids.size == 0 or keys.size == 0:
        return machines, keys
    loc = replicas.holds(keys, machines)
    if loc.any():
        cost.local(machines[loc], store.value_width)
    return machines[~loc], keys[~loc]


def _dedup_pairs(machine: np.ndarray, keys: np.ndarray, num_keys: int):
    """Unique (machine, key) pairs -> (machines, keys)."""
    pair = machine.astype(np.int64) * np.int64(num_keys + 1) + keys
    uniq = np.unique(pair)
    return ((uniq // np.int64(num_keys + 1)).astype(np.int64),
            (uniq % np.int64(num_keys + 1)).astype(np.int64))


@register_engine("pull")
class DirectPullEngine:
    """Dedup per machine, then fetch every needed chunk to the tasks (§2.3
    "Direct Pull" — the RDMA pattern). Hot chunks swamp their home machine
    with outbound B-word replies."""

    def __init__(self, num_machines: int, work_per_task: float = 1.0,
                 work_per_pair: float = 0.0, backend=None):
        self.P = int(num_machines)
        self.work_per_task = work_per_task
        self.work_per_pair = work_per_pair
        self.backend = make_backend(backend)

    def run_stage(self, tasks, store, f, write_back="add", return_results=False,
                  replicas=None):
        merge = get_merge_op(write_back)
        cost = CostAccumulator(self.P)
        B = store.chunk_words

        cost.begin("pull_fetch")
        if tasks.nnz:
            org, key = _dedup_pairs(tasks.origin[tasks.pair_task],
                                    tasks.read_indices, store.num_keys)
            org, key = _split_replica_local(cost, store, replicas, org, key)
            if key.size:
                hm = store.home[key]
                cost.send(org, hm, 2)  # request: key + reply address
                cost.work(hm, 1.0)
                cost.send(hm, org, B + 1)  # reply: the chunk
                cost.tick(2)
        cost.end()

        cost.begin("pull_execute")
        out = self.backend.execute(tasks, store, f, merge,
                                   want_result=return_results,
                                   replicas=replicas)
        cost.work(tasks.origin, self.work_per_task)
        if self.work_per_pair and tasks.nnz:
            cost.work(tasks.origin[tasks.pair_task], self.work_per_pair)
        cost.end()
        # results already live at the task's origin machine — no return traffic

        cost.begin("pull_write_back")
        updates = out.get("update")
        if updates is not None:
            writes = tasks.write_keys >= 0
            if writes.any():
                # RDMA semantics: every task issues its own remote write —
                # no network-side combining, so a hot chunk's home machine
                # receives one message per writer (the §2.3 skew pathology).
                w_u = update_width(updates)
                hm = store.home[tasks.write_keys[writes]]
                cost.send(tasks.origin[writes], hm, w_u + 1)
                cost.work(hm, 1.0)
                cost.tick()
                charge_write_through(cost, store.home, replicas,
                                     tasks.write_keys[writes], w_u)
            self.backend.apply_writes(tasks, store, updates, merge, cost)
        cost.end()

        return OrchestrationResult(out.get("result"), cost.totals(),
                                   tasks.origin.copy(), {})

    def estimate_cost(self, histogram, layout):
        """Replay the direct-pull charging paths above against a scratch
        accumulator (the `engine="auto"` estimator contract, core/policy.py).
        Bit-identical to the realized report under the layout's width/update
        assumptions; `histogram` is accepted per the contract (pull's bill
        is a closed form of the deduped pair stream)."""
        from .policy import PhaseCostEstimate
        tasks, store, replicas = layout.tasks, layout.store, layout.replicas
        cost = CostAccumulator(self.P)
        B = store.chunk_words
        cost.begin("pull_fetch")
        if tasks.nnz:
            org, key = _dedup_pairs(tasks.origin[tasks.pair_task],
                                    tasks.read_indices, store.num_keys)
            org, key = _split_replica_local(cost, store, replicas, org, key)
            if key.size:
                hm = store.home[key]
                cost.send(org, hm, 2)
                cost.work(hm, 1.0)
                cost.send(hm, org, B + 1)
                cost.tick(2)
        cost.end()
        cost.begin("pull_execute")
        cost.work(tasks.origin, self.work_per_task)
        if self.work_per_pair and tasks.nnz:
            cost.work(tasks.origin[tasks.pair_task], self.work_per_pair)
        cost.end()
        cost.begin("pull_write_back")
        writes = tasks.write_keys >= 0
        if layout.assume_updates and writes.any():
            w_u = layout.update_width
            hm = store.home[tasks.write_keys[writes]]
            cost.send(tasks.origin[writes], hm, w_u + 1)
            cost.work(hm, 1.0)
            cost.tick()
            charge_write_through(cost, store.home, replicas,
                                 tasks.write_keys[writes], w_u)
            uniq = np.unique(tasks.write_keys[writes])
            cost.work(store.home[uniq], 1.0)  # the ⊙-apply charge
        cost.end()
        return PhaseCostEstimate("pull", cost.totals())


@register_engine("push")
class DirectPushEngine:
    """Ship every task context to its chunk's home machine (§2.3 "Direct
    Push" — the RPC pattern). Hot chunks swamp their home with inbound σ-word
    contexts *and* with the execution work itself. Multi-get tasks go to
    their primary key's home and pull the remaining chunks there."""

    def __init__(self, num_machines: int, work_per_task: float = 1.0,
                 work_per_pair: float = 0.0, backend=None):
        self.P = int(num_machines)
        self.work_per_task = work_per_task
        self.work_per_pair = work_per_pair
        self.backend = make_backend(backend)

    def run_stage(self, tasks, store, f, write_back="add", return_results=False,
                  replicas=None, stealer=None):
        merge = get_merge_op(write_back)
        cost = CostAccumulator(self.P)
        sigma = tasks.ctx_words
        B = store.chunk_words
        primary = tasks.primary_read
        reads = primary >= 0
        exec_site = tasks.origin.copy()
        exec_site[reads] = store.home[primary[reads]]
        wr_only = (~reads) & (tasks.write_keys >= 0)
        exec_site[wr_only] = store.home[tasks.write_keys[wr_only]]
        prim_local = np.zeros(tasks.n, dtype=bool)
        if replicas is not None and replicas.hot_ids.size:
            # primary chunk replicated at the origin: no RPC — the task
            # executes in place against the local replica
            prim_local[reads] = replicas.holds(primary[reads],
                                               tasks.origin[reads])
            exec_site[prim_local] = tasks.origin[prim_local]

        # ---- Phase-3 work stealing (core/elasticity.py): reassign over-
        # subscribed homes' RPCs before they are issued. The offload below
        # already carries the context to wherever exec_site points, so the
        # steal only pays for the primary chunk following the task.
        if stealer is not None:
            cost.begin("phase3_steal")
            moved, dst = stealer.plan(exec_site, eligible=~prim_local)
            if moved.size:
                src = exec_site[moved].copy()
                exec_site = exec_site.copy()
                exec_site[moved] = dst
                rd = moved[reads[moved]]
                if rd.size:
                    mch, key = _dedup_pairs(exec_site[rd], primary[rd],
                                            store.num_keys)
                    cost.send(store.home[key], mch, B + 1)
                    cost.tick()
                stealer.note(src, dst)
            cost.end()

        cost.begin("push_offload")
        cost.send(tasks.origin, exec_site, sigma + _L0_HEADER)
        cost.tick()
        if prim_local.any():
            cost.local(tasks.origin[prim_local], store.value_width)
        if tasks.max_arity > 1:
            # secondary chunks fetched to the execution site, deduped per
            # (site, key) — same RPC round-trip shape as the offload
            is_primary = np.zeros(tasks.nnz, dtype=bool)
            is_primary[tasks.read_indptr[:-1][reads]] = True
            sec = np.flatnonzero(~is_primary)
            if sec.size:
                site, key = _dedup_pairs(exec_site[tasks.pair_task[sec]],
                                         tasks.read_indices[sec], store.num_keys)
                site, key = _split_replica_local(cost, store, replicas,
                                                 site, key)
                if key.size:
                    hm = store.home[key]
                    cost.send(site, hm, 2)
                    cost.send(hm, site, B + 1)
                    cost.tick(2)
        cost.end()

        cost.begin("push_execute")
        out = self.backend.execute(tasks, store, f, merge,
                                   want_result=return_results,
                                   exec_site=exec_site, replicas=replicas)
        cost.work(exec_site, self.work_per_task)
        if self.work_per_pair and tasks.nnz:
            cost.work(exec_site[tasks.pair_task], self.work_per_pair)
        results = out.get("result")
        if return_results and results is not None:
            w_r = results.shape[1] if results.ndim > 1 else 1
            cost.send(exec_site, tasks.origin, w_r + 1)
            cost.tick()
        cost.end()

        cost.begin("push_write_back")
        updates = out.get("update")
        if updates is not None:
            writes = tasks.write_keys >= 0
            cross = writes & (store.home[np.maximum(tasks.write_keys, 0)] != exec_site)
            if cross.any():
                w_u = update_width(updates)
                org, key = _dedup_pairs(exec_site[cross], tasks.write_keys[cross],
                                        store.num_keys)
                cost.send(org, store.home[key], w_u + 1)
                cost.tick()
            if writes.any():
                charge_write_through(cost, store.home, replicas,
                                     tasks.write_keys[writes],
                                     update_width(updates))
            self.backend.apply_writes(tasks, store, updates, merge, cost)
        cost.end()

        return OrchestrationResult(results, cost.totals(), exec_site, {})

    def estimate_cost(self, histogram, layout):
        """Replay the direct-push charging paths above against a scratch
        accumulator (the `engine="auto"` estimator contract)."""
        from .policy import PhaseCostEstimate
        tasks, store, replicas = layout.tasks, layout.store, layout.replicas
        cost = CostAccumulator(self.P)
        sigma = tasks.ctx_words
        B = store.chunk_words
        primary = tasks.primary_read
        reads = primary >= 0
        exec_site = tasks.origin.copy()
        exec_site[reads] = store.home[primary[reads]]
        wr_only = (~reads) & (tasks.write_keys >= 0)
        exec_site[wr_only] = store.home[tasks.write_keys[wr_only]]
        prim_local = np.zeros(tasks.n, dtype=bool)
        if replicas is not None and replicas.hot_ids.size:
            prim_local[reads] = replicas.holds(primary[reads],
                                               tasks.origin[reads])
            exec_site[prim_local] = tasks.origin[prim_local]
        cost.begin("push_offload")
        cost.send(tasks.origin, exec_site, sigma + _L0_HEADER)
        cost.tick()
        if prim_local.any():
            cost.local(tasks.origin[prim_local], store.value_width)
        if tasks.max_arity > 1:
            is_primary = np.zeros(tasks.nnz, dtype=bool)
            is_primary[tasks.read_indptr[:-1][reads]] = True
            sec = np.flatnonzero(~is_primary)
            if sec.size:
                site, key = _dedup_pairs(exec_site[tasks.pair_task[sec]],
                                         tasks.read_indices[sec],
                                         store.num_keys)
                site, key = _split_replica_local(cost, store, replicas,
                                                 site, key)
                if key.size:
                    hm = store.home[key]
                    cost.send(site, hm, 2)
                    cost.send(hm, site, B + 1)
                    cost.tick(2)
        cost.end()
        cost.begin("push_execute")
        cost.work(exec_site, self.work_per_task)
        if self.work_per_pair and tasks.nnz:
            cost.work(exec_site[tasks.pair_task], self.work_per_pair)
        if layout.return_results:
            cost.send(exec_site, tasks.origin, layout.result_width + 1)
            cost.tick()
        cost.end()
        cost.begin("push_write_back")
        writes = tasks.write_keys >= 0
        if layout.assume_updates and writes.any():
            w_u = layout.update_width
            cross = writes & (store.home[np.maximum(tasks.write_keys, 0)]
                              != exec_site)
            if cross.any():
                org, key = _dedup_pairs(exec_site[cross],
                                        tasks.write_keys[cross],
                                        store.num_keys)
                cost.send(org, store.home[key], w_u + 1)
                cost.tick()
            charge_write_through(cost, store.home, replicas,
                                 tasks.write_keys[writes], w_u)
            uniq = np.unique(tasks.write_keys[writes])
            cost.work(store.home[uniq], 1.0)  # the ⊙-apply charge
        cost.end()
        return PhaseCostEstimate("push", cost.totals())


@register_engine("sort")
class SortBasedEngine:
    """Theory-guided MPC scheme (§2.3): sort tasks by chunk address, broadcast
    chunks to the sorted runs, execute, reverse. Asymptotically optimal but
    pays ≥3 full passes over the task contexts (§3.6) — the constant factor
    TD-Orch eliminates. Modeled after KaDiS-style sample sort with perfect
    balance (generous to the baseline)."""

    def __init__(self, num_machines: int, work_per_task: float = 1.0,
                 work_per_pair: float = 0.0, backend=None):
        self.P = int(num_machines)
        self.work_per_task = work_per_task
        self.work_per_pair = work_per_pair
        self.backend = make_backend(backend)

    def run_stage(self, tasks, store, f, write_back="add", return_results=False,
                  replicas=None):
        merge = get_merge_op(write_back)
        cost = CostAccumulator(self.P)
        P = self.P
        sigma = tasks.ctx_words
        B = store.chunk_words
        n = tasks.n
        primary = tasks.primary_read

        # ---- pass 1: global sample-sort of tasks by (primary) read key
        cost.begin("sort_pass")
        order = self.backend.argsort_stable(
            np.where(primary >= 0, primary, tasks.write_keys))
        block = max(1, -(-n // P))
        sorted_machine = np.empty(n, dtype=np.int64)
        sorted_machine[order] = np.arange(n, dtype=np.int64) // block
        cost.send(tasks.origin, sorted_machine, sigma + _L0_HEADER)
        # sample-sort bookkeeping: splitter exchange ~ P·log n words each
        cost.send(np.arange(P), np.zeros(P, dtype=np.int64), np.log2(max(n, 2)))
        cost.work(sorted_machine, np.log2(max(n / P, 2)))  # local sort work
        cost.tick(2)
        cost.end()

        # ---- pass 2: broadcast each chunk to every machine its run spans
        cost.begin("sort_broadcast")
        if tasks.nnz:
            mch, key = _dedup_pairs(sorted_machine[tasks.pair_task],
                                    tasks.read_indices, store.num_keys)
            mch, key = _split_replica_local(cost, store, replicas, mch, key)
            if key.size:
                cost.send(store.home[key], mch, B + 1)
                cost.tick()
        cost.end()

        cost.begin("sort_execute")
        out = self.backend.execute(tasks, store, f, merge,
                                   want_result=return_results,
                                   exec_site=sorted_machine, replicas=replicas)
        cost.work(sorted_machine, self.work_per_task)
        if self.work_per_pair and tasks.nnz:
            cost.work(sorted_machine[tasks.pair_task], self.work_per_pair)
        cost.end()

        # ---- pass 3: reverse broadcast (write-backs) + reverse sort
        cost.begin("sort_reverse")
        updates = out.get("update")
        if updates is not None:
            writes = tasks.write_keys >= 0
            if writes.any():
                w_u = update_width(updates)
                mch, key = _dedup_pairs(sorted_machine[writes],
                                        tasks.write_keys[writes], store.num_keys)
                cost.send(mch, store.home[key], w_u + 1)
                charge_write_through(cost, store.home, replicas,
                                     tasks.write_keys[writes], w_u)
            self.backend.apply_writes(tasks, store, updates, merge, cost)
        results = out.get("result")
        if return_results and results is not None:
            w_r = results.shape[1] if results.ndim > 1 else 1
            cost.send(sorted_machine, tasks.origin, w_r + 1)
        else:
            # tasks themselves are restored to their original order/machine
            cost.send(sorted_machine, tasks.origin, sigma + _L0_HEADER)
        cost.tick(2)
        cost.end()

        return OrchestrationResult(results, cost.totals(), sorted_machine, {})

    def estimate_cost(self, histogram, layout):
        """Replay the sample-sort charging paths. Run placement uses
        `backend.argsort_stable`, which is parity-pinned across backends —
        so the estimate (and any policy decision built on it) is
        bit-identical on numpy and torch."""
        from .policy import PhaseCostEstimate
        tasks, store, replicas = layout.tasks, layout.store, layout.replicas
        cost = CostAccumulator(self.P)
        P = self.P
        sigma = tasks.ctx_words
        B = store.chunk_words
        n = tasks.n
        primary = tasks.primary_read
        cost.begin("sort_pass")
        order = self.backend.argsort_stable(
            np.where(primary >= 0, primary, tasks.write_keys))
        block = max(1, -(-n // P))
        sorted_machine = np.empty(n, dtype=np.int64)
        sorted_machine[order] = np.arange(n, dtype=np.int64) // block
        cost.send(tasks.origin, sorted_machine, sigma + _L0_HEADER)
        cost.send(np.arange(P), np.zeros(P, dtype=np.int64),
                  np.log2(max(n, 2)))
        cost.work(sorted_machine, np.log2(max(n / P, 2)))
        cost.tick(2)
        cost.end()
        cost.begin("sort_broadcast")
        if tasks.nnz:
            mch, key = _dedup_pairs(sorted_machine[tasks.pair_task],
                                    tasks.read_indices, store.num_keys)
            mch, key = _split_replica_local(cost, store, replicas, mch, key)
            if key.size:
                cost.send(store.home[key], mch, B + 1)
                cost.tick()
        cost.end()
        cost.begin("sort_execute")
        cost.work(sorted_machine, self.work_per_task)
        if self.work_per_pair and tasks.nnz:
            cost.work(sorted_machine[tasks.pair_task], self.work_per_pair)
        cost.end()
        cost.begin("sort_reverse")
        writes = tasks.write_keys >= 0
        if layout.assume_updates:
            if writes.any():
                w_u = layout.update_width
                mch, key = _dedup_pairs(sorted_machine[writes],
                                        tasks.write_keys[writes],
                                        store.num_keys)
                cost.send(mch, store.home[key], w_u + 1)
                charge_write_through(cost, store.home, replicas,
                                     tasks.write_keys[writes], w_u)
                uniq = np.unique(tasks.write_keys[writes])
                cost.work(store.home[uniq], 1.0)  # the ⊙-apply charge
        if layout.return_results:
            cost.send(sorted_machine, tasks.origin, layout.result_width + 1)
        else:
            cost.send(sorted_machine, tasks.origin, sigma + _L0_HEADER)
        cost.tick(2)
        cost.end()
        return PhaseCostEstimate("sort", cost.totals())
