"""TD-Orch: the four-phase orchestration engine (§3).

Phases (§3):
  1. Contention detection — task descriptors climb the communication forest
     as meta-task sets; >C same-level meta-tasks at a node are parked there
     and replaced by one aggregated meta-task (§3.1–3.2).
  2. Task-data co-location via distributed push-pull — refcount ≤ C chunks
     already have every requesting context at their home machine (push done);
     contended chunks broadcast a copy down the meta-task tree to every
     parking site (pull) (§3.3).
  3. Local task execution at the co-location sites.
  4. Merge-able write-backs aggregated up the reverse meta-task tree (§3.4);
     cross-key writes (write key ≠ read key, e.g. DistEdgeMap destinations)
     ride their own forest with en-route ⊗-combining — this is exactly the
     "destination tree" construction TDO-GP uses (§5.1).

Sessions may pass a `ReplicaSet` (the hot-chunk directory maintained by
`core/replication.py`): pairs whose chunk is replicated at the requesting
machine skip the forest entirely and execute in place (their reads are
replica-local words, not wire traffic), and Phase-4 write-backs to
replicated chunks are write-through-propagated from the home copy to every
holder. With no directory (the default) nothing changes — the cost paths
below are word-for-word the unreplicated engine.

Implementation note (simulation fidelity): numeric results are computed by a
single vectorized execute/apply pass — identical for TD-Orch and every
baseline — while *cost* (per-machine words sent/received, work executed,
BSP rounds) is accounted by faithfully walking the forest/meta-task
structures. This separates what the paper proves (Theorem 1 is about cost
and balance) from what a pure re-implementation could only sample.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

import numpy as np

from .backend import make_backend
from .comm_forest import CommForest
from .cost import CostAccumulator, StageReport
from .datastore import DataStore, TaskBatch
from .mergeops import MergeOp, get_merge_op
from .registry import register_engine
from .replication import ReplicaSet, charge_write_through

# words charged per message row (header: key + level/count bookkeeping)
_L0_HEADER = 2  # key + count
_META_WORDS = 4  # key + level + count + store ref ("aggregated metadata", §3.2)


@dataclasses.dataclass
class OrchestrationResult:
    results: Optional[np.ndarray]  # per-task return values (None if f has none)
    report: StageReport
    exec_site: np.ndarray  # machine that executed each task
    refcount: Dict[int, int]  # observed per-chunk contention (hot-spot map)
    # set by the engine="auto" stage policy (core/policy.py): the
    # PolicyDecision behind this stage — chosen engine, predicted vs.
    # realized words, decision-latency words. None for fixed engines.
    decision: Optional[object] = None


@dataclasses.dataclass
class _Stores:
    """Meta-task parking sites created during Phase 1 (§3.2).

    Store s holds the >C level-`level[s]` meta-tasks that were popped out of a
    meta-task set at `machine[s]`; `parent[s]` is the store its aggregated
    L_{level+1} meta-task eventually parked at (-2 = reached the tree root).
    Together these form the *meta-task tree* Phase 2 broadcasts along.
    """

    machine: List[int] = dataclasses.field(default_factory=list)
    key: List[int] = dataclasses.field(default_factory=list)
    level: List[int] = dataclasses.field(default_factory=list)
    parent: List[int] = dataclasses.field(default_factory=list)  # -1 unknown, -2 root
    n_members: List[int] = dataclasses.field(default_factory=list)

    def add(self, machine: int, key: int, level: int, n_members: int) -> int:
        self.machine.append(int(machine))
        self.key.append(int(key))
        self.level.append(int(level))
        self.parent.append(-1)
        self.n_members.append(int(n_members))
        return len(self.machine) - 1

    def __len__(self) -> int:
        return len(self.machine)


@register_engine("tdorch")
class TDOrchEngine:
    """Paper-faithful TD-Orch over a BSP machine model with cost accounting.

    Multi-get batches: every (task, requested-key) pair climbs the forest as
    its own meta-task descriptor. The task's *primary* (first) pair carries
    the σ-word context and decides the execution site; secondary pairs climb
    as bare requests and their values are forwarded to the execution site
    after co-location (Phase 2). Arity-1 batches follow the exact original
    cost path.
    """

    def __init__(
        self,
        num_machines: int,
        *,
        fanout: int | None = None,
        C: int | None = None,
        sigma: int | None = None,
        work_per_task: float = 1.0,
        work_per_pair: float = 0.0,
        backend=None,
    ):
        self.P = int(num_machines)
        self.forest = CommForest.build(self.P, fanout)
        self.C_override = C
        self.sigma_override = sigma
        self.work_per_task = work_per_task
        # per-(task, requested-key) compute at the execution site — models
        # workloads whose Phase-3 cost scales with arity (one expert FFN per
        # routed pair, one gather-reduce per neighbor); 0 keeps the original
        # per-task-only accounting bit-identical
        self.work_per_pair = work_per_pair
        # numeric execution backend ("torch" on the card | "numpy" oracle);
        # cost accounting below is backend-independent by construction
        self.backend = make_backend(backend)

    # ------------------------------------------------------------------
    def run_stage(
        self,
        tasks: TaskBatch,
        store: DataStore,
        f: Callable[[np.ndarray, np.ndarray], Dict[str, np.ndarray]],
        write_back: str | MergeOp = "add",
        return_results: bool = False,
        replicas: ReplicaSet | None = None,
        stealer=None,
    ) -> OrchestrationResult:
        merge = get_merge_op(write_back)
        P, forest = self.P, self.forest
        sigma = self.sigma_override or tasks.ctx_words
        B = store.chunk_words
        # theory-guided C = Θ(B/σ), §3.2/§3.5; ≥2 so a lone duplicate never parks
        C = self.C_override or max(2, int(math.ceil(B / max(sigma, 1))))

        cost = CostAccumulator(P)
        arity = tasks.arity
        has_read = arity > 0
        # each (task, key) pair gets a co-location site; tasks with no read
        # execute in place, the rest where their primary pair lands
        pair_site = tasks.origin[tasks.pair_task]
        # pairs whose chunk is replicated at the requesting machine are
        # satisfied by the session's hot-chunk directory: they never climb
        # the forest, and their task (if primary) executes in place
        if replicas is not None and replicas.hot_ids.size and tasks.nnz:
            pair_local = replicas.holds(tasks.read_indices, pair_site)
        else:
            pair_local = np.zeros(tasks.nnz, dtype=bool)

        stores = _Stores()
        root_rows_key: np.ndarray = np.empty(0, dtype=np.int64)
        root_rows_cnt: np.ndarray = np.empty(0, dtype=np.int64)

        # ---------------- Phase 1: contention detection --------------------
        cost.begin("phase1_contention_detection")
        if tasks.nnz:
            pair_site, root_rows_key, root_rows_cnt = self._phase1(
                tasks, store, cost, stores, pair_site, sigma, C,
                climb=~pair_local,
            )
        cost.end()
        exec_site = tasks.origin.copy()
        exec_site[has_read] = pair_site[tasks.read_indptr[:-1][has_read]]

        # ---------------- Phase-3 work stealing (core/elasticity.py) -------
        # Rebalance exec-site assignment BEFORE Phase 2, so a stolen task's
        # secondary values forward straight to the thief. Replica-local
        # primaries stay put — stealing them would forfeit the local read.
        if stealer is not None:
            cost.begin("phase3_steal")
            prim_local = np.zeros(tasks.n, dtype=bool)
            if pair_local.any():
                prim_local[has_read] = \
                    pair_local[tasks.read_indptr[:-1][has_read]]
            exec_site = stealer.steal(tasks, exec_site, cost,
                                      value_width=store.value_width,
                                      eligible=~prim_local)
            cost.end()

        # ---------------- Phase 2: push-pull co-location -------------------
        cost.begin("phase2_push_pull")
        self._phase2_pull(store, cost, stores, B)
        self._phase2_replica_local(tasks, store, cost, pair_local)
        self._phase2_secondary(tasks, store, cost, pair_site, exec_site,
                               replicas)
        cost.end()

        # ---------------- Phase 3: execution -------------------------------
        cost.begin("phase3_execute")
        # want_result lets a device backend skip materializing per-task
        # results the caller never asked for (a StagePlan round's only host
        # traffic is then the write-back / flush path); exec_site/replicas
        # let the mesh-sharded backend place real work exactly where the
        # cost model just charged it
        out = self.backend.execute(tasks, store, f, merge,
                                   want_result=return_results,
                                   exec_site=exec_site, replicas=replicas)
        updates = out.get("update")
        results = out.get("result")
        cost.work(exec_site, self.work_per_task)
        if self.work_per_pair and tasks.nnz:
            cost.work(exec_site[tasks.pair_task], self.work_per_pair)
        if return_results and results is not None:
            w_r = results.shape[1] if results.ndim > 1 else 1
            cost.send(exec_site, tasks.origin, w_r + 1)
            cost.tick()
        cost.end()

        # ---------------- Phase 4: write-backs -----------------------------
        cost.begin("phase4_write_back")
        if updates is not None:
            self._phase4(tasks, store, cost, stores, exec_site, updates, merge,
                         replicas)
        cost.end()

        refcount = {
            int(k): int(c) for k, c in zip(root_rows_key, root_rows_cnt) if c > 0
        }
        # replica-local pairs are observed at their origin machine — the
        # leaf-level half of contention detection — so the demand histogram
        # keeps seeing the full per-chunk request stream
        if pair_local.any():
            lk, lc = self.backend.key_counts(
                tasks.read_indices[pair_local], store.num_keys)
            for k, c in zip(lk, lc):
                refcount[int(k)] = refcount.get(int(k), 0) + int(c)
        return OrchestrationResult(
            results=results,
            report=cost.totals(),
            exec_site=exec_site,
            refcount=refcount,
        )

    def estimate_cost(self, histogram, layout):
        """Analytic cost estimate for running `layout`'s stage on THIS engine
        (the `engine="auto"` policy contract, core/policy.py).

        Replays the exact Phase 1–4 charging paths above — the same forest
        climb, meta-task parking, pull broadcast, and reverse-tree write-back
        — against a scratch `CostAccumulator`, without executing the lambda.
        The estimate is therefore bit-identical to the realized stage report
        whenever the layout's assumptions hold: the lambda returns
        `layout.update_width`-wide updates for every declared write key and
        `layout.result_width`-wide results when `return_results` is set,
        and no Phase-3 work stealing intervenes.
        `histogram` (the Phase-1 demand
        histogram) is accepted per the estimator contract; TD-Orch's climb
        is replayed from the pair stream itself, which the histogram is a
        projection of."""
        from .policy import PhaseCostEstimate  # local: policy imports engines
        tasks, store, replicas = layout.tasks, layout.store, layout.replicas
        sigma = self.sigma_override or layout.sigma
        B = store.chunk_words
        C = self.C_override or max(2, int(math.ceil(B / max(sigma, 1))))
        cost = CostAccumulator(self.P)
        has_read = tasks.arity > 0
        pair_site = tasks.origin[tasks.pair_task]
        if replicas is not None and replicas.hot_ids.size and tasks.nnz:
            pair_local = replicas.holds(tasks.read_indices, pair_site)
        else:
            pair_local = np.zeros(tasks.nnz, dtype=bool)
        stores = _Stores()
        cost.begin("phase1_contention_detection")
        if tasks.nnz:
            pair_site, _, _ = self._phase1(tasks, store, cost, stores,
                                           pair_site, sigma, C,
                                           climb=~pair_local)
        cost.end()
        exec_site = tasks.origin.copy()
        exec_site[has_read] = pair_site[tasks.read_indptr[:-1][has_read]]
        cost.begin("phase2_push_pull")
        self._phase2_pull(store, cost, stores, B)
        self._phase2_replica_local(tasks, store, cost, pair_local)
        self._phase2_secondary(tasks, store, cost, pair_site, exec_site,
                               replicas)
        cost.end()
        cost.begin("phase3_execute")
        cost.work(exec_site, self.work_per_task)
        if self.work_per_pair and tasks.nnz:
            cost.work(exec_site[tasks.pair_task], self.work_per_pair)
        if layout.return_results:
            cost.send(exec_site, tasks.origin, layout.result_width + 1)
            cost.tick()
        cost.end()
        cost.begin("phase4_write_back")
        if layout.assume_updates:
            wrote = self._phase4_charge(tasks, store, cost, stores, exec_site,
                                        layout.update_width, replicas)
            if wrote:
                # the authoritative ⊙-apply charge (execution.apply_writes)
                uniq = np.unique(tasks.write_keys[tasks.write_keys >= 0])
                cost.work(store.home[uniq], 1.0)
        cost.end()
        return PhaseCostEstimate("tdorch", cost.totals())

    # ------------------------------------------------------------------
    def _phase1(self, tasks, store, cost, stores, pair_site, sigma, C,
                climb=None):
        """Climb the communication forest, merging meta-task sets (§3.1–3.2).

        Merging happens at the *leaf* machines first — a machine's own >C
        duplicate requests collapse to one aggregated meta-task before any
        message is sent (this is what makes the "trivial" F = Θ(n/P) regime
        of Theorem 1's proof work) — then again at every transit VM.

        Each (task, requested-key) pair is its own descriptor. Primary pairs
        carry the task context (σ + header words); secondary pairs of a
        multi-get task are bare requests (header only). `climb` masks the
        pairs that enter the forest at all — replica-local pairs (served by
        the session's hot-chunk directory) stay at their origin.
        """
        forest = self.forest
        nnz = tasks.read_indices.shape[0]
        is_primary = np.zeros(nnz, dtype=bool)
        has = tasks.arity > 0
        is_primary[tasks.read_indptr[:-1][has]] = True
        sel = np.arange(nnz, dtype=np.int64) if climb is None \
            else np.flatnonzero(climb)
        if sel.size == 0:
            return pair_site, np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)
        keys = tasks.read_indices[sel]
        origin = tasks.origin[tasks.pair_task[sel]]
        tbl = {
            "key": keys.copy(),
            "hm": store.home[keys],  # tree root machine
            "node": forest.leaf_node(origin),
            "pm": origin.copy(),
            "lvl": np.zeros(sel.size, dtype=np.int64),
            "cnt": np.ones(sel.size, dtype=np.int64),
            # L0 payload = pair index; L>=1 payload = store id
            "pay": sel,
            # words an L0 row costs to move (context rides the primary pair)
            "w0": np.where(is_primary[sel], sigma + _L0_HEADER, _L0_HEADER),
        }

        # merge at leaves (round 0: no movement, purely local aggregation)
        tbl = self._merge_pass(tbl, stores, pair_site, cost, C)

        for _round in range(forest.height):
            # ---- move every live meta-task to its parent transit VM
            parent_node = forest.parent(tbl["node"])
            new_pm = forest.physical(tbl["hm"], parent_node)
            words = np.where(tbl["lvl"] == 0, tbl["w0"], _META_WORDS)
            cost.send(tbl["pm"], new_pm, words)
            cost.tick()
            tbl["node"], tbl["pm"] = parent_node, new_pm
            # ---- merge per (key, node); skip the root — the chunk lives
            # there, so arriving L0 contexts are final (push complete, §3.3)
            if (tbl["node"] != 0).any():
                tbl = self._merge_pass(tbl, stores, pair_site, cost, C)

        # all rows now at roots: L0 pairs co-locate at the chunk's home
        key, lvl, cnt, pay, pm = (tbl[k] for k in ("key", "lvl", "cnt", "pay", "pm"))
        l0 = lvl == 0
        pair_site[pay[l0]] = pm[l0]
        for p in pay[~l0]:
            stores.parent[int(p)] = -2  # reached root
        # per-key observed refcount at root — the Phase-1 contention
        # histogram (the CUDA histogram kernel on the torch backend)
        if key.size:
            uk, rc = self.backend.key_counts(key, store.num_keys, weights=cnt)
        else:
            uk = np.empty(0, dtype=np.int64)
            rc = np.empty(0, dtype=np.int64)
        return pair_site, uk, rc

    # ------------------------------------------------------------------
    def _merge_pass(self, tbl, stores, pair_site, cost, C):
        """Merge meta-task sets per (key, node): >C same-level meta-tasks are
        parked at the hosting machine and replaced by one L_{ℓ+1} aggregate;
        the cascade may overflow upward (§3.2, Fig. 4)."""
        if tbl["key"].size == 0:
            return tbl
        at_root = tbl["node"] == 0
        grp_key = (
            tbl["key"] * np.int64(self.forest.first_at_depth(self.forest.height + 1))
            + tbl["node"]
        )
        uniq, gid = np.unique(grp_key, return_inverse=True)
        G = uniq.size
        gid = np.where(at_root, np.int64(-1), gid)  # root sets never merge
        cost.work(tbl["pm"][~at_root], 1.0)  # merge bookkeeping work
        tbl = dict(tbl)
        tbl["gid"] = gid

        level = 0
        while level <= int(tbl["lvl"].max(initial=0)):
            at_level = np.flatnonzero((tbl["gid"] >= 0) & (tbl["lvl"] == level))
            if at_level.size == 0:
                level += 1
                continue
            counts = np.bincount(tbl["gid"][at_level], minlength=G)
            hot = counts > C
            park = at_level[hot[tbl["gid"][at_level]]]
            if park.size == 0:
                level += 1
                continue
            park = park[np.argsort(tbl["gid"][park], kind="stable")]
            bounds = np.flatnonzero(
                np.r_[True, tbl["gid"][park][1:] != tbl["gid"][park][:-1]]
            )
            emit = {k: [] for k in tbl}
            # iterate hot groups (few — only contended chunks get here)
            for bi, start in enumerate(bounds):
                stop = bounds[bi + 1] if bi + 1 < bounds.size else park.size
                members = park[start:stop]
                g_pm = int(tbl["pm"][members[0]])
                g_key = int(tbl["key"][members[0]])
                sid = stores.add(g_pm, g_key, level, members.size)
                # park: L0 members co-locate here; store members get parent
                if level == 0:
                    pair_site[tbl["pay"][members]] = g_pm
                else:
                    for p in tbl["pay"][members]:
                        stores.parent[int(p)] = sid
                # emit the aggregated L_{level+1} meta-task
                emit["key"].append(g_key)
                emit["hm"].append(int(tbl["hm"][members[0]]))
                emit["node"].append(int(tbl["node"][members[0]]))
                emit["pm"].append(g_pm)
                emit["lvl"].append(level + 1)
                emit["cnt"].append(int(tbl["cnt"][members].sum()))
                emit["pay"].append(sid)
                emit["gid"].append(int(tbl["gid"][members[0]]))
                emit["w0"].append(_META_WORDS)  # unused: aggregates are L≥1
            keep = np.ones(tbl["key"].size, dtype=bool)
            keep[park] = False
            for k in tbl:
                tbl[k] = np.concatenate(
                    [tbl[k][keep], np.asarray(emit[k], dtype=np.int64)]
                )
            level += 1
        tbl.pop("gid")
        return tbl

    # ------------------------------------------------------------------
    def _phase2_pull(self, store, cost, stores, B):
        """Broadcast chunk copies down the meta-task tree (§3.3 "Pull")."""
        if len(stores) == 0:
            return
        machine = np.array(stores.machine, dtype=np.int64)
        key = np.array(stores.key, dtype=np.int64)
        parent = np.array(stores.parent, dtype=np.int64)
        src = np.where(parent >= 0, machine[np.maximum(parent, 0)], store.home[key])
        cost.send(src, machine, B + 1)
        levels = np.array(stores.level, dtype=np.int64)
        cost.tick(int(levels.max(initial=0)) + 1)
        cost.work(machine, 1.0)

    # ------------------------------------------------------------------
    def _phase2_replica_local(self, tasks, store, cost, pair_local):
        """Serve replica-resident primary pairs from the local copy: the task
        executes at its origin, the value is a local memory read — recorded
        as replica-local words, never as wire traffic."""
        if not pair_local.any():
            return
        is_primary = np.zeros(tasks.nnz, dtype=bool)
        has = tasks.arity > 0
        is_primary[tasks.read_indptr[:-1][has]] = True
        prim = pair_local & is_primary
        if prim.any():
            cost.local(tasks.origin[tasks.pair_task[prim]], store.value_width)

    # ------------------------------------------------------------------
    def _phase2_secondary(self, tasks, store, cost, pair_site, exec_site,
                          replicas=None):
        """Forward secondary-pair values to their task's execution site.

        A multi-get task executes where its primary pair landed; each of its
        other requested values — now resident at the pair's co-location site
        (a parked transit machine with a chunk copy, or the chunk's home) —
        is forwarded there as a (key, value) row. Chunks replicated at the
        execution site itself are read there directly (replica-local words,
        no forwarding). Arity-1 batches have no secondary pairs, so this is
        free and round-less for them.
        """
        if tasks.max_arity <= 1:
            return
        is_primary = np.zeros(tasks.nnz, dtype=bool)
        has = tasks.arity > 0
        is_primary[tasks.read_indptr[:-1][has]] = True
        sec = np.flatnonzero(~is_primary)
        if sec.size == 0:
            return
        dst = exec_site[tasks.pair_task[sec]]
        if replicas is not None and replicas.hot_ids.size:
            loc = replicas.holds(tasks.read_indices[sec], dst)
            if loc.any():
                cost.local(dst[loc], store.value_width)
                sec, dst = sec[~loc], dst[~loc]
                if sec.size == 0:
                    return
        cost.send(pair_site[sec], dst, store.value_width + 1)
        cost.work(pair_site[sec], 1.0)
        cost.tick()

    # ------------------------------------------------------------------
    def _phase4(self, tasks, store, cost, stores, exec_site, updates, merge,
                replicas=None):
        """Merge-able write-backs (§3.4). In-tree writes climb the reverse
        meta-task tree; cross-key writes ride the destination forest.
        Written chunks that are replicated get their ⊗-combined update
        write-through-propagated from home to every other holder."""
        updates = np.atleast_2d(np.asarray(updates))
        if updates.shape[0] != tasks.n:
            updates = updates.T
        if not self._phase4_charge(tasks, store, cost, stores, exec_site,
                                   updates.shape[1], replicas):
            return
        # --- numeric application (single authoritative ⊙ per chunk, shared)
        self.backend.apply_writes(tasks, store, updates, merge, cost)

    # ------------------------------------------------------------------
    def _phase4_charge(self, tasks, store, cost, stores, exec_site, w_u,
                       replicas=None) -> bool:
        """The Phase-4 charging paths, without the numeric ⊙-apply (kept
        apart so a cost estimator can replay the bill alone). Returns
        whether any write happened."""
        writes = tasks.write_keys >= 0
        if not writes.any():
            return False

        # writes to the task's primary key climb its reverse meta-task tree;
        # everything else (cross-key, secondary-key) rides the dest forest
        in_tree = writes & (tasks.write_keys == tasks.primary_read)
        cross = writes & ~in_tree

        # --- reverse meta-task tree: one ⊗-combined message per store edge
        if len(stores) > 0:
            machine = np.array(stores.machine, dtype=np.int64)
            key = np.array(stores.key, dtype=np.int64)
            parent = np.array(stores.parent, dtype=np.int64)
            dst = np.where(parent >= 0, machine[np.maximum(parent, 0)], store.home[key])
            cost.send(machine, dst, w_u + 1)
            n_members = np.array(stores.n_members, dtype=np.float64)
            cost.work(machine, n_members)  # local ⊗ combining
            levels = np.array(stores.level, dtype=np.int64)
            cost.tick(int(levels.max(initial=0)) + 1)
        # root-resident tasks write locally (no comm)

        # --- cross-key writes: climb the destination forest, ⊗ en route
        if cross.any():
            self._forest_scatter_reduce(
                tasks.write_keys[cross], exec_site[cross], store, cost, w_u
            )

        # --- replica maintenance: home → holders, one combined row each
        if replicas is not None:
            charge_write_through(cost, store.home, replicas,
                                 tasks.write_keys[writes], w_u)
        return True

    # ------------------------------------------------------------------
    def _forest_scatter_reduce(self, wkeys, site, store, cost, w_u):
        """Route (key, update) rows up home(key)'s tree, combining duplicates
        at every transit node — TDO-GP's destination-tree write path (§5.1).
        Mergeability means sets never overflow: duplicates collapse to one."""
        forest = self.forest
        # pre-combine per (machine, key): ⊗ at the execution site first
        pairs = site.astype(np.int64) * np.int64(store.num_keys + 1) + wkeys
        uniq, inv = np.unique(pairs, return_inverse=True)
        cost.work(site, 1.0)
        machine = (uniq // np.int64(store.num_keys + 1)).astype(np.int64)
        key = (uniq % np.int64(store.num_keys + 1)).astype(np.int64)
        hm = store.home[key]
        node = forest.leaf_node(machine)
        pm = machine.copy()
        for _ in range(forest.height):
            parent_node = forest.parent(node)
            new_pm = forest.physical(hm, parent_node)
            cost.send(pm, new_pm, w_u + 2)
            cost.tick()
            node, pm = parent_node, new_pm
            # combine rows that met at the same (key, node)
            grp = key * np.int64(forest.first_at_depth(forest.height + 1)) + node
            uq, first_idx = np.unique(grp, return_index=True)
            cost.work(pm, 1.0)
            key, hm, node, pm = key[first_idx], hm[first_idx], node[first_idx], pm[first_idx]
