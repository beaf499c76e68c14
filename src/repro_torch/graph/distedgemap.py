"""DISTEDGEMAP (§5, Fig. 6): the distributed EdgeMap over an orchestrated
graph, with sparse/dense dual-mode execution (§5.1) and the T1–T3
implementation techniques (§5.2 / Appendix D) as toggleable features.

Semantics (Fig. 6): apply `f` to every edge (u,v) with u ∈ U (and, if given,
filter_dst(v)); aggregate returned values per destination with the merge-able
`merge_value`; `write_back` applies the aggregate to each touched v and
returns which vertices changed — those form the next frontier.

Numeric execution is one vectorized pass (identical in both modes); *cost*
is accounted against the ingestion-time source/destination trees:
  sparse mode — each active source's value travels down its source tree
  (root = the pinned vertex value, leaves = machines storing its edges);
  dense mode — destination-aware broadcast (T1): each active value goes
  directly to exactly the machines storing its out-edges.
Write-backs are ⊗-combined per (machine, destination), then climb the
destination tree to the vertex home (§5.1 "destination trees").

The source-tree machinery (per-member parent maps over the C-ary trees) is
session state: rounds driven through a `GraphSession` reuse the session's
precomputed `TreeCharger`; direct calls borrow the graph's cached default
session instead of rebuilding the layout per call.

Hot-vertex replication (`replicate=`, session-owned, cost-model only): the
session's `HotChunkReplicator` learns per-round vertex demand and keeps the
hottest vertices' values resident on every machine — their source-value
propagation becomes machine-local reads, and only *changed* values are
write-through-propagated back to holders. Numerics are unaffected.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from ..core.backend import make_backend
from ..core.cost import CostAccumulator, StageReport
from ..core.mergeops import get_merge_op
from ..core.replication import charge_write_through
from .partition import OrchestratedGraph
from .session import VALUE_WORDS, TreeCharger, _expand_csr, session_for
from .vertex_subset import DistVertexSubset


def _estimate_mode_costs(og, sess, idx, replicas, dedup):
    """Charge both propagation modes' bills against scratch accumulators —
    the graph-side `estimate_cost` (core/policy.py contract). Exact by
    construction: the same `TreeCharger.charge`/`direct_broadcast` calls the
    realized round makes, over the same frontier and replica discount. Only
    the source-propagation phase is mode-DEPENDENT (edge compute and the
    destination-tree write-back cost the same either way), so the argmin
    over these estimates is the argmin over full round bills."""
    from ..core.policy import PhaseCostEstimate
    out = {}
    for mode in ("sparse", "dense"):
        cost = CostAccumulator(og.P)
        cost.begin(f"edgemap_{mode}")
        if idx.size:
            live = idx
            if replicas is not None:
                slot = replicas.lookup[idx]
                hot = slot >= 0
                hot[hot] = replicas.holders[slot[hot]].all(axis=1)
                if hot.any() and (dedup or mode == "sparse"):
                    flat_h, _ = _expand_csr(og.src_grp_indptr, idx[hot])
                    cost.local(og.src_grp_machines[flat_h], VALUE_WORDS)
                    live = idx[~hot]
            if mode == "sparse":
                h = (sess.src_charger.charge(cost, live, VALUE_WORDS,
                                             upward=False)
                     if live.size else 0)
                cost.tick(max(h, 1))
            else:
                if dedup:
                    if live.size:
                        sess.src_charger.direct_broadcast(cost, live,
                                                          VALUE_WORDS)
                else:
                    for mch in np.arange(og.P, dtype=np.int64):
                        cost.send(og.vertex_home[idx],
                                  np.full(idx.size, mch), VALUE_WORDS)
                cost.tick(1)
        cost.end()
        out[mode] = PhaseCostEstimate(mode, cost.totals())
    return out


@dataclasses.dataclass
class EdgeMapStats:
    mode: str
    active_vertices: int
    active_edges: int
    report: Optional[StageReport] = None


def dist_edge_map(
    og: OrchestratedGraph,
    U: DistVertexSubset,
    f: Callable[[np.ndarray, np.ndarray, np.ndarray], np.ndarray],
    write_back: Callable[[np.ndarray, np.ndarray], np.ndarray],
    merge_value: str = "min",
    filter_dst: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    *,
    session=None,  # GraphSession providing the tree machinery
    account: bool = True,
    force_mode: Optional[str] = None,
    dedup: bool = True,  # T1: dedup + destination-aware broadcast
    fast_local: bool = True,  # T2: work-efficient local combine
    per_edge_comm: bool = False,  # Ligra-Dist baseline: naive RDMA per edge
    threshold_frac: float = 1 / 20,  # Ligra direction heuristic
    replicate=None,  # hot-vertex replication: None = session's setting,
    #                  True/dict/config = opt this session in, False = off
    backend=None,  # numeric backend: None = session's (a direct call: the
    #                card), "torch"/"numpy"/instance
) -> tuple[DistVertexSubset, EdgeMapStats]:
    g = og.graph
    merge = get_merge_op(merge_value)
    sess = session if session is not None else session_for(og)
    if backend is not None:
        bk = make_backend(backend)
        check = getattr(bk, "validate_machines", None)
        if check is not None:
            check(og.P)
    elif session is not None:
        bk = session.backend
    else:
        bk = make_backend(None)
    idx = U.indices
    sum_deg = U.sum_degrees(og.out_indptr)

    # ---- adaptive hot-vertex replication (session state, cost-model only):
    # per_edge_comm is the no-orchestration ablation, so it never replicates.
    # replicate=None inherits the replicator only from an EXPLICITLY passed
    # session — a direct call borrowing the graph's cached default session
    # must opt in per call, so one replicate=True call can never silently
    # turn replication on for later default calls on the same graph.
    rep = None
    if account and not per_edge_comm:
        if replicate is None and session is not None:
            rep = getattr(sess, "replicator", None)
        elif replicate is not None and replicate is not False:
            rep = sess.ensure_replicator(replicate)
    ref_report = rep.maybe_refresh() if rep is not None else None
    replicas = rep.replicas if rep is not None else None
    if replicas is not None and not replicas.hot_ids.size:
        replicas = None

    # ---- mode selection (§5.1): sparse for small frontiers ---------------
    # A session armed with engine="auto" (GraphSession.mode_policy) replaces
    # the static Ligra direction threshold with the cost model itself: both
    # modes' propagation bills are charged against scratch accumulators
    # (exact — the downstream edge-compute and write-back costs are
    # mode-independent) and the argmin wins under the BSP objective.
    policy = getattr(sess, "mode_policy", None)
    decision = None
    if force_mode is not None:
        mode = force_mode
    elif policy is not None and account and not per_edge_comm:
        estimates = _estimate_mode_costs(og, sess, idx, replicas, dedup)
        decision = policy.choose(estimates, kind="edge_map_mode")
        mode = decision.choice
    else:
        mode = "sparse" if (sum_deg + idx.size) < threshold_frac * (g.m + g.n) else "dense"

    # ---- gather active edges ----------------------------------------------
    if mode == "sparse":
        flat, _ = _expand_csr(og.out_indptr, idx)
        edge_ids = og.out_edges[flat]
    else:
        edge_ids = np.flatnonzero(U.mask[g.src])
    s, d = g.src[edge_ids], g.dst[edge_ids]
    w = g.weights[edge_ids] if g.weights is not None else np.ones(edge_ids.size)

    if filter_dst is not None and edge_ids.size:
        keep = filter_dst(d)
        edge_ids, s, d, w = edge_ids[keep], s[keep], d[keep], w[keep]

    cost = CostAccumulator(og.P) if account else None
    if cost is not None:
        cost.begin(f"edgemap_{mode}")

    # ---- cost: source-value propagation ------------------------------------
    if cost is not None and per_edge_comm and edge_ids.size:
        # Ligra-Dist/ghost-node baseline (Table 3): every active edge does
        # its own remote read of dist[src] and remote write to dist[dst] —
        # no meta-task aggregation, no trees, no per-machine dedup. Hot
        # vertices' home machines absorb per-edge message storms.
        em = og.edge_machine[edge_ids]
        cost.send(og.vertex_home[s], em, VALUE_WORDS)
        cost.work(em, 1.0 if fast_local else 3.0)
        cost.send(em, og.vertex_home[d], VALUE_WORDS)
        cost.work(og.vertex_home[d], 1.0)
        cost.tick(2)
    elif cost is not None and idx.size:
        # replicated sources: every machine holding their out-edges already
        # has the value — a machine-local read, no tree/broadcast traffic
        live = idx
        if replicas is not None and mode in ("sparse", "dense"):
            # a vertex counts as replicated only when EVERY machine holds it
            # (conservative under a partial holders bitmap: any gap falls
            # back to the full tree broadcast)
            slot = replicas.lookup[idx]
            hot = slot >= 0
            hot[hot] = replicas.holders[slot[hot]].all(axis=1)
            if hot.any() and (dedup or mode == "sparse"):
                flat_h, _ = _expand_csr(og.src_grp_indptr, idx[hot])
                cost.local(og.src_grp_machines[flat_h], VALUE_WORDS)
                live = idx[~hot]
        if mode == "sparse":
            h = (sess.src_charger.charge(cost, live, VALUE_WORDS, upward=False)
                 if live.size else 0)
            cost.tick(max(h, 1))
        else:
            if dedup:
                # T1 destination-aware broadcast: value -> only machines
                # holding that vertex's out-edges, one copy each
                if live.size:
                    sess.src_charger.direct_broadcast(cost, live, VALUE_WORDS)
            else:
                # naive dense: broadcast every active value to all machines
                allm = np.arange(og.P, dtype=np.int64)
                for mch in allm:
                    cost.send(og.vertex_home[idx], np.full(idx.size, mch),
                              VALUE_WORDS)
            cost.tick(1)

    # ---- local compute ------------------------------------------------------
    if edge_ids.size:
        vals = np.asarray(f(s, d, w), dtype=np.float64)
        # T2 ablation (fast_local=False): charge the generic CAS-loop
        # constant instead of the work-efficient segmented combine — the
        # 2–5.7× band Table 4 measures. Numerics are unaffected.
        if cost is not None:
            cost.work(og.edge_machine[edge_ids], 1.0 if fast_local else 3.0)
        # per-destination ⊗-combine through the session's execution backend
        # (numpy oracle, or the torch backend's routed device sum)
        uniq_d, combined = bk.combine_by_key(vals[:, None], d, og.n, merge,
                                             edge_ids)
    else:
        uniq_d = np.empty(0, dtype=np.int64)
        combined = np.empty((0, 1))

    # ---- cost: write-back combine up the destination trees -----------------
    if cost is not None and edge_ids.size and not per_edge_comm:
        pair = d * np.int64(og.P) + og.edge_machine[edge_ids]
        upair = np.unique(pair)
        uv = (upair // og.P).astype(np.int64)
        um = (upair % og.P).astype(np.int64)
        if dedup:
            # group by vertex: CSR over (uv, um), tree-combine to vertex home
            # (per-round charger: the touched (vertex, machine) set depends
            # on this round's active edges)
            indptr = np.zeros(og.n + 1, dtype=np.int64)
            np.add.at(indptr, uv + 1, 1)
            np.cumsum(indptr, out=indptr)
            vset = np.unique(uv)
            dst_charger = TreeCharger(og.vertex_home, indptr, um, og.C)
            h = dst_charger.charge(cost, vset, VALUE_WORDS, upward=True)
            cost.tick(max(h, 1))
        else:
            # no en-route combining: every machine writes straight to home
            cost.send(um, og.vertex_home[uv], VALUE_WORDS)
            cost.tick(1)
        cost.work(og.vertex_home[uniq_d], 1.0)

    # ---- apply + next frontier ---------------------------------------------
    if uniq_d.size:
        changed = np.asarray(write_back(uniq_d, combined[:, 0]), dtype=bool)
        nxt = DistVertexSubset(og.n, indices=uniq_d[changed])
        # replicated destinations whose value actually changed: home
        # write-through-propagates the new value to every holder, keeping
        # replicas fresh (unchanged homes need no propagation)
        if cost is not None and replicas is not None and not per_edge_comm:
            charge_write_through(cost, og.vertex_home, replicas,
                                 uniq_d[changed], VALUE_WORDS)
    else:
        nxt = DistVertexSubset.empty(og.n)

    if rep is not None:
        # demand feed: a vertex is "requested" once per machine that needs
        # its value this round (its source-tree member count)
        rep.observe_keys(idx, weights=(og.src_grp_indptr[idx + 1]
                                       - og.src_grp_indptr[idx]
                                       ).astype(np.float64))

    report = None
    if cost is not None:
        cost.end()
        report = cost.totals()
        if decision is not None:
            # the mode decision's bill rides this round's report as its own
            # `policy` phase (frontier holders sketch demand to the
            # coordinator, which broadcasts the verdict), and the decision
            # itself lands on the session ledger. realized_words is the full
            # round; predicted covers the mode-dependent propagation part.
            from ..core.policy import decision_phase
            decision.realized_words = float(report.sent.sum())
            policy_report = decision_phase(
                og.P, np.unique(og.vertex_home[idx]), policy.config)
            decision.policy_words = float(policy_report.sent.sum())
            report = StageReport(og.P, policy_report.phases + report.phases)
            decision.stage_index = len(getattr(sess, "stats", []))
            sess.report.record_decision(decision)
        if ref_report is not None:
            # the refresh broadcast is part of this round's bill, kept as
            # its own `replica_refresh` phase for the session-level split
            report = StageReport(og.P, ref_report.phases + report.phases)
    return nxt, EdgeMapStats(mode=mode, active_vertices=idx.size,
                             active_edges=int(edge_ids.size), report=report)
