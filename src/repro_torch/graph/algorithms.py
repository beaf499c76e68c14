"""The five §5 graph algorithms on DISTEDGEMAP: BFS, SSSP, BC, CC, PR —
each expressed as a declarative `StagePlan` (core/plan.py) over
`dist_edge_map`.

Each follows the paper's pseudocode (Algorithm 2 for BFS, Algorithm 3 for
BC) and inherits TDO-GP's bounds (Table 1): work-efficient O((n+m)/P·…)
computation with communication a log_{n/P}P factor above it, because every
round is a TD-Orch-orchestrated stage over the ingestion-time trees.

The algorithms used to hand-roll a Python `while not frontier.is_empty` loop
per algorithm; now each builds a plan — a per-round body factory (the
lambdas close over round-local values exactly as before) inside
`loop(until="empty" | <predicate>, max_rounds=...)` — and hands the whole
program to `GraphSession.run_plan`, which carries the emitted next frontier
between rounds inside the framework. Round-by-round the plan hits
`session.edge_map` with the same arguments the old loops did, so per-round
stats and per-phase cost reports are bit-identical to the JAX package's
algorithms (`tests/test_torch_graph.py`).

`backend=` picks the numeric backend of the session an algorithm builds:
None/"torch" — the card (the default; raises without one), "numpy" — the
float64 oracle, or an instance such as ``TorchBackend(device="cpu")``.

All algorithms return (values, RunInfo) where RunInfo carries per-round
EdgeMapStats so benchmarks can report comm/compute/overhead breakdowns
(Fig. 10) without re-instrumenting the algorithms.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..core.cost import SessionReport
from ..core.plan import CARRY, StagePlan
from .distedgemap import EdgeMapStats
from .partition import OrchestratedGraph
from .session import GraphSession
from .vertex_subset import DistVertexSubset


@dataclasses.dataclass
class RunInfo:
    rounds: int
    stats: List[EdgeMapStats]
    # the run's session report: per-phase words/rounds/work summed across all
    # DistEdgeMap rounds (one GraphSession per algorithm invocation)
    report: Optional[SessionReport] = None

    @property
    def total_edges_processed(self) -> int:
        return sum(s.active_edges for s in self.stats)

    def comm_time(self) -> float:
        return sum(s.report.comm_time for s in self.stats if s.report)

    def compute_time(self) -> float:
        return sum(s.report.compute_time for s in self.stats if s.report)

    def bsp_rounds(self) -> int:
        return sum(s.report.rounds for s in self.stats if s.report)


_EDGE_OPTS = ("account", "dedup", "fast_local", "force_mode", "threshold_frac",
              "per_edge_comm")


def _session(og, kw):
    """One GraphSession per algorithm run (or the caller's, via session=...);
    every round is driven through it so the tree machinery is built once and
    costs accumulate across rounds.

    Returns (session, per_call_opts): a fresh session absorbs the caller's
    edge-map options as its defaults — and its `backend=` / `replication=`
    session options — while a caller-provided session keeps its own defaults
    and the options ride along per call instead."""
    opts = {k: kw[k] for k in _EDGE_OPTS if k in kw}
    sess = kw.pop("session", None)
    backend = kw.pop("backend", None)
    replication = kw.pop("replication", None)
    if sess is not None:
        # a caller-provided session keeps its own backend/replicator unless
        # explicitly overridden — forward per-call (dist_edge_map accepts
        # both) instead of silently dropping the kwargs
        if backend is not None:
            opts["backend"] = backend
        if replication is not None:
            opts["replicate"] = replication
        return sess, opts
    return GraphSession(og, opts, replication=replication,
                        backend=backend), {}


# ---------------------------------------------------------------------------
def bfs(og: OrchestratedGraph, source: int, **kw):
    """Algorithm 2: frontier BFS; merge = max (any writer wins — idempotent
    since every writer this round carries the same ROUND value)."""
    n = og.n
    sess, em_opts = _session(og, kw)
    dist = np.full(n, -1, dtype=np.int64)
    dist[source] = 0

    def round_body(state):
        _r = state.round + 1

        def f(s, d, w):
            return np.full(s.size, float(_r))

        def wb(vs, agg):
            fresh = dist[vs] == -1
            dist[vs[fresh]] = agg[fresh].astype(np.int64)
            return fresh

        return StagePlan().edge_map(CARRY, f, wb, "max",
                                    filter_dst=lambda d: dist[d] == -1,
                                    **em_opts)

    plan = StagePlan("bfs").loop(round_body, until="empty")
    out = sess.run_plan(plan, carry=DistVertexSubset.single(n, source))
    return dist, RunInfo(out.rounds, out.stats, sess.report)


# ---------------------------------------------------------------------------
def sssp(og: OrchestratedGraph, source: int, **kw):
    """Frontier Bellman–Ford (nonnegative weights); merge = min."""
    n = og.n
    if og.graph.weights is None:
        raise ValueError("sssp needs weights; call Graph.with_weights()")
    sess, em_opts = _session(og, kw)
    dist = np.full(n, np.inf)
    dist[source] = 0.0

    def round_body(state):
        def f(s, d, w):
            return dist[s] + w

        def wb(vs, agg):
            better = agg < dist[vs]
            dist[vs[better]] = agg[better]
            return better

        return StagePlan().edge_map(CARRY, f, wb, "min", **em_opts)

    plan = StagePlan("sssp").loop(round_body, until="empty",
                                  max_rounds=og.n + 2)
    out = sess.run_plan(plan, carry=DistVertexSubset.single(n, source))
    if out.rounds > og.n + 1:  # negative-cycle guard (shouldn't trigger)
        raise RuntimeError("SSSP failed to converge")
    return dist, RunInfo(out.rounds, out.stats, sess.report)


# ---------------------------------------------------------------------------
def cc(og: OrchestratedGraph, **kw):
    """Connected components by min-label propagation; merge = min."""
    n = og.n
    sess, em_opts = _session(og, kw)
    labels = np.arange(n, dtype=np.float64)

    def round_body(state):
        def f(s, d, w):
            return labels[s]

        def wb(vs, agg):
            better = agg < labels[vs]
            labels[vs[better]] = agg[better]
            return better

        return StagePlan().edge_map(CARRY, f, wb, "min", **em_opts)

    plan = StagePlan("cc").loop(round_body, until="empty")
    out = sess.run_plan(plan, carry=DistVertexSubset.full(n))
    return labels.astype(np.int64), RunInfo(out.rounds, out.stats, sess.report)


# ---------------------------------------------------------------------------
def pagerank(og: OrchestratedGraph, alpha: float = 0.85, tol: float = 1e-8,
             max_iter: int = 100, **kw):
    """Power iteration; merge = add. Dangling mass redistributed uniformly
    (networkx convention, so oracles agree exactly).

    A fixpoint plan with a convergence predicate: the body factory does the
    per-round host prep (contributions, teleport base), the `until`
    callback folds the new ranks in and reports the L1 delta."""
    n = og.n
    force_mode = kw.pop("force_mode", "dense")
    sess, em_opts = _session(og, kw)
    deg = og.out_degree().astype(np.float64)
    dangling = deg == 0
    frontier = DistVertexSubset.full(n)

    def round_body(state):
        pr = state["pr"]
        contrib = np.divide(pr, deg, out=np.zeros(n), where=deg > 0)
        nxt = np.full(n, (1.0 - alpha) / n + alpha * pr[dangling].sum() / n)
        state["nxt"] = nxt

        def f(s, d, w):
            return contrib[s]

        def wb(vs, agg):
            nxt[vs] += alpha * agg
            return np.ones(vs.size, dtype=bool)

        return StagePlan().edge_map(frontier, f, wb, "add",
                                    force_mode=force_mode, **em_opts)

    def converged(state):
        delta = np.abs(state["nxt"] - state["pr"]).sum()
        state["pr"] = state["nxt"]
        return delta < tol * n

    plan = StagePlan("pagerank").loop(round_body, until=converged,
                                      max_rounds=max_iter)
    out = sess.run_plan(plan, state={"pr": np.full(n, 1.0 / n)})
    return out.state["pr"], RunInfo(out.rounds, out.stats, sess.report)


# ---------------------------------------------------------------------------
def bc(og: OrchestratedGraph, source: int, **kw):
    """Betweenness centrality from one root (Algorithm 3): forward
    level-synchronous σ accumulation, then backward dependency propagation
    using the 1/σ trick (lines 27–34): δ_v = σ_v·φ_v − 1.

    Two chained fixpoint loops in one plan, with a host step between them
    (the 1/σ inversion) — the backward loop's round bound (`last − 1`) is
    resolved at loop entry from the state the forward loop recorded."""
    n = og.n
    sess, em_opts = _session(og, kw)
    num_paths = np.zeros(n)
    rounds_arr = np.zeros(n, dtype=np.int64)
    num_paths[source] = 1.0
    rounds_arr[source] = 1
    frontiers = {1: DistVertexSubset.single(n, source)}
    phi = np.zeros(n)

    # ---- forward pass
    def fwd_body(state):
        _r = state.round + 2  # the old loop's rnd counter (starts at 2)

        def f(s, d, w):
            return num_paths[s]

        def wb(vs, agg):
            fresh = rounds_arr[vs] == 0
            num_paths[vs[fresh]] += agg[fresh]
            rounds_arr[vs[fresh]] = _r
            return fresh

        def record(st, nxt):
            if not nxt.is_empty:
                frontiers[_r] = nxt
            return nxt

        return StagePlan().edge_map(
            CARRY, f, wb, "add", filter_dst=lambda d: rounds_arr[d] == 0,
            emit=record, **em_opts)

    # ---- line 27: φ_v = 1/σ_v on visited vertices
    def prepare_backward(state):
        state["last"] = max(frontiers)
        visited = rounds_arr > 0
        phi[visited] = 1.0 / num_paths[visited]

    # ---- backward pass (lines 27–32): r = last, last-1, ..., 2
    def bwd_body(state):
        _r = state["last"] - state.round
        fr = frontiers[_r]

        def f(s, d, w):
            return phi[s]

        def wb(vs, agg):
            sel = rounds_arr[vs] == _r - 1
            phi[vs[sel]] += agg[sel]
            return sel

        return StagePlan().edge_map(
            fr, f, wb, "add",
            filter_dst=lambda d: rounds_arr[d] == _r - 1, **em_opts)

    plan = (StagePlan("bc")
            .loop(fwd_body, until="empty", name="forward")
            .host(prepare_backward)
            .loop(bwd_body, until=None,
                  max_rounds=lambda st: st["last"] - 1, name="backward"))
    out = sess.run_plan(plan, carry=frontiers[1])
    last = out.state["last"]
    fwd_rounds = out.loops[0].rounds
    # ---- line 34: δ_v = σ_v·φ_v − 1 on visited vertices (0 elsewhere)
    visited = rounds_arr > 0
    delta = np.zeros(n)
    delta[visited] = phi[visited] * num_paths[visited] - 1.0
    delta[source] = 0.0
    return delta, RunInfo(fwd_rounds + 1 + last - 1, out.stats, sess.report)
