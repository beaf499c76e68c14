"""Ingestion-time orchestration of task-data flow (§5.1).

Contention for vertex values is proportional to vertex degree — a static
property of the graph — so TD-Orch runs ONCE at ingestion and the resulting
layout resolves skew for every future DistEdgeMap:

  Stage 1: edges (tasks) start on random machines and run a TD-Orch stage
  keyed by their *source* vertex. Low-degree sources end up co-located with
  their vertex value; high-degree sources leave their edges parked on transit
  machines, and the parked structure *is* the source tree that future rounds
  propagate source values down. The engine's `exec_site` is exactly the
  final edge placement.

  Stage 2: with edge storage now frozen, a second pass keyed by *destination*
  builds the destination trees along which write-backs are ⊗-combined.

Vertex values are pinned (ingestion schema, §5/D.3): placement greedily
balances out-degree per machine so local compute is naturally balanced.

Stage 1 runs through an `Orchestrator` on the backend `ingest` is given —
the card by default, where its Phase-1 root call is the histogram kernel
over every edge's source.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from ..core.cost import StageReport
from ..core.datastore import DataStore, TaskBatch
from ..core.session import Orchestrator
from .generators import Graph


def _balanced_vertex_home(degrees: np.ndarray, P: int, seed: int) -> np.ndarray:
    """D.3: vertex layout with ≈equal out-degree per machine. Heavy vertices
    are spread round-robin (LPT-style); ties and light vertices randomized
    for adversary resistance."""
    n = degrees.shape[0]
    rng = np.random.default_rng(seed)
    order = np.argsort(-(degrees + rng.random(n)))  # desc, random tie-break
    home = np.empty(n, dtype=np.int64)
    # cyclic assignment in degree order ≈ greedy least-loaded for power laws
    home[order] = np.arange(n, dtype=np.int64) % P
    return home


@dataclasses.dataclass
class OrchestratedGraph:
    """A graph after ingestion-time TD-Orch: frozen edge placement plus the
    source/destination tree groups used for cost-accounted communication."""

    graph: Graph
    P: int
    C: int  # meta-task capacity used for the trees
    vertex_home: np.ndarray  # (n,) machine pinning each vertex value
    edge_machine: np.ndarray  # (m,) machine storing each edge
    # out-CSR over edge ids (sorted by src) and in-CSR (sorted by dst)
    out_indptr: np.ndarray
    out_edges: np.ndarray
    in_indptr: np.ndarray
    in_edges: np.ndarray
    # source trees: u -> sorted unique machines holding u's out-edges
    src_grp_indptr: np.ndarray
    src_grp_machines: np.ndarray
    # destination trees: v -> sorted unique machines holding v's in-edges
    dst_grp_indptr: np.ndarray
    dst_grp_machines: np.ndarray
    ingest_report: StageReport | None = None

    @property
    def n(self) -> int:
        return self.graph.n

    @property
    def m(self) -> int:
        return self.graph.m

    def edges_per_machine(self) -> np.ndarray:
        return np.bincount(self.edge_machine, minlength=self.P)

    def out_degree(self) -> np.ndarray:
        return np.diff(self.out_indptr)


def _group_machines(keys: np.ndarray, machines: np.ndarray, n: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """CSR of sorted-unique machines per key (tree leaf sets)."""
    if keys.size == 0:
        return np.zeros(n + 1, dtype=np.int64), np.empty(0, dtype=np.int64)
    pair = keys * np.int64(2**20) + machines  # P << 2^20 always here
    uniq = np.unique(pair)
    k = (uniq // np.int64(2**20)).astype(np.int64)
    m = (uniq % np.int64(2**20)).astype(np.int64)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, k + 1, 1)
    np.cumsum(indptr, out=indptr)
    return indptr, m


def _csr(keys: np.ndarray, n: int) -> Tuple[np.ndarray, np.ndarray]:
    order = np.argsort(keys, kind="stable")
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, keys + 1, 1)
    np.cumsum(indptr, out=indptr)
    return indptr, order


def ingest(
    graph: Graph,
    P: int,
    *,
    C: int | None = None,
    fanout: int | None = None,
    seed: int = 0,
    strategy: str = "tdorch",
    balanced_vertices: bool = True,
    backend=None,
) -> OrchestratedGraph:
    """Two-stage ingestion-time TD-Orch (§5.1).

    `backend=` runs Stage 1's orchestration stage: None/"torch" — the card
    (the default; raises without one), "numpy" — the float64 oracle, or a
    backend instance such as ``TorchBackend(device="cpu")``. The layout is
    the same on every backend.

    strategy="direct" is the Ligra-Dist/ghost-node baseline of Table 3: every
    edge is stored at its source vertex's home machine (hot vertices overload
    one machine) and no transit trees exist. balanced_vertices=False drops
    the T3 degree-balanced vertex layout (random placement)."""
    n, m = graph.n, graph.m
    degrees = graph.out_degrees()
    if balanced_vertices:
        vertex_home = _balanced_vertex_home(degrees, P, seed)
    else:
        from ..core import hashing
        vertex_home = hashing.chunk_home(np.arange(n), P, salt=seed)

    if strategy == "direct":
        edge_machine = vertex_home[graph.src]
        src_grp_indptr, src_grp_machines = _group_machines(
            graph.src, edge_machine, n)
        dst_grp_indptr, dst_grp_machines = _group_machines(
            graph.dst, edge_machine, n)
        out_indptr, out_edges = _csr(graph.src, n)
        in_indptr, in_edges = _csr(graph.dst, n)
        return OrchestratedGraph(
            graph=graph, P=P, C=max(8, int(np.ceil(m / (P * 64)))),
            vertex_home=vertex_home, edge_machine=edge_machine,
            out_indptr=out_indptr, out_edges=out_edges,
            in_indptr=in_indptr, in_edges=in_edges,
            src_grp_indptr=src_grp_indptr, src_grp_machines=src_grp_machines,
            dst_grp_indptr=dst_grp_indptr, dst_grp_machines=dst_grp_machines,
            ingest_report=None)

    # Theory-guided chunk capacity: edges-per-chunk such that a machine's
    # share of a hot vertex stays O(m/P)-bounded; C = Θ(B/σ) with B an edge
    # chunk and σ one edge context. Heuristic floor keeps trees shallow.
    if C is None:
        C = max(8, int(np.ceil(m / (P * 64))))

    # ---- Stage 1: orchestrate edges against their SOURCE vertex ----------
    vertex_store = DataStore(
        values=np.zeros((n, 1)), home=vertex_home, chunk_words=max(2 * C, 2), P=P
    )
    rng = np.random.default_rng(seed + 1)
    tasks = TaskBatch(
        contexts=np.zeros((m, 2)),  # an edge context: (dst, weight) ~ σ=2
        read_keys=graph.src,
        origin=rng.integers(0, P, size=m),  # random initial edge placement
    )
    sess = Orchestrator(vertex_store, engine="tdorch", backend=backend, C=C,
                        fanout=fanout, sigma=2)
    res = sess.run_stage(tasks, lambda c, v: {}, write_back="add")
    edge_machine = res.exec_site.copy()

    # ---- Stage 2: destination trees over the frozen placement ------------
    src_grp_indptr, src_grp_machines = _group_machines(graph.src, edge_machine, n)
    dst_grp_indptr, dst_grp_machines = _group_machines(graph.dst, edge_machine, n)

    out_indptr, out_edges = _csr(graph.src, n)
    in_indptr, in_edges = _csr(graph.dst, n)

    return OrchestratedGraph(
        graph=graph,
        P=P,
        C=C,
        vertex_home=vertex_home,
        edge_machine=edge_machine,
        out_indptr=out_indptr,
        out_edges=out_edges,
        in_indptr=in_indptr,
        in_edges=in_edges,
        src_grp_indptr=src_grp_indptr,
        src_grp_machines=src_grp_machines,
        dst_grp_indptr=dst_grp_indptr,
        dst_grp_machines=dst_grp_machines,
        ingest_report=res.report,
    )
