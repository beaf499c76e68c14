"""Case Study II (§5): TDO-GP — distributed graph processing on TD-Orch.
Ingestion-time orchestration (source/destination trees), DistVertexSubset,
sparse/dense DistEdgeMap, and the five paper algorithms (BFS, SSSP, BC, CC,
PR) with work-efficient bounds (Table 1). `ingest`, `GraphSession` and the
algorithms run their numerics on the card unless given another backend."""
from .generators import (
    Graph,
    barabasi_albert,
    erdos_renyi,
    grid_2d,
    star_graph,
)
from .partition import OrchestratedGraph, ingest
from .vertex_subset import DistVertexSubset
from .session import GraphSession, TreeCharger
from .distedgemap import dist_edge_map, EdgeMapStats
from .algorithms import RunInfo, bfs, bc, cc, pagerank, sssp

__all__ = [
    "Graph", "barabasi_albert", "erdos_renyi", "grid_2d", "star_graph",
    "OrchestratedGraph", "ingest",
    "DistVertexSubset", "dist_edge_map", "EdgeMapStats",
    "GraphSession", "TreeCharger",
    "RunInfo", "bfs", "bc", "cc", "pagerank", "sssp",
]
