"""The parameter-server serving tier on torch: MoE expert routing
(`MoERouter`) and embedding-table serving (`EmbeddingStore`) as front doors
over Orchestrator sessions — tokens/lookups are lambda-tasks, expert weight
blocks/vocab rows are data chunks, routing skew is the paper's hot-chunk
regime. Both take the unified `SessionConfig` and run on the CUDA card by
default (`TorchBackend`), or on the float64 numpy oracle. The streaming
`serve()` front doors wait for the port of the serve subsystem."""
from .embedding import EmbeddingStore, LookupResult, UpdateResult
from .moe import DecodeResult, MoEFFNLambda, MoERouter, NaiveDispatchResult

__all__ = [
    "MoERouter", "MoEFFNLambda",
    "DecodeResult", "NaiveDispatchResult",
    "EmbeddingStore", "LookupResult", "UpdateResult",
]
