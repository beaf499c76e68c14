"""The parameter-server serving tier on torch: MoE expert routing
(`MoERouter`) and embedding-table serving (`EmbeddingStore`) as front doors
over Orchestrator sessions — tokens/lookups are lambda-tasks, expert weight
blocks/vocab rows are data chunks, routing skew is the paper's hot-chunk
regime. Both take the unified `SessionConfig` and run on the CUDA card by
default (`TorchBackend`), or on the float64 numpy oracle, and both expose
`serve()` streaming front doors over `repro_torch.serve`."""
from .embedding import (EmbeddingFrontend, EmbeddingStore, LookupResult,
                        UpdateResult)
from .moe import (DecodeResult, MoEFFNLambda, MoEFrontend, MoERouter,
                  NaiveDispatchResult)

__all__ = [
    "MoERouter", "MoEFFNLambda", "MoEFrontend",
    "DecodeResult", "NaiveDispatchResult",
    "EmbeddingStore", "EmbeddingFrontend", "LookupResult", "UpdateResult",
]
