# The streaming serve subsystem on the torch port: async request ingest with
# per-request deadlines, an adaptive (size- OR deadline-triggered,
# arrival-rate-tuned) batching window coalescing single requests into ragged
# CSR TaskBatches, double-buffered Orchestrator sessions overlapping batch
# k's execution with batch k+1's admission/routing (its contexts staged on
# the card by TorchBackend.prefetch), per-request result futures, and
# ServeStats serving-layer accounting.
from .batching import BatchingConfig, BatchWindow, QueueFullError, ServeRequest
from .frontend import Frontend, FrontendClosedError, TagSpec
from .futures import RequestFuture
from .stats import OverlapClock, ServeStats

__all__ = [
    "BatchingConfig", "BatchWindow", "QueueFullError", "ServeRequest",
    "Frontend", "FrontendClosedError", "TagSpec",
    "RequestFuture",
    "OverlapClock", "ServeStats",
]
