"""The task-data orchestration interface (paper Fig. 1).

    orchestration(tasks, f, store, write_back=...) -> OrchestrationResult

`tasks` is a vectorized `TaskBatch` (InputPointers = read_indptr/read_indices
CSR — or the flat `read_keys` convenience for arity-1 batches; OutputPointers
= write_keys; LocalContexts = contexts); `f` is the batched lambda
(contexts, in_values[, mask]) -> {"update": ..., "result": ...}; `write_back`
names a merge-able ⊕ (Definition 2). The `engine` kwarg selects the
scheduling strategy through the `@register_engine` registry: "tdorch", the
§2.3 baselines "pull", "push" and "sort", and "auto", which picks one of the
four per stage from their predicted bills (`core/policy.py`).
`return_results=True` ships each task's per-task result back to its origin
(and is what makes the device backend materialize results at all).

Session-level options ride the same call: `backend=` picks the numeric
execution backend — None/"torch", the PyTorch pipeline with the CUDA
kernels on the card (the default), or "numpy", the float64 oracle; cost
reports are bit-identical across them — and `replication=` opts into the
adaptive hot-chunk subsystem, and `elasticity=` into migration, work
stealing and failure recovery (`core/elasticity.py`); all forward to the
underlying `Orchestrator`.
`config=` carries every session-level option in one `SessionConfig`
(core/config.py).

`orchestration()` is the one-shot shim: it builds a throwaway `Orchestrator`
session per call. Workloads that chain stages should construct an
`Orchestrator` once: `run_stage` chains stages against one CommForest and
an accumulating `SessionReport`.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np

# importing the engine modules populates the registry
from . import baselines as _baselines  # noqa: F401
from . import engine as _engine  # noqa: F401
from . import policy as _policy  # noqa: F401
from .config import SessionConfig, resolve_session_config
from .datastore import DataStore, TaskBatch
from .engine import OrchestrationResult
from .registry import ENGINES, make_engine, register_engine
from .session import Orchestrator

__all__ = ["ENGINES", "make_engine", "register_engine", "orchestration",
           "Orchestrator", "SessionConfig", "resolve_session_config"]


def orchestration(
    tasks: TaskBatch,
    f: Callable[[np.ndarray, np.ndarray], Dict[str, np.ndarray]],
    store: DataStore,
    write_back: str = "add",
    *,
    config=None,
    engine: str = None,
    return_results: bool = False,
    backend=None,
    replication=None,
    replicate=None,
    elasticity=None,
    **engine_opts,
) -> OrchestrationResult:
    sess = Orchestrator(store, engine=engine, config=config, backend=backend,
                        replication=replication, replicate=replicate,
                        elasticity=elasticity, **engine_opts)
    return sess.run_stage(tasks, f, write_back=write_back,
                          return_results=return_results)
