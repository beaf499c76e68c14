"""Shared Phase-3 execution path (simulation fidelity contract).

Numeric results are computed by ONE vectorized gather/execute/apply pass used
identically by TD-Orch and every baseline — only *cost* accounting differs
between engines. This module is that shared pass, in its reference (numpy,
float64) form: `core/backend.py` wraps it as the `"numpy"` execution backend
— the oracle every other backend (the `"torch"` pipeline on the card) is
tested against — and engines reach it through their `backend` rather than calling
here directly.

Gathered views: an arity-≤1 batch hands the lambda the legacy
`(n, value_width)` array (zeros where a task reads nothing). A ragged batch
hands it a padded `(n, max_arity, value_width)` view plus an `(n, max_arity)`
validity mask; the mask is passed as a third positional argument when the
lambda accepts one.
"""
from __future__ import annotations

import inspect
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from .datastore import DataStore, TaskBatch
from .mergeops import MergeOp


def gather_values(tasks: TaskBatch, store: DataStore
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Gather each task's requested chunk values.

    Returns (values, mask): `(n, w)` values with `(n,)` mask for arity-≤1
    batches, `(n, max_arity, w)` padded values with `(n, max_arity)` mask
    for ragged ones. Padding slots are zero-filled and masked False.
    """
    n, w = tasks.n, store.value_width
    if tasks.max_arity <= 1:
        vals = np.zeros((n, w), dtype=store.values.dtype)
        has = tasks.read_keys >= 0
        if has.any():
            vals[has] = store.values[tasks.read_keys[has]]
        return vals, has
    A = tasks.max_arity
    vals = np.zeros((n, A, w), dtype=store.values.dtype)
    mask = np.zeros((n, A), dtype=bool)
    row = tasks.pair_task
    col = np.arange(tasks.nnz, dtype=np.int64) - tasks.read_indptr[:-1][row]
    vals[row, col] = store.values[tasks.read_indices]
    mask[row, col] = True
    return vals, mask


def _accepts_mask(f: Callable) -> bool:
    try:
        params = list(inspect.signature(f).parameters.values())
    except (TypeError, ValueError):  # builtins / C callables: play safe
        return False
    if any(p.name == "mask" for p in params):
        return True
    # only REQUIRED positional params count — a legacy lambda with an
    # unrelated defaulted 3rd param (f(ctx, vals, scale=2.0)) must NOT have
    # the mask silently bound to it
    required = [p for p in params
                if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
                and p.default is p.empty]
    has_var = any(p.kind == p.VAR_POSITIONAL for p in params)
    return has_var or len(required) >= 3


def call_lambda(f: Callable, contexts: np.ndarray, values: np.ndarray,
                mask: np.ndarray) -> Dict[str, Optional[np.ndarray]]:
    """Invoke the stage lambda, forwarding the validity mask when its
    signature has room for it."""
    out = f(contexts, values, mask) if _accepts_mask(f) else f(contexts, values)
    return out if out is not None else {}


def execute(tasks: TaskBatch, store: DataStore, f: Callable
            ) -> Dict[str, Optional[np.ndarray]]:
    """The single authoritative gather + execute pass shared by all engines."""
    vals, mask = gather_values(tasks, store)
    return call_lambda(f, tasks.contexts, vals, mask)


def apply_writes(tasks: TaskBatch, store: DataStore, updates,
                 merge: MergeOp, cost) -> None:
    """The single authoritative ⊗-combine + ⊙-apply pass (shared)."""
    if updates is None:
        return
    updates = np.atleast_2d(np.asarray(updates))
    if updates.shape[0] != tasks.n:
        updates = updates.T
    writes = tasks.write_keys >= 0
    if not writes.any():
        return
    wk = tasks.write_keys[writes]
    uniq, seg = np.unique(wk, return_inverse=True)
    combined = merge.combine_segments(updates[writes], seg, uniq.size,
                                      tasks.priority[writes])
    store.write_rows(uniq, merge.apply(store.values[uniq], combined))
    cost.work(store.home[uniq], 1.0)


def update_width(updates) -> int:
    u = np.atleast_2d(np.asarray(updates))
    return u.shape[1] if u.shape[0] != u.size else 1
