"""Fused-able stage lambdas: a declarative per-pair reduction spec.

A generic user lambda sees the *padded* gathered view — `(n, max_arity, w)`
values plus a validity mask — so a device backend has no choice but to
materialize that view before calling it. `FusedStageLambda` instead names
its per-pair reduction (`read_op` ∈ add/min/max/first) and an optional
per-row `finish(contexts, reduced)` epilogue, which is exactly the
information the ragged-native fused CUDA kernel (`kernels/stage_fused/`)
needs to walk the CSR pair list directly — no `max_arity` padding, no
materialized intermediates.

The instance is still a perfectly ordinary stage lambda: `__call__`
implements the identical padded-view semantics with numpy (oracle) or torch
(when handed tensors), so every engine/backend that does NOT understand
`fused_spec` runs it unchanged and bit-compatibly.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

FUSED_READ_OPS = ("add", "min", "max", "first")


def _xp(arr):
    """numpy for ndarrays, torch for tensors."""
    return np if isinstance(arr, np.ndarray) else torch


def _scalar(arr, value):
    """A 0-d array of `arr`'s dtype (and device) holding `value` — numpy
    and torch spell the creation call differently."""
    if isinstance(arr, np.ndarray):
        return np.asarray(value, dtype=arr.dtype)
    return torch.tensor(value, dtype=arr.dtype, device=arr.device)


class FusedStageLambda:
    """Stage lambda defined by a per-pair reduction + optional epilogue.

    ``read_op`` reduces each task's gathered chunk values across its reads:

    - ``"add"``   — sum of requested values (0 for arity-0 tasks)
    - ``"min"``   — elementwise min (0 for arity-0 tasks, matching the
      zero-filled padded gather the oracle hands generic lambdas)
    - ``"max"``   — elementwise max (0 for arity-0 tasks, as above)
    - ``"first"`` — the task's first requested value (its `primary_read`)

    ``finish(contexts, reduced)`` — optional per-row epilogue applied to the
    `(n, w)` reduced values; must be elementwise per row (no cross-row
    mixing) and written against the array subset shared by numpy and
    torch, so both the oracle and the torch backend can run it.
    The output is returned as both the stage ``update`` and ``result``.
    """

    def __init__(self, read_op: str, finish: Optional[Callable] = None):
        if read_op not in FUSED_READ_OPS:
            raise ValueError(
                f"read_op {read_op!r} not in {FUSED_READ_OPS}")
        self.read_op = read_op
        self.finish = finish

    @property
    def fused_spec(self) -> Tuple[str, Optional[Callable]]:
        """(read_op, finish) — the backend's routing key to the fused path."""
        return (self.read_op, self.finish)

    def __repr__(self):
        fin = getattr(self.finish, "__name__", self.finish)
        return f"FusedStageLambda({self.read_op!r}, finish={fin})"

    # ---- generic (padded-view) realization --------------------------------
    def reduce_padded(self, vals, mask):
        """Reduce the padded gathered view exactly like the fused kernel
        reduces the CSR pair list. `vals` is `(n, w)` (arity ≤ 1, `mask`
        `(n,)`) or `(n, A, w)` (ragged, `mask` `(n, A)`)."""
        xp = _xp(vals)
        zero = _scalar(vals, 0.0)
        if vals.ndim == 2:  # arity-≤1 view: every op degenerates to masking
            return xp.where(mask[:, None], vals, zero)
        if self.read_op == "add":
            return xp.where(mask[..., None], vals, zero).sum(1)
        if self.read_op == "first":
            return xp.where(mask[:, :1], vals[:, 0, :], zero)
        big = _scalar(vals, np.finfo(np.float32).max / 2)
        filled = xp.where(mask[..., None], vals,
                          big if self.read_op == "min" else -big)
        red = xp.amin(filled, 1) if self.read_op == "min" \
            else xp.amax(filled, 1)
        # arity-0 rows reduce to 0, matching the oracle's zero-filled gather
        return xp.where(mask.any(1)[:, None], red, zero)

    def __call__(self, contexts, vals, mask) -> Dict[str, object]:
        out = self.reduce_padded(vals, mask)
        if self.finish is not None:
            out = self.finish(contexts, out)
        return {"update": out, "result": out}


_FUSED_CACHE: Dict[Tuple[str, int], FusedStageLambda] = {}


def fused_read(read_op: str, finish: Optional[Callable] = None
               ) -> FusedStageLambda:
    """A cached `FusedStageLambda` — reusing the instance keeps the
    backends' per-lambda state (the host-fallback set) keyed on one object
    across stages/sessions."""
    key = (read_op, id(finish))
    lam = _FUSED_CACHE.get(key)
    if lam is None or lam.finish is not finish:
        lam = FusedStageLambda(read_op, finish)
        _FUSED_CACHE[key] = lam
    return lam
