"""Pluggable numeric execution backends: the numpy oracle, and the PyTorch
pipeline on the CUDA card.

The simulation-fidelity contract (`core/engine.py`) splits every stage into
*numerics* (one vectorized gather → lambda → ⊗-combine → ⊙-apply pass
shared by all engines) and *cost* (the forest walk that charges
words/rounds). This module makes the numeric half pluggable:

* `NumpyBackend` — the reference oracle. Exactly the pure-numpy pass in
  `core/execution.py` / `core/mergeops.py`, in float64. Every numeric claim
  in the test suite is anchored to it.
* `TorchBackend` — the per-stage pass on torch tensors (`core/torchexec.py`)
  on one device, the CUDA card unless the caller asks for the CPU. Phase-1
  contention histograms run the histogram kernel, the Phase-3 gather +
  lambda runs as torch ops, the Phase-4 ⊗-combine runs the segment-combine
  kernel, ragged stages with a fused-able lambda run the stage_fused
  kernel, and the store's values stay device-resident between stages (a
  cache keyed on `DataStore.version`). Inside a `StagePlan` scope
  (`core/plan.py`) write-backs stay on the device and the host copy is
  refreshed only at flush points. Values are computed in float32 by default
  and match the oracle within float tolerance; ``dtype="float64"`` matches
  it to round-off.

The backend-parity contract: per-phase **words and rounds are bit-identical**
across backends, because every quantity the cost model consumes (execution
sites, written-key sets, message widths) is computed on the host by the same
code regardless of backend — only the floating-point *values* differ, within
tolerance.

A stage lambda that torch cannot run (numpy calls on its inputs, say) is
detected on first use and permanently routed to the numpy path for that
function object — correctness never depends on it. That fallback covers
only the call of user code: a kernel that fails to build or launch raises.
"""
from __future__ import annotations

import warnings
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from . import execution
from .mergeops import MergeOp
from .registry import get_backend_cls, register_backend

# merges the device combine implements; anything else falls back to the
# oracle apply (still correct, just not fused)
_DEVICE_MERGES = ("add", "min", "max", "or", "write")
_I32 = np.iinfo(np.int32)


def _combine_eligibility(tasks, merge: Optional[MergeOp]):
    """(writer rows, fuse the ⊗-combine on device?, hand real update rows
    back for the oracle apply?). Fusing needs a supported merge and
    int32-safe priorities (the device combine carries them as int32 order
    keys)."""
    w_rows = np.flatnonzero(tasks.write_keys >= 0)
    pr = tasks.priority
    combine = bool(
        w_rows.size and merge is not None and merge.name in _DEVICE_MERGES
        and int(pr.min(initial=0)) > -(2**31)
        and int(pr.max(initial=0)) < 2**31 - 1)
    return w_rows, combine, bool(w_rows.size) and not combine


@register_backend("numpy")
class NumpyBackend:
    """The reference oracle: the float64 pure-numpy pass, unchanged."""

    name = "numpy"
    # device→host state-array transfers (results / update rows / combined
    # write-backs / plan flushes / device edge combines). Always 0 here —
    # the oracle IS host-resident.
    host_syncs = 0

    # -- StagePlan device-residency hooks (no-ops for the host oracle) ------
    def begin_plan(self, store) -> None:
        """Enter a plan scope over `store` (see `core/plan.py`)."""

    def end_plan(self) -> None:
        """Leave the plan scope, flushing any deferred state."""

    def plan_flush(self) -> None:
        """Make the host store copy current (no-op when nothing deferred)."""

    # -- non-blocking dispatch hooks (serve.Frontend double-buffering) -----
    def prefetch(self, tasks, store) -> None:
        """Stage the batch's device operands ahead of `execute()` without
        blocking: a serving frontend calls this from its admission thread
        for batch k+1 while batch k is still computing, so the upload rides
        the async dispatch stream instead of the executor's critical path.
        Callers must not mutate `tasks.contexts` between prefetch and
        execute. No-op for the host-resident oracle."""

    def sync(self, store=None) -> None:
        """Block until pending device work (for `store`'s cached values, if
        given) has completed — a fair timing boundary for serving/benchmark
        layers. No-op for the host-resident oracle."""

    # -- phase 3 -----------------------------------------------------------
    def execute(self, tasks, store, f: Callable, merge: Optional[MergeOp] = None,
                want_result: bool = True, exec_site=None,
                replicas=None) -> Dict[str, Optional[np.ndarray]]:
        """Run the stage numerics. `exec_site`/`replicas` describe where the
        cost model placed each task and which chunks the session has
        replicated — advisory for single-device backends (the oracle and the
        torch pipeline compute the same values regardless)."""
        return execution.execute(tasks, store, f)

    # -- phase 4 -----------------------------------------------------------
    def apply_writes(self, tasks, store, updates, merge: MergeOp, cost) -> None:
        execution.apply_writes(tasks, store, updates, merge, cost)

    # -- phase 1 -----------------------------------------------------------
    def key_counts(self, keys: np.ndarray, num_keys: int, weights=None
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """(unique keys, int64 counts) — the observed per-chunk demand."""
        uk, inv = np.unique(np.asarray(keys, dtype=np.int64),
                            return_inverse=True)
        if weights is None:
            rc = np.bincount(inv, minlength=uk.size).astype(np.int64)
        else:
            rc = np.bincount(inv, weights=np.asarray(weights, dtype=np.float64),
                             minlength=uk.size).astype(np.int64)
        return uk, rc

    # -- phase 2 -----------------------------------------------------------
    def argsort_stable(self, keys: np.ndarray) -> np.ndarray:
        """The routing permutation (stable, so backends agree exactly)."""
        return np.argsort(keys, kind="stable")

    # -- DistEdgeMap local combine ----------------------------------------
    def combine_by_key(self, values: np.ndarray, keys: np.ndarray,
                       num_keys: int, merge: MergeOp, order: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """⊗-combine update rows per destination key; returns
        (sorted unique keys, combined rows aligned with them)."""
        uniq, seg = np.unique(keys, return_inverse=True)
        combined = merge.combine_segments(values, seg, uniq.size, order)
        return uniq, combined


@register_backend("torch")
class TorchBackend(NumpyBackend):
    """The PyTorch execution path (`core/torchexec.py` + `kernels/`).

    `device` defaults to ``"cuda"``: without a CUDA device the constructor
    raises — pass ``device="cpu"`` explicitly for the plain PyTorch
    versions of the kernels (what the CPU tests do). Numerics only: every
    cost-model input is still produced by the host code paths, so reports
    are bit-identical to the numpy backend's.

    Plan scope (`begin_plan` / `end_plan`, opened by `Orchestrator.run_plan`):
    a fused write-back onto the scope's store stays on the device — the
    store's version is bumped, the device copy re-pinned and the written
    keys recorded — and the host copy catches up at `plan_flush` (one gather
    of the written rows, one device→host copy), which runs before any code
    that reads the host values: the host route of `execute`, the oracle
    apply of `apply_writes`, every user callback of the plan, and plan exit.
    Batches are not padded to power-of-two sizes as the JAX backend does in
    a plan scope: that padding only lets jit reuse one executable across
    drifting batch sizes, and eager PyTorch launches the same kernels at any
    size, so it would only add work.

    `combine_by_key` (the DistEdgeMap's per-destination combine) follows the
    JAX backend's route: an add merge over at least 4,096 keys whose key set
    repeats (PageRank re-reduces the same edges every round) builds the
    stable permutation and segment ends on its second sighting and runs the
    permute → prefix sum → difference of `torchexec.sorted_segment_sum` on
    the device from then on; every other combine takes the oracle's.

    `host_syncs` counts the transfers of state arrays, as the JAX backend's
    does; the Phase-1 counts and the Phase-2 routing permutation, which the
    host cost model reads every stage, are not counted.

    `prefetch` (a serving frontend's router thread, batch k+1) stages only
    the batch's contexts: in the backend's dtype into pinned host memory,
    then one non-blocking copy to the card on a side stream the backend
    owns, with an event recorded behind it. `execute` (the executor thread,
    after batch k) takes the staged tensor when dtype and device match: its
    current stream waits on the event, and the tensor is recorded on that
    stream so the caching allocator keeps the block until the stage is
    done. The store's values are never staged: the executor may be writing
    them. On the CPU the staged contexts are a plain tensor and no stream
    is used. `sync` waits for the copy stream and, when the store has
    values cached on the card, for the device's queued work.
    """

    name = "torch"

    def __init__(self, device=None, dtype: str = "float32",
                 kernel_backend: str = "auto"):
        from . import torchexec

        self._tx = torchexec
        if dtype not in ("float32", "float64"):
            raise ValueError(f"unsupported torch backend dtype {dtype!r}")
        # one route only: ragged stages with a fused-able lambda always run
        # the stage_fused kernel (the JAX package's "padded"/"interpret"
        # choices answered TPU memory gates and Pallas' CPU mode)
        if kernel_backend == "interpret":
            raise ValueError(
                "kernel_backend='interpret' does not exist in the torch port: "
                "a CUDA kernel has no interpret mode — use "
                "TorchBackend(device='cpu') for the plain PyTorch versions")
        if kernel_backend != "auto":
            raise ValueError(
                f"unsupported kernel_backend {kernel_backend!r}: the torch "
                "port has the one route 'auto'")
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "TorchBackend runs on a CUDA device and none is "
                    "available; pass device='cpu' to run the plain PyTorch "
                    "versions on the CPU")
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
        elif self.device.type != "cpu":
            raise ValueError(f"unsupported device {self.device}")
        self.dtype = dtype
        self._np_dtype = np.dtype(dtype)
        self._torch_dtype = getattr(torch, dtype)
        self._host_lambdas: set = set()  # ids of fns torch cannot run
        self._stash = None  # one-slot (execute → apply_writes) carry
        self._route = None  # one-slot combine_by_key routing cache
        # device→host state-array transfer counter (results / update rows /
        # combined write-backs / plan flushes / device edge combines)
        self.host_syncs = 0
        # StagePlan device-residency scope (core/plan.py): while a plan runs
        # over `_plan_store`, write-backs stay on the device and the host
        # copy is refreshed at flush points (user callbacks, plan exit)
        self._plan_store = None
        self._plan_depth = 0
        self._plan_written: list = []
        self._plan_dirty = False
        self._copy_stream = None  # prefetch's side stream, made on first use

    # -- StagePlan device-residency scope -----------------------------------
    def begin_plan(self, store) -> None:
        """Enter a plan scope: fused write-backs onto `store` defer their
        host copy to the next flush point."""
        if self._plan_depth == 0:
            self._plan_store = store
        self._plan_depth += 1

    def end_plan(self) -> None:
        self._plan_depth = max(self._plan_depth - 1, 0)
        if self._plan_depth == 0:
            self.plan_flush()
            self._plan_store = None

    def plan_flush(self) -> None:
        """Refresh the host store copy from the device-resident values: one
        gather of every row written since the last flush and one
        device→host copy. Called by the plan runner before any user
        callback and at plan exit."""
        if not self._plan_dirty:
            return
        store = self._plan_store
        # a cache hit: every deferred apply re-pins the copy after touch()
        dv = self.device_values(store)
        wk = np.unique(np.concatenate(self._plan_written))
        self._plan_written = []
        self._plan_dirty = False
        rows = self._to_host(dv.index_select(0, self._dl(wk)))
        store.write_rows(wk, rows.astype(store.values.dtype, copy=False))
        self._remember_values(store, dv)

    def _flush_if_deferred(self, store) -> None:
        """Host code is about to read `store.values`: make the host copy
        current first."""
        if self._plan_store is store and self._plan_dirty:
            self.plan_flush()

    # -- device-resident store values --------------------------------------
    def _cache_key(self):
        return (str(self.device), self.dtype)

    def device_values(self, store) -> torch.Tensor:
        """The store's values on this backend's device, in its dtype: one
        copy per (device, dtype) and store version, kept on the store and
        shared by every TorchBackend that matches. The stages' ⊙-apply
        updates it in place; callers outside the backend only read it."""
        cache = store.__dict__.setdefault("_device_values", {})
        ent = cache.get(self._cache_key())
        if ent is not None and ent[0] == store.version:
            return ent[1]
        # always a copy: the ⊙-apply updates this tensor in place, and a
        # CPU tensor made with from_numpy would alias the host store
        dv = torch.tensor(store.values, dtype=self._torch_dtype,
                          device=self.device)
        cache[self._cache_key()] = (store.version, dv)
        return dv

    def _remember_values(self, store, dv) -> None:
        store.__dict__.setdefault("_device_values", {})[self._cache_key()] = (
            store.version, dv)

    def _di(self, arr) -> torch.Tensor:
        """A host integer array as an int32 tensor on the device; raises
        instead of wrapping a value outside int32 (the kernels index
        without bounds checks)."""
        arr = np.asarray(arr)
        if arr.size and (arr.min() < _I32.min or arr.max() > _I32.max):
            raise OverflowError(
                f"{self.name} backend: values in [{arr.min()}, {arr.max()}] "
                "do not fit the kernels' int32 operands")
        return torch.from_numpy(np.ascontiguousarray(
            arr, dtype=np.int32)).to(self.device)

    def _dl(self, arr) -> torch.Tensor:
        """A host integer array as an int64 (indexing) tensor."""
        return torch.from_numpy(np.ascontiguousarray(
            arr, dtype=np.int64)).to(self.device)

    def _dctx(self, tasks) -> torch.Tensor:
        """The batch's contexts on the device: the tensor `prefetch` staged
        when its dtype, device and shape match (behind its copy's event),
        else a fresh upload."""
        pre = tasks.__dict__.pop("_device_ctx", None)
        if pre is not None:
            dtype, t, ev, _ = pre
            if (dtype == self.dtype and t.device == self.device
                    and tuple(t.shape) == tasks.contexts.shape):
                if ev is not None:
                    cur = torch.cuda.current_stream(self.device)
                    cur.wait_event(ev)
                    t.record_stream(cur)
                return t
        return torch.from_numpy(np.ascontiguousarray(
            tasks.contexts, dtype=self._np_dtype)).to(self.device)

    # -- non-blocking dispatch hooks (serve.Frontend double-buffering) -----
    def prefetch(self, tasks, store) -> None:
        """Stage the batch's contexts for `execute` (see the class
        docstring): pinned host copy, one non-blocking copy on the side
        stream, an event behind it. Kept as (dtype, tensor, event, pinned
        buffer) in `tasks.__dict__["_device_ctx"]`."""
        if tasks.n == 0:
            return
        ctx = np.ascontiguousarray(tasks.contexts, dtype=self._np_dtype)
        if self.device.type != "cuda":
            tasks.__dict__["_device_ctx"] = (self.dtype, torch.tensor(ctx),
                                             None, None)
            return
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        pinned = torch.empty(ctx.shape, dtype=self._torch_dtype,
                             pin_memory=True)
        pinned.numpy()[...] = ctx
        with torch.cuda.stream(self._copy_stream):
            t = pinned.to(self.device, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self._copy_stream)
        tasks.__dict__["_device_ctx"] = (self.dtype, t, ev, pinned)

    def sync(self, store=None) -> None:
        """Wait for the staged copies, and for the device's queued work
        when `store` has values cached there (its stages' kernels and
        copies). No-op on the CPU."""
        if self.device.type != "cuda":
            return
        if self._copy_stream is not None:
            self._copy_stream.synchronize()
        if store is not None and self._cache_key() in store.__dict__.get(
                "_device_values", {}):
            torch.cuda.synchronize(self.device)

    def _to_host(self, t) -> np.ndarray:
        """A state array to the host, counted in `host_syncs`."""
        self.host_syncs += 1
        return t.cpu().numpy() if isinstance(t, torch.Tensor) \
            else np.asarray(t)

    # -- phase 3 (+ fused phase-4 ⊗) ---------------------------------------
    def execute(self, tasks, store, f: Callable, merge: Optional[MergeOp] = None,
                want_result: bool = True, exec_site=None,
                replicas=None) -> Dict[str, Optional[np.ndarray]]:
        self._stash = None
        # host route: empty batches, lambdas torch cannot run, and batches
        # whose keys or CSR offsets (nnz) overflow the kernels' int32
        if tasks.n == 0 or id(f) in self._host_lambdas \
                or store.num_keys >= 2**30 or tasks.nnz > _I32.max:
            self._flush_if_deferred(store)
            return execution.execute(tasks, store, f)

        n = tasks.n
        # when there ARE writers but no fused combine, the engines need the
        # real update rows for the oracle apply (want_update)
        w_rows, combine, want_update = _combine_eligibility(tasks, merge)
        uniq = None
        if combine:
            uniq, seg_w = np.unique(tasks.write_keys[w_rows],
                                    return_inverse=True)
        merge_name = merge.name if combine else "add"
        dv = self.device_values(store)
        ctx = self._dctx(tasks)
        try:
            # ragged batches with a fused-able lambda skip the padded gather:
            # the stage_fused kernel walks the CSR pair list. Flat
            # (arity ≤ 1) batches have no padding tax — they keep the flat
            # path.
            if (getattr(f, "fused_spec", None) is not None
                    and tasks.max_arity > 1):
                read_op, finish = f.fused_spec
                S = uniq.size if combine else 0
                seg_t = np.full(n, S, dtype=np.int32)  # S = writes nothing
                if combine:
                    seg_t[w_rows] = seg_w
                out = self._tx.run_stage_fused(
                    dv, self._di(tasks.read_indptr),
                    self._di(tasks.read_indices), ctx, self._di(seg_t),
                    self._di(tasks.priority) if combine else None,
                    num_segments=S,
                    read_op=read_op, finish=finish, merge_name=merge_name,
                    combine=combine, want_update=want_update,
                    want_result=want_result, max_arity=tasks.max_arity)
            else:
                if combine:
                    w_idx, seg, order = (self._dl(w_rows), self._di(seg_w),
                                         self._di(tasks.priority[w_rows]))
                    S = uniq.size
                else:
                    w_idx = seg = order = None
                    S = 0
                kw = dict(f=f, fwd_mask=execution._accepts_mask(f),
                          num_segments=S, merge_name=merge_name,
                          combine=combine, want_update=want_update,
                          want_result=want_result)
                if tasks.max_arity <= 1:
                    out = self._tx.run_stage_flat(
                        dv, self._dl(tasks.read_keys), ctx, w_idx, seg,
                        order, **kw)
                else:
                    row = tasks.pair_task
                    col = np.arange(tasks.nnz, dtype=np.int64) \
                        - tasks.read_indptr[:-1][row]
                    mask = torch.zeros((n, tasks.max_arity), dtype=torch.bool,
                                       device=self.device)
                    row_t, col_t = self._dl(row), self._dl(col)
                    mask[row_t, col_t] = True
                    out = self._tx.run_stage_ragged(
                        dv, self._dl(tasks.read_indices), row_t, col_t, mask,
                        ctx, w_idx, seg, order, **kw)
        except self._tx.LambdaFailed as exc:
            # the user's lambda (or finish) cannot run on torch tensors:
            # route this function object to the oracle path from now on —
            # if it is genuinely broken it raises there. Only user code is
            # inside torchexec's try; kernel and device failures propagate.
            warnings.warn(f"{self.name} backend: {exc}; this lambda runs on "
                          "the host numpy path from now on", RuntimeWarning,
                          stacklevel=2)
            self._host_lambdas.add(id(f))
            self._flush_if_deferred(store)
            return execution.execute(tasks, store, f)

        host: Dict[str, Optional[np.ndarray]] = {"result": None,
                                                 "update": None}
        if out.get("result") is not None:
            host["result"] = self._to_host(out["result"])
        if out.get("update") is not None:
            host["update"] = self._to_host(out["update"])
        combined = out.get("combined")
        if combine and combined is not None:
            # the engines only ever hand `update` back to apply_writes, and
            # the combine already happened on device — carry a zero-copy
            # shape-only placeholder instead of transferring n·w floats
            placeholder = np.broadcast_to(
                np.zeros((), dtype=self._np_dtype), (n, combined.shape[1]))
            host["update"] = placeholder
            self._stash = (id(tasks), id(placeholder), placeholder, uniq,
                           combined, merge.name, dv)
        return host

    def _take_stash(self, tasks, updates, merge: MergeOp):
        """apply_writes preamble: coerce `updates` to (n, w) rows and match
        them against the one-slot execute() carry. Returns (stash, updates)
        — stash None means "no fused combine for this pair, run the oracle
        apply". Guards the sentinel: if an engine transformed our
        zero-strided placeholder (copy/slice breaks the id match), applying
        it as real update rows would silently write zeros — refuse
        instead."""
        stash, self._stash = self._stash, None
        updates = np.atleast_2d(np.asarray(updates))
        if updates.shape[0] != tasks.n:
            updates = updates.T
        if (stash is None or stash[0] != id(tasks)
                or stash[1] != id(updates) or stash[5] != merge.name):
            if (stash is not None and updates.size
                    and 0 in updates.strides and not updates.any()):
                raise RuntimeError(
                    f"{self.name} backend: the zero-copy update placeholder "
                    "from execute() was transformed before apply_writes (id "
                    "no longer matches the fused combine). Pass the update "
                    "array through unchanged, or use backend='numpy' for "
                    "this engine.")
            return None, updates
        return stash, updates

    # -- phase 4 ⊙ ----------------------------------------------------------
    def apply_writes(self, tasks, store, updates, merge: MergeOp, cost) -> None:
        if updates is None:
            return
        stash, updates = self._take_stash(tasks, updates, merge)
        if stash is None:
            self._flush_if_deferred(store)
            execution.apply_writes(tasks, store, updates, merge, cost)
            return
        _, _, _, uniq, combined_dev, _, dv = stash
        if uniq.size == 0:
            return
        cost.work(store.home[uniq], 1.0)
        # device-side ⊙-apply, so the next stage needs no full re-upload
        new_dv = self._tx.apply_rows(dv, self._dl(uniq), combined_dev,
                                     merge_name=merge.name)
        if self._plan_store is store:
            # plan scope: the write-back stays on the device — the host copy
            # is refreshed at the next flush point, not per stage
            store.touch()
            self._remember_values(store, new_dv)
            self._plan_written.append(uniq)
            self._plan_dirty = True
            return
        # authoritative host apply (store dtype), exactly the oracle's ⊙
        combined = self._to_host(combined_dev).astype(store.values.dtype,
                                                      copy=False)
        store.write_rows(uniq, merge.apply(store.values[uniq], combined))
        self._remember_values(store, new_dv)

    # -- phase 1 ------------------------------------------------------------
    def key_counts(self, keys: np.ndarray, num_keys: int, weights=None
                   ) -> Tuple[np.ndarray, np.ndarray]:
        keys = np.asarray(keys, dtype=np.int64)
        # dense demand: the histogram kernel; sparse keys over a huge
        # range: the host path (identical counts)
        if keys.size == 0 or num_keys > max(1024, 8 * keys.size) \
                or num_keys >= 2**31:
            return super().key_counts(keys, num_keys, weights)
        w = None if weights is None else self._di(weights)
        # a cost-model input, not a state array: not a counted host sync
        counts = self._tx.contention_counts(
            self._di(keys), int(num_keys), weights=w).cpu().numpy()
        uk = np.flatnonzero(counts)
        return uk.astype(np.int64), counts[uk].astype(np.int64)

    # -- phase 2 ------------------------------------------------------------
    def argsort_stable(self, keys: np.ndarray) -> np.ndarray:
        return self._tx.stable_argsort(
            self._dl(keys)).cpu().numpy().astype(np.int64)

    # -- DistEdgeMap local combine ------------------------------------------
    def combine_by_key(self, values, keys, num_keys, merge: MergeOp, order):
        """Add-combines over a *repeated* key set (PageRank re-reduces the
        same edge list every round) run scatter-free on the device via the
        cached routing permutation; everything else — first sighting of a
        key set, non-add merges, batches under 4,096 keys — takes the
        oracle path, exactly as the JAX backend routes them. The returned
        key list is identical either way; combined sums agree within the
        float32 prefix-sum tolerance."""
        if merge.name == "add" and keys.size >= 4096 and num_keys < 2**31:
            rt = self._route
            if (rt is not None and rt[0].size == keys.size
                    and np.array_equal(rt[0], keys)):
                if len(rt) == 1:
                    # second sighting: the key set repeats — now the argsort
                    # pays off (a one-shot key set never sorts, it only
                    # pays the O(m) copy + compare)
                    perm = np.argsort(keys, kind="stable")
                    sk = keys[perm]
                    ends = np.flatnonzero(np.r_[sk[1:] != sk[:-1], True])
                    rt = self._route = (rt[0], self._dl(perm),
                                        self._dl(ends),
                                        sk[ends].astype(np.int64))
                vals = torch.from_numpy(np.ascontiguousarray(
                    values, dtype=self._np_dtype)).to(self.device)
                dev = self._tx.sorted_segment_sum(vals, rt[1], rt[2])
                return rt[3].copy(), self._to_host(dev).astype(np.float64)
            self._route = (keys.copy(),)  # candidate; routed if seen again
        return super().combine_by_key(values, keys, num_keys, merge, order)


def make_backend(spec) -> NumpyBackend:
    """Coerce a user-facing `backend=` spec into a backend instance.

    None/"torch" → a `TorchBackend` on the CUDA card (float32; raises
    without one); "numpy" → the shared float64 oracle; an existing backend
    instance passes through (shared device caches across sessions, or a
    ``TorchBackend(device="cpu")``).
    """
    if spec == "numpy":
        return _NUMPY
    if isinstance(spec, NumpyBackend):
        return spec
    if spec is None or isinstance(spec, str):
        return get_backend_cls("torch" if spec is None else spec)()
    raise TypeError(f"bad backend spec: {spec!r}")


_NUMPY = NumpyBackend()
