"""`MoERouter` — token→expert dispatch as an orchestration workload.

Token→expert routing is the paper's problem statement verbatim: tasks are
routed tokens, data chunks are per-expert FFN weight blocks, and expert
imbalance (the Zipfian routing every trained MoE exhibits) is the data hot
spot of §2.3. The router homes each `(layer, expert)` weight block as one
DataStore chunk; a decode step's routed tokens become one ragged CSR
`TaskBatch` — task = token, reads = its top-k experts' chunks, context =
the token activation ‖ its combine gates — whose stage lambda runs the
gathered-weights expert FFN (`kernels.moe_gemm.gathered_swiglu`). Hot-expert
replication and the backend choice come from the `Orchestrator` core
through the same `SessionConfig` every front door takes; by default the
stage runs on `TorchBackend()`, the CUDA card.

Phase mapping:

  Phase 1  routed-expert contention detection  = expert-demand histogram
  Phase 2  push-pull co-location               = weight pull / token push
  Phase 3  local execution                     = grouped expert FFN
  Phase 4  merge-able write-backs              = (serving: none — reads only)

`naive_dispatch` is the §2.3 all-to-all baseline: every assignment executes
at its expert's home shard (classic expert parallelism), so per-machine
work is exactly expert demand. With ``gemm="torch"`` its two projections
run the grouped-GEMM kernel (`kernels.moe_gemm.grouped_gemm`).

The streaming front door (`serve()`, `MoEFrontend`) waits for the port of
`repro.serve`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core import (DataStore, Orchestrator, TaskBatch, TorchBackend,
                    resolve_session_config)
from ..kernels.moe_gemm.ops import gathered_swiglu, grouped_gemm
from ._sessions import cached_session

__all__ = ["MoERouter", "MoEFFNLambda", "DecodeResult",
           "NaiveDispatchResult"]

_SERVE_PENDING = (
    "the streaming front door ({what}) needs the serve subsystem, which is "
    "not ported to the torch package yet (the repro.serve slice); call "
    "decode_step on whole batches")


class MoEFFNLambda:
    """The router's stage lambda: per-token gathered-expert SwiGLU.

    Sees the orchestrator's padded multi-get view — `vals[i, a]` is the
    flattened weight block (w_in ‖ w_out) of token i's a-th routed expert,
    CSR slot order — and the token context `(x ‖ gates)`, gates aligned to
    the same slot order. One cached instance per `(d, f, k)`. Runs on numpy
    arrays (the oracle) and on torch tensors (the torch backend) with the
    same `gathered_swiglu` expression.
    """

    def __init__(self, d_model: int, d_ff: int, top_k: int):
        self.d = int(d_model)
        self.f = int(d_ff)
        self.k = int(top_k)

    def __repr__(self):
        return f"MoEFFNLambda(d={self.d}, f={self.f}, k={self.k})"

    def __call__(self, contexts, vals, mask) -> Dict[str, object]:
        d, f = self.d, self.f
        if vals.ndim == 2:  # arity-≤1 view: one expert slot
            vals = vals[:, None, :]
            mask = mask[:, None]
        n, A = vals.shape[0], vals.shape[1]
        x = contexts[:, :d]
        gates = contexts[:, d:d + A] * mask  # inactive slots combine as 0
        # views, no copies: each block splits a contiguous run of a row
        w_in = vals[..., :d * 2 * f].reshape(n, A, d, 2 * f)
        w_out = vals[..., d * 2 * f:].reshape(n, A, f, d)
        y = gathered_swiglu(x, w_in, w_out, gates)
        return {"result": y}


_LAMBDAS: Dict[Tuple[int, int, int], MoEFFNLambda] = {}


def _ffn_lambda(d: int, f: int, k: int) -> MoEFFNLambda:
    lam = _LAMBDAS.get((d, f, k))
    if lam is None:
        lam = _LAMBDAS[(d, f, k)] = MoEFFNLambda(d, f, k)
    return lam


@dataclasses.dataclass
class DecodeResult:
    """One orchestrated decode step: combined outputs + the stage's bill."""

    y: np.ndarray  # (T, d) gated expert mixture per token
    report: object  # StageReport
    refcount: Dict[int, int]  # Phase-1 per-expert-chunk demand
    exec_site: np.ndarray  # (T,) machine that ran each token's FFN


@dataclasses.dataclass
class NaiveDispatchResult:
    """The all-to-all baseline arm: outputs + its per-machine work model."""

    y: np.ndarray  # (T, d)
    work: np.ndarray  # (P,) FFN work units charged at each expert's home
    work_ratio: float  # max/mean — Definition 1's balance quantity
    dropped: int  # assignments with expert id -1 (router drops)


class MoERouter:
    """Per-layer expert weights homed as DataStore chunks; decode steps are
    orchestration stages.

    Chunk key `layer * E + e` holds expert e of layer `layer` as one
    flattened `(d·2f + f·d)`-word row (w_in ‖ w_out). `decode_step` routes a
    `(T, d)` batch of token activations with their top-k expert assignments
    through the session: work per (token, expert) pair is charged where the
    pair's FFN actually runs (`work_per_pair`), so `report.per_machine()`
    measures Definition 1 on expert-imbalanced traffic directly.
    """

    def __init__(self, num_experts: int, d_model: int, d_ff: int,
                 num_machines: int, *, num_layers: int = 1, top_k: int = 2,
                 seed: int = 0):
        width = int(d_model) * 2 * int(d_ff) + int(d_ff) * int(d_model)
        self._attach(DataStore.create(
            int(num_layers) * int(num_experts), num_machines,
            value_width=width, chunk_words=width, salt=seed),
            num_experts, d_model, d_ff, num_layers, top_k)

    def _attach(self, store: DataStore, num_experts: int, d_model: int,
                d_ff: int, num_layers: int, top_k: int) -> None:
        self.E = int(num_experts)
        self.d = int(d_model)
        self.f = int(d_ff)
        self.k = int(top_k)
        self.num_layers = int(num_layers)
        self.P = int(store.P)
        self.store = store
        # FLOPs proxy per (token, expert) assignment: 2·d·2f (in-proj)
        # + 2·f·d (out-proj) MACs ≈ 6·d·f — the Phase-3 unit `work_per_pair`
        # charges, so work_ratio measures FFN imbalance, not bookkeeping
        self.ffn_work = float(6 * self.d * self.f)
        self._sessions: Dict[tuple, Orchestrator] = {}

    @classmethod
    def from_reference(cls, ref) -> "MoERouter":
        """A port router holding the same expert weights and placement as a
        JAX-package `MoERouter` (read by attribute, never imported)."""
        self = cls.__new__(cls)
        self._attach(DataStore.from_reference(ref.store), ref.E, ref.d,
                     ref.f, ref.num_layers, ref.k)
        width = self.d * 2 * self.f + self.f * self.d
        if self.store.values.shape != (self.num_layers * self.E, width):
            raise ValueError(
                f"reference store holds {self.store.values.shape}, expected "
                f"{(self.num_layers * self.E, width)}")
        return self

    # ---- weights -----------------------------------------------------------
    @property
    def weight_width(self) -> int:
        return self.store.value_width

    def _chunk(self, layer: int) -> slice:
        if not 0 <= layer < self.num_layers:
            raise ValueError(f"layer {layer} out of range "
                             f"[0, {self.num_layers})")
        return slice(layer * self.E, (layer + 1) * self.E)

    def load_weights(self, w_in: np.ndarray, w_out: np.ndarray,
                     layer: int = 0) -> None:
        """Home one layer's expert stack: w_in (E, d, 2f), w_out (E, f, d)."""
        w_in = np.asarray(w_in, dtype=np.float64)
        w_out = np.asarray(w_out, dtype=np.float64)
        if w_in.shape != (self.E, self.d, 2 * self.f):
            raise ValueError(f"w_in shape {w_in.shape} != "
                             f"{(self.E, self.d, 2 * self.f)}")
        if w_out.shape != (self.E, self.f, self.d):
            raise ValueError(f"w_out shape {w_out.shape} != "
                             f"{(self.E, self.f, self.d)}")
        rows = np.concatenate(
            [w_in.reshape(self.E, -1), w_out.reshape(self.E, -1)], axis=1)
        sl = self._chunk(layer)
        self.store.write_rows(np.arange(sl.start, sl.stop, dtype=np.int64),
                              rows)

    def init_weights(self, seed: int = 0) -> None:
        """Deterministic random expert stacks for every layer (tests/bench)."""
        rng = np.random.default_rng(seed)
        for layer in range(self.num_layers):
            w_in = rng.normal(0, self.d ** -0.5,
                              (self.E, self.d, 2 * self.f))
            w_out = rng.normal(0, self.f ** -0.5, (self.E, self.f, self.d))
            self.load_weights(w_in, w_out, layer)

    def layer_weights(self, layer: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        """(w_in (E, d, 2f), w_out (E, f, d)) views of the homed chunks."""
        rows = self.store.values[self._chunk(layer)]
        cut = self.d * 2 * self.f
        return (rows[:, :cut].reshape(self.E, self.d, 2 * self.f),
                rows[:, cut:].reshape(self.E, self.f, self.d))

    # ---- sessions ----------------------------------------------------------
    def session(self, engine=None, *, config=None, backend=None,
                replication=None, replicate=None, elasticity=None,
                **engine_opts) -> Orchestrator:
        """The router's cached long-lived session (same alias resolution as
        every front door). Unless overridden, sessions charge Phase-3 work
        per (token, expert) pair at `ffn_work` units — the FFN cost model —
        instead of the generic one-unit-per-task default."""
        cfg = resolve_session_config(
            config, engine_opts=engine_opts, engine=engine, backend=backend,
            replication=replication, replicate=replicate,
            elasticity=elasticity)
        opts = dict(cfg.engine_opts)
        opts.setdefault("work_per_task", 0.0)
        opts.setdefault("work_per_pair", self.ffn_work)
        return cached_session(self._sessions, self.store,
                              dataclasses.replace(cfg, engine_opts=opts))

    # ---- routing -----------------------------------------------------------
    def route_batch(self, x: np.ndarray, top_i: np.ndarray,
                    gates: np.ndarray, layer: int = 0,
                    origin: Optional[np.ndarray] = None) -> TaskBatch:
        """One decode step's routed tokens as a ragged CSR TaskBatch.

        x: (T, d) activations; top_i: (T, k) expert ids (-1 = dropped slot);
        gates: (T, k) combine weights. Task i reads the chunks of its kept
        experts (CSR order = kept slots in top-k order) and carries
        `(x_i ‖ gates_i-compacted-to-kept-order)` as its σ = d + k context.
        Serving reads weights only: `write_keys = -1` everywhere.
        """
        x = np.asarray(x, dtype=np.float64)
        top_i = np.asarray(top_i, dtype=np.int64)
        gates = np.asarray(gates, dtype=np.float64)
        T = x.shape[0]
        if x.shape != (T, self.d):
            raise ValueError(f"x shape {x.shape} != {(T, self.d)}")
        if top_i.shape != (T, self.k) or gates.shape != (T, self.k):
            raise ValueError(
                f"top_i/gates must be (T, k) = {(T, self.k)}, got "
                f"{top_i.shape}/{gates.shape}")
        base = self._chunk(layer).start
        keep = top_i >= 0  # (T, k)
        arity = keep.sum(axis=1)
        indptr = np.zeros(T + 1, dtype=np.int64)
        np.cumsum(arity, out=indptr[1:])
        indices = base + top_i[keep]
        # compact each token's kept gates to the front so gate slot a of the
        # context aligns with CSR slot a of the gathered padded view
        gctx = np.zeros((T, self.k))
        row, _ = np.nonzero(keep)
        slot = np.arange(keep.sum()) - indptr[:-1][row]
        gctx[row, slot] = gates[keep]
        if origin is None:
            origin = TaskBatch.even_origins(T, self.P)
        return TaskBatch(
            contexts=np.concatenate([x, gctx], axis=1),
            origin=origin,
            write_keys=np.full(T, -1, dtype=np.int64),
            read_indptr=indptr, read_indices=indices,
        )

    def decode_step(self, x: np.ndarray, top_i: np.ndarray,
                    gates: np.ndarray, *, layer: int = 0, engine=None,
                    config=None, origin=None, **kw) -> DecodeResult:
        """Run one routed decode step through the orchestrated dispatcher
        (on the card unless the session's backend says otherwise)."""
        tasks = self.route_batch(x, top_i, gates, layer, origin)
        sess = self.session(engine, config=config, **kw)
        res = sess.run_stage(tasks, _ffn_lambda(self.d, self.f, self.k),
                             write_back="add", return_results=True)
        return DecodeResult(y=np.asarray(res.results), report=res.report,
                            refcount=res.refcount, exec_site=res.exec_site)

    # ---- oracle + naive baseline ------------------------------------------
    def oracle(self, x: np.ndarray, top_i: np.ndarray, gates: np.ndarray,
               layer: int = 0) -> np.ndarray:
        """Dense numpy reference: gather every token's expert blocks and run
        the same `gathered_swiglu` expression the stage lambda runs."""
        x = np.asarray(x, dtype=np.float64)
        top_i = np.asarray(top_i, dtype=np.int64)
        gates = np.asarray(gates, dtype=np.float64)
        w_in, w_out = self.layer_weights(layer)
        keep = top_i >= 0
        safe = np.maximum(top_i, 0)
        w_in_g = np.where(keep[..., None, None], w_in[safe], 0.0)
        w_out_g = np.where(keep[..., None, None], w_out[safe], 0.0)
        return gathered_swiglu(x, w_in_g, w_out_g, gates * keep)

    def naive_dispatch(self, x: np.ndarray, top_i: np.ndarray,
                       gates: np.ndarray, *, layer: int = 0,
                       gemm: str = "numpy", device=None
                       ) -> NaiveDispatchResult:
        """The all-to-all baseline: each assignment ships to its expert's
        home shard and runs there (classic expert parallelism), so
        per-machine FFN work is exactly per-expert demand — no contention
        detection, no replication, no stealing.

        `gemm="numpy"` computes with the dense float64 oracle; ``"torch"``
        sorts assignments by expert and runs the two projections through
        `kernels.moe_gemm.grouped_gemm` in float32 on `device` (None: the
        CUDA card, which must exist; ``"cpu"``: the plain version).
        """
        if gemm not in ("numpy", "torch"):
            raise ValueError(
                f"gemm={gemm!r}: the torch port computes with 'numpy' (the "
                "float64 oracle) or 'torch' (the grouped-GEMM kernel); "
                "'pallas', 'interpret' and 'ref' belong to the JAX package")
        x = np.asarray(x, dtype=np.float64)
        top_i = np.asarray(top_i, dtype=np.int64)
        gates = np.asarray(gates, dtype=np.float64)
        sl = self._chunk(layer)
        keep = top_i >= 0
        flat_e = top_i[keep]
        dropped = int((~keep).sum())
        # per-machine FFN work: every kept assignment charged at its
        # expert's home — the imbalance the orchestrated arm dissolves
        work = np.zeros(self.P, dtype=np.float64)
        np.add.at(work, self.store.home[sl.start + flat_e], self.ffn_work)
        ratio = float(work.max(initial=0.0) / max(work.mean(), 1e-12))

        if gemm == "numpy":
            y = self.oracle(x, top_i, gates, layer)
        else:
            y = self._grouped_ffn(x, keep, flat_e, gates, sl, device)
        return NaiveDispatchResult(y=y, work=work, work_ratio=ratio,
                                   dropped=dropped)

    def _grouped_ffn(self, x, keep, flat_e, gates, sl: slice, device
                     ) -> np.ndarray:
        """The naive arm's expert FFN in the sorted-by-group layout: two
        grouped GEMMs over the kept assignments, float32 on `device`, then
        the gated scatter-add to the tokens in float64 there. The weights
        are views of the float32 device copy of the store that the torch
        backend keeps (shared with `decode_step`'s sessions), read in
        place."""
        rows = TorchBackend(device=device).device_values(self.store)[sl]
        dev = rows.device
        cut = self.d * 2 * self.f
        w_in = rows[:, :cut].view(self.E, self.d, 2 * self.f)
        w_out = rows[:, cut:].view(self.E, self.f, self.d)
        order = np.argsort(flat_e, kind="stable")
        tok = torch.from_numpy(np.nonzero(keep)[0][order]).to(dev)
        sizes = torch.from_numpy(np.bincount(
            flat_e, minlength=self.E).astype(np.int32)).to(dev)
        xs = torch.from_numpy(x.astype(np.float32)).to(dev)[tok]
        h = grouped_gemm(xs, w_in, sizes)
        g, up = h[:, :self.f], h[:, self.f:]
        act = (g * (1.0 / (1.0 + torch.exp(-g))) * up).contiguous()
        out = grouped_gemm(act, w_out, sizes).double()
        out *= torch.from_numpy(gates[keep][order]).to(dev)[:, None]
        y = torch.zeros((x.shape[0], self.d), dtype=torch.float64,
                        device=dev)
        return y.index_add_(0, tok, out).cpu().numpy()

    # ---- synthetic routing (tests / benchmarks / examples) -----------------
    def zipf_routing(self, num_tokens: int, alpha: float = 1.2,
                     seed: int = 0,
                     rank_perm: Optional[np.ndarray] = None
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """A skewed decode step: Zipf(α) expert popularity (rank-permuted by
        seed), distinct experts per token, softmax-ish gates. Returns
        (x (T,d), top_i (T,k), gates (T,k)) ready for `decode_step`. The
        draws are the JAX package's, in its order, so a seed routes the
        same tokens in both packages.

        Each seed draws a fresh rank→expert permutation, so consecutive
        seeds model an adversarially nonstationary router. A trained MoE's
        hot experts persist across decode steps — pass one `rank_perm`
        (`rng.permutation(E)`) to every stage for that stationary regime."""
        rng = np.random.default_rng(seed)
        T = int(num_tokens)
        x = rng.normal(0, 1.0, (T, self.d))
        rank = rng.permutation(self.E) if rank_perm is None \
            else np.asarray(rank_perm, dtype=np.int64)
        p = 1.0 / np.arange(1, self.E + 1, dtype=np.float64) ** alpha
        probs = np.empty(self.E)
        probs[rank] = p / p.sum()
        top_i = np.empty((T, self.k), dtype=np.int64)
        for t in range(T):
            top_i[t] = rng.choice(self.E, size=self.k, replace=False, p=probs)
        raw = rng.uniform(0.5, 1.5, (T, self.k))
        gates = raw / raw.sum(axis=1, keepdims=True)
        return x, top_i, gates

    # ---- streaming serving mode -------------------------------------------
    def serve(self, **kw) -> "MoEFrontend":
        raise NotImplementedError(_SERVE_PENDING.format(
            what="MoERouter.serve"))


class MoEFrontend:
    """The streaming decode front door of the JAX package; not ported."""

    def __init__(self, *args, **kw):
        raise NotImplementedError(_SERVE_PENDING.format(what="MoEFrontend"))
