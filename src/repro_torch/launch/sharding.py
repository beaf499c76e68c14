"""Sharding rules, the port of the JAX package's `launch/sharding.py`: the
param / optimizer / batch / activation / cache partition specs of each
arch, as pure functions on shapes (meta-device tensors serve: no
allocation).

Strategy (the JAX package's baseline):
  * TP on "model": attention Q/O + FFN hidden + vocab (Megatron-style
    column/row pairs).
  * GQA with kv_heads < |model|: K/V projections replicate on "model"; the
    decode KV cache shards on *sequence* instead.
  * FSDP on "data" for every >= 2D weight (ZeRO-3); optimizer moments
    likewise. The "pod" axis is pure DP.
  * MoE experts shard on "model" (EP), which the MoE block's mesh
    branches consume as (ep, E_pad/ep, ...) shards.
  * Divisibility guard: any dim not divisible by its axis size falls back
    to replication.

Rules match on the parameter's name (its last part) and apply to the
trailing dims. The specs are keyed by the port's parameter names, one
entry a layer. The JAX package stacks each layer kind's leaves over the
layers (leading dims that get None), so a JAX leaf's spec is the port's
entry's with those leading dims in front; the rules run on the JAX
package's stacked shape and the port keeps the leading dims' axes as
`P.stacked`. Those are None but where ZeRO-1 gives a moment's layer dim
the data axis (`opt_pspecs`): that layer's moments live on one data
shard, which a spec of the per-layer tensor cannot say.

The port runs on one device, so nothing places a tensor by these specs:
the JAX package's `to_named` (a `NamedSharding` a spec) has no
counterpart. The dry run (`launch.dryrun`) checks them and reckons each
device's bytes under them.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..models.config import ModelConfig
from ..models.model import _STACKED, Model

# tail-dim templates per parameter name: "F" = fsdp axis, "M" = model axis
_RULES: Dict[str, Tuple[Optional[str], ...]] = {
    # embeddings / head
    "embed": ("M", "F"),
    "lm_head": ("F", "M"),
    # attention
    "wq": ("F", "M"),
    "wk": ("F", "M"),
    "wv": ("F", "M"),
    "wo": ("M", "F"),
    "bq": ("M",),
    "bk": (None,),
    "bv": (None,),
    # dense MLP
    "w_gate": ("F", "M"),
    "w_up": ("F", "M"),
    "w_down": ("M", "F"),
    # MoE (consumed by the mesh branches as ("model", ...) shards)
    "router": (None, None),
    "w_in": ("M", None, "F"),
    "w_out": ("M", None, "F"),
    # mamba2
    "in_proj": ("F", "M"),
    "out_proj": ("M", "F"),
    "conv_w": (None, None),
    "conv_b": (None,),
    "A_log": (None,),
    "D": (None,),
    "dt_bias": (None,),
    "out_norm": (None,),
    # xlstm
    "up": ("F", "M"),
    "down": ("M", "F"),
    "w_gates": ("F", None),
    "b_gates": (None,),
    "w_in_slstm": ("F", "M"),
    "r": (None, None, None, None),
    "b": (None,),
    "ffn_up": ("F", "M"),
    "ffn_down": ("M", "F"),
    "norm_ffn": (None,),
}
_NORM_NAMES = {"ln", "ln1", "ln2", "final_norm", "norm_ffn", "out_norm"}


class P(tuple):
    """A partition spec: an entry a dim of the tensor — None, an axis name
    or a tuple of names — and `stacked`, the entries of the leading dims
    the JAX package's stacked leaf has in front (module docstring)."""

    def __new__(cls, *axes, stacked: Tuple = ()):
        # a tuple of one axis is that axis, as `PartitionSpec` has it
        self = super().__new__(cls, (_one(a) for a in axes))
        self.stacked = tuple(_one(a) for a in stacked)
        return self

    @property
    def full(self) -> Tuple:
        """The JAX package's spec of the stacked leaf."""
        return self.stacked + tuple(self)

    def __repr__(self) -> str:
        inner = ", ".join(map(repr, self))
        return (f"P({inner}, stacked={self.stacked!r})" if self.stacked
                else f"P({inner})")


def _one(entry):
    return entry[0] if isinstance(entry, tuple) and len(entry) == 1 \
        else entry


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _leaf_name(name: str) -> str:
    keys = name.split(".")
    leaf = keys[-1]
    # slstm's w_in shares a name with the MoE's; disambiguate
    if leaf == "w_in" and any("slstm" in k for k in keys):
        return "w_in_slstm"
    return leaf


def stacked_sizes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """The leading dims of each layer kind's stacked leaves in the JAX
    package, by the port's top-level name (`models.model._STACKED`)."""
    L = cfg.n_layers
    out = {"blocks": (L,), "mamba": (L,)}
    if cfg.xlstm is not None:
        units = L // cfg.xlstm.slstm_every
        out.update(slstm=(units,), mlstm=(units, cfg.xlstm.slstm_every - 1))
    assert set(out) <= set(_STACKED)
    return out


def _stacked_shape(name: str, shape, sizes) -> Tuple[Tuple[int, ...], int]:
    """(the JAX package's leaf shape, the count of leading stacked dims)."""
    lead = sizes.get(name.partition(".")[0], ()) if "." in name else ()
    return tuple(lead) + tuple(shape), len(lead)


def _split(full, k: int) -> P:
    return P(*full[k:], stacked=tuple(full[:k]))


def _resolve(template, shape, mesh, fsdp: bool, tp: bool) -> P:
    """Template tail -> full spec with divisibility fallbacks."""
    ndim = len(shape)
    tail = list(template)[-ndim:] if len(template) >= ndim else list(template)
    spec = [None] * (ndim - len(tail)) + tail
    out = []
    for dim, want in zip(shape, spec):
        axis = None
        if want == "M" and tp and "model" in mesh.axis_names:
            axis = "model" if dim % mesh.shape["model"] == 0 else None
        elif want == "F" and fsdp and "data" in mesh.axis_names:
            axis = "data" if dim % mesh.shape["data"] == 0 else None
        out.append(axis)
    # never shard the same axis twice in one spec
    seen = set()
    out = [a if (a is None or a not in seen) and not seen.add(a) else None
           for a in out]
    return P(*out)


def param_pspecs(params: Dict[str, torch.Tensor], cfg: ModelConfig, mesh, *,
                 fsdp: bool = True, tp: bool = True) -> Dict[str, P]:
    """{parameter name: P} for `params` (a model's named parameters; meta
    tensors serve). `cfg` is the model's (EP-padded) config. tp=False
    replicates over the model axis (the pure-DP preset) EXCEPT the MoE
    expert tables, which always ride "model" (EP)."""
    sizes = stacked_sizes(cfg)
    out = {}
    for name, t in params.items():
        leaf = _leaf_name(name)
        full, k = _stacked_shape(name, t.shape, sizes)
        if leaf in _NORM_NAMES or leaf not in _RULES:
            tmpl = (None,) * len(full)
        else:
            tmpl = _RULES[leaf]
        keep_tp = tp or leaf in ("w_in", "w_out")  # EP stays on "model"
        out[name] = _split(_resolve(tmpl, full, mesh, fsdp, keep_tp), k)
    return out


def opt_pspecs(param_specs: Dict[str, P], params: Dict[str, torch.Tensor],
               mesh, cfg: ModelConfig) -> Dict[str, Any]:
    """ZeRO-1: the moments inherit the parameter's spec, and the first
    still-unsharded dim of the stacked leaf (a layer dim, or a replicated
    small parameter's) gets the data axis where it divides."""
    sizes = stacked_sizes(cfg)

    def one(name, spec):
        full, k = _stacked_shape(name, params[name].shape, sizes)
        names = list(spec.full)
        if "data" not in names and "data" in mesh.axis_names:
            n = mesh.shape["data"]
            for i, (ax, dim) in enumerate(zip(names, full)):
                if ax is None and dim % n == 0 and dim >= n:
                    names[i] = "data"
                    break
        return _split(names, k)

    moments = {n: one(n, s) for n, s in param_specs.items()}
    return {"m": moments, "v": dict(moments), "step": P()}


def batch_axes_of(mesh, include_model: bool = False) -> Tuple[str, ...]:
    names = ("pod", "data", "model") if include_model else ("pod", "data")
    return tuple(a for a in names if a in mesh.axis_names)


def _size(mesh, axes) -> int:
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def batch_pspec(mesh, batch_size: int, include_model: bool = False) -> P:
    axes = batch_axes_of(mesh, include_model)
    if axes and batch_size % _size(mesh, axes) == 0:
        return P(axes)
    # small batches: shard over as much of the batch axes as divides (the
    # JAX package reads the sizes before it checks that the axes exist,
    # and raises KeyError('pod') here on a mesh without a pod axis)
    for sub in (("pod", "data"), ("data",), ()):
        if all(a in mesh.axis_names for a in sub) and \
                batch_size % _size(mesh, sub) == 0:
            return P(sub if sub else None)
    return P(None)


def activation_pspec(mesh, batch_size: int, seq_len: int,
                     sequence_parallel: bool = True, tp: bool = True) -> P:
    """Residual-stream spec: batch over the DP axes and (optionally) seq
    over "model" (Megatron sequence parallelism). tp=False (pure DP): batch
    spreads over the model axis instead."""
    b = batch_pspec(mesh, batch_size, include_model=not tp)
    bspec = b[0] if len(b) else None
    if tp and sequence_parallel and "model" in mesh.axis_names \
            and seq_len % mesh.shape["model"] == 0:
        return P(bspec, "model", None)
    return P(bspec, None, None)


def cache_pspecs(cfg: ModelConfig, mesh, batch: int, max_len: int):
    """Decode-cache specs, and the caches as meta tensors (`Model.
    init_caches` on the meta device: the JAX package's layout). Attention
    k/v (L, B, T, KV, hd): batch over the DP axes where it divides; KV
    heads over "model" where they cover it, else the *sequence* dim. SSM
    and LSTM states: batch over the DP axes, the last feature dim that
    divides over "model"."""
    bspec = batch_pspec(mesh, batch)
    baxes = bspec[0] if len(bspec) else None
    msize = mesh.shape["model"] if "model" in mesh.axis_names else 1

    def attn_spec(shape):  # (n, B, T, KV, hd)
        kv = shape[3]
        if kv % msize == 0 and kv >= msize:
            return P(None, baxes, None, "model", None)
        if shape[2] % msize == 0:
            return P(None, baxes, "model", None, None)
        return P(None, baxes, None, None, None)

    def generic(t):
        # the batch dim follows the stacked layer dim(s)
        names = [None] * t.ndim
        if t.ndim >= 2:
            names[1] = baxes if t.shape[1] == batch and batch > 1 else None
        for i in range(t.ndim - 1, 1, -1):
            if t.shape[i] % msize == 0 and t.shape[i] >= msize:
                names[i] = "model"
                break
        return P(*names)

    def assign(t):
        if t.ndim == 5 and t.shape[2] == max_len:
            return attn_spec(t.shape)
        return generic(t)

    shapes = Model(cfg, device="meta").init_caches(batch, max_len)
    return tree_map(assign, shapes), shapes


def tree_map(fn, tree):
    """`fn` on every tensor of a tree of dicts, tuples and NamedTuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and not isinstance(tree, P):
        items = [tree_map(fn, v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else \
            tuple(items)
    return fn(tree)


def tree_leaves(tree) -> list:
    """The tensors (or specs) of a tree, dict keys sorted, as `jax.tree.
    leaves` orders them."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, tuple) and not isinstance(tree, P):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]
