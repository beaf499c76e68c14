"""The step builders, the port of the JAX package's `launch/steps.py`: the
train / prefill / decode steps bound to a mesh (`launch.mesh`), with the
specs of every argument — what the dry run checks and the launchers call.

`build_step(cfg, mesh, shape)` returns a `BoundStep`:
    fn         a plain callable on the model's device:
                 train    fn(params, opt_state, batch)
                          -> (params, opt_state, metrics), both written in
                          place: `runtime.trainer.train_step` (`Model.
                          loss_fn` under autograd, grad accumulation,
                          AdamW), the step `Trainer.train_step` runs;
                 prefill  fn(batch, max_len=S) -> (logits of the last
                          position, caches): `Model.prefill`; with M-RoPE
                          positions, fn(batch) -> (logits of the last
                          position, the forward's states), as the JAX
                          package's variant;
                 decode   fn(caches, batch, cache_pos) -> (logits,
                          caches), the caches written in place:
                          `Model.decode_step`.
    arg_specs  meta tensors of the arguments: {"params", "opt"} at
               training, "inputs" (`specs.input_specs`), "caches" and
               "cache_pos" at decode;
    specs      their partition specs (`launch.sharding`), the same keys,
               plus "logits" and "caches" at prefill and "activation"
               (the residual stream's, which the JAX package applies
               between blocks; nothing applies it in one process);
    model      the `Model` (on `device`, the card unless named; "meta"
               builds the shapes alone, as the dry run does), EP-padded
               for the mesh. `model=` binds an existing model instead (a
               prefill and a decode step on the same weights). On a
               group mesh (`mesh.make_group_mesh`) it is this rank's: its
               experts alone, and `fn` takes this rank's data group's
               rows; `arg_specs` and `specs` stay the whole model's;
    shape      the workload (batch, seq, kind; accum at training);
    out_shapes meta tensors of the caches a prefill fills.

The JAX package's `scan_layers` and `remat` switches (a scanned or
unrolled layer stack; recompute in the backward) have no counterpart: the
port runs its layers in a Python loop and keeps their activations.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from ..models.config import ModelConfig
from ..models.model import Model
from ..optim import AdamWConfig, init_opt_state
from ..runtime.trainer import train_step as _train_step
from . import sharding as sh
from .specs import Shape, input_specs, shape_info


@dataclasses.dataclass
class BoundStep:
    fn: Callable
    arg_specs: Dict[str, Any]
    model: Model
    specs: Dict[str, Any]
    kind: str = "train"
    # the workload: batch, seq, kind (and accum, the microbatches, at
    # training)
    shape: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # meta tensors of outputs that have specs: the caches a prefill fills
    out_shapes: Dict[str, Any] = dataclasses.field(default_factory=dict)


def _vocab_axis(cfg: ModelConfig, mesh):
    m = mesh.shape.get("model", 1)
    return "model" if cfg.vocab_size % m == 0 else None


def _batch_specs(inputs: Dict, mesh, batch: int, tp: bool = True):
    bspec = sh.batch_pspec(mesh, batch, include_model=not tp)
    baxes = bspec[0] if len(bspec) else None

    def spec(k):
        if k in ("tokens", "targets"):
            return sh.P(baxes, None)
        if k == "embeds":
            return sh.P(baxes, None, None)
        if k == "positions":
            return sh.P(None, baxes, None)
        raise KeyError(k)

    return {k: spec(k) for k in inputs}


def _split_inputs(inputs: Dict) -> Dict:
    return {k: inputs[k] for k in ("tokens", "embeds") if k in inputs}


def _logits_spec(cfg, mesh, batch: int):
    bspec = sh.batch_pspec(mesh, batch)
    baxes = bspec[0] if len(bspec) else None
    return sh.P(baxes, None, _vocab_axis(cfg, mesh))


def _bind(cfg, mesh, device, seed, model) -> Model:
    if model is None:
        return Model(cfg, device=device, seed=seed, mesh=mesh)
    if model.mesh is not mesh or model.cfg.name != cfg.name:
        raise ValueError("model= must be built for this config and mesh")
    return model


def _meta_params(model: Model) -> Dict[str, torch.Tensor]:
    """Meta tensors of the whole model's parameters (on a group mesh a
    rank holds a shard of the expert tables; the specs are the whole
    model's)."""
    return {n: torch.empty(model.global_shape(n, p), dtype=p.dtype,
                           device="meta")
            for n, p in model.named_parameters()}


def default_grad_accum(cfg: ModelConfig) -> int:
    """>= 25 B-parameter archs split the global batch into microbatches
    (2; >= 60 B: 4), cutting the live activations."""
    n = cfg.param_count()
    if n >= 60e9:
        return 4
    if n >= 25e9:
        return 2
    return 1


def build_train_step(cfg: ModelConfig, mesh, shape: Shape = "train_4k", *,
                     opt_cfg: Optional[AdamWConfig] = None,
                     fsdp: bool = True, sequence_parallel: bool = True,
                     tp: bool = True, grad_accum: Optional[int] = None,
                     device=None, seed: int = 0,
                     model: Optional[Model] = None) -> BoundStep:
    spec = input_specs(cfg, shape)
    B, S = spec["batch"], spec["seq"]
    opt_cfg = opt_cfg or AdamWConfig()
    accum = grad_accum if grad_accum is not None else default_grad_accum(cfg)
    model = _bind(cfg, mesh, device, seed, model)
    params = _meta_params(model)
    pspecs = sh.param_pspecs(params, model.cfg, mesh, fsdp=fsdp, tp=tp)

    def train_step(params, opt_state, batch):
        metrics = _train_step(model, {"params": params, "opt": opt_state},
                              batch, opt_cfg, accum)
        return params, opt_state, metrics

    return BoundStep(
        fn=train_step, model=model, kind="train",
        shape=dict(shape_info(shape), accum=accum),
        arg_specs={"params": params, "opt": init_opt_state(params),
                   "inputs": spec["inputs"]},
        specs={"params": pspecs,
               "opt": sh.opt_pspecs(pspecs, params, mesh, model.cfg),
               "inputs": _batch_specs(spec["inputs"], mesh, B, tp=tp),
               "activation": sh.activation_pspec(
                   mesh, B // accum, S, sequence_parallel, tp=tp)})


def build_prefill_step(cfg: ModelConfig, mesh, shape: Shape = "prefill_32k",
                       *, fsdp: bool = True, sequence_parallel: bool = True,
                       device=None, seed: int = 0,
                       model: Optional[Model] = None) -> BoundStep:
    spec = input_specs(cfg, shape)
    B, S = spec["batch"], spec["seq"]
    model = _bind(cfg, mesh, device, seed, model)
    params = _meta_params(model)
    cache_specs, cache_shapes = sh.cache_pspecs(model.cfg, mesh, B, S)

    def prefill_step(batch, max_len=S):
        return model.prefill(**_split_inputs(batch), max_len=max_len)

    # M-RoPE: the (3, B, S) ids flow through forward() directly
    if "positions" in spec["inputs"]:
        def prefill_step(batch):  # noqa: F811
            logits, states, _ = model.forward(
                tokens=batch.get("tokens"), embeds=batch.get("embeds"),
                positions=batch["positions"])
            return logits[:, -1:], states

        cache_specs = cache_shapes = None  # the forward's raw states

    return BoundStep(
        fn=prefill_step, model=model, kind="prefill",
        shape=shape_info(shape), out_shapes={"caches": cache_shapes},
        arg_specs={"params": params, "inputs": spec["inputs"]},
        specs={"params": sh.param_pspecs(params, model.cfg, mesh, fsdp=fsdp),
               "inputs": _batch_specs(spec["inputs"], mesh, B),
               "caches": cache_specs,
               "logits": _logits_spec(cfg, mesh, B),
               "activation": sh.activation_pspec(mesh, B, S,
                                                 sequence_parallel)})


def build_decode_step(cfg: ModelConfig, mesh, shape: Shape, *,
                      fsdp: bool = True, device=None, seed: int = 0,
                      model: Optional[Model] = None) -> BoundStep:
    spec = input_specs(cfg, shape)
    B, S = spec["batch"], spec["seq"]
    model = _bind(cfg, mesh, device, seed, model)
    params = _meta_params(model)
    cache_specs, cache_shapes = sh.cache_pspecs(model.cfg, mesh, B, S)

    def serve_step(caches, batch, cache_pos):
        return model.decode_step(caches, **_split_inputs(batch),
                                 cache_pos=cache_pos)

    return BoundStep(
        fn=serve_step, model=model, kind="decode", shape=shape_info(shape),
        arg_specs={"params": params, "caches": cache_shapes,
                   "inputs": spec["inputs"],
                   "cache_pos": torch.empty((), dtype=torch.int32,
                                            device="meta")},
        specs={"params": sh.param_pspecs(params, model.cfg, mesh, fsdp=fsdp),
               "caches": cache_specs,
               "inputs": _batch_specs(spec["inputs"], mesh, B),
               "cache_pos": sh.P(),
               "logits": _logits_spec(cfg, mesh, B)})


def build_step(cfg: ModelConfig, mesh, shape: Shape, **kw) -> BoundStep:
    kind = shape_info(shape)["kind"]
    if kind == "train":
        return build_train_step(cfg, mesh, shape, **kw)
    if kind == "prefill":
        return build_prefill_step(cfg, mesh, shape, **kw)
    return build_decode_step(cfg, mesh, shape, **kw)
