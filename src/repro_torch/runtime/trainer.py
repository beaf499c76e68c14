"""The fault-tolerant trainer, the port of the JAX package's
`runtime/trainer.py`.

Composes: a train step (`Model.loss_fn` under autograd, gradient
accumulation over microbatches summed in float32, optional int8
error-feedback gradient compression, `adamw_update` in place), async
checkpointing, deterministic data resume, failure injection → restore, and
straggler detection. The JAX package jits the step and donates its
buffers; the port runs it eagerly and updates the model's parameters, the
moments and the compression residuals in place.

The state is {"params": the model's named parameters (the live tensors),
"opt": `init_opt_state`'s, "comp": `init_compression_state`'s}. A restore
reads the checkpoint to the host and copies it into those tensors.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Dict, List, Optional

import torch

from ..checkpoint.manager import CheckpointManager, _leaves
from ..data.synthetic import SyntheticLMStream
from ..models.config import ModelConfig
from ..models.model import Model, resolve_device
from ..optim import AdamWConfig, adamw_update, init_opt_state
from .compression import (BLOCK, compress_gradients, decompress,
                          init_compression_state)
from .failures import FailureInjector, StragglerDetector


def _grads(model: Model, params: Dict[str, torch.Tensor], batch):
    """(loss, metrics, {name: gradient}) of one (micro)batch; a parameter
    the loss does not reach gets zeros, as `jax.grad` gives it."""
    loss, metrics = model.loss_fn(batch)
    names = list(params)
    got = torch.autograd.grad(loss, [params[k] for k in names],
                              allow_unused=True)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, {
        k: torch.zeros_like(params[k]) if g is None else g
        for k, g in zip(names, got)}


def _microbatches(batch: Dict[str, torch.Tensor], n: int):
    """`batch` cut into n microbatches along the batch dim (dim 1 of the
    (3, B, S) M-RoPE positions, dim 0 of the rest)."""
    parts = {k: v.chunk(n, dim=1 if k == "positions" else 0)
             for k, v in batch.items()}
    return [{k: p[i] for k, p in parts.items()} for i in range(n)]


@torch.no_grad()
def _data_mean(mesh, loss, metrics, grads):
    """The loss, metrics and gradients averaged over the mesh's data axis
    (a group mesh's data column; each rank computed its own data group's
    rows): the reduction GSPMD inserts for the JAX package, one
    all-reduce a tensor. Each data group's loss is a mean over its rows,
    so their mean is the whole batch's where the groups count as many
    positions (no mask, or as many unmasked)."""
    ax = mesh.data_axis

    def mean(t):
        return ax.psum(t[None], boundary="data mean")[0] / ax.P
    return (mean(loss), {k: mean(v) for k, v in metrics.items()},
            {k: mean(g) for k, g in grads.items()})


def _check_blocks(model: Model, grads) -> None:
    """int8 compression quantises each leaf in blocks of BLOCK values of
    the flattened leaf; a rank's shard lines up with the whole leaf's
    blocks only when its own size is a multiple of BLOCK."""
    for k in model.sharded_names():
        if grads[k].numel() % BLOCK:
            raise ValueError(
                f"int8 compression of {k}: a rank's shard "
                f"{tuple(grads[k].shape)} is not whole blocks of {BLOCK}, so "
                "its blocks would not be the whole leaf's")


def train_step(model: Model, state: Dict[str, Any], batch,
               opt_cfg: AdamWConfig, grad_accum: int = 1,
               compress_grads: bool = False) -> Dict[str, Any]:
    """One training step of `model` on `batch`: `Model.loss_fn` under
    autograd (over `grad_accum` microbatches, the gradients summed in
    float32 and averaged), optional int8 error-feedback compression
    (`state["comp"]`), `adamw_update` in place on `state["params"]` and
    `state["opt"]`. Returns {"loss", "nll", "aux", "lr", "grad_norm"} as
    tensors. `Trainer.train_step` and `launch.steps.build_train_step`
    both run it.

    On a group mesh (`launch.mesh.make_group_mesh`) `batch` is this rank's
    data group's rows: the loss, metrics and gradients are averaged over
    the data axis when it is over 1, and the global norm sums the sharded
    experts' squares over the model axis (`optim.clip`)."""
    params = state["params"]
    if grad_accum > 1:
        n = grad_accum
        acc = {k: torch.zeros(p.shape, dtype=torch.float32,
                              device=p.device) for k, p in params.items()}
        loss, metrics = 0.0, {}
        for mb in _microbatches(batch, n):
            l_mb, m_mb, grads = _grads(model, params, mb)
            for k, g in grads.items():
                acc[k] += g
            loss = loss + l_mb
            metrics = {k: metrics.get(k, 0.0) + v for k, v in m_mb.items()}
        grads = {k: a / n for k, a in acc.items()}
        loss = loss / n
        metrics = {k: v / n for k, v in metrics.items()}
    else:
        loss, metrics, grads = _grads(model, params, batch)
    mesh = model.mesh
    if mesh is not None and mesh.data_axis is not None \
            and mesh.data_axis.P > 1:
        loss, metrics, grads = _data_mean(mesh, loss, metrics, grads)
    sharded = model.sharded_names()
    if compress_grads:
        _check_blocks(model, grads)
        payload, _ = compress_gradients(grads, state["comp"])
        grads = decompress(payload, grads)
    _, _, opt_metrics = adamw_update(
        params, grads, state["opt"], opt_cfg, model.decayed(),
        mesh.groups[0] if sharded else None, sharded)
    return {"loss": loss, **metrics, **opt_metrics}


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 200
    checkpoint_every: int = 50
    checkpoint_dir: str = os.path.join(tempfile.gettempdir(),
                                       "repro_torch_ckpt")
    grad_accum: int = 1
    compress_grads: bool = False
    log_every: int = 10
    keep_checkpoints: int = 3


class Trainer:
    """Trains `Model(model_cfg)` on `stream`. `device=None` means CUDA (it
    raises without a card); the tests pass "cpu"."""

    def __init__(self, model_cfg: ModelConfig, opt_cfg: AdamWConfig,
                 cfg: TrainerConfig, stream: SyntheticLMStream,
                 failure_injector: Optional[FailureInjector] = None,
                 device=None):
        self.model_cfg = model_cfg
        self.opt_cfg = opt_cfg
        self.cfg = cfg
        self.stream = stream
        self.device = resolve_device(device)
        self.ckpt = CheckpointManager(cfg.checkpoint_dir,
                                      keep=cfg.keep_checkpoints)
        self.injector = failure_injector
        self.stragglers = StragglerDetector()
        self.history: List[Dict[str, float]] = []
        self.recoveries = 0
        self.model: Optional[Model] = None

    # ------------------------------------------------------------------
    def build_model(self, seed: int) -> Model:
        """The model at `seed`, from the port's seeded initializer. A
        subclass may start elsewhere (the tests carry a JAX `Model.init`
        across with `from_jax_params`)."""
        return Model(self.model_cfg, device=self.device, seed=seed)

    def init_state(self, seed: int = 0) -> Dict[str, Any]:
        self.model = self.build_model(seed)
        params = dict(self.model.named_parameters())
        return {"params": params, "opt": init_opt_state(params),
                "comp": init_compression_state(params)}

    # ------------------------------------------------------------------
    def train_step(self, state: Dict[str, Any], batch) -> Dict[str, Any]:
        """One step on `batch` (tensors on the device): the state written in
        place; returns {"loss", "nll", "aux", "lr", "grad_norm"} as
        tensors."""
        return train_step(self.model, state, batch, self.opt_cfg,
                          self.cfg.grad_accum, self.cfg.compress_grads)

    def _restore(self, state: Dict[str, Any]):
        """The newest checkpoint copied into `state`'s tensors: its step, or
        None when there is none."""
        restored = self.ckpt.restore_latest(state, device="cpu")
        if restored is None:
            return None
        step, tree, _ = restored
        with torch.no_grad():
            for (_, live), (_, saved) in zip(_leaves(state), _leaves(tree)):
                live.copy_(saved)
        return step

    # ------------------------------------------------------------------
    def run(self, seed: int = 0, node_id: int = 0) -> Dict[str, Any]:
        state = self.init_state(seed)
        start = self._restore(state)
        step = start or 0
        while step < self.cfg.total_steps:
            died = self.injector.tick(step) if self.injector else []
            if died:
                # node loss: roll back to the last commit and continue
                self.recoveries += 1
                restored = self._restore(state)
                if restored is not None:
                    step = restored
                else:
                    step = 0
                    state = self.init_state(seed)
                continue

            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in self.stream.batch_at(step).items()}
            t0 = time.perf_counter()
            metrics = self.train_step(state, batch)
            loss = float(metrics["loss"])  # waits for the step's work
            dt = time.perf_counter() - t0
            self.stragglers.record(node_id, dt)
            step += 1
            if step % self.cfg.log_every == 0 or step == 1:
                self.history.append({
                    "step": step,
                    "loss": loss,
                    "grad_norm": float(metrics["grad_norm"]),
                    "lr": float(metrics["lr"]),
                    "sec_per_step": dt,
                })
            if step % self.cfg.checkpoint_every == 0:
                self.ckpt.save_async(step, state, extra={"step": step})
        self.ckpt.wait()
        return {"state": state, "history": self.history,
                "recoveries": self.recoveries}
