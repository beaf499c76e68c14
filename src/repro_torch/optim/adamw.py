"""AdamW with a warmup + cosine schedule, the port of the JAX package's
`optim/adamw.py` on a dict of named tensors (a model's
`named_parameters()`, the names of `from_jax_params`).

The arithmetic is the JAX package's: the moments m and v are float32; the
schedule, the step count's bias corrections and the update are float32
tensors; decoupled weight decay applies where the JAX package's leaf has
ndim >= 2; the new value is computed in float32 and rounded to the
parameter's own dtype, so bf16 parameters stay bf16 with no float32 master
copy. The JAX package returns new pytrees; the port updates parameters and
moments in place under `torch.no_grad()` (it never holds two copies of a
model).

The port's parameters are one tensor a layer, where the JAX package stacks
the layers into one leaf: there a layer's norm scale or bias is a row of
an ndim-2 leaf and takes the decay. So `adamw_update` takes the rule as
`decay` (name -> bool): the trainer passes `Model.decayed()`, the JAX
package's rule on its stacked leaves.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Collection, Dict, Tuple

import torch

from .clip import clip_by_global_norm


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def lr_schedule(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    """The learning rate at `step` (a tensor), float32: linear warmup, then
    a cosine down to min_lr_ratio of the peak at total_steps."""
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps,
                                        1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.peak_lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Zeroed float32 moments beside each parameter, and the step count."""
    dev = next(iter(params.values())).device

    def zeros32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"m": {k: zeros32(p) for k, p in params.items()},
            "v": {k: zeros32(p) for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def adamw_update(params: Dict[str, torch.Tensor],
                 grads: Dict[str, torch.Tensor], state: Dict[str, Any],
                 cfg: AdamWConfig, decay: Dict[str, bool], mesh=None,
                 sharded: Collection[str] = ()
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any],
                            Dict[str, torch.Tensor]]:
    """One clipped AdamW step, in place: `params`, `state["m"]`,
    `state["v"]` and `state["step"]` are written. Returns (params, state,
    {"lr", "grad_norm"}), the JAX package's triple. `decay` says which
    tensors take the weight decay. On a group mesh `sharded` names the
    tensors split over `mesh` (the "model" axis), whose squares the
    global norm sums over its ranks (`clip.global_norm`)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm, mesh, sharded)
    state["step"].add_(1)
    step = state["step"]
    lr = lr_schedule(step, cfg)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(b1, step.to(torch.float32))
    bc2 = 1 - torch.pow(b2, step.to(torch.float32))
    for k, p in params.items():
        g = grads[k].to(torch.float32)
        m, v = state["m"][k], state["v"][k]
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g.square())
        delta = (m / bc1) / ((v / bc2).sqrt() + cfg.eps)
        if decay[k]:  # decoupled
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))
    return params, state, {"lr": lr, "grad_norm": gnorm}
