"""Meshes, the port of the JAX package's `launch/mesh.py`: one small
frozen class, `Mesh`, in two forms.

* Abstract (`make_production_mesh`): the 16 x 16 ("data", "model") pod or
  the 2 x 16 x 16 ("pod", "data", "model") pair of pods, with no device.
  It carries what the JAX `Mesh` shows its callers — `axis_names` and
  `shape`, a dict from name to size — and serves the sharding rules
  (`launch.sharding`), the dry run and the roofline's reckoning. A model
  given it can be built (on the meta device, say) but not run.
* Executing (`make_host_mesh`): ("data", "model") on one device. The
  "model" axis is a `core.shardexec.StackedMesh` of `model` shards, all on
  the one device (an all-to-all is a transpose, a psum a sum over the
  shard dimension). The "data" axis's groups run in turn, each on a
  stacked mesh of its own (`groups`), so each routes and drops by its own
  token count, as each data group of the JAX package's `shard_map` does.

`torch.distributed.DeviceMesh` is not used: it needs a process group and
a rank a device, and the card is one process. (A "model" axis of one rank
a device, `core.shardexec.GroupMesh`, is not wired in yet.)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..core.shardexec import StackedMesh
from ..models.model import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    device: Optional[torch.device] = None
    # one stacked mesh of the "model" axis a data group; () when abstract
    groups: Tuple[StackedMesh, ...] = ()

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"{self.axis_names} against sizes {self.sizes}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n

    @property
    def executes(self) -> bool:
        return bool(self.groups)

    def reset_counts(self) -> None:
        """Zero every group's collective counters."""
        for g in self.groups:
            g.reset_counts()


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: 16 x 16 = 256 chips ("data", "model"). Multi-pod: 2 x 16
    x 16 = 512 chips ("pod", "data", "model"), the pod axis pure data
    parallelism. Abstract: for specs and reckoning only."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_host_mesh(data: int = 1, model: int = 1, device=None) -> Mesh:
    """An executing ("data", "model") mesh on one device (the card unless
    `device` names another): `data` groups, each a stacked mesh of `model`
    shards."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh ({data}, {model})")
    dev = resolve_device(device)
    return Mesh(("data", "model"), (int(data), int(model)), dev,
                tuple(StackedMesh(model, dev) for _ in range(data)))
