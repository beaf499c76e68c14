"""Meshes, the port of the JAX package's `launch/mesh.py`: one small
frozen class, `Mesh`, in two forms.

* Abstract (`make_production_mesh`): the 16 x 16 ("data", "model") pod or
  the 2 x 16 x 16 ("pod", "data", "model") pair of pods, with no device.
  It carries what the JAX `Mesh` shows its callers — `axis_names` and
  `shape`, a dict from name to size — and serves the sharding rules
  (`launch.sharding`), the dry run and the roofline's reckoning. A model
  given it can be built (on the meta device, say) but not run.
* Executing on one device (`make_host_mesh`): ("data", "model"). The
  "model" axis is a `core.shardexec.StackedMesh` of `model` shards, all on
  the one device (an all-to-all is a transpose, a psum a sum over the
  shard dimension). The "data" axis's groups run in turn, each on a
  stacked mesh of its own (`groups`), so each routes and drops by its own
  token count, as each data group of the JAX package's `shard_map` does.
* Executing over processes (`make_group_mesh`): ("data", "model") over an
  initialized `torch.distributed` world of data·model ranks, one process
  a shard; rank r is (r // model, r % model). `groups` holds this rank's
  "model" axis, a `core.shardexec.GroupMesh` over its model row (S = 1),
  and `data_axis` a `GroupMesh` over its data column, over which the
  trainer averages the gradients (the reduction GSPMD inserts for the
  JAX package). The batch rows a rank is given are its data group's.
  Ranks that share one card talk through gloo (NCCL refuses two ranks on
  one device); ranks on cards of their own may use NCCL.

`torch.distributed.DeviceMesh` is not used: the stacked form has no
process group, and the group form needs only two sub-groups a rank.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..core.shardexec import GroupMesh, StackedMesh
from ..models.model import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    device: Optional[torch.device] = None
    # the "model" axis: one stacked mesh a data group on one device, or
    # this rank's group mesh over processes; () when abstract
    groups: Tuple[object, ...] = ()
    # over processes: this rank's data column (a GroupMesh), else None
    data_axis: Optional[GroupMesh] = None

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

    @property
    def over_processes(self) -> bool:
        """Whether the "model" axis is one process a shard."""
        return bool(self.groups) and self.groups[0].kind == "group"

    def reset_counts(self) -> None:
        """Zero every group's collective counters (the data axis's too)."""
        for g in self.groups + ((self.data_axis,) if self.data_axis
                                else ()):
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


def make_group_mesh(data: int = 1, model: int = 1, device=None) -> Mesh:
    """An executing ("data", "model") mesh over the initialized
    `torch.distributed` world, which must hold data·model ranks: rank r
    is (r // model, r % model), on `device` (the card unless it names
    another). Every rank calls it (each sub-group is made by all ranks
    in the same order)."""
    import torch.distributed as dist

    if data < 1 or model < 1:
        raise ValueError(f"mesh ({data}, {model})")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_group_mesh runs inside an initialized "
                           "torch.distributed world of data·model ranks")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != data * model:
        raise RuntimeError(f"a ({data}, {model}) mesh needs {data * model} "
                           f"ranks; the world has {world}")
    rows = [dist.new_group(list(range(i * model, (i + 1) * model)))
            for i in range(data)]
    cols = [dist.new_group(list(range(j, world, model)))
            for j in range(model)]
    dev = resolve_device(device)
    i, j = divmod(rank, model)
    return Mesh(("data", "model"), (int(data), int(model)), dev,
                (GroupMesh(model, dev, rows[i]),),
                GroupMesh(data, dev, cols[j]))
