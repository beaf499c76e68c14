"""Global-norm gradient clipping (float32 accumulation), the port of the JAX
package's `optim/clip.py` on a dict of named tensors.

On a group mesh (`launch.mesh.make_group_mesh`) a rank holds only its
shards of the leaves split over the "model" axis: their squares are summed
over the axis's ranks (one all-reduce, counted as "global norm"), the
replicated leaves' counted once, so every rank clips by the whole model's
norm, as the JAX package's one global pytree is clipped."""
from __future__ import annotations

from typing import Collection, Dict, Tuple

import torch


def global_norm(tree: Dict[str, torch.Tensor], mesh=None,
                sharded: Collection[str] = ()) -> torch.Tensor:
    """sqrt of the sum of every value's square, summed in float32 tensor by
    tensor in the dict's order. `sharded` names the entries split over
    `mesh` (a `core.shardexec.GroupMesh`, the "model" axis): their sum is
    taken over the mesh's ranks and added to the replicated entries'."""
    total = 0
    split = torch.zeros((), dtype=torch.float32)
    for k, x in tree.items():
        sq = x.float().square().sum()
        if k in sharded:
            split = split.to(sq.device) + sq
        else:
            total = total + sq
    if sharded:
        total = total + (split if mesh is None else mesh.psum(
            split.reshape(1), boundary="global norm")[0])
    return torch.as_tensor(total, dtype=torch.float32).sqrt()


def clip_by_global_norm(tree: Dict[str, torch.Tensor], max_norm: float,
                        mesh=None, sharded: Collection[str] = ()
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """(the tree scaled by min(1, max_norm / max(norm, 1e-12)) in float32
    and cast back to each tensor's dtype, the norm). New tensors; the
    inputs are not written. `mesh`, `sharded` as for `global_norm`."""
    norm = global_norm(tree, mesh, sharded)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return {k: (x.float() * scale).to(x.dtype) for k, x in tree.items()}, \
        norm
