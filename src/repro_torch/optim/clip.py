"""Global-norm gradient clipping (float32 accumulation), the port of the JAX
package's `optim/clip.py` on a dict of named tensors."""
from __future__ import annotations

from typing import Dict, Tuple

import torch


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every value's square, summed in float32 tensor by
    tensor in the dict's order."""
    total = 0
    for x in tree.values():
        total = total + x.float().square().sum()
    return torch.as_tensor(total, dtype=torch.float32).sqrt()


def clip_by_global_norm(tree: Dict[str, torch.Tensor], max_norm: float
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """(the tree scaled by min(1, max_norm / max(norm, 1e-12)) in float32
    and cast back to each tensor's dtype, the norm). New tensors; the
    inputs are not written."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return {k: (x.float() * scale).to(x.dtype) for k, x in tree.items()}, \
        norm
