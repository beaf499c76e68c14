"""Collective accounting for the roofline, the counterpart of the JAX
package's `launch/hlo.py`. The JAX package parses the compiled HLO module
for every collective's result bytes and replica-group size; the port has
no HLO, so its meshes count what they run (`core.shardexec`: calls and
one shard's result bytes by kind), and `collective_stats` charges each
device's wire bytes with the same ring-algorithm factors:

    all-reduce          2·size·(g−1)/g
    all-gather          size·(g−1)/g            (size = gathered output)
    all-to-all          size·(g−1)/g

g is the mesh's "model" axis (every collective of the port's model runs
over it), or on a group mesh the data axis for the gradients' mean over
it. The port issues no reduce-scatter and no collective-permute.

On a group mesh (`launch.mesh.make_group_mesh`) the counts are this
rank's, and a device's. They include the boundary collectives the
stacked mesh does not run, listed by name (`boundary`): `pvary`'s
backward sums (the MoE input's, the router's and the pulled hot experts'
gradients; on the stacked mesh the last is the pull psum's backward,
counted as such), the global norm's sum over the model axis, and the data
axis's mean of the loss, metrics and gradients.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from ..core.shardexec import COLLECTIVE_KINDS


@dataclasses.dataclass
class CollectiveStats:
    wire_bytes: float  # a device's, ring-factor adjusted
    result_bytes: float
    count: int
    by_kind: Dict[str, float]
    lines: List[str]
    # {name: (calls, result bytes)} a device, of the boundary collectives
    boundary: Dict[str, tuple] = dataclasses.field(default_factory=dict)


def wire_bytes(kind: str, size: float, g: int) -> float:
    """A device's wire bytes for a collective of `size` result bytes over
    a group of g devices."""
    if kind == "all-reduce":
        return 2.0 * size * (g - 1) / g
    if kind in ("all-gather", "all-to-all"):
        return size * (g - 1) / g
    raise ValueError(f"unknown collective {kind!r}")


def collective_stats(mesh) -> CollectiveStats:
    """A device's collectives so far on `mesh`: a `core.shardexec` mesh, or
    a `launch.mesh.Mesh`, whose data groups each run the same collectives
    on their own devices (their mean is a device's); on a group mesh this
    rank's, its data axis's included."""
    groups = getattr(mesh, "groups", None)
    groups = list(groups) if groups is not None else [mesh]
    axes = [(groups, groups[0].P)]
    data = getattr(mesh, "data_axis", None)
    if data is not None:
        axes.append(([data], data.P))
    wire = raw = 0.0
    count = 0
    by_kind: Dict[str, float] = {}
    boundary: Dict[str, tuple] = {}
    lines: List[str] = []
    for meshes, g in axes:
        n = max(len(meshes), 1)
        for kind in COLLECTIVE_KINDS:
            calls = sum(m.calls[kind] for m in meshes) / n
            size = sum(m.result_bytes[kind] for m in meshes) / n
            if not calls:
                continue
            w = wire_bytes(kind, size, g)
            wire += w
            raw += size
            count += int(round(calls))
            by_kind[kind] = by_kind.get(kind, 0.0) + w
            lines.append(f"{kind}: {calls:g} calls, {size:.0f} result bytes "
                         f"a device, group {g}")
        for name in sorted({k for m in meshes for k in m.boundary}):
            c = sum(m.boundary.get(name, (0, 0))[0] for m in meshes) / n
            b = sum(m.boundary.get(name, (0, 0))[1] for m in meshes) / n
            boundary[name] = (c, b)
            lines.append(f"  of which {name}: {c:g} calls, {b:.0f} result "
                         f"bytes a device, group {g}")
    return CollectiveStats(wire_bytes=wire, result_bytes=raw, count=count,
                           by_kind=by_kind, lines=lines, boundary=boundary)
