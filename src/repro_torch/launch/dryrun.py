"""Dry run, the port of the JAX package's `launch/dryrun.py`: build every
(architecture x input shape) step on the meta device — shapes, no
storage, no device needed — on the 16 x 16 single-pod and 2 x 16 x 16
multi-pod production meshes, check every partition spec, and reckon each
device's bytes under them.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun.json

A cell is "ok" when every spec of its parameters, optimizer state, inputs,
caches and residual stream names only the mesh's axes, uses no axis twice
and shards only dims its axes divide; "skipped" where `shape_applicable`
says so; "FAILED" otherwise (the run then exits non-zero). Its record
gives a device's bytes of each of those under the specs on the production
mesh's shape.

The JAX package's records also hold lowering and compile times, XLA's
temporary bytes and the compiled module's collectives. An eager PyTorch
step is not lowered or compiled ahead of its run, so there are none of
these to record; a step's collectives are counted as it runs
(`launch.collectives`, `launch.roofline`).
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from typing import Dict, List, Optional

from ..configs import all_arch_ids, get_config
from . import sharding as sh
from .mesh import make_production_mesh
from .specs import SHAPES, shape_applicable
from .steps import build_step


def _problems(what: str, shape, spec, mesh) -> List[str]:
    """What is wrong with `spec` (a `sharding.P`, its stacked dims in
    front of `shape`'s) on `mesh`."""
    full = tuple(spec.full)
    out, seen = [], set()
    if len(full) != len(shape):
        return [f"{what}: spec {spec} for a tensor of shape {tuple(shape)}"]
    for dim, entry in zip(shape, full):
        n = 1
        for a in sh._axes(entry):
            if a not in mesh.axis_names:
                out.append(f"{what}: axis {a!r} not in the mesh")
                continue
            if a in seen:
                out.append(f"{what}: axis {a!r} used twice in {spec}")
            seen.add(a)
            n *= mesh.shape[a]
        if dim % n:
            out.append(f"{what}: dim {dim} not divisible by {entry} ({n})")
    return out


def _shard_bytes(t, spec, mesh) -> float:
    n = 1
    for entry in spec.full:
        for a in sh._axes(entry):
            n *= mesh.shape.get(a, 1)
    return t.numel() * t.element_size() / n


def check_step(step, mesh) -> Dict:
    """Every spec of `step` checked on `mesh`: (problems, a device's bytes
    by group)."""
    cfg = step.model.cfg
    sizes = sh.stacked_sizes(cfg)
    problems: List[str] = []
    nbytes: Dict[str, float] = {}

    def add(group, what, t, spec, stacked_name=None):
        shape = tuple(t.shape)
        if stacked_name is not None:
            shape, _ = sh._stacked_shape(stacked_name, shape, sizes)
        problems.extend(_problems(f"{group} {what}", shape, spec, mesh))
        nbytes[group] = nbytes.get(group, 0.0) + _shard_bytes(t, spec, mesh)

    params, specs = step.arg_specs, step.specs
    for n, t in params["params"].items():
        add("params", n, t, specs["params"][n], n)
    if "opt" in params:
        for m in ("m", "v"):
            for n, t in params["opt"][m].items():
                add("opt", f"{m}.{n}", t, specs["opt"][m][n], n)
        add("opt", "step", params["opt"]["step"], specs["opt"]["step"])
    for n, t in params["inputs"].items():
        add("inputs", n, t, specs["inputs"][n])
    caches = params.get("caches", step.out_shapes.get("caches"))
    if specs.get("caches") is not None:
        for i, (t, spec) in enumerate(zip(sh.tree_leaves(caches),
                                          sh.tree_leaves(specs["caches"]))):
            add("caches", f"leaf {i}", t, spec)
    act = specs.get("activation")
    if act is not None:
        shape = step.shape
        problems.extend(_problems(
            "activation", (shape["batch"] // shape.get("accum", 1),
                           shape["seq"], cfg.d_model), act, mesh))
    return {"problems": problems, "bytes": nbytes}


def run_cell(arch: str, shape: str, multi_pod: bool,
             overrides: Optional[Dict] = None) -> Dict:
    cfg = get_config(arch)
    rec: Dict = {"arch": arch, "shape": shape,
                 "mesh": "2x16x16" if multi_pod else "16x16"}
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = why
        return rec
    t0 = time.time()
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        step = build_step(cfg, mesh, shape, device="meta",
                          **_for_kind(shape, overrides))
        t_build = time.time() - t0
        got = check_step(step, mesh)
        if got["problems"]:
            raise ValueError(f"{len(got['problems'])} bad specs: "
                             + "; ".join(got["problems"][:4]))
        b = got["bytes"]
        rec.update({
            "status": "ok",
            "build_s": round(t_build, 3),
            "memory": {
                **{f"{k}_bytes": v for k, v in b.items()},
                "per_device_bytes": sum(b.values()),
            },
        })
    except Exception as e:  # a failure here is a bug in the sharding
        rec["status"] = "FAILED"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["trace"] = traceback.format_exc()[-2000:]
    return rec


def _for_kind(shape: str, overrides: Optional[Dict]) -> Dict:
    """The overrides a step of this kind takes (decode: fsdp only)."""
    ov = dict(overrides or {})
    if SHAPES[shape]["kind"] == "decode":
        ov.pop("sequence_parallel", None)
    return ov


def _fmt_bytes(b):
    return f"{b / 2**30:.2f}GiB" if b > 2**29 else f"{b / 2**20:.1f}MiB"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None, help="--arch <id> (see configs)")
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true",
                    help="every (arch x shape) cell")
    ap.add_argument("--out", default=None, help="write JSON records")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--no-seq-parallel", action="store_true")
    args = ap.parse_args(argv)

    archs = all_arch_ids() if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    overrides = {}
    if args.no_fsdp:
        overrides["fsdp"] = False
    if args.no_seq_parallel:
        overrides["sequence_parallel"] = False

    records = []
    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                rec = run_cell(arch, shape, multi, overrides=overrides)
                records.append(rec)
                tag = f"{arch:24s} {shape:12s} {rec['mesh']:8s}"
                if rec["status"] == "ok":
                    m = rec["memory"]
                    print(f"{tag} OK   mem/dev="
                          f"{_fmt_bytes(m['per_device_bytes'])} (params "
                          f"{_fmt_bytes(m.get('params_bytes', 0))}, opt "
                          f"{_fmt_bytes(m.get('opt_bytes', 0))}, caches "
                          f"{_fmt_bytes(m.get('caches_bytes', 0))}) "
                          f"build={rec['build_s']}s", flush=True)
                elif rec["status"] == "skipped":
                    print(f"{tag} SKIP {rec['reason'][:70]}", flush=True)
                else:
                    print(f"{tag} FAIL {rec['error'][:120]}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
        print(f"wrote {len(records)} records to {args.out}")
    n_fail = sum(r["status"] == "FAILED" for r in records)
    if n_fail:
        raise SystemExit(f"{n_fail} cells FAILED")
    return records


if __name__ == "__main__":
    main()
