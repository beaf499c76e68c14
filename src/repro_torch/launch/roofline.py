"""Roofline analysis, the port of the JAX package's `launch/roofline.py`.

    PYTHONPATH=src python -m repro_torch.launch.roofline --arch tinyllama-1.1b \
        --shape decode_32k [--device cuda] [--rows 1] [--out roofline.json]

Hardware model (NVIDIA H100 SXM5, the datasheet's figures): 989 TFLOP/s
dense bf16 on the tensor cores, 3.35 TB/s of HBM3, NVLink 4 at 450 GB/s a
direction. Terms, all a device's:

    compute    = FLOPs / peak FLOPs
    memory     = bytes / HBM bandwidth
    collective = collective wire bytes / NVLink bandwidth

A cell is measured by running one step (`launch.steps.build_step`) at two
reduced depths (`_PROBE_DEPTHS`) and extrapolating linearly — exact for
homogeneous layer stacks:
    per_layer = (cost(L2) − cost(L1)) / (L2 − L1);  total = intercept + L·per_layer
(same arch, width and mesh; only the depth changes). The step runs as the
program runs it — on the card, through the hand-written kernels — and
its work is the sum of two parts:

* the aten ops, as eager PyTorch runs them (unfused): FLOPs from
  `torch.utils.flop_counter.FlopCounterMode`; bytes from a
  `TorchDispatchMode` that adds every op's tensor inputs and outputs
  (views and bare allocations move nothing and are skipped);
* the kernels, which launch through `ctypes` where neither mode sees
  them: each launch names its own work (`kernels._lib.record_work`), the
  operations it does on its inputs and the bytes it must move, every
  tensor it is handed read or written once (its scratch too);

and collectives from the mesh's own counts (`launch.collectives`). With
`--device cpu` the wrappers take their plain versions, by their own rule
for CPU tensors, and the count is theirs (attention in row blocks of
scores, an unfused graph's bytes): slower, and an upper bound.

The step runs the per-device share of the global batch: the batch over
the mesh's batch shards (`sharding.batch_pspec`), on a host mesh of the
production mesh's "model" axis (`make_host_mesh(1, model)`: the MoE
layers' expert parallelism and its collectives as one data group runs
them). Its FLOPs and bytes are divided by the model axis: that assumes
the tensor parallelism that GSPMD gives the JAX package (every op split
evenly over "model"). The port's model issues no tensor- or
FSDP-parallel collectives (one process holds the whole model), so only
the MoE dispatch's all-to-alls, psums and all-gathers are counted, where
GSPMD would add its all-reduces and all-gathers. For the same reason the
JAX CLI's sharding presets (`--no-tp`, `--no-fsdp`, `--no-seq-parallel`)
are not offered: they pick GSPMD's placement of parameters and
activations, which changes which collectives XLA inserts, and this
eager count has no collectives of that kind to change (`launch.dryrun`
takes them: there they change a device's bytes). `--rows n` runs n of
the device's rows and scales by the device's share over n (the costs are
linear in the rows: each row's work is its own, and the MoE buffers are
sized by the token count), for cells whose share does not fit one card.

MODEL_FLOPS = 6·N·D (train) / 2·N·D (inference), N = active params — the
"useful" fraction MODEL_FLOPS / FLOPs flags redundancy.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import traceback
from typing import Dict, Optional

import torch
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from ..configs import all_arch_ids, get_config
from ..kernels import _lib
from ..optim import init_opt_state
from .collectives import collective_stats
from .mesh import make_host_mesh, make_production_mesh
from .sharding import _axes, batch_pspec
from .specs import SHAPES, shape_applicable, shape_info
from .steps import build_step

PEAK_FLOPS = 989e12  # H100 SXM5 datasheet: dense bf16, tensor cores
HBM_BW = 3.35e12  # bytes/s: H100 SXM5 datasheet, HBM3
NVLINK_BW = 450e9  # bytes/s a direction: H100 SXM5 datasheet, NVLink 4

# probe depths per pattern (must keep hybrid cadence intact)
_PROBE_DEPTHS = {
    "dense": (2, 4), "parallel": (2, 4), "moe": (2, 4),
    "zamba2": (6, 12), "xlstm": (8, 16),
}


def _with_depth(cfg, n):
    return dataclasses.replace(cfg, n_layers=n)


_ALLOCATIONS = {torch.ops.aten.empty, torch.ops.aten.empty_like,
                torch.ops.aten.empty_strided, torch.ops.aten.new_empty,
                torch.ops.aten.new_empty_strided}


class _Bytes(TorchDispatchMode):
    """The bytes of every aten op's tensor inputs and outputs (not views,
    not bare allocations)."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func.overloadpacket not in _ALLOCATIONS:
            self.total += sum(t.numel() * t.element_size() for t in
                              tree_leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
        return out


def _device_rows(mesh, batch: int) -> int:
    """A device's share of the global batch: the batch over its shards."""
    spec = batch_pspec(mesh, batch)
    n = 1
    for a in _axes(spec[0] if len(spec) else None):
        n *= mesh.shape[a]
    return batch // n


def _inputs(step, cfg, device, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Random inputs of the step's `arg_specs["inputs"]` on `device`."""
    g = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for k, t in step.arg_specs["inputs"].items():
        if k == "positions":
            b, s = t.shape[1:]
            out[k] = torch.arange(s, dtype=torch.int32, device=device)[
                None, None].expand(3, b, s).contiguous()
        elif k == "embeds":
            out[k] = torch.randn(t.shape, generator=g, device=device).to(
                t.dtype)
        else:
            out[k] = torch.randint(0, cfg.vocab_size, t.shape, generator=g,
                                   device=device, dtype=t.dtype)
    return out


def _costs_of(cfg, shape, mesh, overrides=None, device="cpu",
              rows: Optional[int] = None) -> Dict[str, float]:
    """One step's FLOPs, bytes and collective wire bytes on a device of
    `mesh` (module docstring)."""
    info = shape_info(shape)
    share = _device_rows(mesh, info["batch"])
    n = min(rows or share, share)
    ep = mesh.shape.get("model", 1)
    host = make_host_mesh(1, ep, device)
    step = build_step(cfg, host, dict(info, batch=n), device=device,
                      **(overrides or {}))
    batch = _inputs(step, cfg, device)
    if step.kind == "train":
        params = dict(step.model.named_parameters())
        args = (params, init_opt_state(params), batch)
    elif step.kind == "prefill":
        args = (batch,)
    else:
        args = (step.model.init_caches(n, info["seq"]), batch,
                info["seq"] - 1)
    host.reset_counts()
    with FlopCounterMode(display=False) as fc, _Bytes() as nb, \
            _lib.record_work() as launched:
        step.fn(*args)
    k_ops, k_bytes = _lib.work_of(launched)
    scale = share / n
    return {"flops": (fc.get_total_flops() + k_ops) * scale / ep,
            "bytes": (nb.total + k_bytes) * scale / ep,
            "coll": collective_stats(host).wire_bytes * scale}


def model_flops_per_chip(cfg, shape, n_chips: int) -> float:
    info = shape_info(shape)
    tokens = info["batch"] * (info["seq"] if info["kind"] == "train" else
                              (info["seq"] if info["kind"] == "prefill" else 1))
    n = cfg.active_param_count()
    mult = 6.0 if info["kind"] == "train" else 2.0
    return mult * n * tokens / n_chips


def extrapolate(c1: Dict[str, float], c2: Dict[str, float], l1: int, l2: int,
                depth: int) -> Dict[str, float]:
    """The probes' costs at `depth` layers, linear in the depth."""
    total = {}
    for k in c1:
        per_layer = (c2[k] - c1[k]) / (l2 - l1)
        intercept = c1[k] - per_layer * l1
        total[k] = max(intercept + per_layer * depth, 0.0)
    return total


def analyze_cell(arch: str, shape, overrides: Optional[Dict] = None,
                 multi_pod: bool = False, cfg_transform=None, device=None,
                 rows: Optional[int] = None) -> Dict:
    cfg = get_config(arch)
    if cfg_transform is not None:
        cfg = cfg_transform(cfg)
    rec: Dict = {"arch": arch, "shape": shape,
                 "mesh": "2x16x16" if multi_pod else "16x16"}
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = why
        return rec
    try:
        device = torch.device("cuda" if device is None else device)
        mesh = make_production_mesh(multi_pod=multi_pod)
        n_chips = mesh.size
        l1, l2 = _PROBE_DEPTHS[cfg.pattern]
        c1 = _costs_of(_with_depth(cfg, l1), shape, mesh, overrides, device,
                       rows)
        c2 = _costs_of(_with_depth(cfg, l2), shape, mesh, overrides, device,
                       rows)
        total = extrapolate(c1, c2, l1, l2, cfg.n_layers)
        terms = {
            "compute_s": total["flops"] / PEAK_FLOPS,
            "memory_s": total["bytes"] / HBM_BW,
            "collective_s": total["coll"] / NVLINK_BW,
        }
        dominant = max(terms, key=terms.get)
        mf = model_flops_per_chip(cfg, shape, n_chips)
        rec.update({
            "status": "ok",
            "device": str(device),
            "rows": rows,
            "flops": total["flops"],
            "bytes": total["bytes"],
            "coll_bytes": total["coll"],
            **terms,
            "dominant": dominant.replace("_s", ""),
            "model_flops": mf,
            "useful_ratio": mf / max(total["flops"], 1.0),
            # achievable step time ≈ max of the three terms (perfect overlap)
            "roofline_s": max(terms.values()),
            "mfu_bound": mf / PEAK_FLOPS / max(max(terms.values()), 1e-12),
        })
    except Exception as e:
        rec["status"] = "FAILED"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["trace"] = traceback.format_exc()[-1500:]
    return rec


def _transform(a):
    """The CLI's config overrides as a `cfg_transform`."""
    def tf(cfg):
        if cfg.ssm is not None and (a.chunk or a.intra_bf16):
            cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
                cfg.ssm,
                chunk=a.chunk or cfg.ssm.chunk,
                intra_dtype=("bfloat16" if a.intra_bf16
                             else cfg.ssm.intra_dtype)))
        if cfg.xlstm is not None and a.chunk:
            cfg = dataclasses.replace(cfg, xlstm=dataclasses.replace(
                cfg.xlstm, chunk=a.chunk))
        if cfg.moe is not None and (a.moe_gemm or a.moe_hot is not None
                                    or a.moe_capacity or a.moe_dispatch):
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe,
                gemm_impl=a.moe_gemm or cfg.moe.gemm_impl,
                num_hot=(a.moe_hot if a.moe_hot is not None
                         else cfg.moe.num_hot),
                capacity_factor=a.moe_capacity or cfg.moe.capacity_factor,
                dispatch=a.moe_dispatch or cfg.moe.dispatch))
        return cfg
    return tf


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--out", default=None)
    ap.add_argument("--grad-accum", type=int, default=None)
    ap.add_argument("--chunk", type=int, default=None,
                    help="override SSD/mLSTM chunk length")
    ap.add_argument("--intra-bf16", action="store_true",
                    help="bf16 intra-chunk SSD tensors")
    ap.add_argument("--moe-gemm", default=None, choices=["ragged", "binned"])
    ap.add_argument("--moe-hot", type=int, default=None)
    ap.add_argument("--moe-capacity", type=float, default=None)
    ap.add_argument("--moe-dispatch", default=None,
                    choices=["tdorch", "push", "pull"])
    ap.add_argument("--device", default=None,
                    help="torch device the probes run on (default: the "
                         "CUDA card)")
    ap.add_argument("--rows", type=int, default=None,
                    help="run this many of a device's batch rows and scale")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    archs = [args.arch] if args.arch else all_arch_ids()
    shapes = [args.shape] if args.shape else list(SHAPES)
    records = []
    for arch in archs:
        for shape in shapes:
            ov = None
            if SHAPES[shape]["kind"] == "train" and \
                    args.grad_accum is not None:
                ov = {"grad_accum": args.grad_accum}
            rec = analyze_cell(arch, shape, ov,
                               cfg_transform=_transform(args),
                               device=args.device, rows=args.rows)
            records.append(rec)
            if rec["status"] == "ok":
                print(f"{arch:24s} {shape:12s} "
                      f"compute={rec['compute_s']*1e3:8.2f}ms "
                      f"memory={rec['memory_s']*1e3:8.2f}ms "
                      f"coll={rec['collective_s']*1e3:8.2f}ms "
                      f"dom={rec['dominant']:10s} "
                      f"useful={rec['useful_ratio']:.2f} "
                      f"mfu_bound={rec['mfu_bound']:.2f}", flush=True)
            else:
                print(f"{arch:24s} {shape:12s} {rec['status']} "
                      f"{rec.get('reason', rec.get('error', ''))[:80]}",
                      flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    return records


if __name__ == "__main__":
    main()
