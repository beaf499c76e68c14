#!/usr/bin/env python3
"""The bytes autograd keeps for the backward of `Model.loss_fn`, on the CPU.

    PYTHONPATH=src python saved_tensors.py [--arch granite-moe-1b-a400m]
        [--layers 1] [--batch 1] [--seq 4096] [--top 12] [--mesh 1 4]

Builds the config at full width with `--layers` layers in its own dtype
(the port's plain versions: no card needed), runs one `loss_fn` forward
under `torch.autograd.graph.saved_tensors_hooks` and sums the storages
the graph saves, each once, parameters apart. Prints the total, the
head's share (the logits) and the largest storages with the function
that saved them. Sizes the training batch a card can hold: a layer's
saved bytes times the depth, plus the parameters, gradients, moments and
compression residuals. `--mesh D M` builds the model on a (D, M) host
mesh (`launch.mesh.make_host_mesh` on the CPU): the MoE layers' mesh
branches, with their stacked shards' buffers.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))


def main(argv=None) -> dict:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMStream
    from repro_torch.models import Model

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-moe-1b-a400m")
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--mesh", type=int, nargs=2, default=None,
                    metavar=("DATA", "MODEL"))
    args = ap.parse_args(argv)

    from repro_torch.launch.mesh import make_host_mesh

    cfg = dataclasses.replace(get_config(args.arch), n_layers=args.layers)
    mesh = None if args.mesh is None else make_host_mesh(*args.mesh,
                                                         device="cpu")
    model = Model(cfg, device="cpu", seed=0, mesh=mesh)
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLMStream(
        vocab_size=cfg.vocab_size, batch_size=args.batch,
        seq_len=args.seq, seed=0).batch_at(0).items()}
    params = {p.untyped_storage().data_ptr() for p in model.parameters()}
    seen = {}

    def pack(t):
        st = t.untyped_storage()
        if st.data_ptr() not in seen and st.data_ptr() not in params:
            frame = traceback.extract_stack(limit=3)[0]
            seen[st.data_ptr()] = (st.nbytes(), tuple(t.shape), str(t.dtype),
                                   f"{frame.name}:{frame.lineno}")
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        model.loss_fn(batch)
    rows = sorted(seen.values(), key=lambda r: -r[0])
    total = sum(r[0] for r in rows)
    head = sum(r[0] for r in rows if r[1][-1:] == (cfg.vocab_size,))
    print(f"{args.arch}, {args.layers} layer(s) at full width"
          f"{'' if mesh is None else f' on a {args.mesh} mesh'}, "
          f"{cfg.compute_dtype}, batch {args.batch} x {args.seq}: "
          f"{total / 1e9:.3f} GB saved for the backward, {head / 1e9:.3f} GB "
          f"of it the logits; {(total - head) / args.layers / 1e9:.3f} GB a "
          "layer")
    for nbytes, shape, dtype, where in rows[:args.top]:
        print(f"  {nbytes / 1e6:10.1f} MB  {shape} {dtype}  ({where})")
    return {"total_bytes": total, "logits_bytes": head,
            "per_layer_bytes": (total - head) / args.layers}


if __name__ == "__main__":
    main()
