"""Training launcher, the port of the JAX package's `launch/train.py`:

    PYTHONPATH=src python -m repro_torch.launch.train \
        [--arch granite-moe-1b-a400m] [--steps 200] [--device cpu] [...]

The same flags and defaults as the JAX launcher, plus `--device` (the CUDA
card unless the caller names another device, such as "cpu"). It trains
the REDUCED config of a token arch by default (granite-moe-1b-a400m's:
two layers, 8 experts, top 2), as the JAX launcher does on a CPU host;
`--full` trains the full config (granite-moe-1b-a400m: 24 layers, 32
experts, top 8) on the one card, where the JAX launcher would bind a pod's
mesh. `Trainer` (`runtime/trainer.py`) does the work: `Model.loss_fn`
under autograd through the kernels' backward (B5's; B4's for the MoE
pattern; B7's, the SSD scan's, for the zamba2 pattern: "mamba_scan_bwd",
or "mamba_scan_bwd_mma" for operands TMA cannot describe), AdamW,
optional int8 gradient compression, checkpoints and a
failure injector. The reduced configs' head dims (8, 16) are below the
attention kernel's, so on the card only `--full` configs train: the
launcher refuses the others there before it builds anything.

Checkpoints go to `--ckpt-dir`, or, without it, to a fresh directory
under the temporary directory: a run resumes from the newest checkpoint
in its directory, so only a named one carries a run on.
"""
from __future__ import annotations

import argparse
import json
import tempfile

import torch

from ..configs import all_arch_ids, get_config, get_reduced
from ..data import SyntheticLMStream
from ..kernels.flash_attention.ops import HEAD_DIMS
from ..optim import AdamWConfig
from ..runtime import FailureInjector, Trainer, TrainerConfig


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-moe-1b-a400m",
                    choices=all_arch_ids())
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None,
                    help="resume from and save to this directory (default: "
                         "a fresh one under the temporary directory)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--inject-failure-at", type=int, default=None)
    ap.add_argument("--full", action="store_true",
                    help="the full config, on the one device")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    cfg = get_config(args.arch) if args.full else get_reduced(args.arch)
    if cfg.modality_stub:
        raise SystemExit(f"{args.arch} is a modality-stub backbone; train a "
                         "token arch")
    if (torch.device(args.device or "cuda").type != "cpu"
            and cfg.pattern != "xlstm" and cfg.head_dim not in HEAD_DIMS):
        raise SystemExit(f"{args.arch}'s {'full' if args.full else 'reduced'}"
                         f" config has head_dim {cfg.head_dim}; the "
                         f"attention kernel takes {HEAD_DIMS}: train --full "
                         "on the card, or pass --device cpu")
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_train_")
    stream = SyntheticLMStream(vocab_size=cfg.vocab_size,
                               batch_size=args.batch, seq_len=args.seq,
                               seed=0, noise=0.05)
    injector = None
    if args.inject_failure_at is not None:
        injector = FailureInjector(schedule={args.inject_failure_at: [0]})
    trainer = Trainer(
        cfg,
        AdamWConfig(peak_lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                    total_steps=args.steps),
        TrainerConfig(total_steps=args.steps,
                      checkpoint_every=args.ckpt_every,
                      checkpoint_dir=ckpt_dir,
                      grad_accum=args.grad_accum,
                      compress_grads=args.compress_grads),
        stream,
        failure_injector=injector,
        device=args.device,
    )
    out = trainer.run()
    for h in out["history"]:
        print(f"step {h['step']:5d}  loss {h['loss']:.4f}  "
              f"gnorm {h['grad_norm']:.2f}  lr {h['lr']:.2e}  "
              f"{h['sec_per_step']*1e3:.0f} ms/step")
    print(f"recoveries: {out['recoveries']}; checkpoints in {ckpt_dir}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out["history"], f, indent=1)
    return out


if __name__ == "__main__":
    main()
