"""Serving launcher, the port of the JAX package's `launch/serve.py`:
batched prefill + decode loop.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --batch 4 --prompt-len 32 --gen 32 [--device cpu]

It serves the reduced config of any token arch (the dense, parallel,
moe, zamba2 and xlstm patterns: `--arch granite-moe-1b-a400m`, `--arch
xlstm-350m`, ...) with random weights, as the JAX launcher does, on the
card unless `--device cpu`. The reduced configs' head dims (8, 16) are
below the attention kernels' (32, 64, 128), so on the card the attention
patterns raise the kernels' `ValueError`: there is no plain fallback
there. The chunked scans (zamba2, xlstm) take a prompt length that is a
multiple of the chunk, or shorter than it.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import all_arch_ids, get_reduced
from ..models import Model


@torch.no_grad()
def generate(model: Model, prompts: torch.Tensor, gen: int,
             temperature: float = 0.0,
             generator: torch.Generator | None = None) -> torch.Tensor:
    """Greedy / temperature batched generation: one prefill of the prompts
    (B, S), then `gen` decode steps, for every pattern (attention caches,
    Mamba and LSTM states alike). Returns (B, S + gen) tokens in the
    prompts' dtype. Sampling draws from `generator` (one seeded 0 on the
    model's device when None)."""
    B, S = prompts.shape
    logits, caches = model.prefill(tokens=prompts, max_len=S + gen)
    if temperature > 0 and generator is None:
        generator = torch.Generator(device=model.device).manual_seed(0)
    out = [prompts]
    for i in range(gen):
        if temperature > 0:
            probs = torch.softmax(logits[:, -1] / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=generator)
        else:
            tok = logits[:, -1].argmax(dim=-1, keepdim=True)
        tok = tok.to(prompts.dtype)
        out.append(tok)
        logits, caches = model.decode_step(caches, tokens=tok,
                                           cache_pos=S + i)
    return torch.cat(out, dim=1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    choices=all_arch_ids())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch)
    if cfg.modality_stub:
        raise SystemExit("modality-stub backbones serve via embeddings; "
                         "use a token arch for this demo")
    model = Model(cfg, device=args.device, seed=0)
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(
            np.int32)).to(model.device)
    t0 = time.perf_counter()
    seqs = generate(model, prompts, args.gen, temperature=args.temperature)
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    dt = time.perf_counter() - t0
    print(f"generated {args.batch}×{args.gen} tokens in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s on {model.device})")
    print("first sequence:", seqs[0].tolist()[:24], "...")


if __name__ == "__main__":
    main()
