"""Deterministic synthetic LM data pipeline, the port's copy of the JAX
package's `data/synthetic.py` (numpy only, so the batches are the same
bits in both packages; the trainer moves each to its device).

Requirements at 1000+-node scale: (i) every host derives its shard locally
from (step, host_id) with zero coordination, (ii) restart at step k
regenerates the exact stream (checkpoint/restart determinism), (iii) elastic
rescale keeps determinism because sharding is by global example index, not by
host enumeration order.

Stream content: a noisy affine-bigram language (t_{i+1} ≈ a·t_i + b mod V
with ε-noise) — enough learnable structure that the loss drops well below
uniform entropy within a few hundred steps.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass
class SyntheticLMStream:
    vocab_size: int
    batch_size: int  # GLOBAL batch
    seq_len: int
    seed: int = 0
    noise: float = 0.1
    host_id: int = 0
    num_hosts: int = 1

    def __post_init__(self):
        if self.batch_size % self.num_hosts:
            raise ValueError("global batch must divide num_hosts")
        self.per_host = self.batch_size // self.num_hosts
        rng = np.random.default_rng(self.seed)
        # fixed random affine map defines the language
        self.a = int(rng.integers(2, self.vocab_size - 1)) | 1
        self.b = int(rng.integers(0, self.vocab_size))

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Fully deterministic in (step, host_id): global example index =
        step·B + slot, hosts own contiguous slot ranges."""
        lo = self.host_id * self.per_host
        seqs = np.empty((self.per_host, self.seq_len + 1), dtype=np.int64)
        for i in range(self.per_host):
            ex = step * self.batch_size + lo + i
            rng = np.random.default_rng((self.seed, ex))
            t = int(rng.integers(0, self.vocab_size))
            row = [t]
            noise_mask = rng.random(self.seq_len) < self.noise
            noise_tok = rng.integers(0, self.vocab_size, self.seq_len)
            for j in range(self.seq_len):
                t = (self.a * t + self.b) % self.vocab_size
                if noise_mask[j]:
                    t = int(noise_tok[j])
                row.append(t)
            seqs[i] = row
        return {"tokens": seqs[:, :-1].astype(np.int32),
                "targets": seqs[:, 1:].astype(np.int32)}


def make_batch_iterator(stream: SyntheticLMStream, start_step: int = 0
                        ) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield stream.batch_at(step)
        step += 1
