"""YCSB workload generation (§4 "Workloads").

Workloads A (50/50 read/update), B (95/5), C (read-only), LOAD (write-only),
with key popularity following a Zipf distribution — exponents γ ∈
{1.5, 2.0, 2.5} in the paper's Fig. 5. Key *identity* is random-permuted so
popular keys land on random home machines (matching §2.2 random placement;
without this, rank-0-hot keys would all collide on one hash bucket pattern).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class YCSBWorkload:
    name: str
    read_fraction: float


YCSB_WORKLOADS = {
    "A": YCSBWorkload("A", 0.5),
    "B": YCSBWorkload("B", 0.95),
    "C": YCSBWorkload("C", 1.0),
    "LOAD": YCSBWorkload("LOAD", 0.0),
}


def zipf_keys(
    n: int, num_keys: int, gamma: float, rng: np.random.Generator
) -> np.ndarray:
    """Sample n keys from Zipf(γ) over num_keys ranks, permuted identities."""
    ranks = np.arange(1, num_keys + 1, dtype=np.float64)
    p = ranks ** (-gamma)
    p /= p.sum()
    raw = rng.choice(num_keys, size=n, p=p)
    perm = rng.permutation(num_keys)
    return perm[raw].astype(np.int64)


def zipf_keys_stationary(
    n: int, num_keys: int, gamma: float, rng: np.random.Generator,
    perm: np.ndarray,
) -> np.ndarray:
    """Sample n keys from Zipf(γ) under a FIXED rank→identity permutation.

    `zipf_keys` redraws the permutation per call, so two batches share no
    hot keys — an adversarial nonstationary stream. Multi-stage hot-spot
    workloads (the regime adaptive replication targets) keep the same
    popular identities batch after batch; pass one `perm`
    (`rng.permutation(num_keys)`) and sample every stage through it.
    """
    ranks = np.arange(1, num_keys + 1, dtype=np.float64)
    p = ranks ** (-gamma)
    p /= p.sum()
    raw = rng.choice(num_keys, size=n, p=p)
    return np.asarray(perm, dtype=np.int64)[raw]


def make_ycsb_batch(
    workload: str | YCSBWorkload,
    tasks_per_machine: int,
    num_machines: int,
    num_keys: int,
    gamma: float = 1.5,
    seed: int = 0,
):
    """Build one YCSB batch: (keys, is_read, operand) arrays.

    Each task fetches its item, performs a multiply-and-add (§4), and —
    for update ops — writes the result back.
    """
    if isinstance(workload, str):
        workload = YCSB_WORKLOADS[workload.upper()]
    rng = np.random.default_rng(seed)
    n = tasks_per_machine * num_machines
    keys = zipf_keys(n, num_keys, gamma, rng)
    is_read = rng.random(n) < workload.read_fraction
    operand = rng.random((n, 2))  # (multiplier, addend) for multiply-and-add
    return keys, is_read, operand


def make_ycsb_stream(
    workload: str | YCSBWorkload,
    tasks_per_machine: int,
    num_machines: int,
    num_keys: int,
    gamma: float = 1.5,
    seed: int = 0,
    stages: int = 1,
):
    """A multi-stage YCSB stream with a *stationary* hot set: one Zipf
    rank→identity permutation shared by every stage (what a session-level
    replicator can learn), fresh operation draws per stage. Yields
    `(keys, is_read, operand)` per stage; deterministic in `seed`."""
    if isinstance(workload, str):
        workload = YCSB_WORKLOADS[workload.upper()]
    rng = np.random.default_rng(seed)
    perm = rng.permutation(num_keys)
    n = tasks_per_machine * num_machines
    for _ in range(stages):
        keys = zipf_keys_stationary(n, num_keys, gamma, rng, perm)
        is_read = rng.random(n) < workload.read_fraction
        operand = rng.random((n, 2))
        yield keys, is_read, operand
