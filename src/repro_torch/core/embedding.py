"""Skew-aware vocab embedding — the KV-store case study (§4) in the LM
stack, on torch tensors.

Token-id frequency is Zipfian (the paper's hot-chunk regime verbatim).
Phase-1 contention detection keeps the H hottest rows in a replicated cache,
so the gather stream reads the full table only for the Zipf tail. Results
are exact either way: the cache changes where the bytes come from, not what
they are.

The electorate is the session-level hot-chunk subsystem
(`core/replication.py`): `cache_from_replicator` exports a replicating
session's `HotChunkReplicator` directory as the `EmbedCache` view that
`embed_skew_aware` consumes (`paramserve.EmbeddingStore.device_cache()`
does this for its sessions). The standalone `init_cache` / `refresh_cache`
bookkeeping is kept, deprecated, for callers of the old interface.

Tensors live on the CUDA card unless the caller passes CPU tensors (or
``device="cpu"`` to `cache_from_replicator`); the Phase-1 counts of
`embed_skew_aware` run the histogram kernel on the card, summed over a
`core.shardexec` mesh when one is passed.
"""
from __future__ import annotations

import warnings
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .replication import decayed_election
from .torchexec import detect_contention

_DEPRECATION = (
    "the standalone EmbedCache bookkeeping ({fn}) is deprecated: use "
    "repro_torch.paramserve.EmbeddingStore with a replicating session — its "
    "device_cache() exports the session's shared HotChunkReplicator "
    "directory as the same EmbedCache view")


class EmbedCache(NamedTuple):
    hot_ids: torch.Tensor  # (H,) int32 row ids
    hot_rows: torch.Tensor  # (H, d) replicated copies
    lookup: torch.Tensor  # (V,) int32: cache slot or -1
    counts: torch.Tensor  # (V,) int32 running demand histogram (Phase 1)


def init_cache(table: torch.Tensor, num_hot: int) -> EmbedCache:
    warnings.warn(_DEPRECATION.format(fn="init_cache"), DeprecationWarning,
                  stacklevel=2)
    V, d = table.shape
    dev = table.device
    return EmbedCache(
        hot_ids=torch.zeros((num_hot,), dtype=torch.int32, device=dev),
        hot_rows=torch.zeros((num_hot, d), dtype=table.dtype, device=dev),
        lookup=torch.full((V,), -1, dtype=torch.int32, device=dev),
        counts=torch.zeros((V,), dtype=torch.int32, device=dev),
    )


def refresh_cache(table: torch.Tensor, cache: EmbedCache,
                  decay: float = 0.5) -> EmbedCache:
    """Re-elect the hot set from the running histogram (Phase 2 pull: the
    elected rows are replicated). One `decayed_election` step of the shared
    subsystem; decay keeps the histogram adaptive."""
    warnings.warn(_DEPRECATION.format(fn="refresh_cache"),
                  DeprecationWarning, stacklevel=2)
    H = cache.hot_ids.shape[0]
    hot_ids, lookup, _valid, counts = decayed_election(
        cache.counts, H, decay=decay, min_count=1)
    return EmbedCache(hot_ids=hot_ids.to(torch.int32),
                      hot_rows=table[hot_ids], lookup=lookup, counts=counts)


def cache_from_replicator(table, replicator, *, device=None) -> EmbedCache:
    """Export a session's `HotChunkReplicator` directory as an `EmbedCache`:
    `hot_ids` are the replicated chunks, `lookup` their directory slots,
    `counts` the live histogram (rounded half to even in float32, as the
    JAX package rounds it). Only the hot rows of `table` (a host array or a
    tensor) are copied. The cache lives on `device`: the CUDA card when
    None, unless `table` is a tensor, whose device it then takes. Host
    arrays become float32 rows."""
    if device is None:
        device = table.device if isinstance(table, torch.Tensor) else "cuda"
    device = torch.device(device)
    replicas = replicator.replicas
    hot = np.asarray(replicas.hot_ids, dtype=np.int64)
    if isinstance(table, torch.Tensor):
        hot_rows = table[torch.from_numpy(hot).to(table.device)].to(device)
    else:
        hot_rows = torch.from_numpy(np.asarray(
            np.asarray(table)[hot], dtype=np.float32)).to(device)
    counts = torch.round(torch.as_tensor(
        np.asarray(replicator.counts), dtype=torch.float32))
    return EmbedCache(
        hot_ids=torch.from_numpy(hot.astype(np.int32)).to(device),
        hot_rows=hot_rows,
        lookup=torch.from_numpy(np.asarray(replicas.lookup,
                                           dtype=np.int32)).to(device),
        counts=counts.to(torch.int32).to(device))


def embed_skew_aware(table: torch.Tensor, ids: torch.Tensor,
                     cache: EmbedCache, mesh=None
                     ) -> Tuple[torch.Tensor, EmbedCache, torch.Tensor]:
    """Exact embedding lookup with hot-row caching.

    Returns (embeddings (*ids.shape, d), updated cache (histogram
    accumulated), hit_rate). Cache hits read the replicated `hot_rows`,
    misses gather from `table`. Results are exact either way — the cache
    only changes where the bytes come from.

    `mesh` (a `core.shardexec` mesh; the JAX package's `axis_name`): `ids`
    is (S, ...) — the local shards' ids in its rows — and the histogram is
    summed over the mesh (`detect_contention`), so the cache's counts are
    the global demand; the hit rate is per shard, (S,). `table` and the
    cache are replicated."""
    d = table.shape[1]
    if mesh is None:
        counts = detect_contention(ids, cache.counts.shape[0])
        per_shard = ids.reshape(1, -1)
    else:
        counts = detect_contention(ids, cache.counts.shape[0], mesh)[0]
        per_shard = ids.reshape(ids.shape[0], -1)
    idx = per_shard.long()
    slot = cache.lookup[idx].long()  # cache slot or -1
    hit = slot >= 0
    out = table[idx]
    if cache.hot_rows.shape[0]:
        out = torch.where(hit[..., None], cache.hot_rows[slot.clamp(min=0)],
                          out)
    hit_rate = hit.to(torch.float32).mean(-1)
    if mesh is None:
        hit_rate = hit_rate[0]
    out = out.reshape(*ids.shape, d)
    return out, cache._replace(counts=cache.counts + counts), hit_rate
