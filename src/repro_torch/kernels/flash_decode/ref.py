"""Plain PyTorch version of single-token GQA decode attention over a KV
cache with a valid prefix, the counterpart of the JAX package's
`flash_decode/ref.py`: query head h reads KV head h // G, positions at or
beyond `length` get the finite score -2.0e38 (so with length <= 0 every
position ties and the result is the mean of V over the whole cache)."""
from __future__ import annotations

import torch

NEG_INF = -2.0e38


def decode_shapes(q, k_cache, v_cache):
    """(B, H, hd, T, KV, G) of a decode call; raises on shapes that do not
    fit together."""
    if q.ndim != 3 or k_cache.ndim != 4 or v_cache.ndim != 4:
        raise ValueError(f"q must be (B, H, hd) and the caches (B, T, KV, "
                         f"hd), got {tuple(q.shape)}, {tuple(k_cache.shape)}"
                         f", {tuple(v_cache.shape)}")
    B, H, hd = q.shape
    _, T, KV, _ = k_cache.shape
    if k_cache.shape != (B, T, KV, hd) or v_cache.shape != k_cache.shape:
        raise ValueError(f"caches {tuple(k_cache.shape)} / "
                         f"{tuple(v_cache.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if KV == 0 or H % KV:
        raise ValueError(f"{H} query heads do not split over {KV} KV heads")
    if T == 0:
        raise ValueError("the cache holds no position (T = 0)")
    return B, H, hd, T, KV, H // KV


def decode_attention_ref(q, k_cache, v_cache, length):
    """q: (B, H, hd); k/v_cache: (B, T, KV, hd); length: the number of valid
    positions (a Python int or a 0-d integer tensor). Returns (B, H, hd) in
    q's dtype; the softmax runs in float32 (float64 for float64 inputs)."""
    B, H, hd, T, KV, G = decode_shapes(q, k_cache, v_cache)
    ct = torch.float64 if q.dtype == torch.float64 else torch.float32
    qf = q.to(ct).reshape(B, KV, G, hd)
    kt = k_cache.to(ct).permute(0, 2, 3, 1)  # (B, KV, hd, T)
    vt = v_cache.to(ct).permute(0, 2, 1, 3)  # (B, KV, T, hd)
    s = torch.matmul(qf, kt) * hd ** -0.5  # (B, KV, G, T)
    valid = torch.arange(T, device=q.device) < torch.as_tensor(
        length, device=q.device)
    s = s.masked_fill(~valid, NEG_INF)
    out = torch.matmul(torch.softmax(s, dim=-1), vt)  # (B, KV, G, hd)
    return out.reshape(B, H, hd).to(q.dtype)
