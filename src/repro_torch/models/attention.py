"""GQA attention, full causal (prefill) and KV-cache decode: the port of the
JAX package's `models/attention.py`.

The JAX package computes attention in XLA ops (`_sdpa` below 4,096
positions, a chunked online-softmax scan from there), both the causal GQA
function its Pallas kernel `flash_attention` computes. The port calls that
kernel's Hopper port for every length (`repro_torch.kernels.attention`,
B5), and for decode the port of `flash_decode` (`decode_attention`, B6)
over the cache prefix. On the CPU both run their plain versions. Under
autograd `kernels.attention` is a `torch.autograd.Function` whose backward
launches B5's backward kernels (the counterpart of the JAX package's custom
VJP `_flash_xla`, which its `attention_full` takes from 4,096 positions),
so the gradient flows through `attention_full` at every length;
`attention_decode` is never trained.
"""
from __future__ import annotations

import torch

from .. import kernels
from .config import ModelConfig
from .layers import apply_mrope, apply_rope, truncated_normal


class Attention(torch.nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device, generator):
        super().__init__()
        if cfg.attn_logit_softcap:
            raise NotImplementedError(
                "attention logit soft-capping: no configured model uses it "
                "and the attention kernels do not take it")
        d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
        std = d ** -0.5

        def w(shape, s):
            return torch.nn.Parameter(
                truncated_normal(shape, s, dtype, device, generator))

        self.wq, self.wk, self.wv = w((d, qd), std), w((d, kvd), std), \
            w((d, kvd), std)
        self.wo = w((qd, d), qd ** -0.5)
        if cfg.attn_qkv_bias:
            for name, n in (("bq", qd), ("bk", kvd), ("bv", kvd)):
                setattr(self, name, torch.nn.Parameter(
                    torch.zeros((n,), dtype=dtype, device=device)))


def init_attention(cfg: ModelConfig, dtype, device, generator) -> Attention:
    return Attention(cfg, dtype, device, generator)


def _project_qkv(params: Attention, cfg: ModelConfig, x, positions):
    B, S, _ = x.shape
    q = x @ params.wq
    k = x @ params.wk
    v = x @ params.wv
    if cfg.attn_qkv_bias:
        q, k, v = q + params.bq, k + params.bk, v + params.bv
    q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    if cfg.rope_kind == "standard":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    elif cfg.rope_kind == "mrope":
        # positions: (3, B, S) multimodal ids (t, h, w)
        q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    return q, k, v


def attention_full(params: Attention, cfg: ModelConfig, x, positions):
    """Causal self-attention over the whole sequence (train / prefill).
    Returns (out, (k, v)) so prefill can seed the decode cache."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(params, cfg, x, positions)
    out = kernels.attention(q, k, v, causal=True)
    out = out.reshape(B, S, cfg.q_dim) @ params.wo
    return out, (k, v)


def attention_decode(params: Attention, cfg: ModelConfig, x, cache_k,
                     cache_v, cache_pos, positions):
    """One-token decode: x (B, 1, d); cache_k/v (B, T, KV, hd), contiguous;
    cache_pos the slot to write. Writes k and v into the caches in place
    (the JAX package returns updated copies) and attends over the
    cache_pos + 1 valid positions."""
    B = x.shape[0]
    q, k, v = _project_qkv(params, cfg, x, positions)
    cache_k[:, cache_pos] = k[:, 0]
    cache_v[:, cache_pos] = v[:, 0]
    out = kernels.decode_attention(q[:, 0], cache_k, cache_v,
                                   length=cache_pos + 1)
    out = out.reshape(B, 1, cfg.q_dim) @ params.wo
    return out, (cache_k, cache_v)
