"""Per-layer block assemblies, the port of the JAX package's
`models/blocks.py`: dense, parallel, MoE (granite-moe), zamba2's Mamba and
shared attention blocks, and xLSTM's mLSTM and sLSTM blocks.

Every block function has the uniform signature
    block(params, cfg, x, positions, cache, *, decode, cache_pos)
      -> (x_out, new_cache, aux_loss_or_None)
and the MoE layer also takes the model's mesh (`mesh`, for its mesh
branches in `models/moe.py`).
Attention caches are (k, v) pairs, written in place at decode; at prefill
the block returns the layer's (k, v) (or its Mamba / LSTM state) as the
cache seed. The recurrent blocks return new state tensors at decode; the
model copies them into its caches.
"""
from __future__ import annotations

import torch

from .attention import attention_decode, attention_full, init_attention
from .config import ModelConfig
from .layers import MLP, mlp, rmsnorm
from .mamba import init_mamba, mamba_chunked, mamba_decode
from .moe import init_moe, moe_block
from .xlstm import (init_mlstm, init_slstm, mlstm_chunked, mlstm_decode,
                    slstm_decode, slstm_forward)


def _ones(d: int, dtype, device) -> torch.nn.Parameter:
    return torch.nn.Parameter(torch.ones((d,), dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# attention sub-step shared by dense/parallel/moe blocks
# ---------------------------------------------------------------------------
def _attn(params, cfg, x, positions, cache, decode, cache_pos):
    if decode:
        k_cache, v_cache = cache
        return attention_decode(params, cfg, x, k_cache, v_cache, cache_pos,
                                positions)
    return attention_full(params, cfg, x, positions)  # the prefill seed


# ---------------------------------------------------------------------------
# dense (glm4 / internlm2 / tinyllama / qwen2-vl / musicgen backbones), and
# zamba2's shared transformer block: ONE set of weights reused at every
# application point
# ---------------------------------------------------------------------------
class DenseBlock(torch.nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device, generator):
        super().__init__()
        self.ln1 = _ones(cfg.d_model, dtype, device)
        self.attn = init_attention(cfg, dtype, device, generator)
        self.ln2 = _ones(cfg.d_model, dtype, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dtype, device, generator)


def init_dense_block(cfg: ModelConfig, dtype, device, generator):
    return DenseBlock(cfg, dtype, device, generator)


init_shared_attn_block = init_dense_block


def dense_block(params, cfg, x, positions, cache=None, *, decode=False,
                cache_pos=None):
    h, new_cache = _attn(params.attn, cfg,
                         rmsnorm(x, params.ln1, cfg.norm_eps),
                         positions, cache, decode, cache_pos)
    x = x + h
    x = x + mlp(params.mlp, rmsnorm(x, params.ln2, cfg.norm_eps))
    return x, new_cache, None


# ---------------------------------------------------------------------------
# parallel attention+FFN, no biases (command-r)
# ---------------------------------------------------------------------------
class ParallelBlock(torch.nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device, generator):
        super().__init__()
        self.ln = _ones(cfg.d_model, dtype, device)
        self.attn = init_attention(cfg, dtype, device, generator)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dtype, device, generator)


def init_parallel_block(cfg: ModelConfig, dtype, device, generator):
    return ParallelBlock(cfg, dtype, device, generator)


def parallel_block(params, cfg, x, positions, cache=None, *, decode=False,
                   cache_pos=None):
    h = rmsnorm(x, params.ln, cfg.norm_eps)
    a, new_cache = _attn(params.attn, cfg, h, positions, cache, decode,
                         cache_pos)
    x = x + a + mlp(params.mlp, h)  # single-norm parallel residual
    return x, new_cache, None


# ---------------------------------------------------------------------------
# MoE (granite-moe): attention + TD-Orch-dispatched expert FFN
# ---------------------------------------------------------------------------
class MoEBlock(torch.nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device, generator,
                 shard=None):
        super().__init__()
        self.ln1 = _ones(cfg.d_model, dtype, device)
        self.attn = init_attention(cfg, dtype, device, generator)
        self.ln2 = _ones(cfg.d_model, dtype, device)
        self.moe = init_moe(cfg, dtype, device, generator, shard)


def init_moe_block(cfg: ModelConfig, dtype, device, generator, shard=None):
    """`shard` (rank, ep): that rank's experts alone (`models/moe.py`)."""
    return MoEBlock(cfg, dtype, device, generator, shard)


def moe_layer_block(params, cfg, x, positions, cache=None, *, decode=False,
                    cache_pos=None, mesh=None):
    h, new_cache = _attn(params.attn, cfg,
                         rmsnorm(x, params.ln1, cfg.norm_eps),
                         positions, cache, decode, cache_pos)
    x = x + h
    y, aux = moe_block(params.moe, cfg,
                       rmsnorm(x, params.ln2, cfg.norm_eps), mesh=mesh,
                       decode=decode)
    return x + y, new_cache, aux


# ---------------------------------------------------------------------------
# zamba2 unit pieces: mamba layer + (external) shared attention block
# ---------------------------------------------------------------------------
class MambaBlock(torch.nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device, generator):
        super().__init__()
        self.ln = _ones(cfg.d_model, dtype, device)
        self.mamba = init_mamba(cfg, dtype, device, generator)


def init_mamba_block(cfg: ModelConfig, dtype, device, generator):
    return MambaBlock(cfg, dtype, device, generator)


def mamba_block(params, cfg, x, positions, cache=None, *, decode=False,
                cache_pos=None):
    h = rmsnorm(x, params.ln, cfg.norm_eps)
    if decode:
        out, new_state = mamba_decode(params.mamba, cfg, h, cache)
    else:
        out, new_state = mamba_chunked(params.mamba, cfg, h)
    return x + out, new_state, None


# ---------------------------------------------------------------------------
# xLSTM blocks
# ---------------------------------------------------------------------------
class MLSTMBlock(torch.nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device, generator):
        super().__init__()
        self.ln = _ones(cfg.d_model, dtype, device)
        self.cell = init_mlstm(cfg, dtype, device, generator)


def init_mlstm_block(cfg: ModelConfig, dtype, device, generator):
    return MLSTMBlock(cfg, dtype, device, generator)


def mlstm_block(params, cfg, x, positions, cache=None, *, decode=False,
                cache_pos=None):
    h = rmsnorm(x, params.ln, cfg.norm_eps)
    if decode:
        state, tail = cache
        out, state, tail = mlstm_decode(params.cell, cfg, h, state, tail)
        return x + out, (state, tail), None
    out, (state, tail) = mlstm_chunked(params.cell, cfg, h)
    return x + out, (state, tail), None


class SLSTMBlock(torch.nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device, generator):
        super().__init__()
        self.ln = _ones(cfg.d_model, dtype, device)
        self.cell = init_slstm(cfg, dtype, device, generator)


def init_slstm_block(cfg: ModelConfig, dtype, device, generator):
    return SLSTMBlock(cfg, dtype, device, generator)


def slstm_block(params, cfg, x, positions, cache=None, *, decode=False,
                cache_pos=None):
    h = rmsnorm(x, params.ln, cfg.norm_eps)
    if decode:
        out, state = slstm_decode(params.cell, cfg, h, cache)
    else:
        out, state = slstm_forward(params.cell, cfg, h)
    return x + out, state, None
