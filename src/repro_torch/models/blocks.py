"""Per-layer block assemblies, the port of the JAX package's
`models/blocks.py` for the dense, parallel and zamba2 patterns.

Every block function has the uniform signature
    block(params, cfg, x, positions, cache, *, decode, cache_pos)
      -> (x_out, new_cache, aux_loss_or_None)
Attention caches are (k, v) pairs, written in place at decode; at prefill
the block returns the layer's (k, v) (or its Mamba state) as the cache
seed. The MoE and xLSTM blocks are not ported yet.
"""
from __future__ import annotations

import torch

from .attention import attention_decode, attention_full, init_attention
from .config import ModelConfig
from .layers import MLP, mlp, rmsnorm
from .mamba import init_mamba, mamba_chunked, mamba_decode


def _ones(d: int, dtype, device) -> torch.nn.Parameter:
    return torch.nn.Parameter(torch.ones((d,), dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# attention sub-step shared by dense/parallel blocks
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
# MoE (granite-moe) and xLSTM: a later slice
# ---------------------------------------------------------------------------
def _later(kind: str):
    def block(*args, **kwargs):
        raise NotImplementedError(
            f"the {kind} block is not ported yet: ROADMAP item A11b ports "
            "the MoE and xLSTM patterns")
    return block


init_moe_block = moe_layer_block = _later("MoE")
init_mlstm_block = mlstm_block = _later("mLSTM")
init_slstm_block = slstm_block = _later("sLSTM")
