"""qwen2-vl-72b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 — M-RoPE, dynamic resolution. [arXiv:2409.12191]
Backbone only: the vision frontend is a STUB — input_specs() supplies
precomputed patch embeddings (B, S, d_model) and (3, B, S) M-RoPE ids."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    vocab_size=152_064,
    d_model=8192,
    n_layers=80,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29_568,
    pattern="dense",
    rope_kind="mrope",
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    attn_qkv_bias=True,  # qwen2 uses qkv bias
    norm_eps=1e-6,
    modality_stub=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-smoke", vocab_size=256, d_model=64, n_layers=2,
        n_heads=4, n_kv_heads=2, d_ff=128, pattern="dense",
        rope_kind="mrope", mrope_sections=(4, 6, 6), attn_qkv_bias=True,
        modality_stub=True, param_dtype="float32", compute_dtype="float32")
