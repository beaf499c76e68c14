"""zamba2-1.2b [hybrid]: 38L d_model=2048 32H (kv=32) d_ff=8192,
ssm_state=64 — Mamba2 backbone + shared attention block. [arXiv:2411.15242]
Sub-quadratic ⇒ serves the long_500k shape."""
from ..models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    vocab_size=32_000,
    d_model=2048,
    n_layers=38,  # mamba2 layers; shared attn applied every 6
    n_heads=32,
    n_kv_heads=32,  # the shared block is full MHA
    d_ff=8192,
    pattern="zamba2",
    ssm=SSMConfig(d_state=64, expand=2, head_dim=64, d_conv=4, chunk=128),
    shared_attn_every=6,
    rope_theta=10_000.0,
    norm_eps=1e-5,
    tie_embeddings=True,
    sub_quadratic=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke", vocab_size=256, d_model=64, n_layers=5,
        n_heads=4, n_kv_heads=4, d_ff=128, pattern="zamba2",
        ssm=SSMConfig(d_state=16, expand=2, head_dim=16, d_conv=4, chunk=8),
        shared_attn_every=2, tie_embeddings=True, sub_quadratic=True,
        param_dtype="float32", compute_dtype="float32")
