"""command-r-35b [dense]: 40L d_model=8192 64H (GQA kv=8) d_ff=22528
vocab=256000 — GQA, no-bias, parallel attention+FFN blocks.
[hf:CohereForAI/c4ai-command-r-v01]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    vocab_size=256_000,
    d_model=8192,
    n_layers=40,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22_528,
    pattern="parallel",  # Cohere's parallel-block residual
    rope_theta=8_000_000.0,
    attn_qkv_bias=False,
    norm_eps=1e-5,
    tie_embeddings=True,  # command-r ties input/output embeddings
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="command-r-smoke", vocab_size=512, d_model=64, n_layers=3,
        n_heads=8, n_kv_heads=2, d_ff=128, pattern="parallel",
        tie_embeddings=True, param_dtype="float32", compute_dtype="float32")
