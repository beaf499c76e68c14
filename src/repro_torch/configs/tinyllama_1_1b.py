"""tinyllama-1.1b [dense]: 22L d_model=2048 32H (GQA kv=4) d_ff=5632
vocab=32000 — llama2-arch small. [arXiv:2401.02385]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    vocab_size=32_000,
    d_model=2048,
    n_layers=22,
    n_heads=32,
    n_kv_heads=4,
    d_ff=5632,
    pattern="dense",
    rope_theta=10_000.0,
    norm_eps=1e-5,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-smoke", vocab_size=256, d_model=64, n_layers=2,
        n_heads=8, n_kv_heads=2, d_ff=160, pattern="dense",
        param_dtype="float32", compute_dtype="float32")
