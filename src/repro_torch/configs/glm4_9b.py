"""glm4-9b [dense]: 40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552
— RoPE, GQA, QKV bias. [hf:THUDM/glm-4-9b]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    vocab_size=151_552,
    d_model=4096,
    n_layers=40,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13_696,
    pattern="dense",
    rope_theta=10_000.0,
    attn_qkv_bias=True,
    norm_eps=1e-5,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b-smoke", vocab_size=256, d_model=64, n_layers=3,
        n_heads=4, n_kv_heads=2, d_ff=128, pattern="dense",
        attn_qkv_bias=True, param_dtype="float32", compute_dtype="float32")
