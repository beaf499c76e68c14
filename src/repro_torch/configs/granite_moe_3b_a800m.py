"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8) d_ff=512
vocab=49155, MoE 40 experts top-8. [hf:ibm-granite/granite-3.0-3b-a800m-base]
"""
from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    vocab_size=49_155,
    d_model=1536,
    n_layers=32,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    pattern="moe",
    moe=MoEConfig(num_experts=40, top_k=8, d_ff_expert=512,
                  dispatch="tdorch", capacity_factor=1.25, num_hot=4),
    rope_theta=10_000.0,
    norm_eps=1e-5,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-smoke", vocab_size=256, d_model=96, n_layers=2,
        n_heads=6, n_kv_heads=2, d_ff=64, pattern="moe",
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=64,
                      dispatch="tdorch", capacity_factor=2.0, num_hot=2),
        tie_embeddings=True, param_dtype="float32", compute_dtype="float32")
