"""internlm2-20b [dense]: 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92544 — GQA. [arXiv:2403.17297]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b",
    vocab_size=92_544,
    d_model=6144,
    n_layers=48,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16_384,
    pattern="dense",
    rope_theta=1_000_000.0,
    norm_eps=1e-5,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="internlm2-20b-smoke", vocab_size=256, d_model=96, n_layers=3,
        n_heads=6, n_kv_heads=2, d_ff=192, pattern="dense",
        param_dtype="float32", compute_dtype="float32")
