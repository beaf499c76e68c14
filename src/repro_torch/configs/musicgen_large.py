"""musicgen-large [audio]: 48L d_model=2048 32H (kv=32, MHA) d_ff=8192
vocab=2048 — decoder-only over EnCodec tokens. [arXiv:2306.05284]
Backbone only: the EnCodec frontend (4-codebook interleaving) is a STUB —
input_specs() supplies precomputed frame embeddings (B, S, d_model)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    vocab_size=2048,  # EnCodec codebook size
    d_model=2048,
    n_layers=48,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    pattern="dense",
    rope_kind="none",  # musicgen uses learned sinusoidal; stubbed as none
    norm_eps=1e-5,
    modality_stub=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="musicgen-smoke", vocab_size=128, d_model=64, n_layers=2,
        n_heads=4, n_kv_heads=4, d_ff=128, pattern="dense",
        rope_kind="none", modality_stub=True,
        param_dtype="float32", compute_dtype="float32")
