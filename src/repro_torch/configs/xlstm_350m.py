"""xlstm-350m [ssm]: 24L d_model=1024 4H d_ff=0 vocab=50304 — sLSTM + mLSTM
blocks. [arXiv:2405.04517] Attention-free ⇒ serves the long_500k shape
(decode state is O(1) in context length)."""
from ..models.config import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    vocab_size=50_304,
    d_model=1024,
    n_layers=24,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,  # xLSTM blocks carry their own projections
    pattern="xlstm",
    xlstm=XLSTMConfig(slstm_every=8, proj_factor=2.0, chunk=128),
    rope_kind="none",
    norm_eps=1e-5,
    tie_embeddings=True,
    sub_quadratic=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="xlstm-smoke", vocab_size=256, d_model=64, n_layers=4,
        n_heads=4, n_kv_heads=4, d_ff=0, pattern="xlstm",
        xlstm=XLSTMConfig(slstm_every=2, proj_factor=2.0, chunk=8),
        rope_kind="none", tie_embeddings=True, sub_quadratic=True,
        param_dtype="float32", compute_dtype="float32")
