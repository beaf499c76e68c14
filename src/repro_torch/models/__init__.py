"""The LM stack, the port of the JAX package's `models/` for serving: the
dense, parallel, moe (granite-moe), zamba2 and xlstm block patterns
(`Model`: forward, prefill, decode_step, init_caches) over the attention,
decode, SSD-scan, grouped-GEMM and histogram kernels, and
`from_jax_params` to carry a JAX parameter pytree across. Training is a
later slice (ROADMAP A11c)."""
from .config import ModelConfig, MoEConfig, SSMConfig, XLSTMConfig  # noqa: F401
from .model import Model, from_jax_params  # noqa: F401
