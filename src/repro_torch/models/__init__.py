"""The LM stack, the port of the JAX package's `models/` for serving: the
dense, parallel and zamba2 block patterns (`Model`: forward, prefill,
decode_step, init_caches) over the attention, decode and SSD-scan kernels,
and `from_jax_params` to carry a JAX parameter pytree across. The MoE and
xLSTM patterns and training are later slices (ROADMAP A11b, A11c)."""
from .config import ModelConfig, MoEConfig, SSMConfig, XLSTMConfig  # noqa: F401
from .model import Model, from_jax_params  # noqa: F401
