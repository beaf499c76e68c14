"""Model configuration schema (a copy of the JAX package's
`models/config.py`). Only the configs are ported so far: the model stack
itself is ROADMAP item A11."""
from .config import ModelConfig, MoEConfig, SSMConfig, XLSTMConfig  # noqa: F401
