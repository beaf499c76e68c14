"""TD-Orch on PyTorch and CUDA: the port of the JAX package `repro` to one
NVIDIA H100. `repro_torch.core` is the orchestration core; its stages run on
the card through hand-written Hopper kernels (`repro_torch.kernels`, sources
in `csrc/`). `repro_torch.kvstore` and `repro_torch.serve` are the KV store
and the streaming serve tier over it; `repro_torch.checkpoint` and
`repro_torch.runtime` the durable snapshots and failure monitors of the
elastic sessions (`repro_torch.core.elasticity`). This package imports torch
and numpy, never jax or `repro`."""
