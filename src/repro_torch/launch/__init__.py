"""Launchers, the port of the JAX package's `launch/`: the workload shape
table (`specs`), the serving loop (`serve.generate`, `python -m
repro_torch.launch.serve`) and the training launcher (`python -m
repro_torch.launch.train`). The mesh and the dry runs are ROADMAP item
A12."""
