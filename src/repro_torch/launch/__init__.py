"""Launchers, the port of the JAX package's `launch/`: the workload shape
table (`specs`) and the serving loop (`serve.generate`, `python -m
repro_torch.launch.serve`). Training, the mesh and the dry runs are ROADMAP
item A12."""
