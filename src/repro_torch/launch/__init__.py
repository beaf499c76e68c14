"""Launchers, the port of the JAX package's `launch/`: the workload shapes
and input specs (`specs`), meshes (`mesh`: the abstract production meshes
and a host mesh that executes), the sharding rules (`sharding`), the step
builders (`steps`), collective accounting (`collectives`, the counterpart
of `hlo.py`), the roofline (`python -m repro_torch.launch.roofline`), the
meta-device dry run (`python -m repro_torch.launch.dryrun`), the serving
loop (`serve.generate`, `python -m repro_torch.launch.serve`) and the
training launcher (`python -m repro_torch.launch.train`).

The JAX package's `compat.py` has no counterpart: it holds shims across
JAX versions (mesh constructors, `cost_analysis`' return type), and the
port calls no JAX.
"""
