"""The JAX package's `Model(cfg, mesh=...)` under `shard_map` on reduced
granite-moe-1b-a400m in float32, the reference that both the stacked
mesh's tests (`test_torch_moe_mesh.py`) and the group mesh's
(`test_torch_group_mesh.py`) hold the port to: loss, nll, aux and every
gradient under `jax.value_and_grad(Model.loss_fn)`, the prefill's logits,
a decode step's and a prefill whose length the model axis does not
divide, at the (1, 4), (2, 2) and (1, 3) meshes, with the seeded inputs
and the initial parameters.

The JAX package runs on 4 host devices in a subprocess (XLA_FLAGS must be
set before JAX starts), once a session: under pytest-xdist the first
worker to ask writes the results beside the workers' temporary
directories, under a file lock, and the others read them.
"""
import fcntl
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
ARCH = "granite-moe-1b-a400m"
MESHES = {"1x4": (1, 4), "2x2": (2, 2), "1x3": (1, 3)}
B, S, S_ODD = 2, 96, 25  # S divisible by 2, 3 and 4; S_ODD by none
CAPACITY = 0.5  # drops assignments on every mesh (asserted)
# float32: rtol 2e-5, and 2e-6 of the largest |value| (a logit near 0
# takes the error of its larger neighbours' sums); gradients rtol 1e-4,
# 1e-5 of the tensor's largest |value|
REL, ABS = 2e-5, 2e-6

_JAX_SCRIPT = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path[:0] = [{src!r}]
import dataclasses
import numpy as np
import jax
from jax.sharding import Mesh
from repro.configs import get_reduced
from repro.models import Model

cfg = get_reduced({arch!r})
cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
    cfg.moe, capacity_factor={cf!r}))
rng = np.random.default_rng(0)
B, S, S2 = {B}, {S}, {S2}
inp = dict(tokens=rng.integers(0, cfg.vocab_size, (B, S)),
           targets=rng.integers(0, cfg.vocab_size, (B, S)),
           tokens2=rng.integers(0, cfg.vocab_size, (B, S2)),
           next=rng.integers(0, cfg.vocab_size, (B, 1)))
inp = {{k: v.astype(np.int32) for k, v in inp.items()}}
out = dict(inp)


def leaves(tree, prefix):
    for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/".join(str(p.key) for p in path)] = np.asarray(v)


def devices_mean(a):  # the mean of the values the devices hold
    return np.mean([np.asarray(s.data) for s in a.addressable_shards])


for tag, (D, M) in {meshes!r}.items():
    mesh = Mesh(np.array(jax.devices()[:D * M]).reshape(D, M),
                ("data", "model"))
    m = Model(cfg, mesh=mesh)
    params = m.init(0)
    batch = dict(tokens=inp["tokens"], targets=inp["targets"])
    (loss, met), grads = jax.jit(jax.value_and_grad(
        m.loss_fn, has_aux=True))(params, batch)
    logits, caches = jax.jit(lambda p, t: m.prefill(
        p, tokens=t, max_len=S + 1))(params, inp["tokens"])
    step, _ = jax.jit(lambda p, c, t: m.decode_step(
        p, c, tokens=t, cache_pos=S))(params, caches, inp["next"])
    odd, _ = jax.jit(lambda p, t: m.prefill(p, tokens=t, max_len=S2))(
        params, inp["tokens2"])
    out[tag + ":loss"] = devices_mean(loss)
    out[tag + ":nll"] = devices_mean(met["nll"])
    out[tag + ":aux"] = devices_mean(met["aux"])
    out[tag + ":aux_first_device"] = np.asarray(met["aux"])
    out[tag + ":logits"] = np.asarray(logits)
    out[tag + ":step"] = np.asarray(step)
    out[tag + ":odd"] = np.asarray(odd)
    leaves(params, tag + ":p:")
    leaves(grads, tag + ":g:")
np.savez({out_path!r}, **out)
print("OK")
"""


def _shared_dir(tmp_path_factory) -> Path:
    """The session's directory every xdist worker sees (the parent of the
    workers' own), or the run's own without xdist."""
    base = tmp_path_factory.getbasetemp()
    return base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base


def run_jax_mesh(tmp_path_factory) -> dict:
    """{name: array} of the JAX runs (module docstring): computed once a
    session, under a lock."""
    root = _shared_dir(tmp_path_factory)
    out_path = root / "moe_mesh_jax.npz"
    with open(root / "moe_mesh_jax.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out_path.exists():
            code = _JAX_SCRIPT.format(
                src=str(ROOT / "src"), arch=ARCH, cf=CAPACITY, B=B, S=S,
                S2=S_ODD, meshes=MESHES, out_path=str(out_path))
            env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
            res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                                 env=env, capture_output=True, text=True,
                                 timeout=600)
            assert res.returncode == 0 and "OK" in res.stdout, \
                res.stdout[-2000:] + res.stderr[-4000:]
    return dict(np.load(out_path))


def tree(flat: dict, prefix: str) -> dict:
    """The nested dict of the arrays under `prefix` (paths joined by /)."""
    out: dict = {}
    for k, v in flat.items():
        if not k.startswith(prefix):
            continue
        *path, leaf = k[len(prefix):].split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out
