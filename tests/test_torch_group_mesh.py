"""The model axis on a group mesh (`launch.mesh.make_group_mesh`: one gloo
rank a shard, `core.shardexec.GroupMesh`'s autograd-aware collectives) on
the CPU, reduced granite-moe-1b-a400m at a capacity that drops
assignments, at the (1, 4), (2, 2) and (1, 3) meshes — one spawn of gloo
ranks a mesh, each in a subprocess, the three at once, every rank
computing all it is asked in one go:

- float64, seeded weights: loss, aux, nll and every gradient (the sharded
  experts' gathered from the ranks, the data axis's mean taken) against
  the stacked mesh (`make_host_mesh`) within 1e-12 (the router, float32
  in every model, within 4 float32 ulps: its gradient sums the shards'
  in another order); the prefill's logits
  (sequence split), a decode step's (psum) and a prefill whose length the
  model axis does not divide (psum at prefill) likewise; one
  `train_step` with a clip norm that binds: its grad norm and the
  parameters equal the stacked mesh's within 4 float32 ulps (AdamW
  computes them in float32), and every replicated parameter is
  bit-identical across the ranks;
- float32, the JAX package's weights: loss, aux, nll, gradients and the
  three logits against its `shard_map` (`_moe_mesh_jax.py`, REL / ABS);
- a world of the wrong size raises, and int8 gradient compression
  refuses a rank's shard that is not whole blocks of 256;
- planted faults (at (1, 4), each patched in and out inside the ranks):
  `all_gather`'s backward a reduce-scatter, `pvary`'s backward the
  identity, and the global norm without its sum over the model axis —
  each must fail the float64 comparison.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from _moe_mesh_jax import (ABS, ARCH, CAPACITY, MESHES, REL, S, S_ODD,
                           run_jax_mesh, tree)

from repro_torch.configs import get_reduced
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import Model
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.runtime.trainer import train_step

ROOT = Path(__file__).resolve().parents[1]
SEED = 7
TOL64 = 1e-12
# the router is float32 in every model (as the JAX package keeps it): its
# gradient is the shards' float32 sum, in another order on the group; and
# AdamW computes every new value and the norm in float32
TOL32 = 4 * float(np.finfo(np.float32).eps)
# the clipped step: a clip norm far below the gradients' norm, and an eps
# above the clipped gradients' values, so the first update is near
# lr·g/eps, in proportion to the clip's scale: it depends on the whole
# model's norm
OPT = AdamWConfig(peak_lr=1e-2, warmup_steps=1, total_steps=10,
                  clip_norm=1e-3, eps=1e-3)
FAULTS = ("all_gather_reduce_scatter", "pvary_identity",
          "global_norm_per_rank")
FAULT_MESH = "1x4"


def _cfg(dtype: str):
    cfg = get_reduced(ARCH)
    return dataclasses.replace(cfg, param_dtype=dtype, compute_dtype=dtype,
                               moe=dataclasses.replace(
                                   cfg.moe, capacity_factor=CAPACITY))


def _inputs(runs: dict, rows=slice(None)) -> dict:
    return {k: torch.from_numpy(runs[k][rows].astype(np.int64))
            for k in ("tokens", "targets", "tokens2", "next")}


def _results(model, inp: dict, mean=None, gather=None) -> dict:
    """Loss, nll, aux and gradients of `inp`'s rows (`mean`: the data axis's
    mean of them; `gather`: the sharded ones made whole), then one clipped
    `train_step` and the three logits."""
    from repro_torch.runtime.trainer import _grads

    params = dict(model.named_parameters())
    batch = {"tokens": inp["tokens"], "targets": inp["targets"]}
    loss, met, grads = _grads(model, params, batch)
    if mean is not None:
        loss, met, grads = mean(loss, met, grads)
    grads = gather(grads) if gather else grads
    out = {"loss": loss, "nll": met["nll"], "aux": met["aux"],
           **{f"g:{k}": v for k, v in grads.items()}}
    with torch.no_grad():
        logits, caches = model.prefill(tokens=inp["tokens"], max_len=S + 1)
        step, _ = model.decode_step(caches, tokens=inp["next"], cache_pos=S)
        odd, _ = model.prefill(tokens=inp["tokens2"], max_len=S_ODD)
    out.update(logits=logits, step=step, odd=odd)
    return {k: v.detach().numpy() for k, v in out.items()}


def _clipped(model, inp: dict, gather=None) -> dict:
    """The parameters after one clipped `train_step` (whole), and its
    grad norm."""
    params = dict(model.named_parameters())
    state = {"params": params, "opt": init_opt_state(params)}
    met = train_step(model, state, {"tokens": inp["tokens"],
                                    "targets": inp["targets"]}, OPT)
    after = gather(params) if gather else params
    return {"grad_norm": met["grad_norm"].numpy(),
            **{f"p:{k}": v.detach().numpy().copy()
               for k, v in after.items()}}


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------
def _plant(fault: str):
    """Patch `fault` in; returns the undo."""
    from repro_torch.core import shardexec
    from repro_torch.optim import clip

    if fault == "all_gather_reduce_scatter":
        cls, old = shardexec._AllGather, shardexec._AllGather.backward

        def backward(ctx, g):  # the sum over the ranks, then its slice
            y = g.contiguous().clone()
            ctx.mesh._dist.all_reduce(y, group=ctx.mesh.group)
            r, n = ctx.mesh.rank, ctx.n
            return None, y[r * n:(r + 1) * n]
        cls.backward = staticmethod(backward)
        return lambda: setattr(cls, "backward", staticmethod(old))
    if fault == "pvary_identity":
        cls, old = shardexec._PVary, shardexec._PVary.backward
        cls.backward = staticmethod(lambda ctx, g: (None, g))
        return lambda: setattr(cls, "backward", staticmethod(old))
    assert fault == "global_norm_per_rank"
    old = clip.global_norm
    clip.global_norm = lambda tree_, mesh=None, sharded=(): old(tree_)
    return lambda: setattr(clip, "global_norm", old)


def _worker(rank, world, port, D, M, runs_path, tag, out_dir, faults):
    import torch.distributed as dist

    from repro_torch.launch.collectives import collective_stats
    from repro_torch.launch.mesh import make_group_mesh
    from repro_torch.models import from_jax_params
    from repro_torch.runtime.trainer import _data_mean

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        runs = dict(np.load(runs_path))
        mesh = make_group_mesh(D, M, "cpu")
        i = rank // M
        inp = _inputs(runs, slice(i * (len(runs["tokens"]) // D),
                                  (i + 1) * (len(runs["tokens"]) // D)))

        def mean(loss, met, grads):
            return _data_mean(mesh, loss, met, grads) if D > 1 else \
                (loss, met, grads)

        def run64():
            m = Model(_cfg("float64"), device="cpu", seed=SEED, mesh=mesh)
            res = _results(m, inp, mean, m.gather)
            m = Model(_cfg("float64"), device="cpu", seed=SEED, mesh=mesh)
            mesh.reset_counts()
            res.update(_clipped(m, inp, m.gather))
            res["replicated"] = np.concatenate([
                p.detach().numpy().ravel() for n, p in m.named_parameters()
                if n not in m.sharded_names()])
            res["shard"] = np.array(m.shard)
            return res, collective_stats(mesh)

        out, st = run64()
        info = {"boundary": {k: list(v) for k, v in st.boundary.items()}}
        m32 = Model(_cfg("float32"), device="cpu", mesh=mesh)
        m32.load_state_dict(from_jax_params(
            m32.cfg, tree(runs, f"{tag}:p:"), "cpu", shard=m32.shard))
        out.update({f"f32:{k}": v for k, v in
                    _results(m32, inp, mean, m32.gather).items()})
        for fault in faults:
            undo = _plant(fault)
            try:
                res, _ = run64()
            finally:
                undo()
            out.update({f"{fault}:{k}": v for k, v in res.items()})
        try:  # a world of the wrong size
            make_group_mesh(D + 1, M, "cpu")
            info["refused"] = ""
        except RuntimeError as exc:
            info["refused"] = str(exc)
        np.savez(Path(out_dir) / f"rank{rank}.npz", **out)
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(info))
    finally:
        dist.destroy_process_group()


_SCRIPT = """
import socket, sys
sys.path[:0] = [{src!r}, {tests!r}]
import torch.multiprocessing as mp
import test_torch_group_mesh as t
s = socket.socket(); s.bind(("localhost", 0)); port = s.getsockname()[1]
s.close()
mp.spawn(t._worker, args=({world}, port, {D}, {M}, {runs!r}, {tag!r},
                          {out!r}, {faults!r}), nprocs={world})
print("OK")
"""


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    return run_jax_mesh(tmp_path_factory)


@pytest.fixture(scope="module")
def group_runs(jax_runs, tmp_path_factory):
    """{tag: [each rank's npz dict, ...], ...} and {tag: rank 0's info}:
    the three meshes' spawns, run at once."""
    base = tmp_path_factory.mktemp("group_mesh")
    runs_path = base / "runs.npz"
    np.savez(runs_path, **jax_runs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {}
    for tag, (D, M) in MESHES.items():
        out = base / tag
        out.mkdir()
        code = _SCRIPT.format(
            src=str(ROOT / "src"), tests=str(ROOT / "tests"), world=D * M,
            D=D, M=M, runs=str(runs_path), tag=tag, out=str(out),
            faults=FAULTS if tag == FAULT_MESH else ())
        procs[tag] = subprocess.Popen(
            [sys.executable, "-c", code], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    got, info = {}, {}
    for tag, p in procs.items():
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0 and "OK" in stdout, \
            stdout[-2000:] + stderr[-4000:]
        D, M = MESHES[tag]
        got[tag] = [dict(np.load(base / tag / f"rank{r}.npz"))
                    for r in range(D * M)]
        info[tag] = json.loads((base / tag / "rank0.json").read_text())
    return got, info


@pytest.fixture(scope="module")
def stacked(jax_runs):
    """{tag: the stacked mesh's float64 results, whole batch}."""
    out = {}
    for tag, (D, M) in MESHES.items():
        mesh = make_host_mesh(D, M, "cpu")
        inp = _inputs(jax_runs)
        res = _results(Model(_cfg("float64"), device="cpu", seed=SEED,
                             mesh=mesh), inp)
        res.update(_clipped(Model(_cfg("float64"), device="cpu", seed=SEED,
                                  mesh=mesh), inp))
        out[tag] = res
    return out


def _rows(tag: str, rank: int, want: np.ndarray) -> np.ndarray:
    """The rows of a whole-batch tensor that `rank`'s data group holds."""
    D, M = MESHES[tag]
    n = want.shape[0] // D
    i = rank // M
    return want[i * n:(i + 1) * n]


def _compare64(tag: str, ranks: list, want: dict, prefix: str = ""):
    """Every float64 result of every rank against the stacked mesh's."""
    for r, got in enumerate(ranks):
        for k, w in want.items():
            g = got[prefix + k]
            if k in ("logits", "step", "odd"):
                w = _rows(tag, r, w)
            tol = TOL64 if w.dtype == np.float64 and not k.startswith(
                "p:") else TOL32
            np.testing.assert_allclose(
                g, w, rtol=tol, atol=tol * max(1.0, np.abs(w).max()),
                err_msg=f"{tag} rank {r}: {prefix}{k}")


@pytest.mark.parametrize("tag", list(MESHES))
def test_group_mesh_matches_the_stacked_mesh_in_float64(group_runs, stacked,
                                                        tag):
    got, _ = group_runs
    ranks, want = got[tag], stacked[tag]
    D, M = MESHES[tag]
    assert [tuple(r["shard"]) for r in ranks] == \
        [(k % M, M) for k in range(D * M)]
    assert float(want["grad_norm"]) > 10 * OPT.clip_norm  # the clip binds
    _compare64(tag, ranks, want)


@pytest.mark.parametrize("tag", list(MESHES))
def test_replicated_parameters_are_bit_identical_across_ranks(group_runs,
                                                              tag):
    ranks = group_runs[0][tag]
    for r in ranks[1:]:
        assert np.array_equal(r["replicated"], ranks[0]["replicated"])


@pytest.mark.parametrize("tag", list(MESHES))
def test_group_mesh_matches_jax_shard_map_in_float32(group_runs, jax_runs,
                                                     tag):
    from repro_torch.models import from_jax_params
    from repro_torch.models.model import ep_padded

    cfg = ep_padded(_cfg("float32"), make_host_mesh(*MESHES[tag], "cpu"))
    grads = {k: v.numpy() for k, v in from_jax_params(
        cfg, tree(jax_runs, f"{tag}:g:"), "cpu").items()}
    for r, got in enumerate(group_runs[0][tag]):
        for k in ("loss", "nll", "aux", "logits", "step", "odd"):
            w = jax_runs[f"{tag}:{k}"]
            if k in ("logits", "step", "odd"):
                w = _rows(tag, r, w)
            np.testing.assert_allclose(
                got[f"f32:{k}"], w, rtol=REL,
                atol=ABS * max(1.0, np.abs(w).max()),
                err_msg=f"{tag} rank {r}: {k}")
        for n, w in grads.items():
            np.testing.assert_allclose(
                got[f"f32:g:{n}"], w, rtol=1e-4, atol=1e-5 * np.abs(w).max(),
                err_msg=f"{tag} rank {r}: gradient {n}")


def test_group_mesh_counts_its_boundary_collectives(group_runs):
    """The clipped step's collectives on rank 0 include the boundary ones:
    pvary's backward sums (three a MoE layer at least: x, the router, the
    hot experts' two tables) and the global norm's sum; the data axis's
    mean at a data axis over 1."""
    info = group_runs[1]
    for tag, (D, M) in MESHES.items():
        b = info[tag]["boundary"]
        layers = _cfg("float64").n_layers
        assert b["pvary backward"][0] >= 4 * layers
        assert b["global norm"][0] == 1
        assert ("data mean" in b) == (D > 1)


def test_a_world_of_the_wrong_size_raises(group_runs):
    for tag, (D, M) in MESHES.items():
        msg = group_runs[1][tag]["refused"]
        assert f"({D + 1}, {M})" in msg and f"{D * M}" in msg


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_faults_fail_the_float64_comparison(group_runs, stacked,
                                                    fault):
    ranks = group_runs[0][FAULT_MESH]
    assert all(f"{fault}:loss" in r for r in ranks)
    with pytest.raises(AssertionError):
        _compare64(FAULT_MESH, ranks, stacked[FAULT_MESH], prefix=f"{fault}:")


def test_compression_refuses_shards_that_are_not_whole_blocks():
    """int8 compression quantises blocks of 256 values of the flattened
    leaf: a rank's shard lines up with the whole leaf's blocks only when it
    is whole blocks itself, so `train_step` refuses one that is not."""
    from types import SimpleNamespace

    from repro_torch.runtime.trainer import _check_blocks

    model = SimpleNamespace(sharded_names=lambda: {"w_in", "w_out"})
    _check_blocks(model, {"w_in": torch.zeros(2, 64, 128),
                          "w_out": torch.zeros(2, 64, 64)})
    with pytest.raises(ValueError, match="whole blocks of 256"):
        _check_blocks(model, {"w_in": torch.zeros(2, 64, 128),
                              "w_out": torch.zeros(3, 5, 7)})
