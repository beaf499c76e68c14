"""The MoE block's mesh branches in the port's model (`repro_torch.models.
moe` on `launch.mesh.make_host_mesh`) against the JAX package's
`Model(cfg, mesh=...)` under `shard_map`, reduced granite-moe-1b-a400m in
float32, the same weights (`from_jax_params`) and tokens:

- loss, aux and every gradient under `jax.value_and_grad(Model.loss_fn)`
  (the sequence-split branch) at (1, 4), (2, 2) and (1, 3) meshes — the
  last pads the 8 experts to 9 — at a capacity that drops assignments,
  so the shards' token layout decides the drops;
- the prefill's logits (sequence split), the decode step's (the psum
  branch) and a prefill whose length the model axis does not divide (the
  psum branch at prefill).

The JAX package runs on 4 host devices in a subprocess, once a session
(`_moe_mesh_jax.py`, shared with the group mesh's tests). At (2, 2) the JAX package returns aux with
`out_specs=P()` and `check_vma=False`, so each data group's devices hold
their own group's mean; the port's aux (and so its loss) is the mean over
the groups, which is the mean of the JAX devices' values and the loss
whose gradient both compute. Tolerances: float32, REL and ABS (in
`_moe_mesh_jax.py`).
"""
import dataclasses

import numpy as np
import pytest
import torch
from _moe_mesh_jax import (ABS, ARCH, CAPACITY, MESHES, REL, S, S_ODD,
                           run_jax_mesh, tree)

from repro_torch.configs import get_reduced
from repro_torch.core.shardexec import StackedMesh
from repro_torch.launch.collectives import collective_stats
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.models import Model, from_jax_params
from repro_torch.models import moe as tmoe

@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    return run_jax_mesh(tmp_path_factory)


def _cfg():
    cfg = get_reduced(ARCH)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=CAPACITY))


def _port_model(runs, tag, mesh):
    model = Model(_cfg(), device="cpu", mesh=mesh)
    model.load_state_dict(from_jax_params(
        model.cfg, tree(runs, f"{tag}:p:"), "cpu"))
    return model


class _Drops:
    """Count the assignments the push path drops (`moe_push_pull`'s
    MoEAux) while the `with` block runs."""

    def __enter__(self):
        self.fn, self.dropped = tmoe.moe_push_pull, 0

        def counted(*a, **kw):
            y, aux = self.fn(*a, **kw)
            self.dropped += int(aux.dropped_assignments.sum())
            return y, aux
        tmoe.moe_push_pull = counted
        return self

    def __exit__(self, *exc):
        tmoe.moe_push_pull = self.fn
        return False


def _close(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=REL,
                               atol=ABS * max(1.0, np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("tag", list(MESHES))
def test_loss_aux_and_grads_match_jax_shard_map(jax_runs, tag):
    D, M = MESHES[tag]
    mesh = make_host_mesh(D, M, "cpu")
    model = _port_model(jax_runs, tag, mesh)
    assert model.cfg.moe.padded == -(-8 // M) * M
    batch = {k: torch.from_numpy(jax_runs[k]) for k in ("tokens", "targets")}
    with _Drops() as drops:
        loss, met = model.loss_fn(batch)
    # the capacity drops assignments, each shard by its own tokens
    assert drops.dropped > 0
    _close(loss, jax_runs[f"{tag}:loss"], "loss")
    _close(met["nll"], jax_runs[f"{tag}:nll"], "nll")
    _close(met["aux"], jax_runs[f"{tag}:aux"], "aux")
    names = [n for n, _ in model.named_parameters()]
    got = dict(zip(names, torch.autograd.grad(loss, list(
        model.parameters()))))
    want = from_jax_params(model.cfg, tree(jax_runs, f"{tag}:g:"), "cpu")
    assert set(got) == set(want)
    for n, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(
            got[n].numpy(), w, rtol=1e-4, atol=1e-5 * np.abs(w).max(),
            err_msg=f"gradient {n}")


def test_aux_is_the_mean_over_data_groups(jax_runs):
    """At (2, 2) the JAX devices disagree on aux (their own group's mean);
    the port's is the mean of the two, which differs from the first
    device's read."""
    first = float(jax_runs["2x2:aux_first_device"])
    mean = float(jax_runs["2x2:aux"])
    assert abs(first - mean) > 1e-4
    model = _port_model(jax_runs, "2x2", make_host_mesh(2, 2, "cpu"))
    _, met = model.loss_fn({k: torch.from_numpy(jax_runs[k])
                            for k in ("tokens", "targets")})
    assert abs(float(met["aux"].detach()) - mean) < 1e-6


@pytest.mark.parametrize("tag", list(MESHES))
@torch.no_grad()
def test_prefill_and_decode_match_jax_shard_map(jax_runs, tag):
    D, M = MESHES[tag]
    model = _port_model(jax_runs, tag, make_host_mesh(D, M, "cpu"))
    tokens = torch.from_numpy(jax_runs["tokens"])
    logits, caches = model.prefill(tokens=tokens, max_len=S + 1)
    _close(logits, jax_runs[f"{tag}:logits"], "prefill (sequence split)")
    step, _ = model.decode_step(caches, tokens=torch.from_numpy(
        jax_runs["next"]), cache_pos=S)
    _close(step, jax_runs[f"{tag}:step"], "decode step (psum)")
    odd, _ = model.prefill(tokens=torch.from_numpy(jax_runs["tokens2"]),
                           max_len=S_ODD)
    _close(odd, jax_runs[f"{tag}:odd"], "prefill of S % ep != 0 (psum)")


@pytest.mark.parametrize("decode", [False, True], ids=["split", "psum"])
def test_one_shard_mesh_is_the_one_device_block(decode):
    """A (1, 1) mesh (and a (2, 1) one: no model axis to split over) runs
    the one-device block, bit for bit."""
    cfg = _cfg()
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 8, cfg.d_model)).astype(np.float32))
    ref = Model(cfg, device="cpu", seed=3)
    want = tmoe.moe_block(ref.blocks[0].moe, cfg, x, decode=decode)
    for shape in ((1, 1), (2, 1)):
        mesh = make_host_mesh(*shape, device="cpu")
        got = tmoe.moe_block(ref.blocks[0].moe, cfg, x, mesh=mesh,
                             decode=decode)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_mesh_branches_match_one_device_at_ample_capacity():
    """Where nothing drops, the (1, 4) mesh's outputs and gradients equal
    one device's (the aux losses differ by definition: aux weight 0 here),
    and the stacked mesh counts its collectives, forward and backward."""
    cfg = _cfg()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=4.0, aux_loss_weight=0.0))
    mesh = make_host_mesh(1, 4, "cpu")
    m4 = Model(cfg, device="cpu", seed=5, mesh=mesh)
    m1 = Model(cfg, device="cpu", seed=5)
    m1.load_state_dict(m4.state_dict())
    rng = np.random.default_rng(2)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32)))
    batch = {"tokens": tok, "targets": tok.roll(-1, 1)}
    with _Drops() as drops:
        l4, _ = m4.loss_fn(batch)
    l1, _ = m1.loss_fn(batch)
    assert drops.dropped == 0
    _close(l4, l1.detach().numpy(), "loss")
    # the forward's collectives a MoE layer: three all-to-alls (tokens,
    # expert ids, results), four psums (Phase 1's counts, the hot w_in and
    # w_out, the drop count)
    calls = mesh.groups[0].calls
    assert calls["all-to-all"] == 3 * cfg.n_layers
    assert calls["all-reduce"] == 4 * cfg.n_layers
    fwd = collective_stats(mesh)
    assert fwd.count == 7 * cfg.n_layers and fwd.wire_bytes > 0
    g4 = torch.autograd.grad(l4, list(m4.parameters()))
    g1 = torch.autograd.grad(l1, list(m1.parameters()))
    for (n, _), a, b in zip(m4.named_parameters(), g4, g1):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6 * float(b.abs().max()),
                                   err_msg=n)
    # the backward's transposes: the two float all-to-alls and the two
    # weight psums again
    assert calls["all-to-all"] == 5 * cfg.n_layers
    assert calls["all-reduce"] == 6 * cfg.n_layers


def test_an_abstract_mesh_or_an_uneven_batch_does_not_execute():
    cfg = _cfg()
    x = torch.zeros((3, 8, cfg.d_model))
    params = Model(cfg, device="cpu").blocks[0].moe
    with pytest.raises(ValueError, match="abstract"):
        tmoe.moe_block(params, cfg, x, mesh=Mesh(("data", "model"), (1, 4)))
    with pytest.raises(ValueError, match="data groups"):
        tmoe.moe_block(params, cfg, x, mesh=make_host_mesh(2, 4, "cpu"))
    with pytest.raises(ValueError, match="runs on"):
        Model(cfg, device="cpu", mesh=Mesh(("data", "model"), (1, 2),
                                           torch.device("meta"),
                                           (StackedMesh(2, "meta"),)))
