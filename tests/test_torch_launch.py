"""The port's launch layer (`repro_torch.launch`: specs, mesh, sharding,
steps, collectives, roofline, dryrun) against the JAX package's
`repro.launch`, and `Model` on the meta device:

- `input_specs` gives the JAX package's shapes and dtypes for every arch x
  shape (meta tensors for ShapeDtypeStructs); `shape_applicable` agrees;
- `param_pspecs`, `opt_pspecs`, `cache_pspecs`, `batch_pspec` and
  `activation_pspec` equal the JAX package's on abstract (1, 1), (4, 16),
  (1, 4) and 2 x 16 x 16 meshes for every reduced config (a port entry a
  layer: its `P.full` is the JAX stacked leaf's spec), with
  tests/test_launch.py's three sharding tests as cases;
- `default_grad_accum` and `model_flops_per_chip` on every full config;
- `collective_stats` against `parse_collectives` on HLO lines of the same
  (kind, bytes, group);
- the roofline's linear extrapolation against a direct count at a third
  depth (a reduced dense config, on the CPU); the work the kernels name
  for it (`kernels._lib.record_work`), its byte count and its flags;
- the dry run on every full config and both production meshes, and a
  planted indivisible spec it must fail;
- a train step built on a (1, 1) host mesh against `Trainer.train_step`
  bit for bit, and the prefill / decode steps against the model's;
- `Model(cfg, device="meta")`: every full config's parameter count (the
  JAX package's `eval_shape` count; `cfg.param_count()` where it is
  exact), and the seeded CPU weights unchanged.
"""
import dataclasses
import hashlib

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as jax_config
from repro.configs import get_reduced as jax_reduced
from repro.launch import roofline as jroof
from repro.launch import sharding as jsh
from repro.launch import specs as jspecs
from repro.launch import steps as jsteps
from repro.launch.compat import abstract_mesh
from repro.launch.hlo import parse_collectives
from repro.models import Model as JaxModel
from repro_torch.configs import all_arch_ids, get_config, get_reduced
from repro_torch.core.shardexec import StackedMesh
from repro_torch.launch import dryrun, roofline, specs, steps
from repro_torch.launch import sharding as sh
from repro_torch.launch.collectives import collective_stats
from repro_torch.launch.mesh import (Mesh, make_host_mesh,
                                     make_production_mesh)
from repro_torch.models import Model
from repro_torch.models.model import _STACKED
from repro_torch.optim import AdamWConfig, init_opt_state

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "4x16": ((4, 16), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
_DTYPES = {"int32": torch.int32, "bfloat16": torch.bfloat16}


def _meshes(tag):
    shape, axes = MESHES[tag]
    return abstract_mesh(shape, axes), Mesh(axes, shape)


def _jtuple(spec):
    return tuple(spec)


# ---------------------------------------------------------------------------
# input specs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", list(specs.SHAPES))
@pytest.mark.parametrize("arch", all_arch_ids())
def test_input_specs_match_jax(arch, shape):
    cfg, jcfg = get_config(arch), jax_config(arch)
    assert specs.shape_applicable(cfg, shape) == \
        jspecs.shape_applicable(jcfg, shape)
    got, want = specs.input_specs(cfg, shape), jspecs.input_specs(jcfg, shape)
    assert {k: v for k, v in got.items() if k != "inputs"} == \
        {k: v for k, v in want.items() if k != "inputs"}
    assert set(got["inputs"]) == set(want["inputs"])
    for k, t in got["inputs"].items():
        w = want["inputs"][k]
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(w.shape), k
        assert t.dtype == _DTYPES[str(w.dtype)], k


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------
def _by_port_name(jtree, shapes):
    """{port parameter name: the JAX spec} — a stacked leaf's spec for
    each of its layers, named as `from_jax_params` names them."""
    specs_flat = jax.tree_util.tree_flatten_with_path(
        jtree, is_leaf=lambda x: isinstance(x, JP))[0]
    shape_of = {jax.tree_util.keystr(p): s.shape for p, s in
                jax.tree_util.tree_flatten_with_path(shapes)[0]}
    out = {}
    for path, spec in specs_flat:
        keys = [str(p.key) for p in path]
        lead = shape_of[jax.tree_util.keystr(path)][:_STACKED.get(keys[0], 0)]
        rest = ".".join(keys[1:])
        for idx in np.ndindex(*lead):
            out[".".join([keys[0], *map(str, idx), rest]) if lead
                else ".".join(keys)] = _jtuple(spec)
    return out


def _jax_and_port(arch, tag):
    jmesh, mesh = _meshes(tag)
    jm = JaxModel(jax_reduced(arch), mesh=jmesh)
    shapes = jax.eval_shape(lambda: jm.init(0))
    pm = Model(get_reduced(arch), device="meta", mesh=mesh)
    params = dict(pm.named_parameters())
    return jmesh, mesh, jm, shapes, pm, params


@pytest.mark.parametrize("tag", list(MESHES))
@pytest.mark.parametrize("arch", all_arch_ids())
def test_param_opt_and_cache_specs_match_jax(arch, tag):
    jmesh, mesh, jm, shapes, pm, params = _jax_and_port(arch, tag)
    if pm.cfg.moe is not None:  # the same EP padding
        assert dataclasses.asdict(pm.cfg.moe) == \
            dataclasses.asdict(jm.cfg.moe)
    for kw in ({}, {"fsdp": False}, {"tp": False}):
        jspec = jsh.param_pspecs(shapes, jm.cfg, jmesh, **kw)
        got = sh.param_pspecs(params, pm.cfg, mesh, **kw)
        want = _by_port_name(jspec, shapes)
        assert set(got) == set(want)
        for n, spec in got.items():
            assert spec.full == want[n], (n, kw)
            assert all(a is None for a in spec.stacked), n
        jopt = jsh.opt_pspecs(jspec, shapes, jmesh)
        opt = sh.opt_pspecs(got, params, mesh, pm.cfg)
        assert opt["step"] == _jtuple(jopt["step"])
        for m in ("m", "v"):
            want = _by_port_name(jopt[m], shapes)
            assert {n: s.full for n, s in opt[m].items()} == want, (m, kw)
    data = mesh.shape["data"]
    for batch, max_len in ((32, 64), (data, 16)):
        jc, _ = jsh.cache_pspecs(jm.cfg, jmesh, batch, max_len)
        c, shp = sh.cache_pspecs(pm.cfg, mesh, batch, max_len)
        want = [_jtuple(s) for s in jax.tree.leaves(
            jc, is_leaf=lambda x: isinstance(x, JP))]
        assert [tuple(s) for s in sh.tree_leaves(c)] == want
        jshape = jax.tree.leaves(jm.init_caches(
            batch, max_len, like=jax.ShapeDtypeStruct))
        assert [tuple(t.shape) for t in sh.tree_leaves(shp)] == \
            [tuple(t.shape) for t in jshape]


@pytest.mark.parametrize("tag", list(MESHES))
def test_batch_and_activation_specs_match_jax(tag):
    jmesh, mesh = _meshes(tag)
    for batch in (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 3):
        for inc in (False, True):
            try:
                want = _jtuple(jsh.batch_pspec(jmesh, batch, inc))
            except KeyError:
                # the JAX package reads the pod axis's size before it asks
                # whether the mesh has one; the port checks first and goes
                # on to the data axis, as the rule means
                assert "pod" not in mesh.axis_names
                want = ("data",) if batch % mesh.shape["data"] == 0 \
                    else (None,)
                assert tuple(sh.batch_pspec(mesh, batch, inc)) == want
                continue
            assert tuple(sh.batch_pspec(mesh, batch, inc)) == want
        for seq in (1, 64, 4096, 100):
            for sp in (False, True):
                for tp in (False, True):
                    try:
                        want = _jtuple(jsh.activation_pspec(
                            jmesh, batch, seq, sp, tp))
                    except KeyError:
                        continue
                    assert tuple(sh.activation_pspec(
                        mesh, batch, seq, sp, tp)) == want
        assert sh.batch_axes_of(mesh) == jsh.batch_axes_of(jmesh)
        assert sh.batch_axes_of(mesh, True) == jsh.batch_axes_of(jmesh, True)


def test_param_specs_cover_every_parameter():
    """tests/test_launch.py's test_param_specs_cover_tree: a spec for
    every parameter, none for anything else."""
    mesh = make_production_mesh()
    for arch in ["glm4-9b", "granite-moe-1b-a400m", "zamba2-1.2b",
                 "xlstm-350m"]:
        model = Model(get_reduced(arch), device="meta", mesh=mesh)
        params = dict(model.named_parameters())
        specs_ = sh.param_pspecs(params, model.cfg, mesh)
        assert list(specs_) == list(params)
        assert all(len(s) == params[n].ndim for n, s in specs_.items())


def test_divisibility_fallback():
    """A dim not divisible by its axis falls back to replication."""
    mesh = Mesh(("data", "model"), (4, 16))
    spec = sh._resolve(("F", "M"), (100, 49155), mesh, True, True)
    assert spec[1] is None  # 49155 % 16 != 0 -> replicate
    assert spec[0] == "data"  # 100 % 4 == 0 -> FSDP ok
    spec = sh._resolve(("F", "M"), (101, 512), mesh, True, True)
    assert spec == sh.P(None, "model")  # 101 % 4 != 0 -> no FSDP


def test_pure_dp_preset_replicates_but_keeps_ep():
    mesh = Mesh(("data", "model"), (1, 4))
    model = Model(get_reduced("granite-moe-1b-a400m"), device="meta",
                  mesh=mesh)
    specs_ = sh.param_pspecs(dict(model.named_parameters()), model.cfg, mesh,
                             tp=False)
    # attention weights replicated over model...
    assert "model" not in specs_["blocks.0.attn.wq"]
    # ...but the expert tables stay on the EP axis
    assert specs_["blocks.0.moe.w_in"][0] == "model"


# ---------------------------------------------------------------------------
# steps, roofline arithmetic, collectives
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", all_arch_ids())
def test_grad_accum_and_model_flops_match_jax(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    assert steps.default_grad_accum(cfg) == jsteps.default_grad_accum(jcfg)
    for shape in specs.SHAPES:
        for n in (256, 512):
            assert roofline.model_flops_per_chip(cfg, shape, n) == \
                jroof.model_flops_per_chip(jcfg, shape, n)


def _hlo_line(kind, nbytes, g, i):
    n = nbytes // 4
    return (f"  %{kind}.{i} = f32[{n}]{{0}} {kind}(f32[{n}]{{0}} %p.{i}), "
            f"replica_groups=[{16 // g},{g}]<=[16], to_apply=%add")


def test_collective_stats_match_parse_collectives():
    """The stacked mesh's counts give the wire bytes the JAX package's
    HLO parse gives for collectives of the same kind, bytes and group."""
    for g in (2, 4, 8):
        mesh = StackedMesh(g, "cpu")
        lines = []
        for i, n in enumerate((8, 24, 100)):
            x = torch.zeros((g, n))
            mesh.psum(x)
            lines.append(_hlo_line("all-reduce", 4 * n, g, 3 * i))
            mesh.all_gather(x[:, None])
            lines.append(_hlo_line("all-gather", 4 * n * g, g, 3 * i + 1))
            mesh.all_to_all(torch.zeros((g, g, n)))
            lines.append(_hlo_line("all-to-all", 4 * n * g, g, 3 * i + 2))
        got = collective_stats(mesh)
        want = parse_collectives("\n".join(lines))
        assert got.count == want.count == 9
        assert got.result_bytes == pytest.approx(want.result_bytes)
        assert got.wire_bytes == pytest.approx(want.wire_bytes)
        assert got.by_kind == pytest.approx(want.by_kind)
        host = Mesh(("data", "model"), (2, g), torch.device("cpu"),
                    (mesh, mesh))
        assert collective_stats(host).wire_bytes == pytest.approx(
            want.wire_bytes)


def test_roofline_extrapolation_equals_a_direct_count():
    """Costs linear in the depth: the two probes extrapolate to a third
    depth's direct count (a reduced dense config, the CPU)."""
    cfg = get_reduced("tinyllama-1.1b")
    mesh = make_production_mesh()
    shape = dict(seq=64, batch=32, kind="train")
    c = {n: roofline._costs_of(dataclasses.replace(cfg, n_layers=n), shape,
                               mesh, device="cpu") for n in (2, 4, 7)}
    got = roofline.extrapolate(c[2], c[4], 2, 4, 7)
    for k in ("flops", "bytes"):
        assert c[7][k] > c[4][k] > 0
        assert got[k] == pytest.approx(c[7][k], rel=1e-12)
    # the probe ran the device's 2 rows of 32 over 16 data shards; one
    # row scaled by 2 gives the same count
    one = roofline._costs_of(dataclasses.replace(cfg, n_layers=2), shape,
                             mesh, device="cpu", rows=1)
    assert one["flops"] == pytest.approx(c[2]["flops"], rel=1e-12)


def test_kernel_launches_name_their_work():
    """Inside `record_work()` each launch hands in its (operations, bytes),
    summed by `work_of`; a launch that names none is refused there (the
    roofline would miss its work) and counted as ever outside, where its
    work is not asked for; the recording nests and restores."""
    from repro_torch.kernels import _lib

    before = _lib.launches()
    try:
        with _lib.record_work() as outer:
            _lib.count("histogram", lambda: (3, 12))
            with _lib.record_work() as inner:
                _lib.count("moe_gemm_sm90", lambda: (2 * 4 * 5 * 6, 100))
                with pytest.raises(RuntimeError, match="names no work"):
                    _lib.count("stage_fused")
            _lib.count("segment_combine", lambda: (1.5, 8))
        assert _lib.work_of(inner) == (240.0, 100.0)
        assert _lib.work_of(outer) == (4.5, 20.0)
        assert [r[0] for r in outer] == ["histogram", "segment_combine"]
        _lib.count("stage_fused")  # no recording: no work asked for

        def unasked():
            raise AssertionError("work asked for outside a recording")
        _lib.count("stage_fused", unasked)
        assert _lib._RECORD is None
        assert _lib.nbytes(torch.zeros(3, 2), None,
                           torch.zeros(5, dtype=torch.bfloat16)) == 34
    finally:
        _lib._LAUNCHES.update(before)


@pytest.mark.parametrize("S,T,causal", [(64, 64, False), (32, 96, False),
                                        (64, 64, True)])
def test_attention_kernel_work_is_the_products(S, T, causal):
    """B5's named operations: Q·Kᵀ and P·V, as FlopCounterMode counts the
    two products of the unfused attention (every score), over the causal
    half with the diagonal under `causal`."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels.flash_attention.ops import _attention_ops

    B, H, hd = 2, 3, 16
    q = torch.randn(B, H, S, hd)
    kv = torch.randn(B, H, T, hd)
    with FlopCounterMode(display=False) as fc:
        (q @ kv.transpose(-1, -2)).softmax(-1) @ kv
    got = _attention_ops(B, S, H, hd, T, causal)
    want = fc.get_total_flops()
    assert got == (want * (S + 1) // (2 * T) if causal else want)


def test_scan_kernel_work_counts_the_chunks():
    """B7's named operations: linear in the rows and the chunks, the
    backward's C·Bᵀ-side terms three times the forward's and its per-head
    products twice."""
    from repro_torch.kernels.mamba_scan.ops import _scan_ops

    B, nh, hd, ds, c = 2, 4, 8, 16, 32
    one = _scan_ops(1, c, nh, hd, ds, c)
    pairs = c * (c + 1) // 2
    assert one == 2 * pairs * ds + nh * (2 * pairs * hd + 4 * c * hd * ds)
    assert _scan_ops(B, 5 * c, nh, hd, ds, c) == 5 * B * one
    assert _scan_ops(B, 5 * c - 7, nh, hd, ds, c) == 5 * B * one
    assert _scan_ops(1, c, nh, hd, ds, c, bwd=True) == 2 * (
        3 * pairs * ds + nh * (2 * pairs * hd + 4 * c * hd * ds))


def test_roofline_bytes_skip_views_and_allocations():
    with roofline._Bytes() as nb:
        a = torch.empty(100)
        torch.empty_like(a)
        a.view(10, 10).t()
    assert nb.total == 0
    with roofline._Bytes() as nb:
        torch.zeros(100).add_(1.0)
    assert nb.total == 400 + 2 * 400  # zeros' out; add_'s in and out


def test_roofline_flags_are_the_jax_ones_but_the_sharding_presets(
        monkeypatch):
    """The JAX CLI's flags with their defaults, types and choices, plus
    `--device` and `--rows`; the GSPMD sharding presets are left out (the
    module docstring says why)."""
    import argparse

    seen = {}

    def parse_args(self, args=None, namespace=None):
        seen["parser"] = self
        raise KeyboardInterrupt

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", parse_args)
        with pytest.raises(KeyboardInterrupt):
            jroof.main()

    def flags(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.type,
                         a.choices, type(a).__name__)
                for a in parser._actions if a.dest != "help"}
    want, got = flags(seen["parser"]), flags(roofline.build_parser())
    presets = {"no_tp", "no_fsdp", "no_seq_parallel"}
    assert presets <= set(want)
    assert set(got) == (set(want) - presets) | {"device", "rows"}
    for dest in set(want) - presets:
        assert got[dest] == want[dest], dest


def test_roofline_cell_on_a_reduced_moe_config():
    rec = roofline.analyze_cell(
        "granite-moe-1b-a400m", dict(seq=64, batch=32, kind="train"),
        cfg_transform=lambda _: get_reduced("granite-moe-1b-a400m"),
        device="cpu")
    assert rec["status"] == "ok", rec.get("trace")
    assert rec["flops"] > 0 and rec["bytes"] > 0 and rec["coll_bytes"] > 0
    assert rec["dominant"] in ("compute", "memory", "collective")


# ---------------------------------------------------------------------------
# dry run
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", all_arch_ids())
def test_dryrun_every_cell(arch):
    cfg = get_config(arch)
    for shape in specs.SHAPES:
        for multi in (False, True):
            rec = dryrun.run_cell(arch, shape, multi)
            if not specs.shape_applicable(cfg, shape)[0]:
                assert rec["status"] == "skipped"
                continue
            assert rec["status"] == "ok", rec.get("error")
            mem = rec["memory"]
            assert mem["params_bytes"] > 0 and mem["per_device_bytes"] > 0
            assert ("opt_bytes" in mem) == (
                specs.SHAPES[shape]["kind"] == "train")


def test_dryrun_fails_a_planted_indivisible_spec(monkeypatch):
    plain = sh.param_pspecs

    def planted(params, cfg, mesh, **kw):
        out = plain(params, cfg, mesh, **kw)
        out["final_norm"] = sh.P("model")  # 2048 over 16 divides; 3 not
        out["blocks.0.ln1"] = sh.P("pod")  # no such axis on one pod
        return out
    monkeypatch.setattr(sh, "param_pspecs", planted)
    rec = dryrun.run_cell("tinyllama-1.1b", "train_4k", False)
    assert rec["status"] == "FAILED" and "'pod'" in rec["error"]
    with pytest.raises(SystemExit, match="FAILED"):
        dryrun.main(["--arch", "tinyllama-1.1b", "--shape", "train_4k",
                     "--mesh", "single"])
    bad = sh.P(None, "model", "model")
    assert any("twice" in p for p in dryrun._problems(
        "x", (4, 32, 32), bad, make_production_mesh()))
    assert any("divisible" in p for p in dryrun._problems(
        "x", (3,), sh.P("data"), make_production_mesh()))


# ---------------------------------------------------------------------------
# the model on the meta device; steps on a host mesh
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", all_arch_ids())
def test_meta_model_counts_the_config_parameters(arch):
    """The meta model's parameter count is the JAX package's `eval_shape`
    count, and `cfg.param_count()` where that formula is exact: it
    undercounts zamba2's and xlstm's tables in both packages."""
    cfg = get_config(arch)
    model = Model(cfg, device="meta")
    assert all(p.device.type == "meta" for p in model.parameters())
    jm = JaxModel(jax_config(arch))
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(
        jax.eval_shape(lambda: jm.init(0))))
    assert model.param_count() == want
    assert (model.param_count() == cfg.param_count()) == (
        cfg.pattern not in ("zamba2", "xlstm"))
    caches = model.init_caches(2, 16)
    assert all(t.device.type == "meta" for t in sh.tree_leaves(caches))


# sha256 (first 16 hex digits) of Model(get_reduced(arch), "cpu", seed=7)'s
# state dict: the seeded CPU draws, as before the meta device was added
_SEEDED = {"granite-moe-1b-a400m": "042f784a34d1ee79",
           "zamba2-1.2b": "0bf16def86787fe7",
           "xlstm-350m": "54e490b8f485a60b",
           "tinyllama-1.1b": "4cc0ef7127f55321"}


@pytest.mark.parametrize("arch", list(_SEEDED))
def test_seeded_cpu_weights_are_unchanged(arch):
    for mesh in (None, make_host_mesh(1, 1, "cpu")):
        m = Model(get_reduced(arch), device="cpu", seed=7, mesh=mesh)
        h = hashlib.sha256()
        for n, p in m.state_dict().items():
            h.update(n.encode())
            h.update(p.contiguous().view(torch.uint8).numpy().tobytes())
        assert h.hexdigest()[:16] == _SEEDED[arch]
        meta = Model(get_reduced(arch), device="meta")
        assert {n: p.shape for n, p in meta.named_parameters()} == \
            {n: p.shape for n, p in m.named_parameters()}


def test_train_step_on_a_one_device_mesh_is_the_trainer_step():
    from repro_torch.data import SyntheticLMStream
    from repro_torch.runtime import Trainer, TrainerConfig

    cfg = get_reduced("granite-moe-1b-a400m")
    stream = SyntheticLMStream(vocab_size=cfg.vocab_size, batch_size=4,
                               seq_len=16, seed=3)
    opt = AdamWConfig(warmup_steps=2)
    for accum in (1, 2):
        tr = Trainer(cfg, opt, TrainerConfig(grad_accum=accum), stream,
                     device="cpu")
        state = tr.init_state(0)
        step = steps.build_step(cfg, make_host_mesh(1, 1, "cpu"),
                                dict(seq=16, batch=4, kind="train"),
                                opt_cfg=opt, grad_accum=accum, device="cpu")
        params = dict(step.model.named_parameters())
        ostate = init_opt_state(params)
        for i in range(2):
            batch = {k: torch.from_numpy(v)
                     for k, v in stream.batch_at(i).items()}
            want = tr.train_step(state, batch)
            params, ostate, got = step.fn(params, ostate, batch)
            assert set(got) == {"loss", "nll", "aux", "lr", "grad_norm"}
            for k in want:
                assert torch.equal(got[k], want[k]), k
        for n, p in params.items():
            assert torch.equal(p, state["params"][n]), n
        assert step.arg_specs["opt"]["m"].keys() == params.keys()


@torch.no_grad()
def test_prefill_and_decode_steps_are_the_model_entry_points():
    cfg = get_reduced("granite-moe-1b-a400m")
    mesh = make_host_mesh(1, 4, "cpu")
    pre = steps.build_step(cfg, mesh, dict(seq=12, batch=2, kind="prefill"),
                           device="cpu", seed=1)
    dec = steps.build_step(cfg, mesh, dict(seq=13, batch=2, kind="decode"),
                           model=pre.model)
    assert dec.model is pre.model and pre.model.cfg.moe.padded == 8
    assert dec.arg_specs["caches"][0].shape == (2, 2, 13, 2, 16)
    tok = torch.randint(0, cfg.vocab_size, (2, 12), dtype=torch.int32)
    logits, caches = pre.fn({"tokens": tok}, max_len=13)
    want, wc = pre.model.prefill(tokens=tok, max_len=13)
    assert torch.equal(logits, want)
    nxt = logits.argmax(-1).to(torch.int32)
    got, _ = dec.fn(caches, {"tokens": nxt}, 12)
    assert torch.equal(got, pre.model.decode_step(wc, tokens=nxt,
                                                  cache_pos=12)[0])
    with pytest.raises(ValueError, match="model="):
        steps.build_step(cfg, make_host_mesh(1, 2, "cpu"),
                         dict(seq=13, batch=2, kind="decode"),
                         model=pre.model)


@torch.no_grad()
def test_mrope_prefill_step_runs_the_forward():
    cfg = get_reduced("qwen2-vl-72b")
    step = steps.build_step(cfg, make_host_mesh(1, 1, "cpu"),
                            dict(seq=8, batch=2, kind="prefill"),
                            device="cpu")
    assert step.specs["caches"] is None and "positions" in \
        step.arg_specs["inputs"]
    emb = torch.randn(2, 8, cfg.d_model).to(torch.bfloat16)
    pos = torch.arange(8, dtype=torch.int32)[None, None].expand(3, 2, 8)
    logits, states = step.fn({"embeds": emb, "positions": pos})
    want, _, _ = step.model.forward(embeds=emb, positions=pos)
    assert torch.equal(logits, want[:, -1:])
