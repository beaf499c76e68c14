"""The port's LM stack (`repro_torch.models`) held against the JAX package's
`repro.models`, on the same seeded numpy inputs and the same parameters in
one process.

Per module: `rmsnorm`, `apply_rope`, `apply_mrope`, `mlp`,
`attention_full`, `attention_decode`, `mamba_chunked` (output, final SSM
state and conv tail, at S a multiple of the chunk and at S = chunk),
`mamba_decode`, and the plain `mamba_ssd(return_state=True)` against JAX
`mamba_chunked`'s final state. Whole model, for each reduced config of
the dense, parallel and zamba2 patterns, with the JAX `Model.init`
parameters carried by `from_jax_params`: `forward` logits and states,
`prefill` logits and caches, and a `decode_step`'s logits and caches; and
the port's own prefill/decode consistency (tests/test_archs_smoke.py's
check), and chip_smoke.py's consistency readings (caches and logits), which
each planted fault (a k/v slot, a lost SSM or mLSTM state, a rotation, a
conv tail not advanced, an sLSTM hidden state not carried) must fail. The
same for the moe (granite-moe, `forward`'s aux loss too) and xlstm
patterns, whose modules tests/test_torch_models_moe_xlstm.py holds. On the
CPU every kernel wrapper runs its plain version, and nothing launches.

Tolerances (float32 throughout): TOL = 1e-5 (atol and rtol) for one layer
(sums of at most a few hundred products in another order: a few float32
ulps); LOGIT_TOL = 1e-4 for a whole model (up to five layers and a head,
logits up to ~53 in size, whose ulp is 4e-6: the largest difference seen
was 2e-5); 2e-3 for the prefill/decode consistency, as the JAX suite's.
"""
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models import Model as JaxModel
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import mamba as jmamba
from repro_torch import kernels
from repro_torch.configs import get_reduced
from repro_torch.models import Model, from_jax_params
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import mamba as tmamba
from repro_torch.models import blocks as tblocks
from repro_torch.models.mamba import MambaState

# one intra-op thread per test process: the suite runs in parallel workers
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-5
LOGIT_TOL = 1e-4
CONSISTENCY_TOL = 2e-3
ARCHS = ["glm4-9b", "internlm2-20b", "tinyllama-1.1b", "command-r-35b",
         "zamba2-1.2b", "qwen2-vl-72b", "musicgen-large",
         "granite-moe-1b-a400m", "granite-moe-3b-a800m", "xlstm-350m"]


@pytest.fixture(autouse=True)
def no_kernel_launch():
    """On the CPU the wrappers take their plain versions: nothing
    launches."""
    kernels.reset_launches()
    yield
    assert kernels.launches() == {k: 0 for k in kernels.KERNELS}


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL, scale=False):
    """got (torch) against want (JAX / numpy) within tol (atol and rtol),
    the atol scaled by max|want| where `scale`."""
    want = np.asarray(want)
    atol = tol * (np.abs(want).max() if scale else 1.0)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=tol,
                               atol=atol)


def _load(module, params):
    """A port module with the JAX sub-pytree `params` loaded into it."""
    sd = {k: _t(v) for k, v in _flat(params)}
    module.load_state_dict(sd, strict=True)
    return module


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _gen():
    return torch.Generator().manual_seed(0)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 48)).astype(np.float32) * 3
    scale = rng.normal(size=(48,)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jlayers.rmsnorm(jnp.asarray(x, jd), jnp.asarray(scale, jd), 1e-5)
    got = tlayers.rmsnorm(_t(x).to(td), _t(scale).to(td), 1e-5)
    assert got.dtype == td
    # bf16: both compute in float32 and round once; allow one bf16 ulp
    tol = TOL if dtype == "float32" else 2.0 ** -7
    _close(got.float(), np.asarray(want, np.float32), tol)


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_apply_rope(theta):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 6, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 4096, size=(2, 6)).astype(np.int32)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tlayers.apply_rope(_t(x), _t(pos), theta)
    # angles up to 4096 rad in float32: sin/cos of one float32 argument
    # in two libraries differ by an ulp of the result
    _close(got, want, TOL)


@pytest.mark.parametrize("hd,sections", [(32, (4, 6, 6)), (16, (4, 6, 6)),
                                         (128, (16, 24, 24))])
def test_apply_mrope(hd, sections):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 3, hd)).astype(np.float32)
    pos3 = rng.integers(0, 300, size=(3, 2, 5)).astype(np.int32)
    want = jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), 10_000.0,
                               sections)
    got = tlayers.apply_mrope(_t(x), _t(pos3), 10_000.0, sections)
    _close(got, want, TOL)
    # text tokens (one id in all three streams): M-RoPE == RoPE
    same = np.broadcast_to(pos3[:1], pos3.shape).copy()
    _close(tlayers.apply_mrope(_t(x), _t(same), 10_000.0, sections),
           np.asarray(jlayers.apply_rope(jnp.asarray(x),
                                         jnp.asarray(same[0]), 10_000.0)),
           TOL)


def test_mlp():
    p = jlayers.init_mlp(jax.random.PRNGKey(3), 32, 80, jnp.float32)
    x = np.random.default_rng(3).normal(size=(2, 7, 32)).astype(np.float32)
    want = jlayers.mlp(p, jnp.asarray(x))
    m = _load(tlayers.MLP(32, 80, torch.float32, "cpu", _gen()), p)
    _close(tlayers.mlp(m, _t(x)), want, TOL)


def test_embed_unembed():
    rng = np.random.default_rng(4)
    table = rng.normal(size=(50, 16)).astype(np.float32)
    ids = rng.integers(0, 50, size=(2, 9)).astype(np.int32)
    x = rng.normal(size=(2, 9, 16)).astype(np.float32)
    head = rng.normal(size=(16, 50)).astype(np.float32)
    _close(tlayers.embed(_t(table), _t(ids)),
           jlayers.embed(jnp.asarray(table), jnp.asarray(ids)), 0.0)
    for tied, w in ((True, table), (False, head)):
        _close(tlayers.unembed(_t(w), _t(x), tied),
               jlayers.unembed(jnp.asarray(w), jnp.asarray(x), tied), TOL)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
ATTN_ARCHS = ["tinyllama-1.1b", "glm4-9b", "qwen2-vl-72b", "musicgen-large",
              "command-r-35b"]


def _attn_case(arch, S, seed):
    """The reduced config's attention with JAX parameters (bias made
    non-zero), an input and its default positions, as numpy."""
    cfg = get_reduced(arch)
    p = jattn.init_attention(jax.random.PRNGKey(seed), jax_reduced(arch),
                             jnp.float32)
    rng = np.random.default_rng(seed)
    p = {k: (rng.normal(size=v.shape).astype(np.float32) * 0.1
             if k.startswith("b") else np.asarray(v)) for k, v in p.items()}
    x = rng.normal(size=(2, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S)).copy()
    if cfg.rope_kind == "mrope":  # distinct streams: a vision-like grid
        pos = np.stack([pos, pos // 3, pos % 3]).astype(np.int32)
    m = _load(tattn.init_attention(cfg, torch.float32, "cpu", _gen()), p)
    return cfg, p, m, x, pos


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_attention_full(arch):
    cfg, p, m, x, pos = _attn_case(arch, 12, 5)
    want, (wk, wv) = jattn.attention_full(p, jax_reduced(arch),
                                          jnp.asarray(x), jnp.asarray(pos))
    got, (k, v) = tattn.attention_full(m, cfg, _t(x), _t(pos))
    _close(got, want, TOL)
    _close(k, wk, TOL)
    _close(v, wv, TOL)


@pytest.mark.parametrize("cache_pos", [0, 5, 15])
@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_attention_decode(arch, cache_pos):
    cfg, p, m, x, _ = _attn_case(arch, 1, 6)
    T = 16
    rng = np.random.default_rng(7)
    ck, cv = (rng.normal(size=(2, T, cfg.n_kv_heads, cfg.head_dim)).astype(
        np.float32) for _ in range(2))
    pos = np.full((2, 1), cache_pos, np.int32)
    if cfg.rope_kind == "mrope":
        pos = np.broadcast_to(pos, (3, 2, 1)).copy()
    want, (wk, wv) = jattn.attention_decode(
        p, jax_reduced(arch), jnp.asarray(x), jnp.asarray(ck),
        jnp.asarray(cv), cache_pos, jnp.asarray(pos))
    tk, tv = _t(ck), _t(cv)
    got, (k, v) = tattn.attention_decode(m, cfg, _t(x), tk, tv, cache_pos,
                                         _t(pos))
    assert k is tk and v is tv  # written in place
    _close(got, want, TOL)
    _close(k, wk, TOL)
    _close(v, wv, TOL)


# ---------------------------------------------------------------------------
# mamba
# ---------------------------------------------------------------------------
def _mamba_case(S, seed):
    cfg = get_reduced("zamba2-1.2b")
    p = jmamba.init_mamba(jax.random.PRNGKey(seed), jax_reduced(
        "zamba2-1.2b"), jnp.float32)
    rng = np.random.default_rng(seed)
    # a spread of decays and skips, as trained weights have
    p = dict(p, A_log=rng.uniform(-1, 1, size=p["A_log"].shape).astype(
        np.float32), D=rng.normal(size=p["D"].shape).astype(np.float32),
        dt_bias=rng.uniform(-2, 0, size=p["dt_bias"].shape).astype(
            np.float32))
    p = {k: np.asarray(v) for k, v in p.items()}
    x = rng.normal(size=(2, S, cfg.d_model)).astype(np.float32)
    m = _load(tmamba.init_mamba(cfg, torch.float32, "cpu", _gen()), p)
    return cfg, p, m, x


@pytest.mark.parametrize("S", [8, 16, 32], ids=lambda s: f"S{s}")
def test_mamba_chunked(S):
    """chunk 8: S = chunk (one chunk) and multiples of it."""
    cfg, p, m, x = _mamba_case(S, 8)
    want, wstate = jmamba.mamba_chunked(p, jax_reduced("zamba2-1.2b"),
                                        jnp.asarray(x))
    got, state = tmamba.mamba_chunked(m, cfg, _t(x))
    assert isinstance(state, MambaState) and state.ssm.dtype == torch.float32
    _close(got, want, TOL)
    _close(state.ssm, wstate.ssm, TOL)
    _close(state.conv, wstate.conv, TOL)


def test_mamba_decode():
    cfg, p, m, x = _mamba_case(1, 9)
    s, d_in, nh, conv_ch = tmamba._dims(cfg)
    rng = np.random.default_rng(10)
    conv = rng.normal(size=(2, s.d_conv - 1, conv_ch)).astype(np.float32)
    ssm = rng.normal(size=(2, nh, s.head_dim, s.d_state)).astype(np.float32)
    want, wstate = jmamba.mamba_decode(
        p, jax_reduced("zamba2-1.2b"), jnp.asarray(x),
        jmamba.MambaState(conv=jnp.asarray(conv), ssm=jnp.asarray(ssm)))
    got, state = tmamba.mamba_decode(m, cfg, _t(x),
                                     MambaState(_t(conv), _t(ssm)))
    _close(got, want, TOL)
    _close(state.ssm, wstate.ssm, TOL)
    _close(state.conv, wstate.conv, TOL)


@pytest.mark.parametrize("S", [8, 24])
def test_mamba_ssd_final_state_matches_jax(S):
    """The plain `mamba_ssd(return_state=True)` fed from the reduced
    zamba2 layer's own projections: its state after the last step is JAX
    `mamba_chunked`'s h_last, and its y the scan's share of the output."""
    cfg, p, m, x = _mamba_case(S, 11)
    jcfg = jax_reduced("zamba2-1.2b")
    s, d_in, nh, _ = jmamba._dims(jcfg)
    _, xbc, dt = jmamba._split_proj(p, jcfg, jnp.asarray(x))
    xbc, _ = jmamba._causal_conv(xbc, p["conv_w"], p["conv_b"], None)
    xs = np.asarray(xbc[..., :d_in]).reshape(2, S, nh, s.head_dim)
    Bc = np.asarray(xbc[..., d_in:d_in + s.d_state])
    Cc = np.asarray(xbc[..., d_in + s.d_state:])
    A = -np.exp(p["A_log"])
    y, h = kernels.mamba_ssd(_t(xs), _t(dt), _t(A), _t(Bc), _t(Cc),
                             chunk=s.chunk, return_state=True)
    assert h.shape == (2, nh, s.head_dim, s.d_state) and \
        h.dtype == torch.float32
    _, wstate = jmamba.mamba_chunked(p, jcfg, jnp.asarray(x))
    _close(h, wstate.ssm, TOL)
    y_only = kernels.mamba_ssd(_t(xs), _t(dt), _t(A), _t(Bc), _t(Cc),
                               chunk=s.chunk)
    assert torch.equal(y, y_only)


# ---------------------------------------------------------------------------
# whole model
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _models(arch):
    """(JAX model, its params, the port model with those params)."""
    jm = JaxModel(jax_reduced(arch))
    params = jm.init(seed=3)
    cfg = get_reduced(arch)
    m = Model(cfg, device="cpu")
    m.load_state_dict(from_jax_params(cfg, jax.tree.map(np.asarray, params),
                                      "cpu"), strict=True)
    return jm, params, m


def _inputs(cfg, B=2, S=16, seed=3):
    """tests/test_archs_smoke.py's inputs: token ids, or (modality stub)
    embeddings; qwen2-vl's (3, B, S) positions as a vision-like grid."""
    rng = np.random.default_rng(seed)
    if cfg.modality_stub:
        kw = {"embeds": (rng.normal(size=(B, S, cfg.d_model)) * 0.3).astype(
            np.float32)}
    else:
        kw = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)}
    return kw


def _jx(kw):
    return {k: jnp.asarray(v) for k, v in kw.items()}


def _pt(kw):
    return {k: _t(v) for k, v in kw.items()}


def _same_tree(got, want, tol):
    g, w = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a, b, tol, scale=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_from_jax_params_carries_every_leaf(arch):
    jm, params, m = _models(arch)
    assert m.param_count() == jm.param_count(params)
    sd = m.state_dict()
    for name, a in _flat(params):
        top, _, rest = name.partition(".")
        if top == "mlstm":  # (units, layers of a unit, ...)
            got = torch.stack([torch.stack([sd[f"{top}.{i}.{j}.{rest}"]
                                            for j in range(a.shape[1])])
                               for i in range(a.shape[0])])
        elif top in ("blocks", "mamba", "slstm"):
            got = torch.stack([sd[f"{top}.{i}.{rest}"]
                               for i in range(a.shape[0])])
        else:
            got = sd[name]
        assert torch.equal(got, _t(a)), name


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    jm, params, m = _models(arch)
    kw = _inputs(m.cfg)
    pos = None
    if m.cfg.rope_kind == "mrope":
        S = 16
        p = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S))
        pos = np.stack([p, p // 4, p % 4]).astype(np.int32)
    want, wstates, waux = jm.forward(params, **_jx(kw), positions=None
                                     if pos is None else jnp.asarray(pos))
    got, states, aux = m.forward(**_pt(kw), positions=None
                                 if pos is None else _t(pos))
    assert got.shape == (2, 16, m.cfg.vocab_size)
    assert (float(aux) > 0) == (m.cfg.pattern == "moe")
    _close(aux, waux, LOGIT_TOL)
    _close(got, want, LOGIT_TOL, scale=True)
    _same_tree(states, wstates, LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    jm, params, m = _models(arch)
    kw = _inputs(m.cfg, S=16)
    last = {k: v[:, -1:] for k, v in kw.items()}
    # the chunked scans take a multiple of the chunk (8)
    first = {k: v[:, :-1] for k, v in kw.items()} if m.cfg.pattern not in \
        ("zamba2", "xlstm") else {k: v[:, :8] for k, v in kw.items()}
    S = next(iter(first.values())).shape[1]
    want, wcaches = jm.prefill(params, **_jx(first), max_len=24)
    got, caches = m.prefill(**_pt(first), max_len=24)
    assert got.shape == (2, 1, m.cfg.vocab_size)
    _close(got, want, LOGIT_TOL, scale=True)
    _same_tree(caches, wcaches, LOGIT_TOL)
    want, wcaches = jm.decode_step(params, wcaches, **_jx(last),
                                   cache_pos=S)
    got, new = m.decode_step(caches, **_pt(last), cache_pos=S)
    assert new is caches  # written in place
    _close(got, want, LOGIT_TOL, scale=True)
    _same_tree(caches, wcaches, LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency(arch):
    """tests/test_archs_smoke.py::test_prefill_decode_consistency on the
    port: decode with prefilled caches reproduces teacher-forced logits."""
    _, _, m = _models(arch)
    S = 8
    kw = _pt(_inputs(m.cfg, S=S, seed=4))
    full, _, _ = m.forward(**kw)
    _, caches = m.prefill(**{k: v[:, :S - 1] for k, v in kw.items()},
                          max_len=S + 4)
    step, _ = m.decode_step(caches, **{k: v[:, S - 1:] for k, v in
                                       kw.items()}, cache_pos=S - 1)
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, -1].numpy(),
                               atol=CONSISTENCY_TOL, rtol=CONSISTENCY_TOL)


def _plant(m, fault, monkeypatch):
    """Plant one of chip_smoke.py's LM_FAULTS in the decode path: "slot"
    moves the k/v just written one slot early (the new slot left zero),
    "rope" rotates decode one position too far, "conv" leaves the mLSTM
    conv tail where the prefill put it, "carry" feeds every sLSTM step a
    zero hidden state. ("state" zeroes a prefill state; the caller does
    that.)"""
    if fault == "slot":
        plain = kernels.decode_attention

        def early(q, k, v, length):
            for c in (k, v):
                c[:, length - 2] = c[:, length - 1]
                c[:, length - 1] = 0
            return plain(q, k, v, length=length)
        monkeypatch.setattr(kernels, "decode_attention", early)
    elif fault == "rope":
        monkeypatch.setattr(
            m, "_default_positions",
            lambda b, s, offset=0: Model._default_positions(m, b, s,
                                                            offset + 1))
    elif fault == "conv":
        plain_m = tblocks.mlstm_decode

        def frozen(params, cfg, x, state, tail):
            out, state, _ = plain_m(params, cfg, x, state, tail)
            return out, state, tail
        monkeypatch.setattr(tblocks, "mlstm_decode", frozen)
    elif fault == "carry":
        plain_s = tblocks.slstm_decode

        def forgetful(params, cfg, x, st):
            return plain_s(params, cfg, x, st._replace(
                h=torch.zeros_like(st.h)))
        monkeypatch.setattr(tblocks, "slstm_decode", forgetful)


def _cache_leaves(c):
    if isinstance(c, dict) and "mlstm" in c:
        (ms, tail), sl = c["mlstm"], c["slstm"]
        return [("C", ms.C), ("n", ms.n), ("m", ms.m), ("conv", tail),
                ("c", sl.c), ("sn", sl.n), ("sm", sl.m), ("h", sl.h)]
    if isinstance(c, dict):
        return [("conv", c["mamba"].conv), ("ssm", c["mamba"].ssm),
                ("k", c["attn"][0]), ("v", c["attn"][1])]
    return [("k", c[0]), ("v", c[1])]


def _decode_pairs(got, want):
    """check 2's decode readings: the k/v caches; for xlstm the recurrent
    states, C / n and c / n put on the reference's stabilizer (m is the
    log of their scale: the same state under another m reads the same)."""
    if not (isinstance(got, dict) and "mlstm" in got):
        return [(g, w) for (n, g), (_, w) in zip(_cache_leaves(got),
                                                 _cache_leaves(want))
                if n in ("k", "v")]
    (ms, tail), (rs, rtail) = got["mlstm"], want["mlstm"]
    sl, rl = got["slstm"], want["slstm"]
    a = torch.exp(ms.m - rs.m)
    b = torch.exp(sl.m - rl.m)
    return [(ms.C * a[..., None, None], rs.C), (ms.n * a[..., None], rs.n),
            (tail, rtail), (sl.c * b, rl.c), (sl.n * b, rl.n),
            (sl.h, rl.h)]


def _share(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _consistency(m, kw, split, fault=None, monkeypatch=None):
    """chip_smoke.py's check 2 at a small size, as shares of max|ref|: a
    `split`-token prefill's caches against `forward`'s states on those
    tokens, then the rest decoded teacher-forced: the last logits against
    a whole prefill's, and the decode caches (`_decode_pairs`) against that
    prefill's."""
    S = next(iter(kw.values())).shape[1]
    head = {k: v[:, :split] for k, v in kw.items()}
    _, states, _ = m.forward(**head)
    want, want_caches = m.prefill(**kw, max_len=S + 4)
    _, caches = m.prefill(**head, max_len=S + 4)
    if fault == "state":
        if m.cfg.pattern == "zamba2":
            caches["mamba"].ssm[m.cfg.n_layers // 2].zero_()
        else:
            caches["mlstm"][0].C[m.units // 2].zero_()
    out = {"prefill_caches": max(
        _share(got[:, :, :split] if n in "kv" else got, ref)
        for (n, got), (_, ref) in zip(_cache_leaves(caches),
                                      _cache_leaves(states)))}
    if fault in ("slot", "rope", "conv", "carry"):
        _plant(m, fault, monkeypatch)
    for i in range(split, S):
        step, caches = m.decode_step(
            caches, **{k: v[:, i:i + 1] for k, v in kw.items()},
            cache_pos=i)
    out["logits"] = _share(step, want)
    out["decode_caches"] = max(_share(g, w)
                               for g, w in _decode_pairs(caches, want_caches))
    return out


def _faults(arch):
    """The planted faults that an arch's caches have."""
    cfg = get_reduced(arch)
    if cfg.pattern == "xlstm":
        return ("state", "conv", "carry")
    return ("slot", "rope", "state") if cfg.pattern == "zamba2" else (
        ("slot",) if cfg.rope_kind == "none" else ("slot", "rope"))


FAULT_CASES = [(a, f) for a in ARCHS for f in _faults(a)]


@pytest.mark.parametrize("arch,fault", FAULT_CASES)
def test_consistency_check_sees_planted_fault(arch, fault, monkeypatch):
    """chip_smoke.py's check 2 (prefill caches, last logits, decode
    caches) reads within CONSISTENCY_TOL of max|ref| on the port, and
    beyond it with each planted fault: k/v written one slot early, a
    prefill state lost, decode rotated one position too far, the mLSTM
    conv tail not advanced, the sLSTM hidden state not carried."""
    _, _, m = _models(arch)
    kw = _pt(_inputs(m.cfg, S=8, seed=4))
    clean = _consistency(m, kw, 4)
    assert max(clean.values()) <= CONSISTENCY_TOL, clean
    got = _consistency(m, kw, 4, fault, monkeypatch)
    assert max(got.values()) > CONSISTENCY_TOL, got


def test_port_models_import_neither_jax_nor_repro():
    """The model stack and the launchers, as the rest of the port, import
    neither jax nor the JAX package."""
    code = (
        "import sys, pkgutil, importlib\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'repro.')) or m == 'repro')\n"
        "assert not bad, bad\n"
        "print(' '.join(m for m in sys.modules "
        "if m.startswith('repro_torch')))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    assert {"repro_torch.models.layers", "repro_torch.models.attention",
            "repro_torch.models.mamba", "repro_torch.models.moe",
            "repro_torch.models.xlstm", "repro_torch.models.blocks",
            "repro_torch.models.model", "repro_torch.launch.specs",
            "repro_torch.launch.serve"} <= set(out.stdout.split())
