"""The port's MoE and xLSTM modules (`repro_torch.models.moe`,
`repro_torch.models.xlstm`) held against the JAX package's, on the same
seeded numpy inputs and the same parameters in one process (float32).

MoE: `_route` (top_i exactly, the gates, the switch aux loss; padded
experts never chosen), `moe_block` under each dispatch engine ("tdorch",
"push", "pull", "dense"), with a capacity that drops nothing and with one
that drops, and in bf16 under each engine (its mesh branches are in
tests/test_torch_moe_mesh.py).
xLSTM: `mlstm_chunked` (output, final C / n / m, conv tail) at S = chunk
and at multiples of it, `mlstm_decode`, `slstm_forward` and
`slstm_decode`; the chunked scan and
the sLSTM loop finite in float32 and bf16 with stabilizers that start at
−inf. The whole models (granite-moe and xlstm reduced configs) are in
tests/test_torch_models.py.

Tolerance TOL = 1e-5 (atol and rtol) for one layer, as that file's: float32
sums of at most a few hundred products in another order. On the CPU every
kernel wrapper runs its plain version, and nothing launches.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models import moe as jmoe
from repro.models import xlstm as jxlstm
from repro_torch import kernels
from repro_torch.configs import get_reduced
from repro_torch.models import moe as tmoe
from repro_torch.models import xlstm as txlstm
from repro_torch.models.xlstm import MLSTMState, SLSTMState

# one intra-op thread per test process: the suite runs in parallel workers
torch.set_num_threads(1)

TOL = 1e-5
MOE_ARCHS = ["granite-moe-1b-a400m", "granite-moe-3b-a800m"]
DISPATCHES = ["tdorch", "push", "pull", "dense"]


@pytest.fixture(autouse=True)
def no_kernel_launch():
    kernels.reset_launches()
    yield
    assert kernels.launches() == {k: 0 for k in kernels.KERNELS}


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def _load(module, params):
    module.load_state_dict({k: _t(v) for k, v in params.items()},
                           strict=True)
    return module


def _gen():
    return torch.Generator().manual_seed(0)


def _both(arch, **moe):
    """The JAX and port configs of `arch`, its MoE config replaced."""
    jc, tc = jax_reduced(arch), get_reduced(arch)
    if moe:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe, **moe))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, **moe))
    return jc, tc


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------
def _moe_case(arch, seed, T=48, **moe):
    jc, tc = _both(arch, **moe)
    p = {k: np.asarray(v) for k, v in jmoe.init_moe(
        jax.random.PRNGKey(seed), jc, jnp.float32).items()}
    m = _load(tmoe.init_moe(tc, torch.float32, "cpu", _gen()), p)
    x = np.random.default_rng(seed).normal(size=(T, tc.d_model)).astype(
        np.float32)
    return jc, tc, p, m, x


@pytest.mark.parametrize("padded", [None, 11])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_route_matches_jax(arch, padded):
    """Exact expert choices (the padded experts never among them), gates
    and aux within TOL."""
    jc, tc, p, m, x = _moe_case(arch, 1, num_experts_padded=padded)
    assert m.router.dtype == torch.float32
    wi, wg, wa = jmoe._route(p, jc, jnp.asarray(x))
    ti, tg, ta = tmoe._route(m, tc, _t(x))
    assert ti.dtype == torch.int32 and tg.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(wi))
    assert int(ti.max()) < tc.moe.num_experts
    _close(tg, wg)
    _close(ta, wa)


def test_route_breaks_ties_to_the_lower_expert():
    """Equal probabilities (a router of zeros): experts 0..k-1, in order,
    as `lax.top_k` picks them."""
    jc, tc, p, m, x = _moe_case("granite-moe-1b-a400m", 2)
    with torch.no_grad():
        m.router.zero_()
    p = dict(p, router=np.zeros_like(p["router"]))
    ti, tg, _ = tmoe._route(m, tc, _t(x))
    wi, _, _ = jmoe._route(p, jc, jnp.asarray(x))
    k = tc.moe.top_k
    assert (ti.numpy() == np.arange(k)).all()
    np.testing.assert_array_equal(ti.numpy(), np.asarray(wi))
    _close(tg, np.full(tg.shape, 1.0 / k, np.float32))


@pytest.mark.parametrize("capacity", [2.0, 0.25], ids=["no-drops", "drops"])
@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_block_matches_jax(arch, dispatch, capacity):
    """Each dispatch engine on one device: (y, aux) within TOL of the JAX
    block's; at capacity factor 0.25 the push engines drop assignments as
    the JAX package's do."""
    jc, tc, p, m, x = _moe_case(arch, 3, dispatch=dispatch,
                                capacity_factor=capacity)
    x3 = x.reshape(2, 24, tc.d_model)
    want, waux = jmoe.moe_block(p, jc, jnp.asarray(x3))
    got, aux = tmoe.moe_block(m, tc, _t(x3))
    assert got.shape == x3.shape and got.dtype == torch.float32
    _close(got, want)
    _close(aux, waux)


@pytest.mark.parametrize("dispatch", DISPATCHES)
@torch.no_grad()
def test_moe_block_runs_in_bf16(dispatch):
    """Each dispatch engine in bf16 on one device keeps bf16 activations
    and gates end to end (the grouped GEMM's plain version rounds its
    float32 sums once) and lands within bf16 roundings of the float32
    block on the same bf16-rounded inputs and weights (so both route
    alike: the router reads x in float32): 2^-8 of max|y| per rounding, a
    few of them (the SwiGLU's two GEMMs, the activation, the gates and the
    combine)."""
    _, tc, _, m, x = _moe_case("granite-moe-3b-a800m", 5, dispatch=dispatch)
    for name in ("w_in", "w_out"):
        getattr(m, name).copy_(getattr(m, name).to(torch.bfloat16))
    xb = _t(x).reshape(2, 24, tc.d_model).to(torch.bfloat16)
    want, want_aux = tmoe.moe_block(m, tc, xb.float())
    mb = tmoe.init_moe(tc, torch.bfloat16, "cpu", _gen())
    mb.load_state_dict({k: v.to(getattr(mb, k).dtype)
                        for k, v in m.state_dict().items()})
    assert mb.router.dtype == torch.float32
    got, aux = tmoe.moe_block(mb, tc, xb)
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    assert float((got.float() - want).abs().max()) <= \
        8 * 2.0 ** -8 * float(want.abs().max())
    _close(aux, want_aux.numpy())


# ---------------------------------------------------------------------------
# xLSTM
# ---------------------------------------------------------------------------
def _mlstm_case(S, seed, B=2):
    jc, tc = jax_reduced("xlstm-350m"), get_reduced("xlstm-350m")
    p = jxlstm.init_mlstm(jax.random.PRNGKey(seed), jc, jnp.float32)
    rng = np.random.default_rng(seed)
    # input and forget biases spread, as trained weights have them
    nh = tc.n_heads
    p = {k: np.asarray(v) for k, v in p.items()}
    p["b_gates"] = np.concatenate([rng.normal(size=nh) * 2,
                                   rng.uniform(-1, 4, size=nh)]).astype(
        np.float32)
    p["conv_b"] = (rng.normal(size=p["conv_b"].shape) * 0.1).astype(
        np.float32)
    m = _load(txlstm.init_mlstm(tc, torch.float32, "cpu", _gen()), p)
    x = rng.normal(size=(B, S, tc.d_model)).astype(np.float32)
    return jc, tc, p, m, x


def _same_state(got, want, tol=TOL):
    for a, b in zip(got, want):
        assert tuple(a.shape) == tuple(np.shape(b))
        _close(a, b, tol)


@pytest.mark.parametrize("S", [8, 16, 40], ids=lambda s: f"S{s}")
def test_mlstm_chunked(S):
    """chunk 8: S = chunk (one chunk) and multiples of it."""
    jc, tc, p, m, x = _mlstm_case(S, 6)
    want, (wstate, wtail) = jxlstm.mlstm_chunked(p, jc, jnp.asarray(x))
    got, (state, tail) = txlstm.mlstm_chunked(m, tc, _t(x))
    assert isinstance(state, MLSTMState)
    assert all(t.dtype == torch.float32 for t in state)
    _close(got, want)
    _same_state(state, wstate)
    _close(tail, wtail)


def test_mlstm_chunked_refuses_a_ragged_sequence():
    _, tc, _, m, x = _mlstm_case(12, 7)
    with pytest.raises(ValueError, match="chunk"):
        txlstm.mlstm_chunked(m, tc, _t(x))


@pytest.mark.parametrize("m0", ["zero", "random"])
def test_mlstm_decode(m0):
    """From init_caches' zero stabilizer and from a random state."""
    jc, tc, p, m, x = _mlstm_case(1, 8)
    d_up, nh, hd = txlstm.mlstm_dims(tc)
    rng = np.random.default_rng(9)
    C = rng.normal(size=(2, nh, hd, hd)).astype(np.float32)
    n = rng.normal(size=(2, nh, hd)).astype(np.float32)
    mm = (np.zeros((2, nh)) if m0 == "zero"
          else rng.normal(size=(2, nh)) * 2).astype(np.float32)
    tail = rng.normal(size=(2, 3, d_up)).astype(np.float32)
    want, wstate, wtail = jxlstm.mlstm_decode(
        p, jc, jnp.asarray(x), jxlstm.MLSTMState(*map(jnp.asarray,
                                                      (C, n, mm))),
        jnp.asarray(tail))
    got, state, new_tail = txlstm.mlstm_decode(
        m, tc, _t(x), MLSTMState(_t(C), _t(n), _t(mm)), _t(tail))
    _close(got, want)
    _same_state(state, wstate)
    _close(new_tail, wtail)


def test_mlstm_decode_continues_the_chunked_scan():
    """A prefill of 16 then 8 decode steps against the chunked scan over
    all 24: the last output within 2e-4 (the JAX suite's consistency
    scale, float32 sums in two orders)."""
    _, tc, _, m, x = _mlstm_case(24, 10)
    full, _ = txlstm.mlstm_chunked(m, tc, _t(x))
    _, (state, tail) = txlstm.mlstm_chunked(m, tc, _t(x[:, :16]))
    for i in range(16, 24):
        out, state, tail = txlstm.mlstm_decode(m, tc, _t(x[:, i:i + 1]),
                                               state, tail)
    _close(out[:, 0], full[:, -1].detach().numpy(), 2e-4)


def _slstm_case(S, seed, B=2):
    jc, tc = jax_reduced("xlstm-350m"), get_reduced("xlstm-350m")
    p = {k: np.asarray(v) for k, v in jxlstm.init_slstm(
        jax.random.PRNGKey(seed), jc, jnp.float32).items()}
    rng = np.random.default_rng(seed)
    p["b"] = (p["b"] + rng.normal(size=p["b"].shape)).astype(np.float32)
    m = _load(txlstm.init_slstm(tc, torch.float32, "cpu", _gen()), p)
    x = rng.normal(size=(B, S, tc.d_model)).astype(np.float32)
    return jc, tc, p, m, x


@pytest.mark.parametrize("S", [1, 9, 32])
def test_slstm_forward(S):
    jc, tc, p, m, x = _slstm_case(S, 11)
    want, wstate = jxlstm.slstm_forward(p, jc, jnp.asarray(x))
    got, state = txlstm.slstm_forward(m, tc, _t(x))
    assert isinstance(state, SLSTMState)
    _close(got, want)
    _same_state(state, wstate)


@pytest.mark.parametrize("m0", ["zero", "random"])
def test_slstm_decode(m0):
    jc, tc, p, m, x = _slstm_case(1, 12)
    rng = np.random.default_rng(13)
    d = tc.d_model
    c, n, h = (rng.normal(size=(2, d)).astype(np.float32) for _ in range(3))
    n = np.abs(n)
    mm = (np.zeros((2, d)) if m0 == "zero"
          else rng.normal(size=(2, d))).astype(np.float32)
    want, wstate = jxlstm.slstm_decode(
        p, jc, jnp.asarray(x), jxlstm.SLSTMState(*map(jnp.asarray,
                                                      (c, n, mm, h))))
    got, state = txlstm.slstm_decode(
        m, tc, _t(x), SLSTMState(*map(_t, (c, n, mm, h))))
    _close(got, want)
    _same_state(state, wstate)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stabilizers_from_minus_inf_stay_finite(dtype):
    """The chunked scan and the sLSTM loop start their stabilizers at −inf
    (and the first chunk carries a zero memory): no −inf − (−inf) reaches
    an exp, in float32 and bf16, even with forget gates near 0 and 1."""
    _, tc, p, m, x = _mlstm_case(24, 14)
    _, _, ps, s, _ = _slstm_case(1, 14)
    with torch.no_grad():
        m.b_gates[tc.n_heads:] = torch.tensor([-30.0, 30.0, 0.0, 5.0])
        s.b[3 * tc.d_model:] = 30.0
        m.to(dtype)
        s.to(dtype)
        m.b_gates.data = m.b_gates.float()
        s.b.data, s.r.data = s.b.float(), s.r.float()
    xs = _t(x).to(dtype)
    out, (state, tail) = txlstm.mlstm_chunked(m, tc, xs)
    y, st = txlstm.slstm_forward(s, tc, xs)
    for t in (out, *state, tail, y, *st):
        assert bool(torch.isfinite(t).all())
    assert out.dtype == dtype and state.C.dtype == torch.float32
