"""The backward of the port's SSD scan (`kernels/mamba_scan`): the plain
reverse pass `ssd_scan_bwd_ref` and `mamba_ssd` as a
`torch.autograd.Function`, on the CPU.

- `ssd_scan_bwd_ref` against `torch.autograd` of `ssd_scan_ref` in float64,
  within 1e-10·(1 + |ref|): dh_final given and not, chunk = S, several
  chunks, a chunk the card runs otherwise (`kernel_chunk`), decays that
  underflow (no NaN); its `terms=True` run bounds every gradient, and
  `dA_steps=True`'s parts sum to dA and to its Σ|terms|.
- The port's Mamba layer (`models/mamba.mamba_chunked`, the scan through the
  Function) against `jax.vjp` of the JAX package's `mamba_chunked` on
  zamba2's reduced config, weights carried across, within
  tests/test_torch_train_loss.py's GRAD_TOL (1e-4 of each gradient's
  max|ref|, + rtol 1e-4).
- `Model.loss_fn` for zamba2 reaches `ssd_scan_bwd_ref` once a layer, and
  the scan keeps for its backward its inputs and the chunk states only.
- `ops.bwd_route`, which picks the backward's kernels from shapes and
  addresses alone: zamba2's training shape and chip_smoke.py's aligned
  SSD_BWD_PARITY shapes take "sm90", ds 3 (hd 5), ds 6 and an x off 16
  bytes take "mma".

On the CPU nothing launches; the kernels (`csrc/mamba_scan_bwd_sm90.cu`,
and `csrc/mamba_scan_bwd.cu` for operands TMA cannot describe) are held to
this reverse pass on the card by chip_smoke.py and
tests/test_torch_cuda_kernels.py, and their arithmetic, emulated, by
tests/test_torch_ssd_emulation.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models import mamba as jmamba
from repro_torch import kernels
from repro_torch.configs import get_reduced
from repro_torch.data import SyntheticLMStream
from repro_torch.kernels import mamba_ssd
from repro_torch.kernels.mamba_scan import ops
from repro_torch.kernels.mamba_scan.ref import ssd_scan_bwd_ref, ssd_scan_ref
from repro_torch.models import Model
from repro_torch.models import mamba as tmamba

# one intra-op thread per test process: the suite runs in parallel workers
torch.set_num_threads(1)

REF_TOL = 1e-10
GRAD_TOL = 1e-4  # tests/test_torch_train_loss.py's
# (S, nh, hd, ds, chunk, dh_final given)
BWD_CASES = [(24, 3, 5, 4, 8, True), (24, 3, 5, 4, 8, False),
             (16, 2, 8, 8, 16, True), (64, 2, 8, 4, 1000, True),
             (400, 2, 4, 4, 200, True)]


@pytest.fixture(autouse=True)
def no_kernel_launch():
    kernels.reset_launches()
    yield
    assert kernels.launches() == {k: 0 for k in kernels.KERNELS}


def _case(S, nh, hd, ds, seed, dt_range=(0.01, 0.3), a_range=(0.3, 2.0),
          dtype=torch.float64):
    rng = np.random.default_rng(seed)
    arrays = (rng.normal(size=(2, S, nh, hd)),
              rng.uniform(*dt_range, size=(2, S, nh)),
              -rng.uniform(*a_range, size=(nh,)),
              rng.normal(size=(2, S, ds)), rng.normal(size=(2, S, ds)),
              rng.normal(size=(2, S, nh, hd)),
              rng.normal(size=(2, nh, hd, ds)))
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _autograd(x, dt, A, Bc, Cc, dy, dh, chunk):
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, Bc, Cc)]
    y, h = ssd_scan_ref(*leaves, chunk=chunk, return_state=True)
    outs, grads = ([y], [dy]) if dh is None else ([y, h], [dy, dh])
    return torch.autograd.grad(outs, leaves, grads)


def _close(got, want, tol):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert bool(torch.isfinite(g).all())
        assert float((g - w).abs().max()) <= tol * (1 + float(
            w.abs().max()))


@pytest.mark.parametrize("case", BWD_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_bwd_ref_matches_autograd(case):
    S, nh, hd, ds, chunk, with_dh = case
    x, dt, A, Bc, Cc, dy, dh = _case(S, nh, hd, ds, seed=S + nh)
    dh = dh if with_dh else None
    want = _autograd(x, dt, A, Bc, Cc, dy, dh, chunk)
    _close(ssd_scan_bwd_ref(x, dt, A, Bc, Cc, dy, dh, chunk=chunk), want,
           REF_TOL)
    # the Function on the CPU: its forward keeps the chunk states, its
    # backward is this reverse pass on them
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, Bc, Cc)]
    y, h = mamba_ssd(*leaves, chunk=chunk, return_state=True)
    outs, grads = ([y], [dy]) if dh is None else ([y, h], [dy, dh])
    _close(torch.autograd.grad(outs, leaves, grads), want, REF_TOL)


def test_bwd_ref_underflowing_decays_stay_finite():
    """dt ~ U(1, 5), A ~ −U(5, 25): l falls by up to ~2,000 in a chunk of
    16, so exp(l_t − l_s) for s > t is inf and the decays underflow; the
    reverse pass forms no inf, and matches autograd."""
    x, dt, A, Bc, Cc, dy, dh = _case(64, 3, 16, 8, seed=3,
                                     dt_range=(1.0, 5.0),
                                     a_range=(5.0, 25.0))
    got = ssd_scan_bwd_ref(x, dt, A, Bc, Cc, dy, dh, chunk=16)
    _close(got, _autograd(x, dt, A, Bc, Cc, dy, dh, 16), REF_TOL)
    got32 = ssd_scan_bwd_ref(*(t.float() for t in (x, dt, A, Bc, Cc, dy,
                                                    dh)), chunk=16)
    assert all(bool(torch.isfinite(g).all()) for g in got32)


def test_bwd_terms_bound_every_gradient():
    x, dt, A, Bc, Cc, dy, dh = _case(48, 3, 8, 4, seed=4)
    want = ssd_scan_bwd_ref(x, dt, A, Bc, Cc, dy, dh, chunk=16)
    mags = ssd_scan_bwd_ref(x, dt, A, Bc, Cc, dy, dh, chunk=16, terms=True)
    for w, m in zip(want, mags):
        assert bool((w.abs() <= m * (1 + 1e-12)).all())


@pytest.mark.parametrize("chunk", [8, 48])
def test_bwd_dA_steps_sum_to_dA(chunk):
    """`dA_steps=True` gives dA unsummed, a part a (row, chunk, head,
    step): the parts sum to dA, and with `terms` to dA's Σ|terms| (the
    card's dA limit takes their root-sum-square)."""
    x, dt, A, Bc, Cc, dy, dh = _case(48, 3, 8, 4, seed=6)
    for terms in (False, True):
        dA = ssd_scan_bwd_ref(x, dt, A, Bc, Cc, dy, dh, chunk=chunk,
                              terms=terms)[2]
        steps = ssd_scan_bwd_ref(x, dt, A, Bc, Cc, dy, dh, chunk=chunk,
                                 terms=terms, dA_steps=True)[2]
        assert steps.shape == (2, 48 // chunk, 3, chunk)
        assert bool((steps >= 0).all()) or not terms
        np.testing.assert_allclose(steps.sum((0, 1, 3)).numpy(), dA.numpy(),
                                   rtol=1e-12,
                                   atol=1e-12 * float(dA.abs().max()))


def test_bwd_refuses_mismatched_cotangents():
    x, dt, A, Bc, Cc, dy, dh = _case(16, 2, 8, 4, seed=5)
    with pytest.raises(ValueError, match="dy"):
        ssd_scan_bwd_ref(x, dt, A, Bc, Cc, dy[:, :-1], dh, chunk=8)
    with pytest.raises(ValueError, match="dh_final"):
        ssd_scan_bwd_ref(x, dt, A, Bc, Cc, dy, dh[..., :-1], chunk=8)


class _Counted:
    """Count the calls of `ops.<name>` (the Function reaches it through the
    module, as chip_smoke.py's hooks do)."""

    def __init__(self, monkeypatch, name):
        self.n = 0
        fn = getattr(ops, name)

        def call(*a, **kw):
            self.n += 1
            return fn(*a, **kw)
        monkeypatch.setattr(ops, name, call)


def test_mamba_layer_grads_match_jax_vjp(monkeypatch):
    """The port's `mamba_chunked` on zamba2's reduced config (chunk 8, three
    chunks) with a cotangent on the output and on the final state, against
    `jax.vjp` of the JAX package's: every parameter's and the input's
    gradient within GRAD_TOL of its max|ref|."""
    bwd = _Counted(monkeypatch, "ssd_scan_bwd_ref")
    jcfg, cfg = jax_reduced("zamba2-1.2b"), get_reduced("zamba2-1.2b")
    p = jmamba.init_mamba(jax.random.PRNGKey(12), jcfg, jnp.float32)
    rng = np.random.default_rng(12)
    p = dict(p, A_log=rng.uniform(-1, 1, size=p["A_log"].shape).astype(
        np.float32), D=rng.normal(size=p["D"].shape).astype(np.float32),
        dt_bias=rng.uniform(-2, 0, size=p["dt_bias"].shape).astype(
            np.float32))
    p = {k: np.asarray(v) for k, v in p.items()}
    S = 24
    x = rng.normal(size=(2, S, cfg.d_model)).astype(np.float32)
    m = tmamba.init_mamba(cfg, torch.float32, "cpu",
                          torch.Generator().manual_seed(0))
    m.load_state_dict({k: torch.from_numpy(np.array(v))
                       for k, v in p.items()})

    def jf(params, xx):
        out, state = jmamba.mamba_chunked(params, jcfg, xx)
        return out, state.ssm
    (wout, wssm), vjp = jax.vjp(jf, {k: jnp.asarray(v) for k, v in
                                     p.items()}, jnp.asarray(x))
    g_out = rng.normal(size=np.shape(wout)).astype(np.float32)
    g_ssm = rng.normal(size=np.shape(wssm)).astype(np.float32)
    want_p, want_x = vjp((jnp.asarray(g_out), jnp.asarray(g_ssm)))

    tx = torch.from_numpy(x).requires_grad_()
    out, state = tmamba.mamba_chunked(m, cfg, tx)
    names = [n for n, _ in m.named_parameters()]
    got = torch.autograd.grad(
        [out, state.ssm], [p_ for _, p_ in m.named_parameters()] + [tx],
        [torch.from_numpy(g_out), torch.from_numpy(g_ssm)])
    assert bwd.n == 1
    for n, g in zip(names + ["x"], got):
        w = np.asarray(want_x if n == "x" else want_p[n])
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * np.abs(w).max(),
                                   err_msg=n)


def test_loss_fn_reaches_the_plain_backward(monkeypatch):
    """zamba2's `loss_fn` under autograd: one `ssd_scan_fwd_ref` (the
    Function's forward, keeping the chunk states) and one
    `ssd_scan_bwd_ref` (its backward) a Mamba layer."""
    fwd = _Counted(monkeypatch, "ssd_scan_fwd_ref")
    bwd = _Counted(monkeypatch, "ssd_scan_bwd_ref")
    cfg = get_reduced("zamba2-1.2b")
    model = Model(cfg, device="cpu", seed=3)
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLMStream(
        vocab_size=cfg.vocab_size, batch_size=2, seq_len=16,
        seed=3).batch_at(0).items()}
    loss, _ = model.loss_fn(batch)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert (fwd.n, bwd.n) == (cfg.n_layers, cfg.n_layers)
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def _saved_bytes(fn) -> int:
    seen = {}

    def pack(t):
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return sum(seen.values())


def test_scan_saves_its_inputs_and_chunk_states_only():
    """Under grad the scan keeps x, dt, A, B, C and the states entering each
    chunk, (B, nh, S / c, hd, ds): at (2, 256, 4, 16, 16, chunk 64) that is
    a ninth of what autograd of the plain forward keeps (its decays, C·Bᵀ
    and the intra-chunk products)."""
    S, nh, hd, ds, c = 256, 4, 16, 16, 64
    x, dt, A, Bc, Cc, _, _ = _case(S, nh, hd, ds, seed=6,
                                   dtype=torch.float32)
    leaves = [t.requires_grad_() for t in (x, dt, A, Bc, Cc)]
    inputs = sum(t.numel() * 4 for t in leaves)
    states = 2 * nh * (S // c) * hd * ds * 4
    got = _saved_bytes(lambda: mamba_ssd(*leaves, chunk=c))
    plain = _saved_bytes(lambda: ssd_scan_ref(*leaves, chunk=c))
    assert got == inputs + states
    assert plain > 9 * got, (plain, got)


def _route_operands(B, S, nh, hd, ds, chunk, offset=0):
    """x, dy, Bc, Cc and the forward's states with the backward's shapes, as
    zero-strided views (the route reads shapes and addresses only) `offset`
    floats into a 64-byte aligned buffer."""
    buf = torch.empty(64)
    nc = -(-S // ops.kernel_chunk(min(chunk, S)))

    def view(*shape):
        return buf[offset:].as_strided(shape, (0,) * len(shape))
    return (view(B, S, nh, hd), view(B, S, nh, hd), view(B, S, ds),
            view(B, S, ds), view(B, nh, nc, hd, ds))


@pytest.mark.parametrize("geom,offset,route", [
    ((2, 4096, 64, 64, 64, 128), 0, "sm90"),   # zamba2's training step
    ((2, 32768, 64, 64, 64, 128), 0, "sm90"),  # phase 5's ssd stage
    ((2, 400, 17, 64, 64, 200), 0, "sm90"),
    ((2, 128, 3, 32, 16, 128), 0, "sm90"),
    ((1, 256, 33, 40, 24, 64), 0, "sm90"),
    ((2, 64, 3, 16, 8, 16), 0, "sm90"),
    ((2, 42, 20, 5, 3, 7), 0, "mma"),          # rows of 20 and 12 bytes
    ((1, 96, 4, 16, 6, 32), 0, "mma"),         # B / C rows of 24 bytes
    ((2, 4096, 64, 64, 64, 128), 1, "mma"),    # bases off 16 bytes
    ((2, 4096, 64, 64, 64, 128), 4, "sm90"),
], ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_bwd_route(geom, offset, route):
    assert ops.bwd_route(*_route_operands(*geom, offset=offset)) == route


def test_bwd_route_reads_every_operand_address():
    """One operand off 16 bytes is enough to leave the TMA route."""
    ops_ = _route_operands(2, 4096, 64, 64, 64, 128)
    off = _route_operands(2, 4096, 64, 64, 64, 128, offset=1)
    for i in range(5):
        moved = [off[j] if j == i else t for j, t in enumerate(ops_)]
        assert ops.bwd_route(*moved) == "mma", i


def test_bwd_bound_counts_the_q_products_once_a_chunk():
    """chip_smoke.py's bound for row 7b (`_ssd_bwd_work`) against its
    products counted one by one on a small shape: per (row, chunk) C·Bᵀ,
    (Σ_h Q)ᵀ·C and (Σ_h Q)·B over the causal pairs s <= t (ds deep, B and
    C shared by the heads), per head P and Wᵀ·dy over them (hd deep) and
    B·Gᵀ, x·G, dy·H and D_k (c·hd·ds each); a multiply-add two
    operations."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    B, S, nh, hd, ds, c = 2, 12, 3, 4, 8, 4
    fma = 0
    for _ in range(B):
        for _ in range(S // c):
            for t in range(c):
                for _ in range(t + 1):
                    fma += 3 * ds + nh * 2 * hd
            fma += nh * 4 * c * hd * ds
    st = dict(B=B, S=S, nh=nh, hd=hd, ds=ds, chunk=c)
    assert chip_smoke._ssd_bwd_work(st)[1] == 2 * fma
