"""The port's Mamba2 SSD chunk scan (`kernels/mamba_scan`) held against the
JAX package's, on the same seeded numpy inputs in one process.

On the CPU `mamba_ssd` runs its plain PyTorch version, a chunked torch form
written fresh (the JAX family's `ref.py` is a float64 numpy loop and its
off-TPU path is the interpret-mode kernel); the CUDA kernel is held against
it by `chip_smoke.py` on the card and by `tests/test_torch_cuda_kernels.py`,
which skips without one. The plain version is compared with the JAX
Pallas kernel in interpret mode and the numpy oracle on the `MAMBA`
geometries of `tests/test_kernels.py`, with |dt·A| large enough that the
unmasked decay exp(l_t − l_s) overflows float32, with bf16 x/B/C, and fed
from the reduced zamba2 layer as `test_mamba_matches_model_layer` does.

Tolerances: atol = rtol = 1e-3 as the JAX suite holds its kernel (float32
sums in other orders and chunkings against the float64 oracle), 1e-4 for
the model-layer case as there, 3e-2 for bf16 (rounding of x, B, C and y).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan.kernel import ssd_scan as jax_ssd
from repro.kernels.mamba_scan.ref import ssd_scan_ref as jax_ssd_ref
from repro_torch import kernels
from repro_torch.kernels import mamba_ssd
from repro_torch.kernels.mamba_scan.ops import kernel_chunk

# one intra-op thread per test process: the suite runs in parallel workers
torch.set_num_threads(1)

TOL = 1e-3
BF16_TOL = 3e-2
# (S, nh, hd, ds, chunk): the MAMBA family
MAMBA_GEOMS = [(32, 2, 8, 8, 16), (64, 3, 16, 8, 16), (128, 1, 32, 16, 32)]


@pytest.fixture(autouse=True)
def no_kernel_launch():
    """On the CPU the wrapper takes its plain version: nothing launches."""
    kernels.reset_launches()
    yield
    assert kernels.launches() == {k: 0 for k in kernels.KERNELS}


def _case(geom, seed=0, dt_range=(0.01, 0.3), a_range=(0.3, 2.0)):
    """The inputs of `_mamba_case` in tests/test_kernels.py, as numpy."""
    S, nh, hd, ds, _ = geom
    B = 2
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, nh, hd)).astype(np.float32),
            rng.uniform(*dt_range, size=(B, S, nh)).astype(np.float32),
            (-rng.uniform(*a_range, size=(nh,))).astype(np.float32),
            rng.normal(size=(B, S, ds)).astype(np.float32),
            rng.normal(size=(B, S, ds)).astype(np.float32))


def _port(arrays, chunk):
    return mamba_ssd(*(torch.from_numpy(a) for a in arrays),
                     chunk=chunk).numpy()


def _jax_kernel(arrays, chunk):
    return np.asarray(jax_ssd(*(jnp.asarray(a) for a in arrays), chunk=chunk,
                              interpret=True))


@pytest.mark.parametrize("path", ["interpret", "oracle"])
@pytest.mark.parametrize("geom", MAMBA_GEOMS,
                         ids=lambda g: "x".join(map(str, g)))
def test_ssd_matches_jax(geom, path):
    arrays = _case(geom)
    chunk = geom[-1]
    got = _port(arrays, chunk)
    want = (_jax_kernel(arrays, chunk) if path == "interpret"
            else np.asarray(jax_ssd_ref(*arrays)))
    assert got.dtype == np.float32 and got.shape == arrays[0].shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("geom", MAMBA_GEOMS,
                         ids=lambda g: "x".join(map(str, g)))
def test_ssd_large_decay_stays_finite(geom):
    """dt ~ U(1, 5), A ~ −U(5, 25): within a chunk l falls by up to ~1,900,
    so exp(l_t − l_s) for s > t is inf in float32. The masked decay never
    multiplies it: the scan is finite and equals the JAX kernel's (which
    discards it with jnp.where) and the float64 oracle."""
    arrays = _case(geom, seed=7, dt_range=(1.0, 5.0), a_range=(5.0, 25.0))
    chunk = geom[-1]
    l = np.cumsum((arrays[1] * arrays[2]).reshape(2, -1, chunk, geom[1]),
                  axis=2)
    assert (l.max(axis=2) - l.min(axis=2)).max() > 89  # exp overflows
    got = _port(arrays, chunk)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _jax_kernel(arrays, chunk), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(got, np.asarray(jax_ssd_ref(*arrays)),
                               atol=TOL, rtol=TOL)


def test_ssd_bf16_io():
    """bf16 x, B, C (dt and A float32, as the model feeds them) against the
    JAX kernel on the same bf16 values."""
    x, dt, A, Bc, Cc = _case(MAMBA_GEOMS[1], seed=3)
    jx, jB, jC = (jnp.asarray(a, jnp.bfloat16) for a in (x, Bc, Cc))
    want = jax_ssd(jx, jnp.asarray(dt), jnp.asarray(A), jB, jC, chunk=16,
                   interpret=True)
    tx, tB, tC = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, Bc, Cc))
    got = mamba_ssd(tx, torch.from_numpy(dt), torch.from_numpy(A), tB, tC,
                    chunk=16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=BF16_TOL,
                               rtol=BF16_TOL)


def test_ssd_matches_model_layer():
    """tests/test_kernels.py::test_mamba_matches_model_layer: the scan fed
    from the reduced zamba2 layer's own projections (chunk 8) against the
    oracle, through the port."""
    from repro.configs import get_reduced
    from repro.models.mamba import (_causal_conv, _dims, _split_proj,
                                    init_mamba)

    cfg = get_reduced("zamba2-1.2b")
    params = init_mamba(jax.random.PRNGKey(0), cfg, jnp.float32)
    s, d_in, nh, _ = _dims(cfg)
    B, S = 2, 16
    x = jax.random.normal(jax.random.PRNGKey(1), (B, S, cfg.d_model))
    _, xbc, dt = _split_proj(params, cfg, x)
    xbc, _ = _causal_conv(xbc, params["conv_w"], params["conv_b"], None)
    xs = xbc[..., :d_in].reshape(B, S, nh, s.head_dim)
    Bc = xbc[..., d_in:d_in + s.d_state]
    Cc = xbc[..., d_in + s.d_state:]
    A = -jnp.exp(params["A_log"])
    arrays = tuple(np.array(a, np.float32) for a in (xs, dt, A, Bc, Cc))
    got = _port(arrays, 8)
    np.testing.assert_allclose(got, np.asarray(jax_ssd_ref(*arrays)),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("chunk", [1, 4, 32, 64, 1000])
def test_ssd_value_does_not_depend_on_the_chunk(chunk):
    """chunk 1 is the plain recurrence; 1000 > S runs as one chunk of S."""
    arrays = _case((64, 2, 8, 8, 16), seed=9)
    np.testing.assert_allclose(_port(arrays, chunk), _port(arrays, 16),
                               atol=1e-5, rtol=1e-5)


def test_ssd_float64_matches_the_oracle():
    """float64 in: the plain version computes in float64 and lands on the
    float64 numpy oracle to rounding."""
    arrays = tuple(a.astype(np.float64) for a in _case(MAMBA_GEOMS[2]))
    got = mamba_ssd(*(torch.from_numpy(a) for a in arrays), chunk=32)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_ssd_ref(*arrays)),
                               atol=1e-5, rtol=1e-5)


def test_ssd_chunk_must_divide_the_sequence():
    arrays = tuple(torch.from_numpy(a) for a in _case((48, 1, 8, 8, 16)))
    with pytest.raises(ValueError, match="does not divide"):
        mamba_ssd(*arrays, chunk=32)
    with pytest.raises(ValueError, match="positive"):
        mamba_ssd(*arrays, chunk=0)


@pytest.mark.parametrize("chunk,want", [(128, 128), (16, 16), (256, 128),
                                        (200, 100), (384, 128), (131, 1)])
def test_kernel_chunk(chunk, want):
    """A requested chunk above 128 runs on the card as its largest divisor
    <= 128 (which divides S as the chunk does)."""
    assert kernel_chunk(chunk) == want


@pytest.mark.parametrize("bad", ["dt", "A", "Bc"])
def test_ssd_refuses_mismatched_shapes(bad):
    x, dt, A, Bc, Cc = (torch.from_numpy(a) for a in _case(MAMBA_GEOMS[0]))
    args = dict(x=x, dt=dt, A=A, Bc=Bc, Cc=Cc)
    args[bad] = args[bad][..., :-1]
    with pytest.raises(ValueError):
        mamba_ssd(**args, chunk=16)
