"""The port's grouped GEMM (`kernels/moe_gemm`) held against the JAX
package's, on the same seeded numpy inputs in one process.

On the CPU `grouped_gemm` runs its plain PyTorch version (the CUDA kernel
is held against that plain version on the card by `chip_smoke.py`). It is
compared with the JAX `grouped_gemm` through `lax.ragged_dot`
(``backend="ref"``) and through the Pallas kernel in interpret mode, on the
`MOE` geometries of `tests/test_kernels.py`, the empty-group case, and rows
beyond the groups' sum. Tolerance atol = rtol = 2e-4, as
`tests/test_kernels.py` holds the JAX kernel: float32 sums in different
orders (and the Pallas kernel's block-k partial sums).

In bf16 (the models' dtype) the plain version is held against both JAX
paths on the same bf16 operands: all three sum exact products in float32
and round y to bf16 once, so they differ by the order of the float32 sums
and, where a sum sits near a rounding point, by one bf16 ulp (up to 2^-7
of |y| at the bottom of a binade): BF16_GATE = 2^-7·|ref| + 1e-5·Σ|x w| +
1e-6.

`gathered_swiglu` is plain array code: the port's numpy and torch float64
forms and the JAX package's (fed numpy arrays) agree to 1e-12.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.moe_gemm.ops import gathered_swiglu as jax_swiglu
from repro.kernels.moe_gemm.ops import grouped_gemm as jax_grouped_gemm
from repro_torch import kernels
from repro_torch.kernels.moe_gemm.ops import (copies16, gathered_swiglu,
                                              grouped_gemm, tile_rows)
from repro_torch.kernels.moe_gemm.ref import grouped_gemm_ref

# one intra-op thread per test process: the suite runs in parallel workers
torch.set_num_threads(1)

TOL = 2e-4
BF16_ULP = 2.0 ** -7  # one bf16 ulp, relative, at its largest
# (G, M, K, N): the MOE family of tests/test_kernels.py
MOE_GEOMS = ((4, 96, 32, 64), (1, 1, 64, 128), (6, 150, 128, 256),
             (3, 17, 32, 64))


@pytest.fixture(autouse=True)
def no_kernel_launch():
    """On the CPU the wrapper takes its plain version: nothing launches."""
    kernels.reset_launches()
    yield
    assert kernels.launches() == {k: 0 for k in kernels.KERNELS}


def _case(geom, seed=0):
    """The inputs of `_moe_case` in tests/test_kernels.py, as numpy."""
    G, M, K, N = geom
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.integers(0, M + 1, size=G - 1))
    sizes = np.diff(np.r_[0, cuts, M]).astype(np.int32)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = (rng.normal(size=(G, K, N)) * 0.1).astype(np.float32)
    return x, w, sizes


def _jax(x, w, sizes, backend):
    K, N = x.shape[1], w.shape[2]
    return np.asarray(jax_grouped_gemm(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(sizes), block_m=16,
        block_n=min(N, 128), block_k=min(K, 64), backend=backend))


def _port(x, w, sizes):
    return grouped_gemm(torch.from_numpy(x), torch.from_numpy(w),
                        torch.from_numpy(sizes)).numpy()


@pytest.mark.parametrize("backend", ["ref", "interpret"])
@pytest.mark.parametrize("geom", MOE_GEOMS, ids=lambda g: "x".join(map(str, g)))
def test_grouped_gemm_matches_jax(geom, backend):
    x, w, sizes = _case(geom)
    got = _port(x, w, sizes)
    assert got.dtype == np.float32 and got.shape == (geom[1], geom[3])
    np.testing.assert_allclose(got, _jax(x, w, sizes, backend), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("backend", ["ref", "interpret"])
def test_grouped_gemm_empty_groups(backend):
    """tests/test_kernels.py::test_moe_empty_groups: every row in group 1."""
    x = np.ones((8, 32), np.float32)
    w = np.ones((4, 32, 16), np.float32)
    sizes = np.array([0, 8, 0, 0], np.int32)
    got = _port(x, w, sizes)
    np.testing.assert_allclose(got, 32.0 * np.ones((8, 16)))
    np.testing.assert_allclose(got, _jax(x, w, sizes, backend), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("backend", ["ref", "interpret"])
def test_grouped_gemm_rows_beyond_the_sum(backend):
    """Groups covering 40 of 57 rows, with an empty group in the middle:
    the last 17 rows are 0, as `lax.ragged_dot` gives them. The JAX
    package's Pallas path does not zero them: its padding plan clamps a
    tail row's group to the last one, so it multiplies them by the last
    group's weights. Against it only the 40 grouped rows are compared."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(57, 24)).astype(np.float32)
    w = rng.normal(size=(5, 24, 40)).astype(np.float32)
    sizes = np.array([11, 0, 20, 9, 0], np.int32)
    got = _port(x, w, sizes)
    assert not got[40:].any()
    rows = slice(None) if backend == "ref" else slice(0, 40)
    np.testing.assert_allclose(got[rows], _jax(x, w, sizes, backend)[rows],
                               atol=TOL, rtol=TOL)


def _bf16(a):
    """float32 numpy -> (jnp bf16, torch bf16), the same bits (both round
    to nearest even)."""
    t = torch.from_numpy(a).to(torch.bfloat16)
    j = jnp.asarray(a, jnp.bfloat16)
    assert np.array_equal(np.asarray(j, np.float32), t.float().numpy())
    return j, t


def _bf16_gate(got, want, x, w, sizes):
    """got (torch bf16) against want (bf16) within BF16_GATE; Σ|x w| in
    float64 from the bf16 values."""
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, np.float64)
    xa, wa = (torch.from_numpy(np.abs(a.float().numpy())).double()
              for a in (x, w))
    mags = grouped_gemm_ref(xa, wa, sizes).numpy()
    allowed = BF16_ULP * np.abs(want) + 1e-5 * mags + 1e-6
    err = np.abs(got.double().numpy() - want)
    assert (err <= allowed).all(), float((err / allowed).max())


# the MOE geometries through both JAX paths, and granite-moe-3b-a800m's two
# projections at a decode step's size through `lax.ragged_dot` (the Pallas
# kernel in interpret mode takes minutes there)
BF16_CASES = [(g, b) for g in MOE_GEOMS for b in ("ref", "interpret")] + [
    ((40, 64, 1536, 1024), "ref"), ((40, 80, 512, 1536), "ref")]


@pytest.mark.parametrize("geom,backend", BF16_CASES,
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else v)
def test_grouped_gemm_bf16_matches_jax(geom, backend):
    """bf16 in, bf16 out, within BF16_GATE of the JAX package's
    `lax.ragged_dot` and of its Pallas kernel (interpret mode) on the same
    bf16 operands."""
    x, w, sizes = _case(geom)
    (xj, xt), (wj, wt) = _bf16(x), _bf16(w)
    st = torch.from_numpy(sizes)
    got = grouped_gemm(xt, wt, st)
    K, N = x.shape[1], w.shape[2]
    want = jax_grouped_gemm(xj, wj, jnp.asarray(sizes), block_m=16,
                            block_n=min(N, 128), block_k=min(K, 64),
                            backend=backend)
    assert want.dtype == jnp.bfloat16 and got.shape == want.shape
    _bf16_gate(got, want, xt, wt, st)


def test_grouped_gemm_plain_version_bf16_rounds_once():
    """The plain version's bf16 semantics: float32 sums of the bf16
    operands, rounded to bf16 once (not a bf16 sum), empty groups and rows
    beyond the sum as 0."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(30, 256)).astype(np.float32)
    w = rng.normal(size=(3, 256, 24)).astype(np.float32)
    (_, xt), (_, wt) = _bf16(x), _bf16(w)
    sizes = torch.tensor([12, 0, 10], dtype=torch.int32)
    got = grouped_gemm_ref(xt, wt, sizes)
    assert got.dtype == torch.bfloat16
    xf, wf = xt.float(), wt.float()
    want = torch.cat([xf[:12] @ wf[0], xf[12:22] @ wf[2]]).to(torch.bfloat16)
    assert torch.equal(got[:22], want)
    assert not got[22:].float().any()


def test_grouped_gemm_plain_version_semantics():
    """The plain version against a float64 row-by-row product: negative
    sizes count as 0, rows past M are cut, and a float64 input comes back
    float64 after float64 arithmetic (what `gradcheck` of the backward
    needs); a float32 input after float32 arithmetic."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(10, 6))
    w = rng.normal(size=(3, 6, 5))
    sizes = torch.tensor([4, -2, 9], dtype=torch.int32)
    got = grouped_gemm_ref(torch.from_numpy(x), torch.from_numpy(w), sizes)
    assert got.dtype == torch.float64
    want = np.concatenate([x[:4] @ w[0], x[4:] @ w[2]])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    got32 = grouped_gemm_ref(torch.from_numpy(x).float(),
                             torch.from_numpy(w).float(), sizes)
    assert got32.dtype == torch.float32
    np.testing.assert_allclose(got32.numpy(), want, rtol=1e-5, atol=1e-5)


def test_grouped_gemm_refuses_other_devices():
    x = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="no kernel or plain path"):
        grouped_gemm(x, torch.zeros((1, 3, 2)), torch.tensor([4]))


@pytest.mark.parametrize("seed", [0, 1])
def test_gathered_swiglu_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n, A, d, f = 7, 3, 5, 4
    x = rng.normal(size=(n, d))
    w_in = rng.normal(size=(n, A, d, 2 * f))
    w_out = rng.normal(size=(n, A, f, d))
    gate = rng.uniform(size=(n, A)) * (rng.uniform(size=(n, A)) > 0.3)
    want = jax_swiglu(x, w_in, w_out, gate)
    got_np = gathered_swiglu(x, w_in, w_out, gate)
    got_t = gathered_swiglu(*(torch.from_numpy(a)
                              for a in (x, w_in, w_out, gate)))
    assert isinstance(got_np, np.ndarray) and got_t.dtype == torch.float64
    np.testing.assert_allclose(got_np, want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got_t.numpy(), want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("backend", ["ref", "interpret"])
def test_grouped_gemm_reads_strided_weight_views(backend):
    """The naive arm passes w_in and w_out as views of one wider weight row
    per expert (w_in ‖ w_out, as the store homes them): the views give the
    results of the contiguous stacks."""
    G, M, K, N, F = 3, 40, 24, 16, 8
    x, w, sizes = _case((G, M, K, N), seed=5)
    w_out = np.random.default_rng(6).normal(size=(G, N, F)).astype(np.float32)
    rows = torch.from_numpy(np.concatenate(
        [w.reshape(G, -1), w_out.reshape(G, -1)], axis=1))
    w_view = rows[:, :K * N].view(G, K, N)
    w_out_view = rows[:, K * N:].view(G, N, F)
    assert not w_view.is_contiguous() and not w_out_view.is_contiguous()
    xt, st = torch.from_numpy(x), torch.from_numpy(sizes)
    h = grouped_gemm(xt, w_view, st)
    np.testing.assert_array_equal(h.numpy(), _port(x, w, sizes))
    np.testing.assert_allclose(h.numpy(), _jax(x, w, sizes, backend),
                               atol=TOL, rtol=TOL)
    y = grouped_gemm(h, w_out_view, st)
    np.testing.assert_array_equal(y.numpy(), _port(h.numpy(), w_out, sizes))


def test_require_dense_rows():
    """The wrapper's check for w: any strides, but each row of N dense."""
    from repro_torch.kernels import _lib

    rows = torch.zeros((3, 50))
    view = rows[:, 10:34].view(3, 4, 6)
    _lib.require(view, "w", (torch.float32,), 3, view.device,
                 dense_rows=True)
    with pytest.raises(ValueError, match="contiguous"):
        _lib.require(view, "w", (torch.float32,), 3, view.device)
    with pytest.raises(ValueError, match="dense rows"):
        _lib.require(view.transpose(1, 2), "w", (torch.float32,), 3,
                     view.device, dense_rows=True)


def test_wrapper_chooses_tiles_and_copies_from_the_shape():
    """What the wrapper hands the kernel, decided from the shape alone:
    64-row tiles where the groups average fewer than 128 rows (a decode
    step of granite's naive arm: 1,024 rows over 40 experts), 128-row ones
    at prefill; 16-byte copies only where x, w, K and w's strides allow."""
    assert tile_rows(1024, 40) == 64 and tile_rows(32768, 40) == 128
    assert tile_rows(127, 1) == 64 and tile_rows(128, 1) == 128
    rows = torch.zeros((3, 4 * 24 * 16 + 64))  # 16-byte aligned storage
    x = torch.zeros((40, 24))
    assert rows.data_ptr() % 16 == 0 and x.data_ptr() % 16 == 0
    assert copies16(x, rows[:, :24 * 16].view(3, 24, 16))
    assert not copies16(x, rows[:, 1:1 + 24 * 16].view(3, 24, 16))
    assert not copies16(torch.zeros((40, 30))[:, :30],
                        torch.zeros((3, 30, 16)))  # K = 30
    assert not copies16(x, torch.zeros((3, 24, 18))[:, :, :15])  # rows 18
    assert copies16(x, torch.zeros((3, 24, 16))[:, :, :15])  # rows 16
    # bf16: 16 bytes are 8 values
    xb, wb = x.to(torch.bfloat16), torch.zeros((3, 24, 16),
                                               dtype=torch.bfloat16)
    assert copies16(xb, wb)
    assert not copies16(xb, torch.zeros((3, 24, 12),
                                        dtype=torch.bfloat16))  # rows 12
    assert not copies16(torch.zeros((40, 20), dtype=torch.bfloat16),
                        torch.zeros((3, 20, 16), dtype=torch.bfloat16))
