"""The choices the B1 and B3 wrappers make before they launch, and the
plain versions at the sizes where those choices change, against the JAX
package.

`histogram.ops.route` picks the histogram kernel's route (a block's bins
in shared memory, or atomics in global memory) and its grid from the ids'
count, the bins' and the device's limits; `stage_fused.ops.layout` picks
how the gather-reduce covers a row (16-byte or one-value loads, lanes a
task, vectors a lane). Both are plain Python, pinned here at an H100's
limits (227 KB of shared memory a block may opt in to, 228 KB an SM, 1 KB
kept back a block, 132 SMs of 2,048 threads) and the kernel's 256-thread
blocks. The kernels themselves run only on the card
(`tests/test_torch_cuda_kernels.py`); here the wrappers take their plain
versions, held against `repro.kernels.histogram` and
`repro.kernels.stage_fused` (the jnp reference, and the Pallas kernel in
interpret mode at the main path's width). Counts, min, max and first are
exact; sums compare at rtol 1e-5 / atol 1e-6 (another order of adds).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.histogram.ops import count_ids as jax_count_ids
from repro.kernels.histogram.ref import histogram_ref as jax_histogram_ref
from repro.kernels.stage_fused.ops import fused_stage as jax_fused_stage
from repro_torch import kernels
from repro_torch.kernels.histogram.ops import Limits, count_ids, route
from repro_torch.kernels.stage_fused.ops import (FUSED_READ_OPS, Layout,
                                                 fused_reduce, layout)

torch.set_num_threads(1)

H100 = Limits(block_shared=232_448, sm_shared=233_472, reserved_shared=1_024,
              sms=132, sm_threads=2_048, block_threads=256)


@pytest.fixture(autouse=True)
def no_kernel_launch():
    """On the CPU every wrapper takes its plain version: nothing launches."""
    kernels.reset_launches()
    yield
    assert kernels.launches() == {k: 0 for k in kernels.KERNELS}


# ---------------------------------------------------------------------------
# B1: the route chooser
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,bins,want", [
    # one block: shared once the ids outnumber its bins
    (300, 300, ("global", 2)), (301, 300, ("shared", 1)),
    (1, 1, ("global", 1)), (1_024, 40, ("shared", 1)),
    # the main path and the parameter-server lookup: global
    (800_000, 800_000, ("global", 1_056)), (8_192, 49_155, ("global", 32)),
    (1_729, 49_155, ("global", 7)),
    # 12,288 bins (48 KB): four blocks an SM, break-even at 528 x 12,288
    (6_488_064, 12_288, ("global", 1_056)),
    (6_488_065, 12_288, ("shared", 528)),
    # the opt-in band: one block an SM, break-even at 132 x bins
    (6_600_000, 50_000, ("global", 1_056)),
    (6_600_001, 50_000, ("shared", 132)),
    # the largest bin vector a block opts in to, and one bin past it
    (8_000_000, 58_112, ("shared", 132)),
    (80_000_000, 58_113, ("global", 1_056)),
], ids=str)
def test_histogram_route_boundaries(n, bins, want):
    assert route(n, bins, H100) == want


def test_histogram_route_grid_follows_the_ids():
    """Fewer ids than the card's resident threads take fewer blocks."""
    assert route(256 * 5, 10**6, H100) == ("global", 5)
    assert route(4_096 * 3, 100, H100) == ("shared", 3)
    assert route(10**7, 100, H100) == ("shared", 1_056)
    small = H100._replace(block_shared=48 * 1024, sm_shared=100 * 1024,
                          sms=10)
    assert route(10**7, 20_000, small)[0] == "global"  # past 48 KB
    assert route(10**7, 12_000, small) == ("shared", 20)


def test_histogram_route_reads_the_kernels_block():
    """The grid follows the block size the kernel reports, not a copy."""
    half = H100._replace(block_threads=128)
    assert route(128 * 5, 10**6, half) == ("global", 5)
    assert route(10**8, 10**6, half) == ("global", 132 * 16)
    assert route(128 * 16 * 3, 100, half) == ("shared", 3)


# ---------------------------------------------------------------------------
# B3: the layout chooser
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("w,itemsize,aligned,want", [
    (16, 4, True, Layout(4, 4, 1)),      # the main path: 8 tasks a warp
    (16, 4, False, Layout(1, 16, 1)),    # a view one value in
    (16, 8, True, Layout(2, 8, 1)),
    (1, 4, True, Layout(1, 1, 1)), (1, 8, True, Layout(1, 1, 1)),
    (3, 4, True, Layout(1, 4, 1)), (3, 8, True, Layout(1, 4, 1)),
    (4, 4, True, Layout(4, 1, 1)), (4, 8, True, Layout(2, 2, 1)),
    (5, 4, True, Layout(1, 8, 1)),
    (17, 4, True, Layout(1, 32, 1)), (17, 8, False, Layout(1, 32, 1)),
    (32, 4, False, Layout(1, 32, 1)), (33, 4, True, Layout(1, 32, 4)),
    (128, 4, True, Layout(4, 32, 1)),    # 512 bytes: still narrow
    (132, 4, True, Layout(4, 32, 4)), (64, 8, True, Layout(2, 32, 1)),
    (66, 8, True, Layout(2, 32, 4)),
    (1536, 4, True, Layout(4, 32, 4)),   # the bags: 3 column passes
    (1536, 8, True, Layout(2, 32, 4)), (1536, 4, False, Layout(1, 32, 4)),
], ids=str)
def test_fused_layout(w, itemsize, aligned, want):
    assert layout(w, itemsize, aligned) == want


# ---------------------------------------------------------------------------
# the plain versions against the JAX package where the choices change
# ---------------------------------------------------------------------------
def _ids(rng, n, bins, zipf):
    if zipf:
        p = 1.0 / np.arange(1, bins + 1) ** 1.2
        return rng.permutation(bins)[rng.choice(bins, size=n, p=p / p.sum())
                                     ].astype(np.int32)
    return rng.integers(0, bins + 3, n).astype(np.int32)  # >= bins dropped


@pytest.mark.parametrize("zipf", [False, True])
@pytest.mark.parametrize("n,bins", [(300, 300), (301, 300), (1_024, 40),
                                    (8_192, 49_155), (1_729, 49_155),
                                    (200_000, 12_288)], ids=str)
def test_count_ids_matches_jax_at_route_boundaries(n, bins, zipf):
    rng = np.random.default_rng(40)
    ids = _ids(rng, n, bins, zipf)
    got = count_ids(torch.from_numpy(ids), bins).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_histogram_ref(jnp.asarray(ids), bins)))
    w = rng.integers(0, 9, n).astype(np.int32)
    got_w = count_ids(torch.from_numpy(ids), bins,
                      weights=torch.from_numpy(w))
    np.testing.assert_array_equal(
        got_w.numpy(), np.asarray(jax_count_ids(jnp.asarray(ids), bins,
                                                weights=jnp.asarray(w))))


def _jax_reduce(values, indptr, indices, read_op, backend="ref"):
    n = indptr.size - 1
    upd, _ = jax_fused_stage(
        values, indptr, indices, np.repeat(np.arange(n), np.diff(indptr)),
        np.zeros((n, 1), values.dtype), np.zeros(n, np.int32),
        np.zeros(n, np.int32), num_segments=1, read_op=read_op,
        combine=False, backend=backend)
    return np.asarray(upd)


def _ragged(seed, n, K, w, max_arity=8):
    r = np.random.default_rng(seed)
    arity = r.integers(0, max_arity + 1, n)
    indptr = np.r_[0, np.cumsum(arity)]
    return (r.normal(size=(K, w)).astype(np.float32), indptr,
            r.integers(0, K, int(indptr[-1])))


@pytest.mark.parametrize("read_op", FUSED_READ_OPS)
@pytest.mark.parametrize("w", [1, 3, 4, 5, 16, 17, 32, 33, 128, 132])
def test_fused_reduce_matches_jax_across_layouts(w, read_op):
    values, indptr, indices = _ragged(41, 37, 29, w)
    got = fused_reduce(torch.from_numpy(values),
                       torch.from_numpy(indptr.astype(np.int32)),
                       torch.from_numpy(indices.astype(np.int32)),
                       read_op=read_op).numpy()
    want = _jax_reduce(values, indptr, indices, read_op)
    if read_op == "add":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("read_op", ["add", "max"])
def test_fused_reduce_matches_pallas_interpret_at_main_path_width(read_op):
    """w = 16 (the main path's rows), a long task next to short ones."""
    values, indptr, indices = _ragged(42, 9, 40, 16)
    arity = np.diff(indptr)
    arity[4] = 150
    indptr = np.r_[0, np.cumsum(arity)]
    indices = np.random.default_rng(43).integers(0, 40, int(indptr[-1]))
    got = fused_reduce(torch.from_numpy(values),
                       torch.from_numpy(indptr.astype(np.int32)),
                       torch.from_numpy(indices.astype(np.int32)),
                       read_op=read_op).numpy()
    want = _jax_reduce(values, indptr, indices, read_op, backend="interpret")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
