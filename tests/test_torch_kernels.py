"""The port's kernel families, held against the JAX package's kernels.

On the CPU a port wrapper runs its kernel's plain PyTorch version (the CUDA
kernels themselves are held against those plain versions on the card by
`chip_smoke.py`). Each plain version is compared, on the same seeded numpy
inputs, with the JAX family's `ref.py` oracle AND its Pallas kernel in
interpret mode, on the geometries of the `Family` table in
`tests/test_kernels.py` and a subset of the `tests/test_stage_fused.py`
cases (interpret mode is slow, so the subset stays small).

Tolerances: histogram counts are exact, and so are min/max/or/write
combines and min/max/first reductions (selection, no arithmetic). Sums
(add) compare float32 against float32 at rtol 1e-5 / atol 1e-6 — the
orders of the additions differ.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.jaxexec import _segment_combine as jax_segment_combine
from repro.core.mergeops import get_merge_op
from repro.kernels.histogram.kernel import histogram as jax_histogram
from repro.kernels.histogram.ops import count_ids as jax_count_ids
from repro.kernels.histogram.ref import histogram_ref as jax_histogram_ref
from repro.kernels.segment_combine.kernel import segment_add as jax_seg_add
from repro.kernels.segment_combine.ops import combine as jax_combine
from repro.kernels.segment_combine.ref import segment_add_ref as jax_seg_ref
from repro.kernels.stage_fused.ops import fused_stage as jax_fused_stage
from repro_torch import kernels
from repro_torch.kernels.histogram.ops import count_ids
from repro_torch.kernels.segment_combine.ops import combine
from repro_torch.kernels.stage_fused.ops import (FUSED_READ_OPS, fused_reduce,
                                                 fused_stage)

# one intra-op thread per test process: the suite runs in parallel workers
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
MERGES = ("add", "min", "max", "or", "write")

HIST_GEOMS = ((300, 4000), (1, 1), (7, 257), (16, 1024))
SEG_GEOMS = ((200, 2000, 3), (1, 1, 1), (13, 511, 8), (127, 129, 1))
FUSED_GEOMS = ((1, "add"), (9, "min"), (24, "max"), (13, "first"))


@pytest.fixture(autouse=True)
def no_kernel_launch():
    """On the CPU every wrapper takes its plain version: nothing launches."""
    kernels.reset_launches()
    yield
    assert kernels.launches() == {k: 0 for k in kernels.KERNELS}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# histogram
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("E,N", HIST_GEOMS)
def test_histogram_matches_jax(E, N):
    rng = np.random.default_rng(0)
    ids = rng.integers(0, E + 3, size=N).astype(np.int32)  # >= E dropped
    got = count_ids(_t(ids), E).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_histogram_ref(jnp.asarray(ids), E)))
    np.testing.assert_array_equal(
        got, np.asarray(jax_histogram(jnp.asarray(ids), E, block_n=256,
                                      interpret=True)))
    # weighted: the JAX package's scatter path, in the weights' dtype
    w = rng.integers(0, 9, size=N).astype(np.int32)
    got_w = count_ids(_t(ids), E, weights=_t(w))
    assert got_w.dtype == torch.int32
    np.testing.assert_array_equal(
        got_w.numpy(), np.asarray(jax_count_ids(jnp.asarray(ids), E,
                                                weights=jnp.asarray(w))))


def test_histogram_drops_negative_ids_and_all_one_bin():
    ids = np.array([-1, -5, 0, 3, 3, 4, 9], dtype=np.int32)
    np.testing.assert_array_equal(count_ids(_t(ids), 4).numpy(),
                                  [1, 0, 0, 2])
    np.testing.assert_array_equal(
        count_ids(_t(ids), 4, weights=_t(np.arange(7, dtype=np.int32)))
        .numpy(), [2, 0, 0, 7])
    skew = count_ids(torch.zeros(10_000, dtype=torch.int32), 16)
    assert int(skew[0]) == 10_000 and int(skew[1:].sum()) == 0


# ---------------------------------------------------------------------------
# segment combine
# ---------------------------------------------------------------------------
def _seg_case(geom, seed=0):
    V, N, W = geom
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(N, W)).astype(np.float32),
            rng.integers(0, V + 2, size=N).astype(np.int32),  # >= V drop
            rng.integers(-3, 3, size=N).astype(np.int32), V)  # tied orders


@pytest.mark.parametrize("geom", SEG_GEOMS)
def test_segment_add_matches_jax(geom):
    vals, seg, _, V = _seg_case(geom)
    got = combine(_t(vals), _t(seg), V, op="add").numpy()
    np.testing.assert_allclose(
        got, np.asarray(jax_seg_ref(jnp.asarray(vals), jnp.asarray(seg), V)),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        got, np.asarray(jax_seg_add(jnp.asarray(vals), jnp.asarray(seg), V,
                                    block_n=128, interpret=True)),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("op", ["min", "max", "or"])
@pytest.mark.parametrize("geom", SEG_GEOMS[:3])
def test_segment_minmax_match_jax(geom, op):
    vals, seg, _, V = _seg_case(geom, seed=1)
    got = combine(_t(vals), _t(seg), V, op=op).numpy()
    want = np.asarray(jax_combine(jnp.asarray(vals), jnp.asarray(seg), V,
                                  op=op, backend="ref"))
    np.testing.assert_array_equal(got, want)  # empties hold the identity


@pytest.mark.parametrize("geom", SEG_GEOMS[:3])
def test_segment_write_matches_jax_and_oracle(geom):
    """Lowest order wins, ties to the lowest row — against the JAX
    package's device combine and the numpy oracle, with negative orders."""
    vals, seg, order, V = _seg_case(geom, seed=2)
    got = combine(_t(vals), _t(seg), V, op="write", order=_t(order)).numpy()
    jx = np.asarray(jax_segment_combine(jnp.asarray(vals), jnp.asarray(seg),
                                        V, "write", jnp.asarray(order)))
    live = seg < V
    hit = np.unique(seg[live])
    np.testing.assert_array_equal(got[hit], jx[hit])
    uniq, inv = np.unique(seg[live], return_inverse=True)
    oracle = get_merge_op("write").combine_segments(
        vals[live], inv, uniq.size, order[live])
    np.testing.assert_array_equal(got[uniq], oracle)
    empty = np.setdiff1d(np.arange(V), hit)
    assert (got[empty] == 0).all()


# ---------------------------------------------------------------------------
# fused stage
# ---------------------------------------------------------------------------
def _finish_muladd(c, r):
    return r * c[:, :1] + c[:, 1:2]


def _fused_case(seed, n, K=23, w=3, S=4, max_arity=6, zero_frac=0.2):
    r = np.random.default_rng(seed)
    arity = r.integers(1, max_arity + 1, n) if max_arity \
        else np.zeros(n, np.int64)
    arity[r.random(n) < zero_frac] = 0
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(arity, out=indptr[1:])
    return dict(values=r.normal(size=(K, w)).astype(np.float32),
                indptr=indptr, indices=r.integers(0, K, int(indptr[-1])),
                pair_task=np.repeat(np.arange(n), arity),
                ctx=r.normal(size=(n, 2)).astype(np.float32),
                seg=r.integers(0, S + 1, n).astype(np.int32),
                order=r.permutation(n).astype(np.int32), S=S)


def _port(c, read_op, merge, finish):
    upd, comb = fused_stage(
        _t(c["values"]), _t(c["indptr"].astype(np.int32)),
        _t(c["indices"].astype(np.int32)), _t(c["ctx"]), _t(c["seg"]),
        _t(c["order"]), num_segments=c["S"], read_op=read_op, finish=finish,
        merge_name=merge)
    return upd.numpy(), comb.numpy()


def _jax(c, read_op, merge, finish, backend):
    upd, comb = jax_fused_stage(
        c["values"], c["indptr"], c["indices"], c["pair_task"], c["ctx"],
        c["seg"], c["order"], num_segments=c["S"], read_op=read_op,
        finish=finish, merge_name=merge, backend=backend)
    return np.asarray(upd), np.asarray(comb)


def _assert_fused(c, read_op, merge, finish=None, backends=("ref",)):
    uk, ck = _port(c, read_op, merge, finish)
    hit = np.unique(c["seg"][c["seg"] < c["S"]])
    exact = read_op != "add" and merge != "add" and finish is None
    for backend in backends:
        uj, cj = _jax(c, read_op, merge, finish, backend)
        if exact:
            np.testing.assert_array_equal(uk, uj)
            np.testing.assert_array_equal(ck[hit], cj[hit])
        else:
            np.testing.assert_allclose(uk, uj, rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(ck[hit], cj[hit], rtol=RTOL,
                                       atol=ATOL)


@pytest.mark.parametrize("n,read_op", FUSED_GEOMS)
def test_fused_family_geoms_match_jax(n, read_op):
    _assert_fused(_fused_case(0, n), read_op, "add",
                  backends=("ref", "interpret"))


@pytest.mark.parametrize("read_op", FUSED_READ_OPS)
@pytest.mark.parametrize("merge", MERGES)
def test_fused_readop_x_merge_match_jax_ref(read_op, merge):
    _assert_fused(_fused_case(11, 23, S=5), read_op, merge)


@pytest.mark.parametrize("read_op", FUSED_READ_OPS)
def test_fused_finish_epilogue(read_op):
    _assert_fused(_fused_case(13, 29, S=5), read_op, "add",
                  finish=_finish_muladd)


@pytest.mark.parametrize("n", [1, 7, 8, 9, 29])
def test_fused_task_tile_boundaries(n):
    _assert_fused(_fused_case(17, n), "add", "add")


def test_fused_pair_block_boundary_and_arity_zero():
    """One task whose pairs cross the TPU kernel's pair block (129 > 128)
    next to an arity-0 task, against the interpret-mode kernel."""
    r = np.random.default_rng(19)
    K, arity = 31, 129
    c = dict(values=r.normal(size=(K, 3)).astype(np.float32),
             indptr=np.array([0, arity, arity]),
             indices=r.integers(0, K, arity),
             pair_task=np.zeros(arity, np.int64),
             ctx=r.normal(size=(2, 2)).astype(np.float32),
             seg=np.array([0, 1], np.int32), order=np.array([0, 1], np.int32),
             S=2)
    _assert_fused(c, "min", "min", backends=("ref", "interpret"))
    _assert_fused(c, "add", "min")
    uk, _ = _port(c, "max", "min", None)
    assert (uk[1] == 0).all()  # arity-0 row reduces to 0


def test_fused_all_rows_arity_zero():
    c = _fused_case(29, 11, max_arity=0)
    for read_op in FUSED_READ_OPS:
        uk, _ = _port(c, read_op, "add", None)
        assert (uk == 0).all()
        _assert_fused(c, read_op, "write")


def test_fused_write_tiebreak_across_tiles():
    """Lowest order wins; equal orders break to the lowest row — across
    the TPU kernel's task tiles, against the interpret-mode kernel."""
    n = 20
    c = dict(values=np.arange(6, dtype=np.float32).reshape(2, 3),
             indptr=np.arange(n + 1), indices=np.zeros(n, np.int64),
             pair_task=np.arange(n),
             ctx=(np.arange(n, dtype=np.float32)[:, None] + 1.0)
             * np.ones((1, 2), np.float32),
             seg=np.zeros(n, np.int32), order=np.full(n, 7, np.int32), S=1)
    c["order"][10] = 1
    _assert_fused(c, "add", "write", backends=("ref", "interpret"))
    _, ck = _port(c, "add", "write", lambda ctx, red: red * ctx[:, :1])
    np.testing.assert_array_equal(ck[0], c["values"][0] * 11)
    c["order"][:] = 7  # all tied: the first row wins
    _, ck = _port(c, "add", "write", lambda ctx, red: red * ctx[:, :1])
    np.testing.assert_array_equal(ck[0], c["values"][0])


def test_fused_padding_rows_do_not_participate():
    """Every task writes, so nothing but real rows may reach the combine."""
    c = _fused_case(37, 11, K=17, S=3, zero_frac=0.0)
    c["seg"] = (np.arange(11) % 3).astype(np.int32)
    c["order"] = np.arange(11, dtype=np.int32)
    _assert_fused(c, "add", "max", backends=("ref", "interpret"))
    for merge in MERGES:
        _assert_fused(c, "add", merge)


def test_fused_duplicate_reads_in_one_task():
    values = np.arange(15, dtype=np.float32).reshape(5, 3)
    red = fused_reduce(_t(values), _t(np.array([0, 4], np.int32)),
                       _t(np.array([2, 2, 0, 2], np.int32)), read_op="add")
    np.testing.assert_array_equal(red.numpy()[0], values[2] * 3 + values[0])
