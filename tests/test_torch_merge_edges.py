"""The port's merges and fused min/max reads at NaN, ±inf and large values,
held to the JAX package's numpy oracle on the CPU
(``TorchBackend(device="cpu")``, where every kernel wrapper runs its plain
PyTorch version; `tests/test_torch_cuda_kernels.py` holds the kernels to
the same inputs on a card).

What the oracle does (`repro/core/mergeops.py`, `repro/core/fusedlam.py`):
- min / max / or merge through ``np.minimum.at`` / ``np.maximum.at``
  from the identity ±float64 max (0 for or): a NaN update makes the
  segment NaN, and the identity folds into every hit segment, so a min
  segment of +inf updates holds float64 max.
- A fused min / max read reduces the padded ``(n, max_arity, w)`` view,
  whose empty slots hold ±float32max/2: tasks below the batch's max arity
  fold that fill in, tasks at it read their pairs alone; NaN propagates.

Tolerances: float64 within 1e-12 (as `tests/test_torch_backend.py`), NaN
where the oracle has NaN. A float32 run stores float32 values, so its
merge identity is ±float32 max where the oracle's is ±float64 max; the
oracle's identities are mapped to the float32 ones before the float32
comparison, whose other values match to float32 rounding (rtol 1e-6).
"""
import numpy as np
import pytest
import torch

import repro.core as ref
import repro_torch.core as port
from repro_torch.kernels.segment_combine.ref import combine_ref
from repro_torch.kernels.stage_fused.ref import BIG, reduce_pairs_ref

torch.set_num_threads(1)

F64_TOL = 1e-12
F32_RTOL = 1e-6
F64_MAX = float(np.finfo(np.float64).max)
F32_MAX = float(np.finfo(np.float32).max)
DTYPES = ["float64", "float32"]
# update values per case: each written by several tasks to a few keys
EDGE_UPDATES = {
    "nan": [np.nan, 1.0, -2.0, 0.5],
    "pos_inf": [np.inf, np.inf, np.inf, np.inf],
    "neg_inf": [-np.inf, -np.inf, -np.inf, -np.inf],
    "mixed_inf": [np.inf, -np.inf, 3.0, np.inf],
    "big": [3e38, -3e38, 3e38, 1.0],
    "nan_and_inf": [np.inf, np.nan, -np.inf, 2.0],
}


def _backend(dtype):
    return port.TorchBackend(device="cpu", dtype=dtype)


def _as_run_dtype(want, dtype):
    """The oracle's float64 identities as the run dtype's."""
    want = np.array(want, dtype=np.float64)
    if dtype == "float32":
        want[want == F64_MAX] = F32_MAX
        want[want == -F64_MAX] = -F32_MAX
    return want


def _same(got, want, dtype):
    want = _as_run_dtype(want, dtype)
    got = np.asarray(got, dtype=np.float64)
    tol = F64_TOL if dtype == "float64" else F32_RTOL
    np.testing.assert_allclose(got, want, rtol=tol, atol=F64_TOL,
                               equal_nan=True)


def _updates(contexts, vals):
    return {"update": contexts[:, :1], "result": contexts[:, :1]}


def _merge_batch(pkg, case):
    """Task i writes key i % 3 with update EDGE_UPDATES[case][i % 4]; key
    3 is never written."""
    upd = np.array(EDGE_UPDATES[case] * 3, dtype=np.float64)
    n = upd.size
    return pkg.TaskBatch(contexts=upd[:, None],
                         read_keys=np.arange(n) % 3,
                         origin=pkg.TaskBatch.even_origins(n, 2),
                         priority=np.arange(n))


def _store(pkg, start):
    store = pkg.DataStore.create(len(start), 2, value_width=1)
    store.write_rows(np.arange(len(start)),
                     np.asarray(start, dtype=np.float64)[:, None])
    return store


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(EDGE_UPDATES))
@pytest.mark.parametrize("merge", ["min", "max", "or"])
def test_merge_edges_match_the_numpy_oracle(merge, case, dtype):
    start = [5.0, np.inf, -np.inf, 7.0]
    stores = []
    for pkg, backend in ((ref, "numpy"), (port, _backend(dtype))):
        store = _store(pkg, start)
        pkg.Orchestrator(store, backend=backend).run_stage(
            _merge_batch(pkg, case), _updates, write_back=merge)
        stores.append(store.values[:, 0])
    _same(stores[1], stores[0], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("merge,upd,start,want", [
    ("min", [np.nan, 1.0], 5.0, np.nan),
    ("max", [np.nan, 1.0], 5.0, np.nan),
    ("or", [np.nan, 1.0], 5.0, np.nan),
    ("min", [np.inf, np.inf], np.inf, F64_MAX),
    ("max", [-np.inf, -np.inf], -np.inf, -F64_MAX),
], ids=["nan_min", "nan_max", "nan_or", "inf_min", "neg_inf_max"])
def test_orchestration_repro(merge, upd, start, want, dtype):
    """Two tasks write key 0 through `orchestration()`: the port stores what
    the oracle stores (the C1 repros of the ROADMAP)."""
    got = []
    for pkg, backend in ((ref, "numpy"), (port, _backend(dtype))):
        store = _store(pkg, [start, 0.0])
        tb = pkg.TaskBatch(contexts=np.array(upd)[:, None],
                           read_keys=np.zeros(2, dtype=np.int64),
                           origin=pkg.TaskBatch.even_origins(2, 2),
                           priority=np.arange(2))
        pkg.orchestration(tb, _updates, store, write_back=merge,
                          engine="tdorch", backend=backend)
        got.append(store.values[0, 0])
    _same(got[0], want, "float64")
    _same(got[1], got[0], dtype)


def _fused_batch(pkg, tasks, n_keys):
    return pkg.TaskBatch.from_ragged(
        np.zeros((len(tasks), 1)), tasks,
        pkg.TaskBatch.even_origins(len(tasks), 2),
        write_keys=np.full(len(tasks), -1), priority=np.arange(len(tasks)))


# (store values, tasks): arity below and at the batch's max arity
FUSED_CASES = {
    "issue": ([3e38, 3e38, np.nan, 1.0], [[0], [0, 1], [2, 3], [3, 0]]),
    "all_at_max": ([3e38, -3e38, np.nan, 1.0], [[0, 1], [2, 3], [3, 0]]),
    "inf": ([np.inf, -np.inf, 2.0, np.nan],
            [[0], [1], [0, 1, 2], [1, 2], [3], []]),
    "big_negative": ([-3e38, -2e38, 1e38, 0.5],
                     [[0], [1, 2], [2, 3, 0, 1], [3]]),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(FUSED_CASES))
@pytest.mark.parametrize("read_op", ["min", "max"])
def test_fused_reads_match_the_numpy_oracle(read_op, case, dtype):
    vals, tasks = FUSED_CASES[case]
    results = []
    for pkg, backend in ((ref, "numpy"), (port, _backend(dtype))):
        store = _store(pkg, vals)
        res = pkg.Orchestrator(store, backend=backend).run_stage(
            _fused_batch(pkg, tasks, len(vals)), pkg.fused_read(read_op),
            write_back="add", return_results=True)
        results.append(np.asarray(res.results, dtype=np.float64).ravel())
    _same(results[1], results[0], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("merge", ["min", "max"])
def test_fused_read_then_merge_matches_the_numpy_oracle(merge, dtype):
    """A fused min read whose tasks write: the read's fold and NaN reach
    the store through the merge."""
    vals = [3e38, np.nan, 1.0, -3e38, 2.0]
    tasks = [[0], [0, 1], [2, 3, 4], [4], [2, 0]]
    wk = np.array([0, 1, 2, 0, 3])
    stores = []
    for pkg, backend in ((ref, "numpy"), (port, _backend(dtype))):
        store = _store(pkg, vals)
        tb = pkg.TaskBatch.from_ragged(
            np.zeros((5, 1)), tasks, pkg.TaskBatch.even_origins(5, 2),
            write_keys=wk, priority=np.arange(5))
        pkg.Orchestrator(store, backend=backend).run_stage(
            tb, pkg.fused_read(merge), write_back=merge)
        stores.append(store.values[:, 0])
    _same(stores[1], stores[0], dtype)


# direct cases of the plain versions against numpy
def _np_combine(values, seg, S, op):
    return ref.get_merge_op(op).combine_segments(values, seg, S, None)


@pytest.mark.parametrize("op", ["min", "max", "or"])
def test_combine_ref_matches_numpy_ufunc_at(op):
    rng = np.random.default_rng(5)
    values = rng.normal(size=(200, 3)) * 1e38
    values[rng.random(values.shape) < 0.05] = np.nan
    values[rng.random(values.shape) < 0.05] = np.inf
    values[rng.random(values.shape) < 0.05] = -np.inf
    seg = rng.integers(0, 40, 200)
    want = _np_combine(values, seg, 45, op)  # segments 40-44 stay empty
    got = combine_ref(torch.from_numpy(values),
                      torch.from_numpy(seg.astype(np.int32)), 45, op=op)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_combine_ref_add_sums_each_segment_alone(dtype):
    """An add segment's error is its own terms' rounding, whatever the
    other segments hold: 1e14-sized segments beside unit ones (a prefix-sum
    difference would leave ~0.02 of error in the unit ones), and ±inf in a
    segment stays in that segment."""
    rng = np.random.default_rng(6)
    n, S = 3000, 60
    seg = rng.integers(0, S, n)
    values = rng.normal(size=(n, 2))
    values[seg % 3 == 0] *= 1e14
    values = torch.from_numpy(values).to(dtype)
    seg_t = torch.from_numpy(seg.astype(np.int32))
    got = combine_ref(values, seg_t, S, op="add").double().numpy()
    want = _np_combine(values.double().numpy(), seg, S, "add")
    mags = _np_combine(values.double().abs().numpy(), seg, S, "add")
    # float64 sums of each segment's rows, then one rounding to the dtype
    unit = 2.0 ** -53 if dtype == torch.float64 else 2.0 ** -24
    assert (np.abs(got - want) <= 64 * 2.0 ** -53 * mags
            + unit * np.abs(want)).all()
    values[5, 0] = np.inf
    got = combine_ref(values, seg_t, S, op="add").numpy()
    assert np.isinf(got[seg[5], 0])
    assert np.isfinite(np.delete(got[:, 0], seg[5])).all()


def test_combine_ref_folds_the_identity_per_dtype():
    seg = torch.tensor([0, 0, 1], dtype=torch.int32)
    for dt in (torch.float32, torch.float64):
        big = torch.finfo(dt).max
        v = torch.tensor([[np.inf], [np.inf], [np.nan]], dtype=dt)
        got = combine_ref(v, seg, 3, op="min")
        assert got[0, 0] == big and torch.isnan(got[1, 0]) \
            and got[2, 0] == big
        assert combine_ref(-v, seg, 3, op="max")[0, 0] == -big
        # without the fold: the bare minimum
        assert combine_ref(v, seg, 3, op="min", fold=False)[0, 0] == np.inf


def test_reduce_pairs_ref_folds_only_below_the_max_arity():
    values = torch.tensor([[3e38], [np.nan], [1.0], [-3e38]],
                          dtype=torch.float64)
    indptr = torch.tensor([0, 1, 3, 5, 5], dtype=torch.int32)
    indices = torch.tensor([0, 0, 2, 1, 3], dtype=torch.int32)
    got = reduce_pairs_ref(values, indptr, indices, read_op="min")
    assert got[0, 0] == BIG  # arity 1 < 2: the fill folds in
    assert got[1, 0] == 1.0 and torch.isnan(got[2, 0]) and got[3, 0] == 0
    got = reduce_pairs_ref(values, indptr, indices, read_op="max",
                           max_arity=1)
    assert got[0, 0] == 3e38  # at the stated max arity: no fill
    assert got[1, 0] == 3e38 and torch.isnan(got[2, 0])
    got = reduce_pairs_ref(values, indptr, indices, read_op="max",
                           max_arity=4)
    assert got[0, 0] == 3e38 and got[1, 0] == 3e38  # max(3e38, -BIG)
    assert reduce_pairs_ref(-values, indptr, indices, read_op="max",
                            max_arity=4)[0, 0] == -BIG
