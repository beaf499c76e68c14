"""The backward of the port's grouped GEMM (`kernels/moe_gemm`) held
against the JAX package's, on the same seeded numpy inputs in one process.

The JAX package trains its MoE models through autodiff of
`lax.ragged_dot`; the port's `grouped_gemm` is a `torch.autograd.Function`
whose backward is `grouped_gemm_bwd_ref` on the CPU (what runs here) and
two kernels on the card: dx = dy · wᵀ (the forward's tile walk with w read
transposed) and dw[g] = x_gᵀ · dy_g (`csrc/moe_gemm_bwd.cu`, the sums over
each group's ragged rows). Held here:

- dx and dw under `torch.autograd.grad` against `jax.vjp` of
  `lax.ragged_dot`: float32 within 1e-5·Σ|terms| + 1e-6 (float32 sums in
  other orders), bf16 on the same bf16 operands within the card's gate
  2^-8·|ref| + 1e-5·Σ|terms| + 1e-6 of JAX's float32 sums (one bf16
  rounding); `gradcheck` in float64; the edge rules (empty groups,
  negative sizes, sizes past M, rows beyond the sum, strided w, M = 0)
  against a float64 oracle; `core.spmd.grouped_swiglu` and `moe_push_pull`
  (hot and cold paths) under grad against `jax.grad` of the JAX package's
  at the reduced granite widths.
- The kernels' arithmetic, emulated: the bf16 dw kernels (`gg_dw_sm90`,
  `gg_dw_bf16`: exact bf16 products, a float32 sum truncated toward zero a
  k16 step of rows, folded into the tile's float32 sums every SUM_DEPTH
  rows — half a sum later in `gg_dw_sm90`'s second warpgroup — read from
  the source) and the dx kernels (`gg_sm90`'s arithmetic on wᵀ) against
  `jax.vjp` at the bf16 gate; the float32 sum of a 4,096-row group carried
  on the tensor core without the fold misses the gate's float32 term on
  same-sign operands. The float32 kernels (3xTF32, a 32-row stage's sums
  added to the tile's) through `tests/test_torch_tf32.py`'s emulation
  against `jax.vjp` at the float32 gate; one TF32 rounding misses it. Each
  dw emulation follows the kernels' walk: a group's rows in chunks of
  `dw_chunk_rows` from its first row (an H100's 132 SMs, and 4 SMs, which
  splits the long groups), the chunks' float32 sums added in chunk order.
- The walk itself: `dw_chunk_rows` (whole sums, at most an SM's fair
  share), `dw_plan_ref` (every row of every group in exactly one chunk,
  longest chunk first, the workspace slots of the split groups) and
  `route_dw`.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.core import spmd as jspmd
from repro_torch import kernels
from repro_torch.core import spmd
from repro_torch.kernels.moe_gemm import ops
from repro_torch.kernels.moe_gemm.ops import (dw_chunk_rows, dw_plan_ref,
                                              dw_walk, grouped_gemm,
                                              route_dw, route_dx)
from repro_torch.kernels.moe_gemm.ref import grouped_gemm_bwd_ref
from test_torch_moe_gemm_sm90 import SUM_DEPTH as SM90_SUM_DEPTH
from test_torch_moe_gemm_sm90 import _trunc32, _views, emulate_sums
from test_torch_tf32 import _mm, emulate_grouped_gemm

# one intra-op thread per test process: the suite runs in parallel workers
torch.set_num_threads(1)

SOURCE = (Path(__file__).resolve().parent.parent / "src" / "repro_torch"
          / "csrc" / "moe_gemm_bwd.cu")


def _constant(name: str) -> int:
    """A `constexpr int` of the dw kernels' source."""
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text())
    assert m, f"{name} not found in {SOURCE.name}"
    return int(m.group(1))


SUM_DEPTH = _constant("kSumDepth")  # rows a bf16 sum stays on the core
DEPTH16 = _constant("kDepth16")     # rows a bf16 ring stage
DEPTH32 = _constant("kDepth32")     # rows a float32 ring stage
TILE_K, TILE_N = _constant("kBM"), _constant("kBN")  # a dw tile
H100_SMS = 132
GEMM_REL = 1e-5                     # chip_smoke.py's GEMM_REL
BF16_ROUND = 2.0 ** -8              # chip_smoke.py's BF16_ROUND
MOE_GEOMS = ((4, 96, 32, 64), (1, 1, 64, 128), (6, 150, 128, 256),
             (3, 17, 32, 64))


@pytest.fixture(autouse=True)
def no_kernel_launch():
    """On the CPU the Function's backward is the plain version: nothing
    launches."""
    kernels.reset_launches()
    yield
    assert kernels.launches() == {k: 0 for k in kernels.KERNELS}


def _case(geom, seed, same_sign=False):
    """x, w and dy as numpy float32 (rows at random cuts, x and dy ~ N(0,
    1), w ~ N(0, 0.1²)), or their absolute values; sizes int32."""
    G, M, K, N = geom
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.integers(0, M + 1, size=G - 1))
    sizes = np.diff(np.r_[0, cuts, M]).astype(np.int32)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = (rng.normal(size=(G, K, N)) * 0.1).astype(np.float32)
    dy = rng.normal(size=(M, N)).astype(np.float32)
    if same_sign:
        x, w, dy = np.abs(x), np.abs(w), np.abs(dy)
    return x, w, dy, sizes


def _jax_vjp(x, w, dy, sizes):
    """(dx, dw) of `lax.ragged_dot` at (x, w) for cotangent dy, float32."""
    _, pull = jax.vjp(lambda a, b: lax.ragged_dot(a, b, jnp.asarray(sizes)),
                      jnp.asarray(x, jnp.float32),
                      jnp.asarray(w, jnp.float32))
    dx, dw = pull(jnp.asarray(dy, jnp.float32))
    return (torch.from_numpy(np.asarray(dx)),
            torch.from_numpy(np.asarray(dw)))


def _port_grads(x, w, dy, sizes):
    """(dx, dw) of the port's `grouped_gemm` under `torch.autograd.grad`."""
    x = x.clone().requires_grad_()
    w = w.clone().requires_grad_()
    y = grouped_gemm(x, w, torch.as_tensor(sizes))
    return torch.autograd.grad(y, (x, w), dy)


def _exact(x, w, dy, sizes):
    """float64 (dx, dw) and their Σ|terms| (the backward on |x|, |w|,
    |dy|)."""
    f = torch.float64
    st = torch.as_tensor(np.asarray(sizes))
    x, w, dy = (torch.as_tensor(a).to(f) for a in (x, w, dy))
    return (grouped_gemm_bwd_ref(x, w, st, dy),
            grouped_gemm_bwd_ref(x.abs(), w.abs(), st, dy.abs()))


def _share(got, want, mags, bf16: bool) -> float:
    """The share of the gate GEMM_REL·Σ|terms| + 1e-6 (+ BF16_ROUND·|ref|
    for a bf16 output) that |got - want| uses."""
    want = want.double()
    allowed = GEMM_REL * mags.double() + 1e-6
    if bf16:
        allowed = allowed + BF16_ROUND * want.abs()
    assert got.shape == want.shape
    err = (got.double() - want).abs()
    return float((err / allowed).max()) if err.numel() else 0.0


@pytest.mark.parametrize("geom", MOE_GEOMS + ((8, 512, 96, 64),),
                         ids=lambda g: "x".join(map(str, g)))
def test_float32_grads_match_jax_vjp(geom):
    x, w, dy, sizes = _case(geom, seed=sum(geom))
    got = _port_grads(*(torch.from_numpy(a) for a in (x, w, dy)), sizes)
    want = _jax_vjp(x, w, dy, sizes)
    _, mags = _exact(x, w, dy, sizes)
    for g, wt, m in zip(got, want, mags):
        assert g.dtype == torch.float32
        assert _share(g, wt, m, bf16=False) <= 1.0


@pytest.mark.parametrize("geom", MOE_GEOMS + ((8, 512, 96, 64),),
                         ids=lambda g: "x".join(map(str, g)))
def test_bf16_grads_within_the_card_gate_of_jax(geom):
    """bf16 x, w and dy: the port's dx and dw (float32 sums of the bf16
    products, rounded to bf16 once) against JAX's float32 vjp of the same
    bf16 values, at the gate chip_smoke.py holds the kernels to."""
    x, w, dy, sizes = _case(geom, seed=sum(geom) + 1)
    xb, wb, db = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, w, dy))
    got = _port_grads(xb, wb, db, sizes)
    want = _jax_vjp(xb.float().numpy(), wb.float().numpy(),
                    db.float().numpy(), sizes)
    _, mags = _exact(xb.float(), wb.float(), db.float(), sizes)
    for g, wt, m in zip(got, want, mags):
        assert g.dtype == torch.bfloat16
        assert _share(g, wt, m, bf16=True) <= 1.0


@pytest.mark.parametrize("sizes", [[4, -2, 9], [0, 7, 0], [3, 3, 30],
                                   [0, 0, 0]])
@pytest.mark.parametrize("strided", [False, True])
def test_gradcheck_float64(sizes, strided):
    """The Function's backward against finite differences of its forward
    in float64: negative sizes, empty groups, sizes past M (M = 12), rows
    beyond the sum, and w a strided view."""
    g = torch.Generator().manual_seed(len(sizes) + 7 * strided)
    x = torch.randn(12, 5, dtype=torch.float64, generator=g)
    wide = torch.randn(3, 5, 9, dtype=torch.float64, generator=g)
    w = wide[:, :, 2:8] if strided else wide[:, :, :6].contiguous()
    st = torch.tensor(sizes, dtype=torch.int32)
    assert torch.autograd.gradcheck(
        lambda a, b: grouped_gemm(a, b, st),
        (x.requires_grad_(), w.requires_grad_()))


EDGE_CASES = {
    "empty groups": ((4, 8, 32, 16), [0, 8, 0, 0]),
    "rows beyond the sum": ((5, 57, 24, 40), [11, 0, 20, 9, 0]),
    "negative, past M": ((4, 500, 64, 192), [-7, 300, 0, 400]),
    "sizes all 0": ((4, 200, 64, 128), [0, 0, 0, 0]),
    "M = 0": ((3, 0, 16, 16), [0, 0, 0]),
    "groups of 1": ((6, 70, 128, 64), [1, 1, 0, 1, 66, 1]),
}


@pytest.mark.parametrize("name", list(EDGE_CASES))
@pytest.mark.parametrize("strided", [False, True])
def test_edge_rules(name, strided):
    """Against the float64 oracle: rows at or beyond the groups' sum give
    dx exactly 0 and add to no dw, an empty group's dw is exactly 0, dw is
    dense and of w's shape for a strided w view; where the sizes are
    nonnegative and sum to at most M, against `jax.vjp` as well."""
    (G, M, K, N), sizes = EDGE_CASES[name]
    x, wide, dy, _ = _case((G, M, K, N + 8 * strided), seed=M + K)
    w = torch.from_numpy(wide)[:, :, 3:3 + N] if strided else \
        torch.from_numpy(wide)
    dy = dy[:, :N]
    got = _port_grads(torch.from_numpy(x), w, torch.from_numpy(dy), sizes)
    assert got[1].shape == (G, K, N) and got[1].is_contiguous()
    want, mags = _exact(x, w, dy, sizes)
    for g, wt, m in zip(got, want, mags):
        assert _share(g, wt, m, bf16=False) <= 1.0
    clamped = np.minimum(np.cumsum(np.maximum(sizes, 0)), M)
    assert not got[0][int(clamped[-1]):].any()
    counts = np.diff(np.r_[0, clamped])
    for gi in np.nonzero(counts == 0)[0]:
        assert not got[1][gi].any()
    if min(sizes) >= 0 and sum(sizes) <= M:
        jw = _jax_vjp(x, w.contiguous().numpy(), dy, sizes)
        for g, wt, m in zip(got, jw, mags):
            assert _share(g, wt, m, bf16=False) <= 1.0


def test_needs_input_grad_only():
    """Only the inputs that need a gradient get one; without grad mode, or
    with neither input requiring grad, the call is the plain forward."""
    x, w, dy, sizes = _case((3, 40, 16, 8), seed=3)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w).requires_grad_()
    y = grouped_gemm(xt, wt, torch.from_numpy(sizes))
    (dw,) = torch.autograd.grad(y, (wt,), torch.from_numpy(dy))
    assert dw.shape == wt.shape
    with torch.no_grad():
        assert grouped_gemm(xt, wt, torch.from_numpy(sizes)).grad_fn is None
    plain = grouped_gemm(xt, wt.detach(), torch.from_numpy(sizes))
    assert plain.grad_fn is None
    torch.testing.assert_close(plain, y.detach(), rtol=0, atol=0)


@pytest.mark.parametrize("K,N,offset,width,want", [
    (1024, 1024, 0, None, "moe_gemm_dx_sm90"),  # granite's in-projection
    (512, 1024, 0, None, "moe_gemm_dx_sm90"),   # and out-projection
    (24, 16, 1, None, "moe_gemm_dx_bf16"),      # a view one value in
    (30, 16, 0, None, "moe_gemm_dx_bf16"),      # dx rows of 30
    (24, 7, 0, 8, "moe_gemm_dx_bf16"),          # dy rows of 7
    (24, 8, 0, 12, "moe_gemm_dx_bf16"),         # w rows 24 bytes apart
    (24, 8, 0, 24, "moe_gemm_dx_sm90"),
    (24, 0, 0, 8, "moe_gemm_dx_bf16"),          # N = 0: no tensor map
])
def test_route_dx_predicate(K, N, offset, width, want):
    """bf16 dx takes gg_sm90 (B K-major) exactly where a TMA tensor map can
    describe dy and w: bases and w's strides 16-byte aligned, N > 0, K and
    N multiples of 8; float32 takes gg_tf32 whatever the layout."""
    x, w = _views(K, N, offset, width)
    dy = torch.zeros((x.shape[0], N), dtype=x.dtype)
    assert route_dx(dy, w) == want
    assert route_dx(dy.float(), w.float()) == "moe_gemm_dx"


# ---------------------------------------------------------------------------
# the dispatch under grad, against the JAX package's
# ---------------------------------------------------------------------------
# granite-moe-1b-a400m's reduced widths (src/repro/configs): d 64, 8
# experts, top 2, d_ff_expert 64, capacity factor 2.0, 2 hot experts
GRANITE_REDUCED = dict(T=64, d=64, f=64, E=8, k=2, capacity=2.0, hot=2)


def _dispatch_case(seed, hot_bias=3.0):
    r = GRANITE_REDUCED
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(r["T"], r["d"])).astype(np.float32)
    w_in = (rng.normal(size=(r["E"], r["d"], 2 * r["f"])) * 0.1).astype(
        np.float32)
    w_out = (rng.normal(size=(r["E"], r["f"], r["d"])) * 0.1).astype(
        np.float32)
    logits = rng.normal(size=(r["T"], r["E"]))
    logits[:, 3] += hot_bias  # one expert hot
    top = np.argsort(-logits, axis=1)[:, :r["k"]].astype(np.int32)
    gates = rng.uniform(0.2, 0.8, size=(r["T"], r["k"])).astype(np.float32)
    cot = rng.normal(size=(r["T"], r["d"])).astype(np.float32)
    return x, top, gates, w_in, w_out, cot


def _grads_close(got, want, rtol=1e-4, atol=1e-5):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("impl", ["ragged", "binned"])
def test_grouped_swiglu_grads_match_jax(impl):
    """`core.spmd.grouped_swiglu` under `torch.autograd.grad` against
    `jax.grad` of the JAX package's: xs, w_in and w_out, rows beyond the
    groups' sum included."""
    r = GRANITE_REDUCED
    rng = np.random.default_rng(5)
    M = 150
    sizes = np.array([30, 0, 41, 9, 25, 0, 17, 8], np.int32)  # 130 of 150
    xs = rng.normal(size=(M, r["d"])).astype(np.float32)
    w_in = (rng.normal(size=(8, r["d"], 2 * r["f"])) * 0.1).astype(
        np.float32)
    w_out = (rng.normal(size=(8, r["f"], r["d"])) * 0.1).astype(np.float32)
    cot = rng.normal(size=(M, r["d"])).astype(np.float32)

    def jloss(a, b, c):
        return (jspmd.grouped_swiglu(a, b, c, jnp.asarray(sizes), impl=impl)
                * cot).sum()
    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (xs, w_in, w_out)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (xs, w_in, w_out)]
    out = spmd.grouped_swiglu(*ts, torch.from_numpy(sizes), impl=impl)
    got = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), ts)
    _grads_close(got, want)


@pytest.mark.parametrize("num_hot", [0, 2], ids=["cold", "hot_and_cold"])
@pytest.mark.parametrize("seed", [0, 1])
def test_moe_push_pull_grads_match_jax(num_hot, seed):
    """`core.spmd.moe_push_pull` on one device under grad: the tokens, the
    gates and both expert stacks against `jax.grad` of the JAX package's,
    the hot path (pulled weights, a zero tail of cold rows) and the cold
    path (capacity buffers) at the reduced granite widths."""
    r = GRANITE_REDUCED
    x, top, gates, w_in, w_out, cot = _dispatch_case(seed)
    jcfg = jspmd.MoEDispatchConfig(num_experts=r["E"], top_k=r["k"],
                                   capacity_factor=r["capacity"],
                                   num_hot=num_hot, ep_size=1)
    pcfg = spmd.MoEDispatchConfig(num_experts=r["E"], top_k=r["k"],
                                  capacity_factor=r["capacity"],
                                  num_hot=num_hot)

    def jloss(a, g, b, c):
        y, _ = jspmd.moe_push_pull(a, jnp.asarray(top), g, b, c, jcfg)
        return (y * cot).sum()
    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (x, gates, w_in, w_out)))
    ts = [torch.from_numpy(a).requires_grad_()
          for a in (x, gates, w_in, w_out)]
    y, aux = spmd.moe_push_pull(ts[0], torch.from_numpy(top), *ts[1:], pcfg)
    assert int(aux.dropped_assignments) == 0
    got = torch.autograd.grad((y * torch.from_numpy(cot)).sum(), ts)
    _grads_close(got, want)


# ---------------------------------------------------------------------------
# the kernels' arithmetic, emulated
# ---------------------------------------------------------------------------
def _chunks(start: int, end: int, chunk):
    """A group's rows [start, end) as the kernels' chunks: `chunk` rows
    each from its first row (the whole group where None)."""
    step = chunk or max(end - start, 1)
    return [(c0, min(end, c0 + step)) for c0 in range(start, end, step)]


def _by_chunks(sizes, M, chunk, chunk_sums, shape):
    """dw (G, K, N) in float32: per group, `chunk_sums(c0, c1)` of each of
    its chunks, added in chunk order in float32 (`dw_reduce`); an empty
    group 0."""
    out = torch.zeros((len(sizes), *shape), dtype=torch.float32)
    start = 0
    for g, size in enumerate(np.asarray(sizes).tolist()):
        end = min(start + max(int(size), 0), M)
        for i, (c0, c1) in enumerate(_chunks(start, end, chunk)):
            part = chunk_sums(c0, c1)
            out[g] = part if i == 0 else out[g] + part
        start = end
    return out


def emulate_dw_bf16(x, dy, sizes, depth=SUM_DEPTH, chunk=None, shift=0):
    """The bf16 dw kernels' float32 sums (before dw's rounding) of bf16 x
    (M, K) and dy (M, N): per chunk of a group's rows (`chunk` rows from
    its first row; the whole group where None), per k16 step of its rows,
    the 16 exact products go into the tensor core's sum, truncated toward
    zero; a sum starts where 16·i + shift is a multiple of `depth` (i
    counted from the chunk's first row, `gg_dw_sm90`'s second warpgroup at
    shift = SUM_DEPTH / 2) and at the chunk's first step, and is added into
    the chunk's float32 sums to nearest where the next starts or at the
    chunk's last step; a split group's chunks are then added in chunk
    order."""
    M, K = x.shape
    N = dy.shape[1]
    xf, df = x.double(), dy.double()

    def chunk_sums(c0, c1):
        steps = -(-(c1 - c0) // 16)
        acc = torch.zeros((K, N), dtype=torch.float32)
        part = None
        for i in range(steps):
            r = slice(c0 + 16 * i, min(c1, c0 + 16 * i + 16))
            p = xf[r].T @ df[r]
            first = i == 0 or (16 * i + shift) % depth == 0
            part = _trunc32(p if first else part.double() + p)
            if i == steps - 1 or (16 * (i + 1) + shift) % depth == 0:
                acc = acc + part
        return acc
    return _by_chunks(sizes, M, chunk, chunk_sums, (K, N))


def emulate_dw_tf32(x, dy, sizes, split=True, chunk=None):
    """gg_dw_tf32's arithmetic: per chunk of a group's rows (as
    `emulate_dw_bf16`), per DEPTH32-row stage from its first row, the
    3xTF32 products (or one TF32 rounding) into stage sums added to the
    chunk's float32 sums; a split group's chunks added in chunk order."""
    M, K = x.shape

    def chunk_sums(c0, c1):
        acc = torch.zeros((K, dy.shape[1]), dtype=torch.float32)
        for r0 in range(c0, c1, DEPTH32):
            r = slice(r0, min(c1, r0 + DEPTH32))
            acc += _mm(x[r].T.contiguous(), dy[r], split)
        return acc
    return _by_chunks(sizes, M, chunk, chunk_sums, (K, dy.shape[1]))


def _bf16_case(geom, seed, same_sign=False):
    x, w, dy, sizes = _case(geom, seed, same_sign)
    return (*(torch.from_numpy(a).to(torch.bfloat16) for a in (x, w, dy)),
            sizes)


# MOE geometries, granite-moe-1b-a400m's widths at a few rows, and a group
# of 4,096 rows (what a training step gives an expert)
EMU_GEOMS = MOE_GEOMS + ((4, 256, 1024, 64), (4, 256, 64, 1024),
                         (2, 8192, 32, 32))
# a hot group of 2,300 rows: on 4 SMs dw_chunk_rows is 1,280, so it splits
# at 1,280 rows from its first row — inside a sum of the second warpgroup
SPLIT_GEOM, SPLIT_SIZES = (3, 3000, 128, 256), [2300, 0, 700]


def _emu_case(geom, seed):
    """`_bf16_case`, or SPLIT_GEOM with SPLIT_SIZES."""
    x, w, dy, sizes = _bf16_case(geom, seed)
    return x, w, dy, (np.array(SPLIT_SIZES, np.int32)
                      if geom == SPLIT_GEOM else sizes)


def _check_dw_bf16_emulation(geom, sms, shift):
    """The bf16 dw kernels' sums in the walk's chunks on `sms` SMs, the
    folds of the warpgroup at `shift`, rounded to bf16 once, against
    `jax.vjp` at the card's bf16 gate; returns (emulated sums, whether a
    group was split)."""
    x, w, dy, sizes = _emu_case(geom, seed=sum(geom) + 2)
    _, want = _jax_vjp(x.float().numpy(), w.float().numpy(),
                       dy.float().numpy(), sizes)
    _, (_, mags) = _exact(x.float(), w.float(), dy.float(), sizes)
    G, M, K, N = geom
    chunk = dw_chunk_rows(M, K, N, sms)
    got = emulate_dw_bf16(x, dy, sizes, chunk=chunk, shift=shift)
    assert _share(got.to(torch.bfloat16), want, mags, bf16=True) <= 1.0
    return got, chunk, (x, dy, sizes)


@pytest.mark.parametrize("geom", EMU_GEOMS,
                         ids=lambda g: "x".join(map(str, g)))
def test_dw_bf16_emulation_within_gate_of_jax(geom):
    """On an H100's SMs, both warpgroups' folds."""
    for shift in (0, SUM_DEPTH // 2):
        _check_dw_bf16_emulation(geom, H100_SMS, shift)


@pytest.mark.parametrize("shift", [0, SUM_DEPTH // 2],
                         ids=["warpgroup0", "warpgroup1"])
@pytest.mark.parametrize("geom", EMU_GEOMS + (SPLIT_GEOM,),
                         ids=lambda g: "x".join(map(str, g)))
def test_dw_bf16_split_emulation_within_gate_of_jax(geom, shift):
    """On 4 SMs, which splits the long groups (SPLIT_GEOM's hot group at
    1,280 rows, inside a sum of the second warpgroup): the chunks'
    partials added in chunk order stay within the gate, and the split
    changes the sums."""
    got, chunk, (x, dy, sizes) = _check_dw_bf16_emulation(geom, 4, shift)
    if geom == SPLIT_GEOM:
        assert chunk == 1280 and chunk < SPLIT_SIZES[0]
        assert not torch.equal(got, emulate_dw_bf16(x, dy, sizes,
                                                    shift=shift))


@pytest.mark.parametrize("geom", EMU_GEOMS[:5],
                         ids=lambda g: "x".join(map(str, g)))
def test_dx_bf16_emulation_within_gate_of_jax(geom):
    """The dx kernel (`gg_sm90` with B K-major) is the forward's arithmetic
    on wᵀ: either warpgroup's offset of the sums."""
    x, w, dy, sizes = _bf16_case(geom, seed=sum(geom) + 3)
    want, _ = _jax_vjp(x.float().numpy(), w.float().numpy(),
                       dy.float().numpy(), sizes)
    (_, _), (mags, _) = _exact(x.float(), w.float(), dy.float(), sizes)
    wt = w.transpose(1, 2).contiguous()
    for shift in (0, SM90_SUM_DEPTH // 2):
        got = emulate_sums(dy, wt, sizes, shift=shift).to(torch.bfloat16)
        assert _share(got, want, mags, bf16=True) <= 1.0


def _adversarial_rows(M=4096, K=8, N=8):
    """Same-sign bf16 x and dy on which a carried sum loses most: the first
    16 rows add 16 (the bottom of a binade, an ulp 2^-19 of it), every
    later 16 rows 16 · 2^-12 · 2^-11·(1 - 2^-5), just under one ulp, which
    a truncated sum drops whole."""
    x = torch.full((M, K), 2.0 ** -12)
    x[:16] = 1.0
    dy = torch.full((M, N), 2.0 ** -11 * (1 - 2.0 ** -5))
    dy[:16] = 1.0
    return x.to(torch.bfloat16), dy.to(torch.bfloat16), np.array([M],
                                                                 np.int32)


def _float32_share(sums, x, dy, sizes) -> float:
    """The emulated float32 dw sums against the exact sums, as a share of
    the gate's float32 term GEMM_REL·Σ|terms| + 1e-6."""
    w0 = torch.zeros((len(sizes), x.shape[1], dy.shape[1]))
    (_, exact), (_, mags) = _exact(x.float(), w0, dy.float(), sizes)
    return float(((sums.double() - exact).abs()
                  / (GEMM_REL * mags + 1e-6)).max())


@pytest.mark.parametrize("operands", ["random", "adversarial"])
def test_dw_sum_depth_keeps_a_margin_of_two(operands):
    """A group of 4,096 rows on same-sign operands: the folded float32 sums
    within half of the gate's float32 term."""
    if operands == "random":
        x, _, dy, _ = _bf16_case((1, 4096, 16, 16), seed=9, same_sign=True)
        sizes = np.array([4096], np.int32)
    else:
        x, dy, sizes = _adversarial_rows()
    assert _float32_share(emulate_dw_bf16(x, dy, sizes), x, dy, sizes) <= 0.5


def test_dw_carried_sum_misses_the_float32_term():
    """The control: the adversarial rows summed on the tensor core through
    all 256 k16 steps of a 4,096-row group, without the fold, land past
    the gate's float32 term; the fold every SUM_DEPTH rows keeps them
    within half of it."""
    x, dy, sizes = _adversarial_rows()
    carried = _float32_share(emulate_dw_bf16(x, dy, sizes, depth=1 << 20),
                             x, dy, sizes)
    assert carried > 1.0, carried
    assert _float32_share(emulate_dw_bf16(x, dy, sizes), x, dy, sizes) <= 0.5


def test_dw_kernel_constants():
    """Sums of whole ring stages, at most 256 rows deep (what the tests
    above hold), the float32 stage the emulation takes, and the host's
    walk on the source's tile and sum depth."""
    assert SUM_DEPTH % DEPTH16 == 0 and SUM_DEPTH <= 256
    assert SUM_DEPTH % (2 * DEPTH16) == 0  # halved between the warpgroups
    assert DEPTH32 == 32
    assert ops.SUM_DEPTH == SUM_DEPTH
    assert ops.DW_TILE == TILE_K == TILE_N


# ---------------------------------------------------------------------------
# the walk: chunks, the plan, the persistent blocks' units, the route
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("M,K,N,sms", [
    (131072, 1024, 1024, 132),  # granite-moe-1b-a400m's in-projection
    (131072, 512, 1024, 132),   # and out-projection
    (2048, 1024, 1024, 132), (3000, 128, 256, 4), (8192, 32, 32, 4),
    (1, 8, 8, 132), (0, 64, 64, 132), (10**6, 30, 50, 7)])
def test_dw_chunk_rows(M, K, N, sms):
    """A whole number of sums, at least one; where an SM's fair share of
    the call's tile-rows is a sum or more, no unit longer than it."""
    C = dw_chunk_rows(M, K, N, sms)
    assert C % SUM_DEPTH == 0 and C >= SUM_DEPTH
    tiles = -(-K // TILE_K) * -(-N // TILE_N)
    fair = tiles * M / sms
    if fair >= SUM_DEPTH:
        assert C <= fair < C + SUM_DEPTH
    else:
        assert C == SUM_DEPTH
    walk = dw_walk(M, K, N, 5, sms)
    assert walk.chunk_rows == C and walk.tiles == tiles
    assert walk.max_chunks == 5 + -(-M // C)
    assert walk.blocks == min(sms, walk.max_chunks * tiles)


def test_dw_chunk_rows_at_granites_shapes():
    """On an H100 the hot expert (a third of 131,072 Zipf-1.2 rows) splits
    into two chunks at the out-projection and stays whole at the
    in-projection, where an SM's fair share is 64 tiles' worth."""
    assert dw_chunk_rows(131072, 512, 1024, H100_SMS) == 31744
    assert dw_chunk_rows(131072, 1024, 1024, H100_SMS) == 63488


PLAN_CASES = {
    "granite Zipf": (np.bincount(np.random.default_rng(3).zipf(1.2, 131072)
                                 % 32, minlength=32), 131072, 15872),
    "negative, past M": ([5, 0, 700, 300, -3, 1000], 2000, 256),
    "all empty": ([0, 0, 0], 100, 256),
    "no rows": ([4, 4], 0, 256),
    "exact multiples": ([512, 256, 768, 0], 1536, 256),
    "one group": ([9000], 9000, 1024),
}


@pytest.mark.parametrize("name", list(PLAN_CASES))
def test_dw_plan_ref_covers_every_row_once_longest_first(name):
    """Every row of every group in exactly one chunk of its group, the
    chunks cut at multiples of C from the group's first row (so at whole
    sums) and at most C long; an empty group one chunk of no rows; the
    chunks longest first, ties in (group, chunk) order; a split group's
    chunks on consecutive workspace slots in chunk order, within the
    wrapper's bound of 2·⌈M/C⌉ slots and G + ⌈M/C⌉ chunks."""
    sizes, M, C = PLAN_CASES[name]
    chunks, splits = dw_plan_ref(sizes, M, C)
    ends = np.minimum(np.cumsum(np.maximum(np.asarray(sizes), 0)), M)
    starts = np.r_[0, ends[:-1]]
    G = len(starts)
    assert len(chunks) <= G + -(-M // C)
    covered = np.zeros(M, int)
    seen = {g: [] for g in range(G)}
    for g, r0, r1, slot in chunks:
        assert starts[g] <= r0 <= r1 <= ends[g] and r1 - r0 <= C
        assert (r0 - starts[g]) % C == 0
        covered[r0:r1] += 1
        seen[g].append((r0, r1, slot))
    assert (covered[:int(ends[-1]) if G else 0] == 1).all()
    assert not covered[int(ends[-1]) if G else 0:].any()
    key = [(-(r1 - r0), g, r0) for g, r0, r1, _ in chunks]
    assert key == sorted(key)
    split = {g: (slot0, n) for g, slot0, n in splits}
    assert [g for g, _, _ in splits] == sorted(split)
    slots = 0
    for g in range(G):
        parts = sorted(seen[g])
        if ends[g] == starts[g]:
            assert parts == [(starts[g], starts[g], -1)]
        elif g in split:
            slot0, n = split[g]
            assert slot0 == slots and len(parts) == n > 1
            assert [p[2] for p in parts] == list(range(slot0, slot0 + n))
            slots += n
        else:
            assert len(parts) == 1 and parts[0][2] == -1
    assert slots <= 2 * -(-M // C)


@pytest.mark.parametrize("K,N,offset,want", [
    (1024, 1024, 0, "moe_gemm_dw_sm90"),  # granite's in-projection
    (512, 1024, 0, "moe_gemm_dw_sm90"),   # and out-projection
    (24, 16, 0, "moe_gemm_dw_sm90"),
    (24, 16, 1, "moe_gemm_dw_bf16"),      # x one value into its storage
    (30, 16, 0, "moe_gemm_dw_bf16"),      # x rows of 30
    (24, 12, 0, "moe_gemm_dw_bf16"),      # dy rows of 12
    (8, 8, 0, "moe_gemm_dw_sm90"),
])
def test_route_dw_predicate(K, N, offset, want):
    """bf16 dw takes gg_dw_sm90 exactly where a TMA tensor map can
    describe x and dy: both bases 16-byte aligned, K and N multiples of 8
    (their rows then 16-byte aligned too); float32 takes gg_dw_tf32
    whatever the layout."""
    M = 40
    store = torch.zeros(offset + M * K + 64, dtype=torch.bfloat16)
    x = store[offset:offset + M * K].view(M, K)
    dy = torch.zeros((M, N), dtype=torch.bfloat16)
    assert route_dw(x, dy) == want
    assert route_dw(x.float(), dy.float()) == "moe_gemm_dw"


def _check_tf32_backward_emulation(geom, sms):
    x, w, dy, sizes = (torch.from_numpy(a) if isinstance(a, np.ndarray)
                       and a.dtype == np.float32 else a
                       for a in _case(geom, seed=sum(geom) + 4))
    if geom == SPLIT_GEOM:
        sizes = np.array(SPLIT_SIZES, np.int32)
    want = _jax_vjp(x.numpy(), w.numpy(), dy.numpy(), sizes)
    exact, mags = _exact(x, w, dy, sizes)
    G, M, K, N = geom
    got = (emulate_grouped_gemm(dy, w.transpose(1, 2).contiguous(), sizes),
           emulate_dw_tf32(x, dy, sizes,
                           chunk=dw_chunk_rows(M, K, N, sms)))
    for g, wt, e, m in zip(got, want, exact, mags):
        assert _share(g, wt, m, bf16=False) <= 1.0
        assert _share(g, e, m, bf16=False) <= 0.5


@pytest.mark.parametrize("geom", EMU_GEOMS[:6],
                         ids=lambda g: "x".join(map(str, g)))
def test_tf32_backward_emulation_within_the_float32_gate(geom):
    """float32 dx (`gg_tf32` on wᵀ) and dw (`gg_dw_tf32`, in the walk's
    chunks on an H100's SMs) in 3xTF32 against `jax.vjp` at the float32
    gate, and against float64 within half of it."""
    _check_tf32_backward_emulation(geom, H100_SMS)


@pytest.mark.parametrize("geom", EMU_GEOMS[:6] + (SPLIT_GEOM,),
                         ids=lambda g: "x".join(map(str, g)))
def test_tf32_backward_split_emulation_within_the_float32_gate(geom):
    """The same on 4 SMs, which splits the long groups: dw's chunk
    partials added in chunk order."""
    _check_tf32_backward_emulation(geom, 4)


def test_tf32_backward_single_rounding_misses_the_gate():
    """One TF32 rounding of each operand (hi·hi alone) misses the float32
    gate at granite-moe-1b-a400m's in-projection width, in dx and dw."""
    x, w, dy, sizes = (torch.from_numpy(a) if isinstance(a, np.ndarray)
                       and a.dtype == np.float32 else a
                       for a in _case((4, 128, 1024, 128), seed=23))
    exact, mags = _exact(x, w, dy, sizes)
    wt = w.transpose(1, 2).contiguous()
    for split, ok in ((True, True), (False, False)):
        got = (emulate_grouped_gemm(dy, wt, sizes, split=split),
               emulate_dw_tf32(x, dy, sizes, split=split))
        shares = [_share(g, e, m, bf16=False)
                  for g, e, m in zip(got, exact, mags)]
        assert (max(shares) <= 0.5) if ok else (min(shares) > 1.0), shares
