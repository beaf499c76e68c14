"""The port's attention, decode and scan kernels on the card, against their
plain PyTorch versions on the same inputs. Every test here is marked
`cuda` and skips without a CUDA device: a CUDA kernel has no CPU mode (the
CPU tests hold the plain versions against the JAX package). This file
imports no JAX, so it runs on a machine with the card alone:

    python -m pytest -m cuda tests/test_torch_cuda_kernels.py

Inputs are the seeded numpy cases of the FLASH / DECODE / MAMBA / MOE
families of `tests/test_kernels.py`. Tolerances are the JAX suite's: atol
= rtol = 2e-5 for attention and decode in float32 (sums in other orders),
1e-3 for the scan, 3e-2 for bf16 (rounding of inputs and outputs). The
bf16 tensor-core kernels (`flash_attention_sm90`, `flash_decode_sm90`) are
also held to `chip_smoke.py`'s gate: within ATTN_REL·(1+|ref|) +
2^-8·|ref| of the plain version run in float32 on the same bf16 inputs
(the output's own rounding plus the float32 gate). The 3xTF32 kernels
(`flash_attention_tf32`, the grouped GEMM `moe_gemm`) are held to
chip_smoke.py's float32 gates against the plain version in float64:
ATTN_REL·(1+|ref|), and 1e-5·Σ|x w| + 1e-6 for the GEMM. The bf16 grouped
GEMM is held to chip_smoke.py's bf16 GEMM gate against the plain
version's float32 sums on the same bf16 operands: 2^-8·|ref| + 1e-5·Σ|x
w| + 1e-6 (its one output rounding plus the float32 term), on both of its
kernels: `moe_gemm_sm90` (TMA and `wgmma`, where a tensor map can describe
the operands) and `moe_gemm_bf16` (`mma.sync`, any layout), each call's
counter asserted by its route. The
tensor-core SSD scan (three kernels behind the "mamba_scan" counter) is
held to chip_smoke.py's scan gates: (SSD_REL + 8·u32·max|l|)·Σ|terms| +
1e-6 against float64, plus 2^-8·|ref| in bf16 against float32.

The segment combine (B2) and the fused gather-reduce (B3) are held to
their plain versions exactly (min, max, or, write, reads; NaN equal to
NaN), sums within chip_smoke.py's 1e-6·Σ|terms| + 1e-6: at NaN, ±inf and
±3e38 (the inputs of tests/test_torch_merge_edges.py), and for B2 on a
Zipf-2.0 hot segment, with rows outside the segments, ties of the write
merge, rows of 3, 16 and 1,536 values and rows not 16-byte aligned. B3 is
also held on each of its layouts (`stage_fused.ops.layout`: 16-byte or
one-value loads, narrow or wide rows) at w = 1 ... 1536 in float32 and
float64, with every read op, arity 0, NaN, ±3e38, the max-arity fill, a
row view that is not 16-byte aligned and one task of arity 1,000. The
histogram (B1) is held exactly on each route (`histogram.ops.route`: the
shared route below 48 KB and in the opt-in band, the global route), with
uniform and Zipf ids, weighted and not, ids out of range on both sides.

A small `StagePlan` runs through `Orchestrator.run_plan` on the card: its
write-backs stay on the device until the plan exits (one counted host sync
in all), and every engine runs there when no device is named.

The attention backward (bf16 `csrc/flash_attention_bwd_sm90.cu`, float32
`csrc/flash_attention_bwd_tf32_sm90.cu`; counters "flash_attention_bwd_bf16" /
"_tf32") is held to chip_smoke.py's gate
against `attention_bwd_ref` on the same q, k, v, out, lse and dout: each
of dq, dk, dv within 2^-8·|ref| + 2^-7·Σ|terms| in bf16 against float32
(the outputs' rounding; P and dS rounded to bf16 once; float32 sums in
other orders), Σ|terms| the plain version's magnitudes with |dS| as
P ⊙ (|dP| + |D|) (`terms="values"`), and ATTN_BWD_REL·(|ref| + Σ|terms|)
= 2e-5 in float32 against float64 (3xTF32), |dS| as
P ⊙ (|dO|·|v|ᵀ + Σ|dO ⊙ O|) (`terms="products"`); the
forward's log-sum-exp output
against the plain one, with the output unchanged by it; `attention` under
autograd on the card (one forward and one backward launch), and with grad
off (no lse: the serving launch). Under grad the float32 `mamba_ssd`
launches its forward and backward kernels and the bf16 one raises (no
bf16 backward kernel, ROADMAP A11f); `grouped_gemm` launches its backward.
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import attention, decode_attention, mamba_ssd
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_ref)
from repro_torch.kernels.flash_decode.ref import decode_attention_ref
from repro_torch.kernels.histogram.ops import count_ids, device_limits, route
from repro_torch.kernels.histogram.ref import histogram_ref
from repro_torch.kernels.mamba_scan.ref import ssd_scan_ref
from repro_torch.kernels.moe_gemm import ops as moe_ops
from repro_torch.kernels.moe_gemm.ops import copies16, grouped_gemm, tile_rows
from repro_torch.kernels.moe_gemm.ref import (grouped_gemm_bwd_ref,
                                              grouped_gemm_ref)
from repro_torch.kernels.segment_combine.ops import combine
from repro_torch.kernels.segment_combine.ref import combine_ref
from repro_torch.kernels.stage_fused.ops import fused_reduce, layout
from repro_torch.kernels.stage_fused.ref import reduce_pairs_ref

pytestmark = pytest.mark.cuda

# (S, H, KV, hd) x causal: the FLASH family
FLASH_GEOMS = [(S, H, KV, hd, causal)
               for (S, H, KV, hd) in [(128, 4, 4, 64), (256, 8, 2, 64),
                                      (128, 4, 1, 128), (64, 2, 2, 32)]
               for causal in (True, False)]
# (B, T, KV, G, hd): the DECODE family, and G = 16 at hd 128
DECODE_GEOMS = [(2, 128, 2, 4, 64), (1, 256, 1, 8, 64), (2, 64, 4, 1, 32),
                (2, 1000, 2, 16, 128)]
# (S, nh, hd, ds, chunk): the MAMBA family, and chunk 256 (run as 128)
MAMBA_GEOMS = [(32, 2, 8, 8, 16), (64, 3, 16, 8, 16), (128, 1, 32, 16, 32),
               (256, 2, 64, 64, 256)]
TOL = {"attention": 2e-5, "scan": 1e-3, "bf16": 3e-2}
ATTN_REL = 2e-5
BF16_ROUND = 2.0 ** -8
SSD_REL = 1e-5
ATTN_BWD_REL = 2e-5
U32 = 2.0 ** -24
MERGES = ["add", "min", "max", "or", "write"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    kernels.reset_launches()
    return torch.device("cuda")


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("geom", FLASH_GEOMS,
                         ids=lambda g: "x".join(map(str, g)))
def test_attention_kernel(dev, geom, dtype):
    S, H, KV, hd, causal = geom
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(_normal(rng, 2, S, n, hd)).to(
        dev, getattr(torch, dtype)) for n in (H, KV, KV))
    got = attention(q, k, v, causal=causal)
    want = attention_ref(q, k, v, causal=causal)
    name = "flash_attention_tf32" if dtype == "float32" else \
        "flash_attention_sm90"
    assert kernels.launches()[name] == 1
    tol = TOL["attention" if dtype == "float32" else "bf16"]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("length", [0, 1, 100, 128, 1005])
@pytest.mark.parametrize("geom", DECODE_GEOMS,
                         ids=lambda g: "x".join(map(str, g)))
def test_decode_kernel(dev, geom, length):
    B, T, KV, G, hd = geom
    rng = np.random.default_rng(1)
    q = torch.from_numpy(_normal(rng, B, KV * G, hd)).to(dev)
    k, v = (torch.from_numpy(_normal(rng, B, T, KV, hd)).to(dev)
            for _ in range(2))
    want = decode_attention_ref(q, k, v, length)
    for n in (length, torch.tensor(length, device=dev)):
        got = decode_attention(q, k, v, n)
        torch.testing.assert_close(got, want, atol=TOL["attention"],
                                   rtol=TOL["attention"])
    assert kernels.launches()["flash_decode"] == 2


def test_decode_kernel_bf16(dev):
    rng = np.random.default_rng(2)
    q = torch.from_numpy(_normal(rng, 2, 8, 64)).to(dev, torch.bfloat16)
    k, v = (torch.from_numpy(_normal(rng, 2, 700, 2, 64)).to(
        dev, torch.bfloat16) for _ in range(2))
    got = decode_attention(q, k, v, 650)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(),
                               decode_attention_ref(q, k, v, 650).float(),
                               atol=TOL["bf16"], rtol=TOL["bf16"])
    assert kernels.launches()["flash_decode_sm90"] == 1


def _bf16_gate(got, q, k, v, ref, *args, **kw):
    """got (bf16) within ATTN_REL·(1+|want|) + 2^-8·|want| of `ref` run
    in float32 on the same bf16 inputs."""
    assert got.dtype == torch.bfloat16
    want = ref(q.float(), k.float(), v.float(), *args, **kw).double()
    err = (got.double() - want).abs()
    allowed = ATTN_REL * (1 + want.abs()) + BF16_ROUND * want.abs()
    assert bool(torch.isfinite(got).all())
    assert bool((err <= allowed).all()), float((err / allowed).max())


@pytest.mark.parametrize("S,T,H,KV,hd,causal", [
    (S, S, H, KV, hd, causal)
    for (S, H, KV, hd) in [(128, 4, 4, 64), (256, 8, 2, 64),
                           (128, 4, 1, 128), (64, 2, 2, 32),
                           (100, 4, 2, 64), (300, 4, 2, 128),
                           (100, 2, 1, 32)]
    for causal in (True, False)] + [
    (48, 80, 4, 2, 32, False), (200, 129, 4, 1, 64, False),
    (130, 384, 8, 2, 128, False)])
def test_attention_sm90_bf16_gate(dev, S, T, H, KV, hd, causal):
    """The wgmma kernel at hd 32 / 64 / 128, causal and not, ragged S
    (100, 300), non-causal S != T, at the bf16 gate."""
    rng = np.random.default_rng(7)
    q = torch.from_numpy(_normal(rng, 2, S, H, hd)).to(dev, torch.bfloat16)
    k, v = (torch.from_numpy(_normal(rng, 2, T, KV, hd)).to(
        dev, torch.bfloat16) for _ in range(2))
    got = attention(q, k, v, causal=causal)
    _bf16_gate(got, q, k, v, attention_ref, causal=causal)
    assert kernels.launches()["flash_attention_sm90"] == 1
    assert kernels.launches()["flash_attention_tf32"] == 0


@pytest.mark.parametrize("S,T,H,KV,hd,causal", [
    (S, S, H, KV, hd, causal)
    for (S, H, KV, hd) in [(128, 4, 4, 64), (256, 8, 2, 64),
                           (128, 4, 1, 128), (64, 2, 2, 32),
                           (100, 4, 2, 64), (300, 4, 2, 128),
                           (100, 2, 1, 32)]
    for causal in (True, False)] + [
    (48, 80, 4, 2, 32, False), (200, 129, 4, 1, 64, False),
    (130, 384, 8, 2, 128, False)])
def test_attention_tf32_float32_gate(dev, S, T, H, KV, hd, causal):
    """The 3xTF32 kernel at hd 32 / 64 / 128, GQA, causal and not, ragged
    S (100, 300), non-causal S != T: within ATTN_REL·(1+|ref|) of the
    plain version in float64."""
    rng = np.random.default_rng(9)
    q = torch.from_numpy(_normal(rng, 2, S, H, hd)).to(dev)
    k, v = (torch.from_numpy(_normal(rng, 2, T, KV, hd)).to(dev)
            for _ in range(2))
    got = attention(q, k, v, causal=causal)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    want = attention_ref(q.double(), k.double(), v.double(), causal=causal)
    err = (got.double() - want).abs()
    allowed = ATTN_REL * (1 + want.abs())
    assert bool((err <= allowed).all()), float((err / allowed).max())
    assert kernels.launches()["flash_attention_tf32"] == 1
    assert kernels.launches()["flash_attention_sm90"] == 0


def _gemm_gate(x, w, sizes):
    """grouped_gemm on the card within 1e-5·Σ|x w| + 1e-6 of the plain
    version in float64 (chip_smoke.py's `gemm_parity`)."""
    got = grouped_gemm(x, w, sizes)
    want = grouped_gemm_ref(x.double(), w.double(), sizes)
    mags = grouped_gemm_ref(x.abs().double(), w.abs().double(), sizes)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    err = (got.double() - want).abs()
    allowed = 1e-5 * mags + 1e-6
    assert bool((err <= allowed).all()), float((err / allowed).max())
    return got


def _moe(rng, G, M, K, N, dev):
    cuts = np.sort(rng.integers(0, M + 1, size=G - 1))
    sizes = np.diff(np.r_[0, cuts, M]).astype(np.int32)
    x = torch.from_numpy(_normal(rng, M, K)).to(dev)
    w = torch.from_numpy(_normal(rng, G, K, N) * 0.1).to(dev)
    return x, w, torch.from_numpy(sizes).to(dev)


@pytest.mark.parametrize("geom", [(4, 96, 32, 64), (1, 1, 64, 128),
                                  (6, 150, 128, 256), (3, 17, 32, 64),
                                  (40, 1024, 1536, 1024),
                                  (40, 1024, 512, 1536), (5, 57, 24, 40),
                                  (3, 300, 30, 50), (2, 200, 33, 7),
                                  (2, 300, 30, 50), (1, 700, 64, 96),
                                  (4, 4096, 1536, 1024)],
                         ids=lambda g: "x".join(map(str, g)))
def test_grouped_gemm_kernel(dev, geom):
    """The MOE geometries of tests/test_kernels.py, granite's in- and
    out-projection at decode size (64-row tiles) and an in-projection of
    4,096 rows (128-row tiles), and K or N not a multiple of 4 (K = 30 and
    33 take the 4-byte loads, at either tile)."""
    G, M = geom[:2]
    assert tile_rows(M, G) == (64 if M < 128 * G else 128)
    got = _gemm_gate(*_moe(np.random.default_rng(5), *geom, dev))
    assert got.shape == (geom[1], geom[3])
    assert kernels.launches()["moe_gemm"] == 1


@pytest.mark.parametrize("M", [100, 600], ids=["64-row", "128-row"])
def test_grouped_gemm_kernel_partial_column_chunk(dev, M):
    """N = 6 columns of rows 8 apart: 16-byte loads whose last chunk is cut
    at N (the rest of the chunk filled with zeros, not read)."""
    rng = np.random.default_rng(10)
    x, _, sizes = _moe(rng, 2, M, 40, 8, dev)
    w = torch.from_numpy(_normal(rng, 2, 40, 8)).to(dev)[..., :6]
    assert copies16(x, w) and not w.is_contiguous()
    got = _gemm_gate(x, w, sizes)
    torch.testing.assert_close(got, grouped_gemm(x, w.contiguous(), sizes),
                               atol=0, rtol=0)


def test_grouped_gemm_kernel_empty_groups_and_rows_beyond_the_sum(dev):
    x = torch.ones((8, 32), device=dev)
    w = torch.ones((4, 32, 16), device=dev)
    got = _gemm_gate(x, w, torch.tensor([0, 8, 0, 0], dtype=torch.int32,
                                        device=dev))
    assert bool((got == 32).all())
    rng = np.random.default_rng(6)
    x, w, _ = _moe(rng, 5, 57, 24, 40, dev)
    got = _gemm_gate(x, w, torch.tensor([11, 0, 20, 9, 0],
                                        dtype=torch.int32, device=dev))
    assert not bool(got[40:].any())
    assert kernels.launches()["moe_gemm"] == 2


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "unaligned"])
def test_grouped_gemm_kernel_reads_strided_weight_views(dev, offset):
    """w_in and w_out as views of one wider row per expert, as the naive
    arm passes the store's rows; one element in, the views are not 16-byte
    aligned and take the 4-byte loads. Both give the stacks' results."""
    G, M, K, N, F = 3, 40, 24, 16, 8
    rng = np.random.default_rng(7)
    x, _, sizes = _moe(rng, G, M, K, N, dev)
    rows = torch.from_numpy(_normal(rng, G, offset + K * N + N * F)).to(dev)
    w_in = rows[:, offset:offset + K * N].view(G, K, N)
    w_out = rows[:, offset + K * N:].view(G, N, F)
    h = _gemm_gate(x, w_in, sizes)
    torch.testing.assert_close(h, grouped_gemm(x, w_in.contiguous(), sizes),
                               atol=0, rtol=0)
    _gemm_gate(h, w_out, sizes)


def _gemm_gate_bf16(x, w, sizes, kernel=None):
    """bf16 grouped_gemm on the card within BF16_ROUND·|ref| + 1e-5·Σ|x w|
    + 1e-6 of the plain version's float32 sums on the same bf16 operands
    (chip_smoke.py's `gemm_parity` in bf16). `kernel` (a launch counter)
    takes that kernel in place of the route's; the call must count one
    launch of it and none of the other."""
    kernel = kernel or moe_ops.route(x, w)
    before = kernels.launches()
    got = (grouped_gemm(x, w, sizes) if kernel == moe_ops.route(x, w)
           else moe_ops._launch(x, w, sizes, kernel=kernel))
    after = kernels.launches()
    if x.shape[0] and w.shape[2]:
        assert after[kernel] == before[kernel] + 1
    other = ({"moe_gemm_sm90", "moe_gemm_bf16"} - {kernel}).pop()
    assert after[other] == before[other]
    want = grouped_gemm_ref(x.float(), w.float(), sizes).double()
    mags = grouped_gemm_ref(x.abs().double(), w.abs().double(), sizes)
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    err = (got.double() - want).abs()
    allowed = BF16_ROUND * want.abs() + 1e-5 * mags + 1e-6
    assert bool((err <= allowed).all()), float((err / allowed).max())
    return got


def _bf16(*ts):
    return tuple(t.to(torch.bfloat16) for t in ts)


def _sizes(sz, dev):
    return torch.tensor(sz, dtype=torch.int32, device=dev)


@pytest.mark.parametrize("geom", [(4, 96, 32, 64), (1, 1, 64, 128),
                                  (6, 150, 128, 256), (3, 17, 32, 64),
                                  (40, 64, 1536, 1024), (40, 80, 512, 1536),
                                  (4, 4096, 1536, 1024), (5, 57, 24, 40),
                                  (3, 300, 30, 50), (2, 200, 33, 7),
                                  (2, 300, 30, 50), (1, 700, 64, 96),
                                  (4, 700, 1536, 1024)],
                         ids=lambda g: "x".join(map(str, g)))
def test_grouped_gemm_bf16_kernel(dev, geom):
    """Both bf16 kernels: the MOE geometries, granite's in- and
    out-projection at a decode step (64-row tiles) and at 4,096 rows
    (128-row tiles, clusters of two blocks), K = 1,536 (24 ring stages,
    six 256-deep sums), K or N not a multiple of 8. Aligned operands route
    to `gg_sm90` and also run on `gg_bf16`; the rest (K = 30 and 33, N =
    50 and 7) route to `gg_bf16`, and `gg_sm90` refuses them (a raise, no
    fallback)."""
    G, M, K, N = geom
    x, w, sizes = _moe(np.random.default_rng(15), *geom, dev)
    x, w = _bf16(x, w)
    aligned = K % 8 == 0 and N % 8 == 0
    assert copies16(x, w) == aligned
    assert moe_ops.route(x, w) == ("moe_gemm_sm90" if aligned else "moe_gemm_bf16")
    got = _gemm_gate_bf16(x, w, sizes)
    assert got.shape == (M, N)
    if aligned:
        _gemm_gate_bf16(x, w, sizes, kernel="moe_gemm_bf16")
    else:
        with pytest.raises(RuntimeError, match="moe_gemm_sm90"):
            moe_ops._launch(x, w, sizes, kernel="moe_gemm_sm90")
    assert kernels.launches()["moe_gemm"] == 0


@pytest.mark.parametrize("M", [100, 600], ids=["64-row", "128-row"])
def test_grouped_gemm_bf16_kernel_partial_column_chunk(dev, M):
    """N = 6 columns of rows 16 apart (`gg_bf16`: a 16-byte load cut at
    N), the output stored a value at a time where N is odd (N = 5); N = 8
    of the same rows takes `gg_sm90` (a 16-byte row of w for each k)."""
    rng = np.random.default_rng(16)
    x, _, sizes = _moe(rng, 2, M, 40, 8, dev)
    w = torch.from_numpy(_normal(rng, 2, 40, 16)).to(dev)
    x, w = _bf16(x, w)
    for n in (6, 5, 8):
        view = w[..., :n]
        assert copies16(x, view) and not view.is_contiguous()
        got = _gemm_gate_bf16(x, view, sizes)
        assert torch.equal(got, grouped_gemm(x, view.contiguous(), sizes))
    assert moe_ops.route(x, w[..., :8]) == "moe_gemm_sm90"
    assert kernels.launches()["moe_gemm_bf16"] == 4
    assert kernels.launches()["moe_gemm_sm90"] == 2


def test_grouped_gemm_bf16_kernel_empty_groups_and_rows_beyond_the_sum(dev):
    x = torch.ones((8, 32), device=dev, dtype=torch.bfloat16)
    w = torch.ones((4, 32, 16), device=dev, dtype=torch.bfloat16)
    got = _gemm_gate_bf16(x, w, _sizes([0, 8, 0, 0], dev))
    assert bool((got == 32).all())
    rng = np.random.default_rng(17)
    for geom in ((5, 57, 24, 40), (5, 300, 64, 128)):
        x, w, _ = _moe(rng, *geom, dev)
        x, w = _bf16(x, w)
        sizes = _sizes([11, 0, 20, 9, 0], dev)
        for kernel in ("moe_gemm_sm90", "moe_gemm_bf16"):
            got = _gemm_gate_bf16(x, w, sizes, kernel)
            assert not bool(got[40:].any())
    assert kernels.launches()["moe_gemm_sm90"] == 3
    assert kernels.launches()["moe_gemm_bf16"] == 2


@pytest.mark.parametrize("case", [
    "straddle", "group of 1", "wrap", "zero rows", "all sizes zero",
    "zero tail of tiles", "negative and past M"])
def test_grouped_gemm_sm90_tile_walk(dev, case):
    """`gg_sm90`'s tile table and persistent walk: row tiles whose x box
    runs into the next group's rows (computed, not stored), groups of one
    row, more tiles than the card keeps blocks (the walk wraps: 64-row and
    128-row tiles), no rows at all, sizes all 0, a zero tail of three
    128-row tiles, and negative sizes with a sum past M (a column tile past
    N = 192 too). Both kernels within the gate of the plain version."""
    rng = np.random.default_rng(21)
    geom, sizes = {
        "straddle": ((3, 300, 64, 128), [100, 60, 140]),
        "group of 1": ((6, 70, 128, 64), [1, 1, 0, 1, 66, 1]),
        "wrap": ((40, 4000, 256, 1024), None),
        "zero rows": ((3, 0, 64, 64), [0, 0, 0]),
        "all sizes zero": ((4, 200, 64, 128), [0, 0, 0, 0]),
        "zero tail of tiles": ((3, 400, 128, 64), [30, 0, 10]),
        "negative and past M": ((4, 500, 64, 192), [-7, 300, 0, 400]),
    }[case]
    x, w, drawn = _moe(rng, *geom, dev)
    x, w = _bf16(x, w)
    sizes = drawn if sizes is None else _sizes(sizes, dev)
    got = _gemm_gate_bf16(x, w, sizes, "moe_gemm_sm90")
    assert got.shape == (geom[1], geom[3])
    if case == "wrap":  # 103 row tiles x 8 column tiles at 64 rows
        big = _moe(rng, 8, 65536, 64, 1024, dev)
        _gemm_gate_bf16(*_bf16(*big[:2]), big[2], "moe_gemm_sm90")
    if case == "zero rows":
        assert kernels.launches()["moe_gemm_sm90"] == 0
        return
    if case in ("all sizes zero", "zero tail of tiles"):
        covered = int(sizes.clamp(min=0).sum())
        assert not bool(got[covered:].any())
    _gemm_gate_bf16(x, w, sizes, "moe_gemm_bf16")


def test_grouped_gemm_sm90_back_to_back_calls(dev):
    """Calls queued back to back with no synchronization, alternating a
    4-group, 16-row table and a 40-group, 20-row one (a granite decode
    step's hot and cold SwiGLUs): each `gg_sm90` launch may start while its
    prologue writes the plan, and must walk that plan, not the one the
    last call left in the same memory. Every output within the gate."""
    rng = np.random.default_rng(22)
    hot = _moe(rng, 4, 16, 512, 1536, dev)
    cold = _moe(rng, 40, 20, 1536, 1024, dev)
    cases = [(*_bf16(x, w), sz) for x, w, sz in (hot, cold)]
    outs = [grouped_gemm(*cases[i % 2]) for i in range(40)]
    torch.cuda.synchronize()
    for i, got in enumerate(outs):
        x, w, sz = cases[i % 2]
        want = grouped_gemm_ref(x.float(), w.float(), sz).double()
        mags = grouped_gemm_ref(x.abs().double(), w.abs().double(), sz)
        allowed = BF16_ROUND * want.abs() + 1e-5 * mags + 1e-6
        assert bool(((got.double() - want).abs() <= allowed).all()), i
    assert kernels.launches()["moe_gemm_sm90"] == 40


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "unaligned"])
def test_grouped_gemm_bf16_kernel_reads_strided_weight_views(dev, offset):
    """w_in and w_out as views of one wider bf16 row per expert; aligned,
    both route to `gg_sm90` (tensor maps with the views' strides); one
    element in, the views are not 16-byte aligned and take `gg_bf16`'s
    one-value loads. Both give the stacks' results bit for bit."""
    G, M, K, N, F = 3, 40, 24, 16, 8
    rng = np.random.default_rng(18)
    x, _, sizes = _moe(rng, G, M, K, N, dev)
    rows = torch.from_numpy(_normal(rng, G, offset + K * N + N * F)).to(dev)
    x, rows = _bf16(x, rows)
    w_in = rows[:, offset:offset + K * N].view(G, K, N)
    w_out = rows[:, offset + K * N:].view(G, N, F)
    assert copies16(x, w_in) == (offset == 0)
    want = "moe_gemm_sm90" if offset == 0 else "moe_gemm_bf16"
    assert moe_ops.route(x, w_in) == moe_ops.route(x, w_out) == want
    h = _gemm_gate_bf16(x, w_in, sizes)
    stack = moe_ops._launch(x, w_in.contiguous(), sizes, kernel=want)
    assert torch.equal(h, stack)
    y = _gemm_gate_bf16(h, w_out, sizes)
    stack = moe_ops._launch(h, w_out.contiguous(), sizes, kernel=want)
    assert torch.equal(y, stack)
    assert kernels.launches()[want] == 4


def test_grouped_gemm_bf16_kernel_copies_nothing_to_float32(dev):
    """The bf16 route reads its operands in place: a call allocates its
    output and its tile table, nothing the size of x or w in float32."""
    x, w, sizes = _moe(np.random.default_rng(19), 40, 4096, 1536, 1024, dev)
    x, w = _bf16(x, w)
    assert moe_ops.route(x, w) == "moe_gemm_sm90"
    grouped_gemm(x, w, sizes)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = grouped_gemm(x, w, sizes)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - before
    assert extra <= out.numel() * 2 + (4096 // 64 + 41) * 16 + 4096


def test_float32_kernels_ignore_allow_tf32(dev):
    """allow_tf32 switches no route: the 3xTF32 kernels give the same bits
    with it on and off."""
    rng = np.random.default_rng(8)
    x, w, sizes = _moe(rng, 4, 96, 64, 64, dev)
    q, k, v = (torch.from_numpy(_normal(rng, 1, 128, 2, 64)).to(dev)
               for _ in range(3))
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        outs = []
        for allow in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = allow
            outs.append((grouped_gemm(x, w, sizes), attention(q, k, v)))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    assert kernels.launches()["moe_gemm"] == 2
    assert kernels.launches()["flash_attention_tf32"] == 2


@pytest.mark.parametrize("B,T,KV,G,hd", [
    (2, 128, 2, 4, 64), (1, 256, 1, 8, 64), (2, 64, 4, 1, 32),
    (2, 1000, 2, 16, 128), (3, 700, 2, 8, 64), (1, 2048, 1, 1, 64),
    (2, 333, 1, 20, 32)])
@pytest.mark.parametrize("length", [0, 1, 64, 128, "T", "T+5"])
def test_decode_sm90_bf16_gate(dev, B, T, KV, G, hd, length):
    """The tensor-core decode kernel at G = 1, 4, 8, 16 and 20 (two
    blocks a KV head), hd 32 / 64 / 128, lengths 0, 1, T, > T and ending
    on a tile boundary (64, 128), as an int and as a device tensor."""
    n = {"T": T, "T+5": T + 5}.get(length, length)
    rng = np.random.default_rng(8)
    q = torch.from_numpy(_normal(rng, B, KV * G, hd)).to(dev, torch.bfloat16)
    k, v = (torch.from_numpy(_normal(rng, B, T, KV, hd)).to(
        dev, torch.bfloat16) for _ in range(2))
    for ln in (n, torch.tensor(n, device=dev)):
        got = decode_attention(q, k, v, ln)
        _bf16_gate(got, q, k, v, decode_attention_ref, ln)
    assert kernels.launches()["flash_decode_sm90"] == 2
    assert kernels.launches()["flash_decode"] == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("geom", MAMBA_GEOMS,
                         ids=lambda g: "x".join(map(str, g)))
def test_ssd_kernel(dev, geom, dtype):
    S, nh, hd, ds, chunk = geom
    rng = np.random.default_rng(3)
    x = torch.from_numpy(_normal(rng, 2, S, nh, hd)).to(dev)
    dt = torch.from_numpy(rng.uniform(0.01, 0.3, size=(2, S, nh)).astype(
        np.float32)).to(dev)
    A = torch.from_numpy(-rng.uniform(0.3, 2.0, size=(nh,)).astype(
        np.float32)).to(dev)
    Bc, Cc = (torch.from_numpy(_normal(rng, 2, S, ds)).to(dev)
              for _ in range(2))
    if dtype == "bfloat16":
        x, Bc, Cc = (t.to(torch.bfloat16) for t in (x, Bc, Cc))
    got = mamba_ssd(x, dt, A, Bc, Cc, chunk=chunk)
    want = ssd_scan_ref(x, dt, A, Bc, Cc, chunk=chunk)
    assert kernels.launches()["mamba_scan"] == 1
    tol = TOL["scan" if dtype == "float32" else "bf16"]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_ssd_kernel_large_decay_is_finite(dev):
    """|dt·A| up to 125: the unmasked decay would be inf within a chunk."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(_normal(rng, 2, 64, 3, 16)).to(dev)
    dt = torch.from_numpy(rng.uniform(1, 5, size=(2, 64, 3)).astype(
        np.float32)).to(dev)
    A = torch.from_numpy(-rng.uniform(5, 25, size=(3,)).astype(
        np.float32)).to(dev)
    Bc, Cc = (torch.from_numpy(_normal(rng, 2, 64, 8)).to(dev)
              for _ in range(2))
    got = mamba_ssd(x, dt, A, Bc, Cc, chunk=16)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, ssd_scan_ref(x, dt, A, Bc, Cc, chunk=16),
                               atol=TOL["scan"], rtol=TOL["scan"])


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q = torch.zeros((1, 64, 2, 48), device=dev)  # head_dim 48
    with pytest.raises(ValueError, match="head_dim"):
        attention(q, q, q)
    q = torch.zeros((1, 64, 2, 32), device=dev)
    with pytest.raises(ValueError, match="dtype"):
        attention(q, q.double(), q)
    with pytest.raises(ValueError, match="S == T"):
        attention(q, torch.zeros((1, 128, 2, 32), device=dev),
                  torch.zeros((1, 128, 2, 32), device=dev))
    # TMA reads 16-byte aligned tensors: a contiguous slice one element in
    # is refused, for attention and decode alike
    flat = torch.zeros(64 * 2 * 32 + 1, device=dev, dtype=torch.bfloat16)
    off = flat[1:].view(1, 64, 2, 32)
    assert off.is_contiguous() and off.data_ptr() % 16
    ok = torch.zeros((1, 64, 2, 32), device=dev, dtype=torch.bfloat16)
    for args in ((off, ok, ok), (ok, off, ok), (ok, ok, off)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            attention(*args)
    qd = torch.zeros((1, 2, 32), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        decode_attention(qd, off, ok, 10)
    with pytest.raises(ValueError, match="dtype"):
        decode_attention(qd, ok.float(), ok, 10)
    x = torch.zeros((1, 16, 1, 128), device=dev)  # head_dim 128 > 64
    dt = torch.zeros((1, 16, 1), device=dev)
    bc = torch.zeros((1, 16, 8), device=dev)
    with pytest.raises(ValueError, match="at most"):
        mamba_ssd(x, dt, torch.zeros(1, device=dev), bc, bc)
    # the grouped GEMM: float32 or bf16, w of x's dtype
    xg = torch.zeros((8, 32), device=dev, dtype=torch.bfloat16)
    wg = torch.zeros((2, 32, 16), device=dev, dtype=torch.bfloat16)
    sg = torch.tensor([4, 4], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        grouped_gemm(xg.half(), wg.half(), sg)
    with pytest.raises(ValueError, match="dtype"):
        grouped_gemm(xg, wg.float(), sg)
    assert kernels.launches() == {k: 0 for k in kernels.KERNELS}


# ---- B2 segment combine and B3 fused reads: edges, hot segments ----------
def _exact(got, want):
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


def _sum_gate(got, want, mags, rel=1e-6):
    assert bool(((got - want).abs() <= rel * mags + 1e-6).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("op", ["min", "max", "or"])
def test_combine_kernel_nan_inf_and_large_values(dev, op, dtype):
    """NaN propagates (an update and a stored NaN), ±inf and ±3e38 fold
    with the identity: the kernel gives the plain version's values, which
    tests/test_torch_merge_edges.py holds to the numpy oracle."""
    edge = torch.tensor([np.nan, np.inf, -np.inf, 3e38, -3e38, 1.0, -2.0,
                         0.0], dtype=dtype)
    rng = np.random.default_rng(30)
    n, w, S = 4096, 16, 37
    vals = edge[torch.from_numpy(rng.integers(0, edge.numel(), (n, w)))]
    vals[rng.random((n, w)) < 0.7] = 1.5  # most columns NaN-free
    seg = torch.from_numpy(rng.integers(-2, S + 2, n).astype(np.int32))
    vals, seg = vals.to(dev), seg.to(dev)
    _exact(combine(vals, seg, S, op=op), combine_ref(vals, seg, S, op=op))
    assert kernels.launches()["segment_combine"] == 1


def _zipf_segments(n, S, rng, gamma=2.0):
    """n segment ids of a Zipf(gamma) law over S segments in task order
    (not sorted), ~60% on one at gamma 2.0, and ids outside [0, S)."""
    p = 1.0 / np.arange(1, S + 1) ** gamma
    seg = rng.choice(S, size=n, p=p / p.sum()).astype(np.int32)
    seg[rng.random(n) < 0.01] = -1
    seg[rng.random(n) < 0.01] = S + 3
    return torch.from_numpy(seg)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("w", [16, 3, 1536])
@pytest.mark.parametrize("op", MERGES)
def test_combine_kernel_hot_segment(dev, op, w, dtype):
    """A Zipf-2.0 batch (the warp pre-combine and the block table on its
    hot segments, the global atomics on the rest): exact but for sums."""
    rng = np.random.default_rng(31)
    n = 20_000 if w < 1536 else 600
    S = 5000
    seg = _zipf_segments(n, S, rng).to(dev)
    vals = torch.from_numpy(rng.normal(size=(n, w))).to(dev, dtype)
    order = torch.from_numpy(rng.integers(-3, 3, n).astype(np.int32)).to(dev)
    got = combine(vals, seg, S, op=op, order=order)
    want = combine_ref(vals, seg, S, op=op, order=order)
    if op == "add":
        _sum_gate(got, want, combine_ref(vals.abs(), seg, S, op="add"))
    else:
        _exact(got, want)
    assert kernels.launches()["segment_combine"] == 1


@pytest.mark.parametrize("op", MERGES)
def test_combine_kernel_rows_not_16_byte_aligned(dev, op):
    """A contiguous view one float in: the kernel loads rows a value at a
    time (16-byte vectors need aligned rows)."""
    rng = np.random.default_rng(32)
    n, w, S = 3000, 16, 40
    flat = torch.from_numpy(rng.normal(size=n * w + 1).astype(
        np.float32)).to(dev)
    vals = flat[1:].view(n, w)
    assert vals.is_contiguous() and vals.data_ptr() % 16
    seg = _zipf_segments(n, S, rng).to(dev)
    order = torch.zeros(n, dtype=torch.int32, device=dev)  # all tied
    got = combine(vals, seg, S, op=op, order=order)
    want = combine_ref(vals, seg, S, op=op, order=order)
    if op == "add":
        _sum_gate(got, want, combine_ref(vals.abs(), seg, S, op="add"))
    else:
        _exact(got, want)


def test_combine_kernel_write_ties_go_to_the_lowest_row(dev):
    """Every row of a hot segment at the lowest order, in several warps
    and blocks: the lowest row wins, as in the plain version."""
    n, S = 50_000, 3
    seg = torch.zeros(n, dtype=torch.int32)
    seg[::7] = 1
    seg[5] = 2
    order = torch.full((n,), 9, dtype=torch.int32)
    order[[40_000, 30_001, 45_000]] = -2**31  # three ties at the lowest
    vals = torch.arange(n, dtype=torch.float32)[:, None].repeat(1, 4)
    got = combine(vals.to(dev), seg.to(dev), S, op="write",
                  order=order.to(dev)).cpu()
    assert got[:, 0].tolist() == [30_001.0, 0.0, 5.0]
    _exact(got, combine_ref(vals, seg, S, op="write", order=order))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("max_arity", [None, 3, 5])
@pytest.mark.parametrize("read_op", ["min", "max"])
def test_fused_reduce_kernel_nan_inf_and_padding_fill(dev, read_op,
                                                      max_arity, dtype):
    """NaN and ±3e38 pairs, ±inf, arity below and at the batch's max arity
    (read off indptr, or stated), and arity 0."""
    values = torch.tensor([[3e38, 1.0], [np.nan, -3e38], [1.0, np.inf],
                           [-3e38, -np.inf], [2.0, 0.5]], dtype=dtype)
    tasks = [[0], [0, 1], [2, 3, 4], [4], [2, 0], [], [3, 3, 3], [0, 2]]
    indptr = torch.tensor(np.r_[0, np.cumsum([len(t) for t in tasks])],
                          dtype=torch.int32)
    indices = torch.tensor([k for t in tasks for k in t], dtype=torch.int32)
    want = reduce_pairs_ref(values, indptr, indices, read_op=read_op,
                            max_arity=max_arity)
    got = fused_reduce(values.to(dev), indptr.to(dev), indices.to(dev),
                       read_op=read_op, max_arity=max_arity)
    _exact(got.cpu(), want)
    assert kernels.launches()["stage_fused"] == 1


def _ragged_case(rng, w, dtype, read_op, dev, aligned):
    """300 tasks of arity 0-8 and one of arity 1,000 over 97 rows; for
    min/max/first some values are NaN, ±inf or ±3e38. With `aligned` False
    the rows are a contiguous view one value into a buffer (not 16-byte
    aligned)."""
    K, n = 97, 301
    arity = rng.integers(0, 9, n)
    arity[::9] = 0
    arity[150] = 1000
    indptr = np.r_[0, np.cumsum(arity)].astype(np.int32)
    idx = rng.integers(0, K, int(indptr[-1])).astype(np.int32)
    vals = rng.normal(size=(K, w))
    if read_op != "add":
        edge = np.array([np.nan, np.inf, -np.inf, 3e38, -3e38])
        pick = rng.random((K, w)) < 0.05
        vals[pick] = edge[rng.integers(0, edge.size, int(pick.sum()))]
    flat = torch.from_numpy(vals.reshape(-1)).to(dtype)
    flat = torch.cat([flat.new_zeros(1), flat]) if not aligned else flat
    flat = flat.to(dev)
    values = (flat[1:] if not aligned else flat).view(K, w)
    assert values.is_contiguous()
    return values, torch.from_numpy(indptr).to(dev), \
        torch.from_numpy(idx).to(dev)


def _pair_order_rel(indptr, dtype):
    """Per task, the relative sum gate: 1e-6, or a·u where a task of
    arity a sums its pairs in the values' type in pair order (each add
    rounds by at most u·Σ|terms|: u = 2^-24 in float32), which the
    arity-1,000 task passes in float32 and 1e-6 would not."""
    u = 2.0 ** (-24 if dtype == torch.float32 else -53)
    arity = (indptr[1:] - indptr[:-1]).double()
    return (arity * u).clamp(min=1e-6)[:, None]


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("w", [1, 3, 4, 5, 16, 17, 33, 1536])
@pytest.mark.parametrize("read_op", ["add", "min", "max", "first"])
def test_fused_reduce_kernel_layouts(dev, read_op, w, dtype, aligned):
    """Every layout of the gather-reduce: exact for min/max/first (NaN as
    NaN), the sum gate for add (a·u for the long task); the max-arity fill
    read off indptr (the arity-1,000 task is the max) and stated (8: the
    long task is past it, tasks of arity 8 read their pairs alone)."""
    rng = np.random.default_rng(34)
    values, indptr, idx = _ragged_case(rng, w, dtype, read_op, dev, aligned)
    lay = layout(w, values.element_size(), values.data_ptr() % 16 == 0)
    if not aligned and w > 1:
        assert lay.vec == 1
    for max_arity in (None, 8):
        got = fused_reduce(values, indptr, idx, read_op=read_op,
                           max_arity=max_arity)
        want = reduce_pairs_ref(values, indptr, idx, read_op=read_op,
                                max_arity=max_arity)
        if read_op == "add":
            mags = reduce_pairs_ref(values.abs(), indptr, idx, read_op="add")
            _sum_gate(got, want, mags, rel=_pair_order_rel(indptr, dtype))
        else:
            _exact(got, want)
    assert kernels.launches()["stage_fused"] == 2


def _ids(rng, n, bins, zipf: bool):
    """n int32 ids over [0, bins) (uniform, or Zipf 1.2 over permuted
    ranks), 1% of them below 0 and 1% at or past `bins`."""
    if zipf:
        p = 1.0 / np.arange(1, bins + 1) ** 1.2
        ids = rng.permutation(bins)[rng.choice(bins, size=n, p=p / p.sum())]
    else:
        ids = rng.integers(0, bins, n)
    ids[rng.random(n) < 0.01] = -3
    ids[rng.random(n) < 0.01] = bins + 5
    return ids.astype(np.int32)


# (bins, ids, route): the shared route below 48 KB of bins and in the
# opt-in band, the global route past the merge's break-even (a lookup's
# 8,192 ids over 49,155 bins, stage (b)'s 800,000 over 800,000) and past
# the opt-in limit
HIST_ROUTES = [(300, 40_000, "shared"), (12_288, 8_000_000, "shared"),
               (50_000, 8_000_000, "shared"), (49_155, 8_192, "global"),
               (800_000, 800_000, "global"), (60_000, 2_000_000, "global"),
               (40, 1_024, "shared")]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("zipf", [False, True])
@pytest.mark.parametrize("bins,n,kind", HIST_ROUTES,
                         ids=lambda v: str(v))
def test_histogram_kernel_routes(dev, bins, n, kind, zipf, weighted):
    """Each route exact against the plain version (on an H100: 227 KB of
    opt-in shared memory a block, 132 SMs)."""
    assert route(n, bins, device_limits(dev.index or 0))[0] == kind
    rng = np.random.default_rng(35)
    ids = torch.from_numpy(_ids(rng, n, bins, zipf)).to(dev)
    wts = torch.from_numpy(rng.integers(-2, 9, n).astype(np.int32)).to(dev) \
        if weighted else None
    got = count_ids(ids, bins, weights=wts)
    assert torch.equal(got, histogram_ref(ids, bins, wts))
    assert kernels.launches()["histogram"] == 1


def test_histogram_kernel_ids_not_16_byte_aligned(dev):
    """The global route on Zipf ids, repeats and all, read from a view one
    id into its buffer (not 16-byte aligned)."""
    rng = np.random.default_rng(36)
    n, bins = 100_001, 70_000
    flat = torch.from_numpy(_ids(rng, n, bins, zipf=True)).to(dev)
    ids = flat[1:]
    wflat = torch.from_numpy(rng.integers(0, 5, n).astype(np.int32)).to(dev)
    assert ids.data_ptr() % 16 and ids.is_contiguous()
    for wts in (None, wflat[1:]):
        assert torch.equal(count_ids(ids, bins, weights=wts),
                           histogram_ref(ids, bins, wts))


def test_histogram_limits_come_from_the_kernel(dev):
    """`route` reads the block size the kernel was built with and the
    device's own limits, through `tdorch_histogram_limits`."""
    got = device_limits(dev.index or 0)
    props = torch.cuda.get_device_properties(dev)
    assert got.block_threads == 256
    assert got.sms == props.multi_processor_count
    assert got.sm_threads == props.max_threads_per_multi_processor
    assert got.sm_threads % got.block_threads == 0
    assert 48 * 1024 <= got.block_shared <= got.sm_shared
    assert 0 <= got.reserved_shared < 48 * 1024


def test_fused_reduce_refuses_a_layout_it_does_not_compile(dev):
    """The C entry compiles one or `WIDE_COLS` = 4 vectors a lane (4 only
    with 32 lanes a task) and returns an error for any other layout."""
    from repro_torch.kernels import _lib

    values = torch.zeros((4, 64), dtype=torch.float32, device=dev)
    indptr = torch.tensor([0, 1, 2], dtype=torch.int32, device=dev)
    idx = torch.tensor([0, 3], dtype=torch.int32, device=dev)
    out = torch.empty((2, 64), dtype=torch.float32, device=dev)
    for vec, log_g, cols in ((4, 5, 2), (4, 4, 4), (4, 6, 1), (3, 5, 1)):
        rc = _lib.load().tdorch_fused_reduce(
            dev.index or 0, values.data_ptr(), 0, 64, indptr.data_ptr(),
            idx.data_ptr(), 2, 0, 0, vec, log_g, cols, out.data_ptr(),
            _lib.stream(values))
        with pytest.raises(RuntimeError, match="stage_fused"):
            _lib.check(rc, "stage_fused")
    torch.cuda.synchronize()


# ---- B7 on the tensor cores: chip_smoke.py's gates -------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("geom", MAMBA_GEOMS + [
    (42, 20, 5, 3, 7), (96, 17, 64, 64, 96), (300, 2, 64, 64, 100),
    (8, 1, 64, 1, 8)], ids=lambda g: "x".join(map(str, g)))
def test_ssd_tensor_core_gate(dev, geom, dtype):
    """The MAMBA geometries, odd widths (hd 5, ds 3), chunks that fill no
    16-row tile (7) or a few (96 -> 3 tiles, 100 -> 7), 17 and 20 heads
    (two head groups a block grid column), at chip_smoke.py's gates."""
    S, nh, hd, ds, chunk = geom
    rng = np.random.default_rng(33)
    x = torch.from_numpy(_normal(rng, 2, S, nh, hd)).to(dev)
    dt = torch.from_numpy(rng.uniform(0.01, 0.3, size=(2, S, nh)).astype(
        np.float32)).to(dev)
    A = torch.from_numpy(-rng.uniform(0.3, 2.0, size=(nh,)).astype(
        np.float32)).to(dev)
    Bc, Cc = (torch.from_numpy(_normal(rng, 2, S, ds)).to(dev)
              for _ in range(2))
    if dtype == "bfloat16":
        x, Bc, Cc = (t.to(torch.bfloat16) for t in (x, Bc, Cc))
    got = mamba_ssd(x, dt, A, Bc, Cc, chunk=chunk)
    up = (lambda t: t.double()) if dtype == "float32" else \
        (lambda t: t.float())
    lift = [up(t) for t in (x, dt, A, Bc, Cc)]
    want = ssd_scan_ref(*lift, chunk=chunk).double()
    c = min(chunk, S)
    max_l = float((dt.double() * A.double()).reshape(2, -1, c, nh)
                  .cumsum(2).abs().max())
    mags = ssd_scan_ref(lift[0].abs(), lift[1], lift[2], lift[3].abs(),
                        lift[4].abs(), chunk=chunk).double()
    allowed = (SSD_REL + 8 * U32 * max_l) * mags + 1e-6
    if dtype == "bfloat16":
        allowed = allowed + BF16_ROUND * want.abs()
    assert bool(torch.isfinite(got).all())
    assert bool(((got.double() - want).abs() <= allowed).all())
    assert kernels.launches()["mamba_scan"] == 1


def _unit_plan_session(engine="tdorch"):
    from repro_torch.core import DataStore, Orchestrator, TaskBatch

    store = DataStore.create(4096, 4, value_width=2, chunk_words=4, init=1.0)
    tb = TaskBatch(contexts=np.ones((1024, 1)), read_keys=np.arange(1024),
                   origin=TaskBatch.even_origins(1024, 4))
    return store, tb, Orchestrator(store, engine=engine)


def _inc(ctx, vals):
    return {"update": vals * 0.0 + 1.0}


def test_plan_write_backs_stay_on_the_card_until_exit(dev):
    """Five rounds of +1 under a plan scope: the host copy is not touched
    until the plan exits (one flush, the one host sync), then holds the
    card's values; the same rounds through run_stage sync every stage."""
    from repro_torch.core import StagePlan

    store, tb, sess = _unit_plan_session()
    assert sess.backend.device.type == "cuda"
    seen = []
    plan = (StagePlan()
            .loop(StagePlan().stage(tb, _inc, "add"), until=None,
                  max_rounds=5)
            .host(lambda st: seen.append(store.values[:1024].copy())))
    before = sess.backend.host_syncs
    out = sess.run_plan(plan)
    assert out.rounds == 5
    assert sess.backend.host_syncs - before == 1  # the flush before .host
    np.testing.assert_array_equal(seen[0], 6.0)
    np.testing.assert_array_equal(store.values[:1024], 6.0)
    np.testing.assert_array_equal(store.values[1024:], 1.0)
    dv = sess.backend.device_values(store)
    assert dv.is_cuda
    np.testing.assert_array_equal(dv.cpu().numpy(), store.values)

    store, tb, sess = _unit_plan_session()
    before = sess.backend.host_syncs
    for _ in range(5):
        sess.run_stage(tb, _inc, "add")
    assert sess.backend.host_syncs - before == 5


@pytest.mark.parametrize("engine", ["pull", "push", "sort", "auto"])
def test_engines_run_on_the_card_by_default(dev, engine):
    store, tb, sess = _unit_plan_session(engine)
    assert sess.backend.device.type == "cuda"
    kernels.reset_launches()
    sess.run_stage(tb, _inc, "add")
    assert kernels.launches()["segment_combine"] == 1
    np.testing.assert_array_equal(store.values[:1024], 2.0)


# ---- B5's backward (flash_attention_bwd{_sm90,}.cu), the forward's lse ---
BWD_GEOMS = [(S, S, H, KV, hd, causal)
             for (S, H, KV, hd) in [(128, 4, 4, 64), (256, 8, 2, 64),
                                    (128, 4, 1, 128), (64, 2, 2, 32),
                                    (100, 4, 2, 64), (300, 8, 1, 128),
                                    (200, 16, 2, 32)]
             for causal in (True, False)] + [
    (48, 80, 4, 2, 32, False), (200, 129, 4, 1, 64, False),
    (130, 384, 8, 2, 128, False)] + [
    # one past the float32 kernels' tiles (64 rows a step and 64 keys, 32
    # keys at hd 128), GQA 8, non-causal S != T
    (65, 65, 8, 1, 64, True), (65, 65, 4, 4, 32, False),
    (33, 33, 8, 1, 128, True), (129, 129, 16, 2, 128, False),
    (65, 33, 8, 1, 128, False), (97, 65, 8, 1, 32, False)] + [
    # chip_smoke.py's phase-2 geometries (BWD_PARITY), at batch 2
    (S, S, H, KV, hd, causal)
    for (S, H, KV, hd, causal) in [
        (1000, 8, 8, 32, True), (1000, 8, 8, 32, False),
        (1000, 16, 4, 64, True), (1000, 16, 4, 64, False),
        (1000, 8, 1, 128, True), (1000, 8, 1, 128, False),
        (4096, 8, 1, 64, True), (4096, 4, 4, 128, False),
        (4096, 8, 2, 32, True)]]


def _bwd_case(dev, S, T, H, KV, hd, causal, dtype, seed):
    """q, k, v, dout of `dtype` and the forward's out (in dtype) and lse
    (float32) from the plain version on the same values."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(seed)
    q, dout = (torch.from_numpy(_normal(rng, 2, S, H, hd)).to(dev, dt)
               for _ in range(2))
    k, v = (torch.from_numpy(_normal(rng, 2, T, KV, hd)).to(dev, dt)
            for _ in range(2))
    out, lse = attention_ref(q.double(), k.double(), v.double(),
                             causal=causal, return_lse=True)
    return q, k, v, out.to(dt), lse.float(), dout


def _bwd_gate(got, q, k, v, out, lse, dout, causal) -> float:
    """(dq, dk, dv) within chip_smoke.py's gate of `attention_bwd_ref` on
    the same values (float32 for bf16, float64 for float32); returns the
    worst share of the gate."""
    bf16 = q.dtype == torch.bfloat16
    up = (lambda t: t.float()) if bf16 else (lambda t: t.double())
    rel, rel_terms, terms = (BF16_ROUND, 2 * BF16_ROUND, "values") if bf16 \
        else (ATTN_BWD_REL, ATTN_BWD_REL, "products")
    want, mags = attention_bwd_ref(up(q), up(k), up(v), up(out), up(lse),
                                   up(dout), causal=causal, terms=terms)
    worst = 0.0
    for name, g, w, m in zip(("dq", "dk", "dv"), got, want, mags):
        assert g.dtype == q.dtype and g.shape == w.shape, name
        assert bool(torch.isfinite(g).all()), name
        err = (g.double() - w.double()).abs()
        allowed = rel * w.double().abs() + rel_terms * m.double()
        share = float((err / allowed.clamp(min=1e-300)).max())
        assert bool((err <= allowed).all()), (name, share)
        worst = max(worst, share)
    return worst


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("S,T,H,KV,hd,causal", BWD_GEOMS)
def test_attention_bwd_kernel_gate(dev, S, T, H, KV, hd, causal, dtype):
    """The three backward kernels at hd 32 / 64 / 128, GQA 1 / 2 / 4 / 8,
    causal and not, ragged S, non-causal S != T, S up to 4,096 (phase 2's
    geometries among them), at the gate."""
    case = _bwd_case(dev, S, T, H, KV, hd, causal, dtype, 11)
    got = fa_ops._backward(*case, causal)
    torch.cuda.synchronize()
    _bwd_gate(got, *case, causal)
    name = f"flash_attention_bwd_{'bf16' if dtype == 'bfloat16' else 'tf32'}"
    assert kernels.launches()[name] == 1
    assert sum(kernels.launches().values()) == 1


def test_attention_bwd_bf16_repeats_bit_for_bit(dev):
    """Two bf16 calls on the same inputs at tinyllama-1.1b's training shape
    (4, 4,096, 32 heads / 4 KV heads, 64) give the same bits: no atomics,
    so a training run restored from a checkpoint retraces its losses."""
    rng = np.random.default_rng(16)
    q, dout = (torch.from_numpy(_normal(rng, 4, 4096, 32, 64)).to(
        dev, torch.bfloat16) for _ in range(2))
    k, v = (torch.from_numpy(_normal(rng, 4, 4096, 4, 64)).to(
        dev, torch.bfloat16) for _ in range(2))
    out, lse = fa_ops._forward(q, k, v, True, True)
    first = fa_ops._backward(q, k, v, out, lse, dout, True)
    again = fa_ops._backward(q, k, v, out, lse, dout, True)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    assert kernels.launches()["flash_attention_bwd_bf16"] == 2


@pytest.mark.parametrize("B, S, H, KV, hd", [
    (4, 4096, 32, 4, 64),    # tinyllama-1.1b's training shape
    (1, 8192, 64, 8, 128),   # prefill_gqa128: hd 128, 32-key tiles
    (2, 4096, 16, 2, 32)])   # hd 32: a ring of 4 stages
def test_attention_bwd_float32_repeats_bit_for_bit(dev, B, S, H, KV, hd):
    """Two float32 calls on the same inputs give the same bits, as the bf16
    ones do, at each head dim's tiles and ring depth."""
    rng = np.random.default_rng(17)
    q, dout = (torch.from_numpy(_normal(rng, B, S, H, hd)).to(dev)
               for _ in range(2))
    k, v = (torch.from_numpy(_normal(rng, B, S, KV, hd)).to(dev)
            for _ in range(2))
    out, lse = fa_ops._forward(q, k, v, True, True)
    first = fa_ops._backward(q, k, v, out, lse, dout, True)
    again = fa_ops._backward(q, k, v, out, lse, dout, True)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    assert kernels.launches()["flash_attention_bwd_tf32"] == 2


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_attention_bwd_gate_sees_a_zeroed_dk_tile(dev, dtype):
    case = _bwd_case(dev, 256, 256, 8, 2, 64, True, dtype, 12)
    dq, dk, dv = fa_ops._backward(*case, True)
    dk = dk.clone()
    dk[:, 64:128] = 0
    with pytest.raises(AssertionError):
        _bwd_gate((dq, dk, dv), *case, True)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_forward_lse(dev, dtype, causal):
    """The forward's optional lse against the plain one; the output is
    the same bits with and without it."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(13)
    q = torch.from_numpy(_normal(rng, 2, 300, 8, 64)).to(dev, dt)
    k, v = (torch.from_numpy(_normal(rng, 2, 300, 2, 64)).to(dev, dt)
            for _ in range(2))
    out, lse = fa_ops._forward(q, k, v, causal, True)
    plain = fa_ops._forward(q, k, v, causal, False)
    assert plain[1] is None and torch.equal(out, plain[0])
    _, want = attention_ref(q.double(), k.double(), v.double(),
                            causal=causal, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (2, 8, 300)
    # float32 scores of |s| <= ~40: a few float32 ulps of the largest
    torch.testing.assert_close(lse.double(), want, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_attention_autograd_launches_the_backward(dev, dtype):
    dt = getattr(torch, dtype)
    case = _bwd_case(dev, 256, 256, 8, 2, 64, True, dtype, 14)
    q, k, v, _, _, dout = case
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    out = attention(q, k, v, causal=True)
    fwd = "flash_attention_sm90" if dt == torch.bfloat16 else \
        "flash_attention_tf32"
    bwd = f"flash_attention_bwd_{'bf16' if dt == torch.bfloat16 else 'tf32'}"
    assert kernels.launches()[fwd] == 1 and kernels.launches()[bwd] == 0
    grads = torch.autograd.grad(out, (q, k, v), dout)
    assert kernels.launches()[bwd] == 1
    o2, lse = fa_ops._forward(q.detach(), k.detach(), v.detach(), True, True)
    assert torch.equal(out.detach(), o2)
    _bwd_gate(grads, q.detach(), k.detach(), v.detach(), o2, lse, dout, True)
    with torch.no_grad():  # serving: the launch without an lse
        attention(q, k, v, causal=True)
    assert kernels.launches()[fwd] == 3 and kernels.launches()[bwd] == 1


def test_scan_and_grouped_gemm_refuse_grad_on_the_card(dev):
    """The bf16 scan refuses grad on the card (A11f); the float32 scan and
    the grouped GEMM no longer do: under grad the scan launches its forward
    and its backward ("mamba_scan_bwd"), the GEMM its forward and, for w
    alone, its dw kernel, and serving launches the forwards alone as
    before."""
    x = torch.zeros((1, 16, 2, 16), device=dev, requires_grad=True)
    dt = torch.full((1, 16, 2), 0.1, device=dev)
    bc = torch.zeros((1, 16, 8), device=dev)
    a = -torch.ones(2, device=dev)
    with pytest.raises(NotImplementedError, match="A11f"):
        mamba_ssd(x.detach().bfloat16().requires_grad_(), dt, a,
                  bc.bfloat16(), bc.bfloat16(), chunk=16)
    (dx,) = torch.autograd.grad(mamba_ssd(x, dt, a, bc, bc, chunk=16).sum(),
                                (x,))
    assert dx.shape == x.shape and not bool(dx.any())
    xg = torch.zeros((8, 32), device=dev, dtype=torch.bfloat16)
    wg = torch.zeros((2, 32, 16), device=dev, dtype=torch.bfloat16,
                     requires_grad=True)
    sg = torch.tensor([4, 4], dtype=torch.int32, device=dev)
    (dw,) = torch.autograd.grad(grouped_gemm(xg, wg, sg).sum(), (wg,))
    assert dw.shape == wg.shape and not bool(dw.any())
    with torch.no_grad():  # serving launches as before
        mamba_ssd(x, dt, a, bc, bc, chunk=16)
        grouped_gemm(xg, wg, sg)
    assert kernels.launches()["mamba_scan"] == 2
    assert kernels.launches()["mamba_scan_bwd"] == 1
    assert kernels.launches()["moe_gemm_sm90"] == 2
    assert kernels.launches()["moe_gemm_dw_sm90"] == 1
    assert kernels.launches()["moe_gemm_dx_sm90"] == 0


# B7's backward on both routes (`ops.bwd_route`): (B, S, nh, hd, ds, chunk,
# dh_final given), as chip_smoke.py's SSD_BWD_PARITY, and the route each
# takes. hd 5 / ds 3 and ds 6 leave rows off 16 bytes: TMA cannot take them.
SSD_BWD_GEOMS = [((1, 512, 20, 64, 64, 128, False), "sm90"),
                 ((2, 400, 17, 64, 64, 100, True), "sm90"),
                 ((2, 128, 3, 32, 16, 128, True), "sm90"),
                 ((1, 256, 33, 40, 24, 64, True), "sm90"),
                 ((2, 64, 3, 16, 8, 16, True), "sm90"),
                 ((2, 42, 20, 5, 3, 7, True), "mma"),
                 ((1, 96, 4, 16, 6, 32, True), "mma")]


def _ssd_bwd_case(dev, geom, seed):
    B, S, nh, hd, ds, chunk, with_dh = geom
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(_normal(rng, B, S, nh, hd)).to(dev)
    dt = torch.from_numpy(rng.uniform(0.01, 0.3, size=(B, S, nh)).astype(
        np.float32)).to(dev)
    A = torch.from_numpy(-rng.uniform(0.3, 2.0, size=(nh,)).astype(
        np.float32)).to(dev)
    Bc, Cc = (torch.from_numpy(_normal(rng, B, S, ds)).to(dev)
              for _ in range(2))
    dy = torch.from_numpy(_normal(rng, B, S, nh, hd)).to(dev)
    dh = (torch.from_numpy(_normal(rng, B, nh, hd, ds)).to(dev)
          if with_dh else None)
    return x, dt, A, Bc, Cc, dy, dh


def _ssd_bwd_grads(inputs, chunk):
    x, dt, A, Bc, Cc, dy, dh = inputs
    leaves = [t.detach().requires_grad_() for t in (x, dt, A, Bc, Cc)]
    y, h = mamba_ssd(*leaves, chunk=chunk, return_state=True)
    outs, grads = ([y], [dy]) if dh is None else ([y, h], [dy, dh])
    return torch.autograd.grad(outs, leaves, grads)


def _ssd_bwd_gate(got, inputs, chunk):
    """chip_smoke.py's scan-backward gate: (SSD_REL + 8·u32·max|l|)·Σ|terms|
    + 1e-6 on dx, ddt, dB, dC against float64, dA's on the root-sum-square
    of its steps' Σ|terms|."""
    from repro_torch.kernels.mamba_scan.ref import ssd_scan_bwd_ref

    x, dt, A, Bc, Cc, dy, dh = (None if t is None else t.double()
                                for t in inputs)
    c = min(chunk, x.shape[1])
    max_l = float((dt * A).reshape(x.shape[0], -1, c, x.shape[2]).cumsum(
        2).abs().max())
    want = ssd_scan_bwd_ref(x, dt, A, Bc, Cc, dy, dh, chunk=chunk)
    mags = list(ssd_scan_bwd_ref(x, dt, A, Bc, Cc, dy, dh, chunk=chunk,
                                 terms=True, dA_steps=True))
    mags[2] = mags[2].square().sum((0, 1, 3)).sqrt()
    rel = SSD_REL + 8 * U32 * max_l
    for name, g, w, m in zip(("dx", "ddt", "dA", "dB", "dC"), got, want,
                             mags):
        assert bool(torch.isfinite(g).all()), name
        assert bool(((g.double() - w).abs() <= rel * m + 1e-6).all()), name


@pytest.mark.parametrize("geom,route", SSD_BWD_GEOMS,
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else v)
def test_ssd_bwd_routes(dev, geom, route):
    """`mamba_ssd`'s float32 backward takes `bwd_route`'s kernels (the
    counter of that route once, the other's never), lands within the gate,
    and two calls give the same bits; an aligned case forced onto the "mma"
    kernels lands within it too, and the "sm90" entry refuses operands off
    16 bytes rather than reading them."""
    from repro_torch.kernels.mamba_scan import ops

    inputs = _ssd_bwd_case(dev, geom, seed=sum(geom[:6]))
    chunk = geom[5]
    x, dt, A, Bc, Cc, dy, dh = inputs
    _, _, states, l = ops._forward(x, dt, A, Bc, Cc, chunk, True, True)
    assert ops.bwd_route(x, dy, Bc, Cc, states) == route
    got = _ssd_bwd_grads(inputs, chunk)
    torch.cuda.synchronize()
    other = "mma" if route == "sm90" else "sm90"
    assert kernels.launches()[ops.BWD_COUNTERS[route]] == 1
    assert kernels.launches()[ops.BWD_COUNTERS[other]] == 0
    _ssd_bwd_gate(got, inputs, chunk)
    again = _ssd_bwd_grads(inputs, chunk)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    if route == "sm90":
        forced = ops._backward(x, dt, A, Bc, Cc, dy, dh, states, l, chunk,
                               route="mma")
        _ssd_bwd_gate(forced, inputs, chunk)
        assert kernels.launches()["mamba_scan_bwd_mma"] == 1
    else:
        with pytest.raises(RuntimeError, match="mamba_scan_bwd"):
            ops._backward(x, dt, A, Bc, Cc, dy, dh, states, l, chunk,
                          route="sm90")


def test_ssd_bwd_route_refuses_an_unaligned_base(dev):
    """x viewed one float into a buffer (a base off 16 bytes) takes the
    "mma" kernels and lands within the gate."""
    from repro_torch.kernels.mamba_scan import ops

    geom = (1, 256, 4, 32, 16, 64, True)
    inputs = list(_ssd_bwd_case(dev, geom, seed=5))
    buf = torch.empty(inputs[0].numel() + 1, device=dev)
    x = buf[1:].view(inputs[0].shape)
    x.copy_(inputs[0])
    inputs[0] = x
    assert ops.bwd_route(x, inputs[5], inputs[3], inputs[4], inputs[5]) \
        == "mma"
    got = _ssd_bwd_grads(inputs, geom[5])
    torch.cuda.synchronize()
    assert kernels.launches()["mamba_scan_bwd_mma"] == 1
    assert kernels.launches()["mamba_scan_bwd"] == 0
    _ssd_bwd_gate(got, inputs, geom[5])


# ---------------------------------------------------------------------------
# B4's backward: dx (the forward's kernels, w read transposed in place) and
# dw (csrc/moe_gemm_bwd.cu: `gg_dw_sm90`, `gg_dw_bf16`, `gg_dw_tf32` over
# the plan of `dw_plan`, split groups' partials added by `dw_reduce`), each
# against the plain version
# (`grouped_gemm_bwd_ref`) at chip_smoke.py's gates: float32 within
# 1e-5·Σ|terms| + 1e-6 of float64, bf16 within BF16_ROUND·|ref| +
# 1e-5·Σ|terms| + 1e-6 of the float32 sums on the same bf16 operands
# ---------------------------------------------------------------------------
BWD_GEMM_CASES = {
    "granite in-projection": (32, 4096, 1024, 1024, None),
    "granite out-projection": (32, 4096, 512, 1024, None),
    "64-row tiles": (32, 2048, 1024, 1024, None),
    "hot path zero tail": (4, 4096, 256, 128, [128, 100, 140, 150]),
    "empty groups": (4, 8, 32, 16, [0, 8, 0, 0]),
    "rows beyond the sum": (5, 57, 24, 40, [11, 0, 20, 9, 0]),
    "negative, past M": (4, 500, 64, 192, [-7, 300, 0, 400]),
    "K and N not multiples of 8": (3, 300, 30, 50, None),
    "sizes all 0": (4, 200, 64, 128, [0, 0, 0, 0]),
    "no rows": (3, 0, 64, 128, [0, 0, 0]),
    # dw_chunk_rows is 512 here on an H100: group 0 splits into 24 chunks
    "split hot group": (4, 20000, 256, 256, [12000, 0, 5000, 2900]),
}


def _bwd_gemm_gate(x, w, dy, sizes, dx_kernel=None, dw_kernel=None,
                   scratch=None):
    """dx and dw on the card, each launching its kernel once (the ones
    `route_dx` / `route_dw` name, or `dx_kernel` / `dw_kernel`; no dx for
    no rows), within the gate; two calls give the same bits. Returns (dx,
    dw); `scratch` receives dw's plan and workspace."""
    dt = x.dtype
    dx_k = dx_kernel or moe_ops.route_dx(dy, w)
    dw_k = dw_kernel or moe_ops.route_dw(x, dy)

    def calls():
        return (moe_ops._launch_dx(dy, w, sizes, kernel=dx_kernel),
                moe_ops._launch_dw(x, dy, sizes, w.shape, kernel=dw_kernel,
                                   scratch=scratch))
    before = kernels.launches()
    dx, dw = calls()
    after = kernels.launches()
    ran = {k: v - before[k] for k, v in after.items() if v != before[k]}
    assert ran == {**({dx_k: 1} if x.shape[0] else {}), dw_k: 1}
    up = torch.float64 if dt == torch.float32 else torch.float32
    want = grouped_gemm_bwd_ref(x.to(up), w.to(up), sizes, dy.to(up))
    mags = grouped_gemm_bwd_ref(x.abs().double(), w.abs().double(), sizes,
                                dy.abs().double())
    for got, wt, m, shape in zip((dx, dw), want, mags,
                                 (x.shape, tuple(w.shape))):
        assert got.dtype == dt and tuple(got.shape) == tuple(shape)
        assert got.is_contiguous() and bool(torch.isfinite(got).all())
        wt = wt.double()
        allowed = 1e-5 * m + 1e-6
        if dt == torch.bfloat16:
            allowed = allowed + BF16_ROUND * wt.abs()
        err = (got.double() - wt).abs()
        if err.numel():
            assert bool((err <= allowed).all()), float((err / allowed).max())
    again = calls()
    assert torch.equal(dx, again[0]) and torch.equal(dw, again[1])
    return dx, dw


def _bwd_gemm_case(rng, G, M, K, N, sizes, dtype, dev):
    x, w, sz = _moe(rng, G, M, K, N, dev)
    if sizes is not None:
        sz = _sizes(sizes, dev)
    dy = torch.from_numpy(_normal(rng, M, N)).to(dev)
    return x.to(dtype), w.to(dtype), dy.to(dtype), sz


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(BWD_GEMM_CASES))
def test_grouped_gemm_backward_kernels(dev, dtype, case):
    """dx and dw at granite-moe-1b-a400m's widths (128- and 64-row tiles),
    a hot-path call whose rows are mostly the zero tail, and the edges:
    empty groups (dw exactly 0), rows beyond the sum (dx exactly 0),
    negative sizes summing past M, K and N not multiples of 8 (gg_bf16's
    dx in bf16), no rows."""
    G, M, K, N, sizes = BWD_GEMM_CASES[case]
    x, w, dy, sz = _bwd_gemm_case(np.random.default_rng(M + K), G, M, K, N,
                                  sizes, getattr(torch, dtype), dev)
    dx, dw = _bwd_gemm_gate(x, w, dy, sz)
    ends = np.minimum(np.cumsum(np.maximum(sz.cpu().numpy(), 0)), M)
    assert not bool(dx[int(ends[-1]):].any())
    for g in np.nonzero(np.diff(np.r_[0, ends]) == 0)[0]:
        assert not bool(dw[g].any())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "unaligned"])
def test_grouped_gemm_backward_reads_strided_weight_views(dev, dtype,
                                                          offset):
    """w a view of wider rows, read in place by dx (bf16: gg_sm90 aligned,
    gg_bf16 one value in); dw comes back dense, of w's shape, equal to the
    contiguous stack's."""
    G, M, K, N = 3, 300, 64, 128
    rng = np.random.default_rng(40 + offset)
    x, w, dy, sz = _bwd_gemm_case(rng, G, M, K, N, None,
                                  getattr(torch, dtype), dev)
    rows = torch.zeros((G, offset + K * (N + 8)), dtype=w.dtype, device=dev)
    view = rows[:, offset:].view(G, K, N + 8)[:, :, :N]
    view.copy_(w)
    dx, dw = _bwd_gemm_gate(x, view, dy, sz)
    want = "moe_gemm_dx" if dtype == "float32" else (
        "moe_gemm_dx_sm90" if offset == 0 else "moe_gemm_dx_bf16")
    assert moe_ops.route_dx(dy, view) == want
    assert torch.equal(dx, moe_ops._launch_dx(dy, w, sz))


def test_grouped_gemm_backward_bf16_route_on_aligned_operands(dev):
    """gg_bf16's dx and gg_dw_bf16's dw (the unaligned routes) forced onto
    aligned operands at granite's in-projection: within the gate,
    counted."""
    x, w, dy, sz = _bwd_gemm_case(np.random.default_rng(41), 32, 2048, 1024,
                                  1024, None, torch.bfloat16, dev)
    _bwd_gemm_gate(x, w, dy, sz, dx_kernel="moe_gemm_dx_bf16",
                   dw_kernel="moe_gemm_dw_bf16")


@pytest.mark.parametrize("dw_kernel", ["moe_gemm_dw_sm90", "moe_gemm_dw_bf16",
                                       "moe_gemm_dw"])
def test_grouped_gemm_backward_dw_plan_and_split(dev, dw_kernel):
    """The dw walk on the card: its plan equal to `dw_plan_ref` (chunks in
    walk order, split groups), a hot group of 24 chunks within the gate
    on each dw kernel, two calls bit for bit, and the sum without one
    chunk's partial (from the workspace) beyond the gate."""
    G, M, K, N, sizes = BWD_GEMM_CASES["split hot group"]
    dt = torch.float32 if dw_kernel == "moe_gemm_dw" else torch.bfloat16
    x, w, dy, sz = _bwd_gemm_case(np.random.default_rng(43), G, M, K, N,
                                  sizes, dt, dev)
    scratch = {}
    _, dw = _bwd_gemm_gate(x, w, dy, sz, dw_kernel=dw_kernel,
                           scratch=scratch)
    chunks, splits = moe_ops.dw_plan_ref(sizes, M, scratch["chunk_rows"])
    plan = scratch["plan"].cpu().tolist()
    n, n_split = plan[0][:2]
    base = 1 + scratch["max_chunks"]
    assert [tuple(r) for r in plan[1:1 + n]] == chunks
    assert [tuple(r[:3]) for r in plan[base:base + n_split]] == splits
    assert splits and splits[0][:1] == (0,) and splits[0][2] > 2
    g, slot0, n_chunks = splits[0]
    ws = scratch["workspace"]
    part = ws[slot0].clone()
    for c in range(2, n_chunks):  # chunk 1 left out
        part += ws[slot0 + c]
    whole = ws[slot0].clone()  # dw_reduce's sum, in chunk order
    for c in range(1, n_chunks):
        whole += ws[slot0 + c]
    assert torch.equal(dw[g], whole.to(dt))
    up = torch.float64 if dt == torch.float32 else torch.float32
    want = grouped_gemm_bwd_ref(x.to(up), w.to(up), sz, dy.to(up))[1][g]
    mags = grouped_gemm_bwd_ref(x.abs().double(), w.abs().double(), sz,
                                dy.abs().double())[1][g]
    allowed = 1e-5 * mags + 1e-6 + (BF16_ROUND * want.double().abs()
                                    if dt == torch.bfloat16 else 0)
    assert not bool(((part.to(dt).double() - want.double()).abs()
                     <= allowed).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_gemm_autograd_on_the_card(dev, dtype):
    """`grouped_gemm` under `torch.autograd.grad`: one forward, one dx and
    one dw launch, their results the direct launches'; with x alone
    requiring grad, no dw launch."""
    dt = getattr(torch, dtype)
    x, w, dy, sz = _bwd_gemm_case(np.random.default_rng(42), 8, 1000, 256,
                                  128, None, dt, dev)
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    kernels.reset_launches()
    gx, gw = torch.autograd.grad(grouped_gemm(xr, wr, sz), (xr, wr), dy)
    fwd = "moe_gemm" if dtype == "float32" else "moe_gemm_sm90"
    dx_k = moe_ops.route_dx(dy, w)
    dw_k = moe_ops.route_dw(x, dy)
    ran = {k: v for k, v in kernels.launches().items() if v}
    assert ran == {fwd: 1, dx_k: 1, dw_k: 1}
    assert torch.equal(gx, moe_ops._launch_dx(dy, w, sz))
    assert torch.equal(gw, moe_ops._launch_dw(x, dy, sz, w.shape))
    kernels.reset_launches()
    torch.autograd.grad(grouped_gemm(xr, w, sz), (xr,), dy)
    ran = {k: v for k, v in kernels.launches().items() if v}
    assert ran == {fwd: 1, dx_k: 1}
