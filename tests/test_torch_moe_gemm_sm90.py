"""The arithmetic of the bf16 grouped GEMM `gg_sm90` (`csrc/moe_gemm.cu`),
emulated in torch on the CPU and held against the JAX package's
`grouped_gemm` at the gate `chip_smoke.py`'s `gemm_check` holds the
kernel to on the card; and the wrapper's route and tile choices as pure
functions of the operands.

`gg_sm90` multiplies bf16 x and w on the tensor cores with `wgmma`
m64nNk16: each product of two bf16 values is exact, and the tensor core
adds a k16 step's 16 products to the float32 sum it carries and truncates
the result toward zero. A sum carried through every k16 step of K would
drift by up to 2^-23 of itself a step; so the kernel keeps a sum on the
tensor core for SUM_DEPTH values of k only (its first `wgmma` with the
scale of d at 0) and then adds it into the tile's float32 sums, rounding
to nearest. Its two consumer warpgroups add half a sum apart (the second
warpgroup's first sum is SUM_DEPTH / 2 deep), so `emulate_sums` takes the
offset too. y is rounded to bf16 once.

Gate (`gemm_check`): |y - S| <= 2^-8·|S| + 1e-5·Σ|x w| + 1e-6, S the
float32 sums of the same bf16 operands — here the JAX package's, run on
their float32 values through `lax.ragged_dot` (backend "ref") and the
Pallas kernel in interpret mode. The float32 part alone (the emulated
sums before the rounding, against exact float64 sums) must stay within
half of 1e-5·Σ|x w| + 1e-6 at K = 1,536 on same-sign operands, random and
adversarial (`_adversarial`: a large first k16 step, then steps that each
add just under one float32 ulp of the sum): a margin of 2. The same
adversarial operands carried through all 96 k16 steps on the tensor core
land past that term (1.097e-5·Σ|x w|), which is why the kernel adds its
sums in float32 every SUM_DEPTH. Random same-sign operands do not show it:
their carried sums read about a fifth of the term.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.moe_gemm.ops import grouped_gemm as jax_grouped_gemm
from repro_torch import kernels
from repro_torch.kernels.moe_gemm.ops import (copies16, grouped_gemm, route,
                                              tile_rows)

# one intra-op thread per test process: the suite runs in parallel workers
torch.set_num_threads(1)

SOURCE = (Path(__file__).resolve().parent.parent / "src" / "repro_torch"
          / "csrc" / "moe_gemm.cu")


def _constant(name: str) -> int:
    """A `constexpr int` of the kernel's source."""
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text())
    assert m, f"{name} not found in {SOURCE.name}"
    return int(m.group(1))


SUM_DEPTH = _constant("kSumDepth")  # k values a sum stays on the tensor core
RING_DEPTH = _constant("kDepth")    # k values a ring stage
GEMM_REL = 1e-5                     # chip_smoke.py's GEMM_REL
BF16_ROUND = 2.0 ** -8              # chip_smoke.py's BF16_ROUND
MOE_GEOMS = ((4, 96, 32, 64), (1, 1, 64, 128), (6, 150, 128, 256),
             (3, 17, 32, 64))


@pytest.fixture(autouse=True)
def no_kernel_launch():
    """Nothing here launches a kernel: the wrapper's choices are pure
    functions, and CPU tensors take the plain version."""
    kernels.reset_launches()
    yield
    assert kernels.launches() == {k: 0 for k in kernels.KERNELS}


def _trunc32(v: torch.Tensor) -> torch.Tensor:
    """float64 -> float32, rounded toward zero (the tensor core's sum)."""
    f = v.to(torch.float32)
    over = f.double().abs() > v.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def emulate_sums(x, w, sizes, depth=SUM_DEPTH, shift=0):
    """gg_sm90's float32 sums (before y's rounding) of bf16 x (M, K) and w
    (G, K, N), group g owning the next sizes[g] rows (negative sizes as 0,
    rows past M cut, the rest 0). Per k16 step the 16 exact products go
    into the tensor core's sum, truncated toward zero; a sum starts where
    16·i + shift is a multiple of `depth` (and at k = 0), and ends, added
    into the float32 sums to nearest, where the next starts or at the last
    step."""
    M, K = x.shape
    N = w.shape[2]
    steps = -(-K // 16)
    pad = steps * 16 - K
    xf = torch.nn.functional.pad(x.double(), (0, pad))
    wf = torch.nn.functional.pad(w.double(), (0, 0, 0, pad))
    out = torch.zeros((M, N), dtype=torch.float32)
    start = 0
    for g, size in enumerate(np.asarray(sizes).tolist()):
        end = min(start + max(int(size), 0), M)
        if end > start:
            acc = torch.zeros((end - start, N), dtype=torch.float32)
            part = None
            for i in range(steps):
                p = xf[start:end, 16 * i:16 * i + 16] @ wf[g, 16 * i:
                                                             16 * i + 16]
                first = i == 0 or (16 * i + shift) % depth == 0
                part = _trunc32(p if first else part.double() + p)
                if i == steps - 1 or (16 * (i + 1) + shift) % depth == 0:
                    acc = acc + part
            out[start:end] = acc
        start = end
    return out


def _case(geom, seed, same_sign=False):
    """bf16 x and w as the MOE family draws them (rows at random cuts, x ~
    N(0, 1), w ~ N(0, 0.1²)), or their absolute values."""
    G, M, K, N = geom
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.integers(0, M + 1, size=G - 1))
    sizes = np.diff(np.r_[0, cuts, M]).astype(np.int32)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = (rng.normal(size=(G, K, N)) * 0.1).astype(np.float32)
    if same_sign:
        x, w = np.abs(x), np.abs(w)
    return (torch.from_numpy(x).to(torch.bfloat16),
            torch.from_numpy(w).to(torch.bfloat16), sizes)


def _adversarial(G=2, M=8, K=1536, N=16):
    """Same-sign bf16 operands on which a carried sum loses most: the
    first k16 step adds 16 (the bottom of a binade, where an ulp is 2^-23
    of the sum), every later one 16 · 2^-12 · 2^-11·(1 - 2^-5), just under
    one ulp (2^-19), which a truncated sum drops whole."""
    x = torch.full((M, K), 2.0 ** -12)
    x[:, :16] = 1.0
    w = torch.full((G, K, N), 2.0 ** -11 * (1 - 2.0 ** -5))
    w[:, :16] = 1.0
    sizes = np.full(G, M // G, np.int32)
    return x.to(torch.bfloat16), w.to(torch.bfloat16), sizes


def _exact(x, w, sizes):
    """float64 sums of the bf16 values, and Σ|x w| (float64)."""
    st = torch.from_numpy(np.asarray(sizes))

    def f64(a, b):
        out = torch.zeros((a.shape[0], b.shape[2]), dtype=torch.float64)
        start = 0
        for g, size in enumerate(st.tolist()):
            end = min(start + max(size, 0), a.shape[0])
            out[start:end] = a[start:end] @ b[g]
            start = end
        return out
    return (f64(x.double(), w.double()),
            f64(x.double().abs(), w.double().abs()))


def _float32_share(sums, x, w, sizes) -> float:
    """The emulated float32 sums' error against the exact sums, as a share
    of gemm_check's float32 term GEMM_REL·Σ|x w| + 1e-6."""
    exact, mags = _exact(x, w, sizes)
    return float(((sums.double() - exact).abs()
                  / (GEMM_REL * mags + 1e-6)).max())


def _jax_sums(x, w, sizes, backend):
    """The JAX package's float32 sums of the bf16 operands' values."""
    K, N = x.shape[1], w.shape[2]
    out = jax_grouped_gemm(jnp.asarray(x.float().numpy()),
                           jnp.asarray(w.float().numpy()),
                           jnp.asarray(sizes), block_m=16,
                           block_n=min(N, 128), block_k=min(K, 64),
                           backend=backend)
    assert out.dtype == jnp.float32
    return torch.from_numpy(np.asarray(out))


def _gemm_check(y, want, x, w, sizes):
    """gemm_check's gate for a bf16 y against float32 sums `want`; returns
    the share of the gate used."""
    assert y.dtype == torch.bfloat16 and y.shape == want.shape
    _, mags = _exact(x, w, sizes)
    want = want.double()
    allowed = GEMM_REL * mags + 1e-6 + BF16_ROUND * want.abs()
    err = (y.double() - want).abs()
    share = float((err / allowed).max()) if err.numel() else 0.0
    assert share <= 1.0, share
    return share


# The MOE geometries through both JAX paths; granite-moe-3b-a800m's in- and
# out-projection (K = 1,536 and 512) at a decode step's size through
# `lax.ragged_dot`, and a few columns of them through the Pallas kernel in
# interpret mode (it takes minutes at full width); random and same-sign.
EMU_CASES = (
    [(g, "ref", False) for g in MOE_GEOMS]
    + [(g, "interpret", False) for g in MOE_GEOMS]
    + [((40, 64, 1536, 1024), "ref", s) for s in (False, True)]
    + [((40, 80, 512, 1536), "ref", s) for s in (False, True)]
    + [((2, 32, 1536, 128), "interpret", s) for s in (False, True)]
    + [((2, 48, 512, 128), "interpret", True)])


@pytest.mark.parametrize("geom,backend,same_sign", EMU_CASES,
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else str(v))
def test_sm90_emulation_within_gate_of_jax(geom, backend, same_sign):
    """(a) The emulated kernel — bf16 y from its float32 sums, each
    warpgroup's offset of the sums — within gemm_check's gate of the JAX
    package's float32 sums of the same bf16 operands."""
    x, w, sizes = _case(geom, seed=sum(geom), same_sign=same_sign)
    want = _jax_sums(x, w, sizes, backend)
    for shift in (0, SUM_DEPTH // 2):
        y = emulate_sums(x, w, sizes, shift=shift).to(torch.bfloat16)
        _gemm_check(y, want, x, w, sizes)
    # the plain version (what the card's gate compares against) agrees
    plain = grouped_gemm(x.float(), w.float(), torch.from_numpy(sizes))
    torch.testing.assert_close(plain, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("operands", ["random", "adversarial"])
@pytest.mark.parametrize("K", [1536, 512])
def test_sum_depth_keeps_a_margin_of_two(operands, K):
    """The kernel's SUM_DEPTH on same-sign operands at granite's depths:
    the float32 sums within half of gemm_check's float32 term, for either
    warpgroup's offset."""
    if operands == "random":
        x, w, sizes = _case((3, 64, K, 128), seed=K, same_sign=True)
    else:
        x, w, sizes = _adversarial(K=K)
    for shift in (0, SUM_DEPTH // 2):
        share = _float32_share(emulate_sums(x, w, sizes, shift=shift), x, w,
                               sizes)
        assert share <= 0.5, (shift, share)


def test_carried_sum_misses_the_float32_term():
    """(b) The control: the adversarial same-sign operands summed on the
    tensor core through all 96 k16 steps of K = 1,536 (no float32 adds)
    land past gemm_check's float32 term, and SUM_DEPTH brings them within
    half of it. Random same-sign operands carried the same way stay inside
    (about a fifth of the term): the miss needs the sum to sit at the
    bottom of a binade while each step adds under an ulp."""
    x, w, sizes = _adversarial()
    carried = _float32_share(emulate_sums(x, w, sizes, depth=1536), x, w,
                             sizes)
    assert 1.0 < carried < 1.2, carried
    assert _float32_share(emulate_sums(x, w, sizes), x, w, sizes) <= 0.5
    x, w, sizes = _case((3, 64, 1536, 128), seed=7, same_sign=True)
    assert _float32_share(emulate_sums(x, w, sizes, depth=1536), x, w,
                          sizes) < 1.0


def test_sum_depth_is_whole_ring_stages():
    """The kernel's constants: sums of whole 64-deep ring stages, an even
    number of them (the warpgroups' offset is half a sum), at most 256
    deep (what the tests above hold)."""
    assert RING_DEPTH == 64
    assert SUM_DEPTH % RING_DEPTH == 0 and (SUM_DEPTH // RING_DEPTH) % 2 == 0
    assert SUM_DEPTH <= 256


def test_trunc32_rounds_toward_zero():
    v = torch.tensor([1.0 + 2.0 ** -30, -(1.0 + 2.0 ** -30), 3.0,
                      (1.0 + 2.0 ** -23) * (1 - 2.0 ** -40), 0.0],
                     dtype=torch.float64)
    assert _trunc32(v).tolist() == [1.0, -1.0, 3.0, 1.0, 0.0]


def _views(K, N, offset=0, width=None, dtype=torch.bfloat16):
    """x (40, K) and w (3, K, N) as a view of rows `width` apart (default
    N), starting `offset` values into 16-byte aligned storage."""
    width = width or N
    rows = torch.zeros((3, offset + K * width + 64), dtype=dtype)
    w = rows[:, offset:offset + K * width].view(3, K, width)[:, :, :N]
    return torch.zeros((40, K), dtype=dtype), w


@pytest.mark.parametrize("K,N,offset,width,want", [
    (24, 16, 0, None, "moe_gemm_sm90"),   # contiguous, aligned
    (1536, 1024, 0, None, "moe_gemm_sm90"),
    (24, 16, 1, None, "moe_gemm_bf16"),   # a view one value in
    (24, 40, 0, None, "moe_gemm_sm90"),   # K = 24 is 8 values x 3
    (30, 16, 0, None, "moe_gemm_bf16"),
    (33, 16, 0, None, "moe_gemm_bf16"),
    (24, 5, 0, 8, "moe_gemm_bf16"),       # N = 5, 6, 7 of rows 8 apart
    (24, 6, 0, 8, "moe_gemm_bf16"),
    (24, 7, 0, 8, "moe_gemm_bf16"),
    (24, 8, 0, 24, "moe_gemm_sm90"),      # N = 8 of rows 24 apart
    (24, 8, 0, 12, "moe_gemm_bf16"),      # rows 24 bytes apart
    (0, 16, 0, None, "moe_gemm_bf16"),    # K = 0: no tensor map
])
def test_route_predicate(K, N, offset, width, want):
    """(c) bf16 operands take gg_sm90 exactly where a TMA tensor map can
    describe them: bases and w's strides 16-byte aligned, K > 0, K and N
    multiples of 8. float32 takes gg_tf32 whatever the layout."""
    x, w = _views(K, N, offset, width)
    assert route(x, w) == want
    if want == "moe_gemm_sm90":
        assert copies16(x, w)
    assert route(x.float(), w.float()) == "moe_gemm"


@pytest.mark.parametrize("M,G,rows", [
    (64, 40, 64), (80, 40, 64),          # granite's decode step: 8 tokens
    (1024, 40, 64), (5119, 40, 64),      # under 128 rows a group
    (5120, 40, 128), (262_144, 40, 128),  # granite's prefill: 32,768 tokens
    (1, 1, 64), (127, 1, 64), (128, 1, 128)])
def test_tile_rows_choice(M, G, rows):
    """(c) The rows of a tile, which also pick gg_sm90's shape: 64 where the
    G groups average fewer than 128 of the M rows (64 x 128 blocks alone,
    the two warpgroups 64 columns each), else 128 (128 x 128 blocks, two of
    them a cluster sharing x)."""
    assert tile_rows(M, G) == rows


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("path", ["batched", "loop"])
def test_gemm_check_sums_match_the_plain_version(dtype, path, monkeypatch):
    """chip_smoke.py's `_grouped_sums` (Σ x w and Σ |x| |w|, what
    `gemm_check`'s gate is made of) against the plain `grouped_gemm_ref` on
    x, w and on |x|, |w|, through its batched product over groups padded to
    the largest and through the plain version it falls back to past
    GEMM_CHECK_PAD: empty groups, negative sizes, groups past M, rows past
    the groups; within GEMM_REL·Σ|x w| + 1e-6 (float32 sums in another
    order)."""
    import sys

    from repro_torch.kernels.moe_gemm.ref import grouped_gemm_ref

    sys.path.insert(0, str(SOURCE.parents[3]))
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "GEMM_CHECK_PAD",
                        1 << 30 if path == "batched" else 0)
    rng = np.random.default_rng(29)
    f32 = torch.float32
    for G, M, K, N, sizes in [(5, 64, 48, 24, [10, 0, 30, 4, 20]),
                              (4, 40, 16, 8, [-3, 12, 0, 50]),
                              (6, 33, 8, 40, [0, 0, 5, 0, 7, 0]),
                              (3, 0, 16, 16, [0, 0, 0]),
                              (40, 64, 96, 64,
                               list(np.bincount(rng.integers(0, 40, 64),
                                                minlength=40)))]:
        x = torch.from_numpy(rng.normal(size=(M, K))).to(getattr(torch,
                                                                 dtype))
        w = torch.from_numpy(rng.normal(size=(G, K, N))).to(x.dtype)
        sz = torch.tensor(sizes, dtype=torch.int32)
        got, mags = chip_smoke._grouped_sums(x, w, sz)
        want = grouped_gemm_ref(x.to(f32), w.to(f32), sz)
        want_mags = grouped_gemm_ref(x.abs().to(f32), w.abs().to(f32), sz)
        assert got.shape == mags.shape == (M, N)
        assert got.dtype == mags.dtype == f32
        allowed = GEMM_REL * want_mags.double() + 1e-6
        assert ((got.double() - want.double()).abs() <= allowed).all()
        assert ((mags.double() - want_mags.double()).abs() <= allowed).all()
