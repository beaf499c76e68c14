"""The 3xTF32 arithmetic of the port's float32 tensor-core kernels,
emulated in torch on the CPU and held against the JAX package's kernels
and float64 at the gates the kernels are held to on the card.

`csrc/moe_gemm.cu` (`gg_tf32`) and `csrc/flash_attention_tf32.cu`
(`fa_tf32`) multiply float32 operands on the tensor cores in TF32 (10
stored mantissa bits). Each operand `a` is split as `hi` = a truncated to
TF32 (its 13 low mantissa bits cleared) and `lo` = a - hi, which the
tensor core truncates to TF32 when it reads it; a product is hi·hi +
hi·lo + lo·hi. Each product of two TF32 values is exact in float32, so a
float32 matmul of the parts is the tensor core's product up to the order
of the float32 sums. The kernels add each ring stage's (GEMM: 32 deep) or
key tile's (attention: P·V over 64 keys, 32 at hd 128) products into
sums of their own, then into the running float32 sums; the emulation
does the same, rounding its sums to nearest where the tensor core
truncates inside a stage's sums (a part that only the card shows). CUDA
kernels cannot run here; `chip_smoke.py` and
`tests/test_torch_cuda_kernels.py` hold the kernels themselves on a card.

Gates: the parameter server's decode gate |Δ| <= DECODE_REL·(1 + |ref|)
against float64, the grouped GEMM's sum bound |Δ| <= 1e-5·Σ|x w| + 1e-6
(chip_smoke.py's `gemm_parity`), attention's ATTN_REL·(1 + |ref|)
against the JAX kernel in interpret mode; and the JAX suite's 2e-4 for
the grouped GEMM against `lax.ragged_dot` and the Pallas kernel. One TF32
truncation of each operand (hi·hi alone) lands past the decode, sum and
attention gates on the same inputs (`*_single_tf32_*`).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention as jax_fa
from repro.kernels.moe_gemm.ops import grouped_gemm as jax_grouped_gemm

# one intra-op thread per test process: the suite runs in parallel workers
torch.set_num_threads(1)

DECODE_REL = 1e-5      # chip_smoke.py's DECODE_REL
SUM_REL = 1e-5         # chip_smoke.py's gemm_parity: 1e-5·Σ|x w| + 1e-6
ATTN_REL = 2e-5        # chip_smoke.py's ATTN_REL
JAX_TOL = 2e-4         # tests/test_kernels.py's MOE tolerance
LOG2E = 1.4426950408889634
MASKED = -2.0e38
GEMM_BK = 32                       # moe_gemm.cu's kBK
FA_BK = {32: 64, 64: 64, 128: 32}  # flash_attention_tf32.cu's Tile::kBK
TF32_MASK = -(1 << 13)             # 0xffffe000: clears 13 mantissa bits
MOE_GEOMS = ((4, 96, 32, 64), (1, 1, 64, 128), (6, 150, 128, 256),
             (3, 17, 32, 64))


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32 by truncation (what the tensor core does to a
    float32 it reads, and how the kernels form hi)."""
    return (x.contiguous().view(torch.int32) & TF32_MASK).view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, split: bool = True):
    """a @ b on the tensor cores: hi·hi + hi·lo + lo·hi (the two small
    products first, as `sm90::mma_3xtf32` issues them), or hi·hi alone."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    if not split:
        return a_hi @ b_hi
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def emulate_grouped_gemm(x, w, sizes, split=True):
    """gg_tf32's arithmetic: per group, per 32-deep stage, the products
    into stage sums added to the running float32 sums; rows at or beyond
    the groups' sum are 0. x (M, K), w (G, K, N) float32; sizes (G,)."""
    M, K = x.shape
    out = torch.zeros((M, w.shape[2]), dtype=torch.float32)
    start = 0
    for g, size in enumerate(np.asarray(sizes).tolist()):
        end = min(start + max(int(size), 0), M)
        for k0 in range(0, K, GEMM_BK):
            out[start:end] += _mm(x[start:end, k0:k0 + GEMM_BK],
                                  w[g, k0:k0 + GEMM_BK], split)
        start = end
    return out


def emulate_attention(q, k, v, causal, split=True):
    """fa_tf32's arithmetic: key tiles of FA_BK[hd], S = Q·Kᵀ in 3xTF32,
    the causal mask on the raw scores, online softmax in base 2 with
    scale·log2 e folded in, and each tile's P·V (P split too) into sums of
    its own added to O with the rescale. (B, S, H, hd) float32."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.permute(0, 2, 1, 3)  # (B, H, S, hd)
    kf, vf = (t.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
              for t in (k, v))
    scale = torch.tensor(hd ** -0.5 * LOG2E, dtype=torch.float32)
    m = torch.full((B, H, S), MASKED)
    l = torch.zeros((B, H, S))
    acc = torch.zeros((B, H, S, hd))
    rows = torch.arange(S)[:, None]
    bk = FA_BK[hd]
    for k0 in range(0, T, bk):
        cols = torch.arange(k0, min(T, k0 + bk))[None, :]
        x = _mm(qf, kf[:, :, k0:k0 + bk].transpose(-1, -2), split)
        if causal:
            x = x.masked_fill(cols > rows, MASKED)
        mx = torch.maximum(m, x.amax(-1) * scale)
        alpha = torch.exp2(m - mx)
        p = torch.exp2(x * scale - mx[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + _mm(p, vf[:, :, k0:k0 + bk], split)
        m = mx
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3)


def test_tf32_truncation_is_bit_arithmetic():
    """_tf32 keeps sign, exponent and 10 mantissa bits, and hi + lo
    carries the value to 21 bits."""
    x = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, -3.14159265,
                      1e-30, 6e4], dtype=torch.float32)
    hi = _tf32(x)
    assert hi.tolist()[:3] == [1.0, 1.0 + 2.0 ** -10, 1.0]
    assert bool((hi.abs() <= x.abs()).all())
    assert bool(((x - hi).abs() < x.abs() * 2.0 ** -10).all())
    lo = _tf32(x - hi)
    err = (x.double() - hi.double() - lo.double()).abs()
    assert bool((err < x.abs().double() * 2.0 ** -20).all())


def _grouped_case(M, K, N, G, seed, w_scale=0.02):
    """Decode-sized rows over G experts at random cuts, activations ~N(0, 1)
    and weights ~N(0, w_scale²) as float32 numpy."""
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.integers(0, M + 1, size=G - 1))
    sizes = np.diff(np.r_[0, cuts, M]).astype(np.int32)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = (rng.normal(size=(G, K, N)) * w_scale).astype(np.float32)
    return x, w, sizes


def _f64(x, w, sizes):
    """The grouped product in float64 and Σ|x w| per element."""
    out = np.zeros((x.shape[0], w.shape[2]))
    mags = np.zeros_like(out)
    start = 0
    for g, size in enumerate(sizes.tolist()):
        end = start + size
        out[start:end] = x[start:end].astype(np.float64) @ w[g]
        mags[start:end] = np.abs(x[start:end]).astype(np.float64) @ \
            np.abs(w[g]).astype(np.float64)
        start = end
    return out, mags


def _gemm_shares(got, want, mags):
    """Shares of the decode gate and of the sum bound."""
    err = np.abs(got.numpy().astype(np.float64) - want)
    return (float((err / (DECODE_REL * (1 + np.abs(want)))).max()),
            float((err / (SUM_REL * mags + 1e-6)).max()))


@pytest.mark.parametrize("K,N", [(1536, 1024), (512, 1536)],
                         ids=["in-projection", "out-projection"])
def test_grouped_gemm_3xtf32_at_granite_width_within_the_gates(K, N):
    """granite-moe-3b-a800m's expert widths (d = 1536, 2f = 1024), 64
    decode rows over 4 experts: the emulation within the decode gate and
    the sum bound of float64."""
    x, w, sizes = _grouped_case(64, K, N, 4, seed=21)
    want, mags = _f64(x, w, sizes)
    got = emulate_grouped_gemm(torch.from_numpy(x), torch.from_numpy(w),
                               sizes)
    decode, sums = _gemm_shares(got, want, mags)
    assert decode <= 0.5 and sums <= 0.5, (decode, sums)


def test_grouped_gemm_single_tf32_breaks_the_gates():
    """One TF32 truncation of each operand (hi·hi alone) misses the decode
    gate and the sum bound at granite's in-projection by far (99x and 13x
    of them on these inputs); the split holds both (0.09 and 0.009)."""
    x, w, sizes = _grouped_case(64, 1536, 1024, 4, seed=22)
    want, mags = _f64(x, w, sizes)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    split = _gemm_shares(emulate_grouped_gemm(xt, wt, sizes), want, mags)
    single = _gemm_shares(emulate_grouped_gemm(xt, wt, sizes, split=False),
                          want, mags)
    assert max(split) <= 0.5, split
    assert min(single) > 4.0, single


def _jax_gemm(x, w, sizes, backend):
    K, N = x.shape[1], w.shape[2]
    return np.asarray(jax_grouped_gemm(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(sizes), block_m=16,
        block_n=min(N, 128), block_k=min(K, 64), backend=backend))


@pytest.mark.parametrize("backend", ["ref", "interpret"])
@pytest.mark.parametrize("geom", MOE_GEOMS, ids=lambda g: "x".join(map(str, g)))
def test_grouped_gemm_3xtf32_matches_jax(geom, backend):
    """The MOE geometries of tests/test_kernels.py (inputs as its
    `_moe_case` makes them) against `lax.ragged_dot` and the Pallas kernel
    in interpret mode."""
    G, M, K, N = geom
    x, w, sizes = _grouped_case(M, K, N, G, seed=0, w_scale=0.1)
    got = emulate_grouped_gemm(torch.from_numpy(x), torch.from_numpy(w),
                               sizes).numpy()
    np.testing.assert_allclose(got, _jax_gemm(x, w, sizes, backend),
                               atol=JAX_TOL, rtol=JAX_TOL)


@pytest.mark.parametrize("backend", ["ref", "interpret"])
def test_grouped_gemm_3xtf32_empty_groups_and_rows_beyond_the_sum(backend):
    """An empty group in the middle and 17 rows past the groups' sum, which
    come out 0 (the Pallas path does not zero them: compared on the 40
    grouped rows there)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(57, 24)).astype(np.float32)
    w = rng.normal(size=(5, 24, 40)).astype(np.float32)
    sizes = np.array([11, 0, 20, 9, 0], np.int32)
    got = emulate_grouped_gemm(torch.from_numpy(x), torch.from_numpy(w),
                               sizes).numpy()
    assert not got[40:].any()
    rows = slice(None) if backend == "ref" else slice(0, 40)
    np.testing.assert_allclose(got[rows], _jax_gemm(x, w, sizes,
                                                    backend)[rows],
                               atol=JAX_TOL, rtol=JAX_TOL)


def _attention_case(S, H, KV, hd, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(2, S, n, hd)).astype(np.float32)
                 for n in (H, KV, KV))


def _attention_share(got, q, k, v, causal, hd):
    """max |got - JAX kernel (interpret)| / (ATTN_REL·(1 + |ref|))."""
    want = np.asarray(jax_fa(*(jnp.asarray(a) for a in (q, k, v)),
                             causal=causal, block_q=128,
                             block_k=FA_BK[hd], interpret=True),
                      np.float64)
    err = np.abs(got.numpy().astype(np.float64) - want)
    return float((err / (ATTN_REL * (1 + np.abs(want)))).max())


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("H,KV,hd", [(8, 2, 64), (4, 1, 128), (4, 4, 64)],
                         ids=["gqa4-hd64", "gqa4-hd128", "mha-hd64"])
def test_attention_3xtf32_within_the_float32_gate(H, KV, hd, causal):
    """S = T = 256 against the JAX kernel in interpret mode."""
    q, k, v = _attention_case(256, H, KV, hd, seed=31)
    got = emulate_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                            causal)
    assert _attention_share(got, q, k, v, causal, hd) <= 0.5


@pytest.mark.parametrize("hd", [64, 128])
def test_attention_single_tf32_breaks_the_float32_gate(hd):
    """One TF32 truncation of q, k, P and v (hi·hi alone) errs by up to
    2^-9 a product: the scores' error moves the softmax weights, and the
    output lands past ATTN_REL (58x of it at hd 64, 65x at hd 128 on these
    inputs); the split holds it (0.05 of it)."""
    q, k, v = _attention_case(256, 8, 2, hd, seed=32)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    split = _attention_share(emulate_attention(qt, kt, vt, True), q, k, v,
                             True, hd)
    single = _attention_share(emulate_attention(qt, kt, vt, True,
                                                split=False),
                              q, k, v, True, hd)
    assert split <= 0.5 and single > 4.0, (split, single)
