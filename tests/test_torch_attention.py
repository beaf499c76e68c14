"""The port's attention kernels (`kernels/flash_attention`,
`kernels/flash_decode`) held against the JAX package's, on the same seeded
numpy inputs in one process.

On the CPU `attention` and `decode_attention` run their plain PyTorch
versions (the CUDA kernels are held against those by `chip_smoke.py` on the
card, and by `tests/test_torch_cuda_kernels.py`, which skips without one).
Each is compared with the JAX family's oracle (`ref.py`) AND its Pallas
kernel in interpret mode, on the `FLASH` and `DECODE` geometries of
`tests/test_kernels.py`, the decode shapes of `tests/test_theory.py`'s
property test, bf16 inputs, and valid prefixes of 0 and beyond T.

Tolerances are the JAX suite's own: atol = rtol = 2e-5 in float32 (sums
in other orders and another blocking of the online softmax), 3e-2 for
bf16 inputs and outputs (`test_flash_bf16_io`: bf16 rounding of the
result).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hyp import given, settings, st

from repro.kernels.flash_attention.kernel import flash_attention as jax_fa
from repro.kernels.flash_attention.ref import attention_ref as jax_fa_ref
from repro.kernels.flash_decode.kernel import flash_decode as jax_fd
from repro.kernels.flash_decode.ref import decode_attention_ref as jax_fd_ref
from repro_torch import kernels
from repro_torch.kernels import attention, decode_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.flash_decode.ops import heads_per_block, num_splits

# one intra-op thread per test process: the suite runs in parallel workers
torch.set_num_threads(1)

TOL = 2e-5
BF16_TOL = 3e-2
# (S, H, KV, hd, block_q, block_k) x causal: the FLASH family
FLASH_GEOMS = [(S, H, KV, hd, bq, bk, causal)
               for (S, H, KV, hd, bq, bk) in [
                   (128, 4, 4, 64, 64, 64), (256, 8, 2, 64, 128, 64),
                   (128, 4, 1, 128, 64, 128), (64, 2, 2, 32, 64, 32)]
               for causal in (True, False)]
# (B, T, KV, G, hd, length, block_t): the DECODE family
DECODE_GEOMS = [(2, 128, 2, 4, 64, 100, 64), (1, 256, 1, 8, 64, 256, 128),
                (2, 64, 4, 1, 32, 1, 64)]


@pytest.fixture(autouse=True)
def no_kernel_launch():
    """On the CPU the wrappers take their plain versions: nothing
    launches."""
    kernels.reset_launches()
    yield
    assert kernels.launches() == {k: 0 for k in kernels.KERNELS}


def _fa_case(geom, seed=0, B=2, dtype=np.float32):
    """The inputs of `_fa_case` in tests/test_kernels.py, as numpy."""
    S, H, KV, hd = geom[:4]
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(B, S, n, hd)).astype(dtype)
                 for n in (H, KV, KV))


def _fd_case(geom, seed=0):
    """The inputs of `_fd_case` in tests/test_kernels.py, as numpy."""
    B, T, KV, G, hd = geom[:5]
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, KV * G, hd)).astype(np.float32),
            rng.normal(size=(B, T, KV, hd)).astype(np.float32),
            rng.normal(size=(B, T, KV, hd)).astype(np.float32))


def _port(fn, *arrays, **kw):
    return fn(*(torch.from_numpy(a) for a in arrays), **kw).numpy()


@pytest.mark.parametrize("path", ["interpret", "ref"])
@pytest.mark.parametrize("geom", FLASH_GEOMS,
                         ids=lambda g: "x".join(map(str, g)))
def test_attention_matches_jax(geom, path):
    q, k, v = _fa_case(geom)
    causal = geom[-1]
    got = _port(attention, q, k, v, causal=causal)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    if path == "interpret":
        want = jax_fa(jq, jk, jv, causal=causal, block_q=geom[4],
                      block_k=geom[5], interpret=True)
    else:
        want = jax_fa_ref(jq, jk, jv, causal=causal)
    assert got.dtype == np.float32 and got.shape == q.shape
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=TOL)


def test_attention_bf16_io():
    """tests/test_kernels.py::test_flash_bf16_io: bf16 in, bf16 out."""
    rng = np.random.default_rng(1)
    q, k, v = (rng.normal(size=(1, 128, 2, 64)).astype(np.float32)
               for _ in range(3))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = jax_fa(jq, jk, jv, block_q=64, block_k=64, interpret=True)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=BF16_TOL, rtol=BF16_TOL)


def test_attention_causal_needs_equal_lengths():
    """Causal S != T has no single answer in the reference: its kernel
    masks col > row, its oracle keeps tril(k=T-S), and at q (1, 64, 2, 32),
    k/v (1, 128, 2, 32) they differ by more than 2 (2.43 on these inputs).
    Both the port's wrapper and its plain version refuse it."""
    rng = np.random.default_rng(6)
    q, k, v = (rng.normal(size=(1, s, 2, 32)).astype(np.float32)
               for s in (64, 128, 128))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    kernel = jax_fa(jq, jk, jv, causal=True, block_q=32, block_k=32,
                    interpret=True)
    oracle = jax_fa_ref(jq, jk, jv, causal=True)
    assert np.abs(np.asarray(kernel) - np.asarray(oracle)).max() > 2
    for fn in (attention, attention_ref):
        with pytest.raises(ValueError, match="S == T"):
            fn(*(torch.from_numpy(a) for a in (q, k, v)), causal=True)


def test_attention_non_causal_unequal_lengths():
    """Non-causal S != T (cross attention, GQA 2:1) against the oracle."""
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, 48, 4, 32)).astype(np.float32)
    k, v = (rng.normal(size=(2, 80, 2, 32)).astype(np.float32)
            for _ in range(2))
    got = _port(attention, q, k, v, causal=False)
    want = jax_fa_ref(*(jnp.asarray(a) for a in (q, k, v)), causal=False)
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=TOL)


def test_attention_blocks_of_query_rows(monkeypatch):
    """The plain version forms its scores a block of query rows at a time;
    blocks of 7 rows give the one-block result."""
    from repro_torch.kernels.flash_attention import ref

    q, k, v = (torch.from_numpy(a) for a in _fa_case(FLASH_GEOMS[2]))
    for causal in (True, False):
        whole = attention_ref(q, k, v, causal=causal)
        monkeypatch.setattr(ref, "SCORE_BUDGET", 2 * 8 * 256 * 7)
        got = attention_ref(q, k, v, causal=causal)
        monkeypatch.undo()
        np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=1e-6,
                                   rtol=1e-6)


@pytest.mark.parametrize("path", ["interpret", "ref"])
@pytest.mark.parametrize("geom", DECODE_GEOMS,
                         ids=lambda g: "x".join(map(str, g)))
def test_decode_matches_jax(geom, path):
    q, k, v = _fd_case(geom)
    length = geom[5]
    got = _port(decode_attention, q, k, v, length=length)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    if path == "interpret":
        want = jax_fd(jq, jk, jv, length, block_t=geom[6], interpret=True)
    else:
        want = jax_fd_ref(jq, jk, jv, length)
    assert got.dtype == np.float32 and got.shape == q.shape
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("path", ["interpret", "ref"])
@pytest.mark.parametrize("length", [0, -3, 129, 10**6])
def test_decode_length_outside_the_cache(length, path):
    """length <= 0: every position scores -2.0e38 and ties, so the result
    is the mean of V over the whole cache (in both JAX paths too); length
    > T reads the whole cache."""
    geom = DECODE_GEOMS[0]
    q, k, v = _fd_case(geom, seed=4)
    got = _port(decode_attention, q, k, v, length=length)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    if path == "interpret":
        want = jax_fd(jq, jk, jv, length, block_t=geom[6], interpret=True)
    else:
        want = jax_fd_ref(jq, jk, jv, length)
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=TOL)
    if length <= 0:
        B, T, KV, G, hd = geom[:5]
        mean = np.repeat(v.mean(axis=1), G, axis=1)  # (B, KV * G, hd)
        np.testing.assert_allclose(got, mean, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("length", [0, 1, 77, 128, 200])
def test_decode_length_as_tensor(length):
    """A 0-d integer tensor gives what the Python int gives."""
    q, k, v = (torch.from_numpy(a) for a in _fd_case(DECODE_GEOMS[0]))
    want = decode_attention(q, k, v, length)
    for dtype in (torch.int32, torch.int64):
        got = decode_attention(q, k, v, torch.tensor(length, dtype=dtype))
        torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_decode_bf16_io():
    rng = np.random.default_rng(5)
    B, T, KV, G, hd = 2, 128, 2, 4, 64
    q = rng.normal(size=(B, KV * G, hd)).astype(np.float32)
    k, v = (rng.normal(size=(B, T, KV, hd)).astype(np.float32)
            for _ in range(2))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = jax_fd(jq, jk, jv, 90, block_t=64, interpret=True)
    got = decode_attention(*(torch.from_numpy(a).to(torch.bfloat16)
                             for a in (q, k, v)), 90)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=BF16_TOL, rtol=BF16_TOL)


@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 500),
       shape=st.sampled_from([(4, 2, 64, 256), (8, 8, 32, 512),
                              (4, 1, 64, 128)]))
def test_decode_property_vs_jax(seed, shape):
    """tests/test_theory.py::TestFlashDecodeKernel's shapes and valid
    prefixes: the port against the interpret-mode kernel and the oracle."""
    H, KV, hd, T = shape
    rng = np.random.default_rng(seed)
    L = int(rng.integers(1, T + 1))
    B = 2
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    k, v = (rng.normal(size=(B, T, KV, hd)).astype(np.float32)
            for _ in range(2))
    got = _port(decode_attention, q, k, v, length=L)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    for want in (jax_fd(jq, jk, jv, L, block_t=64, interpret=True),
                 jax_fd_ref(jq, jk, jv, L)):
        np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("B,KV,G,T,sms,want", [
    (1, 32, 1, 524288, 132, 66),    # zamba2 long_500k: 32 blocks alone
    (128, 4, 8, 32768, 132, 5),     # tinyllama decode_32k
    (2, 2, 4, 128, 132, 1),         # a short cache: one split of >= 512
    (1, 2, 16, 10_000, 132, 20),    # G = 16: two groups of 8 per KV head
])
def test_decode_split_count(B, KV, G, T, sms, want):
    assert num_splits(B, KV, G, T, sms) == want


def test_wrappers_refuse_other_devices():
    x = torch.zeros((1, 4, 2, 32), device="meta")
    with pytest.raises(ValueError, match="no kernel or plain path"):
        attention(x, x, x)
    q = torch.zeros((1, 2, 32), device="meta")
    with pytest.raises(ValueError, match="no kernel or plain path"):
        decode_attention(q, x, x, 3)


@pytest.mark.parametrize("shapes", [
    ((1, 8, 3, 32), (1, 8, 2, 32), (1, 8, 2, 32)),   # 3 heads over 2
    ((1, 8, 4, 32), (1, 8, 2, 16), (1, 8, 2, 16)),   # head dims differ
    ((1, 8, 4, 32), (1, 8, 2, 32), (1, 9, 2, 32)),   # k and v differ
])
def test_attention_refuses_mismatched_shapes(shapes):
    q, k, v = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError):
        attention(q, k, v, causal=False)


# ---------------------------------------------------------------------------
# The bf16 tensor-core kernels' arithmetic, emulated in torch on the CPU
# (csrc/flash_attention_sm90.cu, csrc/flash_decode.cu `fd_sm90`): bf16
# operands, float32 sums a key tile at a time in the kernels' tile order,
# softmax in base 2, and P split into bf16 hi = bf16(p) and lo =
# bf16(p - hi) for P·V. Held against the JAX kernels in interpret mode on
# the same bf16-rounded inputs widened to float32, at the gate
# `chip_smoke.py` holds the kernels to on the card.
# ---------------------------------------------------------------------------
ATTN_REL = 2e-5         # chip_smoke.py's ATTN_REL
BF16_ROUND = 2.0 ** -8  # chip_smoke.py's BF16_ROUND
LOG2E = 1.4426950408889634
MASKED = -2.0e38
SM90_BQ, SM90_BK = 128, 128  # flash_attention_sm90.cu's kBQ, kBK
DEC_WARPS = 4  # flash_decode.cu's kWarps (16 positions a warp)


def _bf16(rng, *shape):
    """randn rounded to bf16 (a torch bf16 tensor)."""
    return torch.from_numpy(rng.normal(size=shape).astype(
        np.float32)).to(torch.bfloat16)


def _pv(p, v, split_p):
    """p·v with bf16 operands and float32 sums: p as hi + lo, or hi
    alone."""
    hi = p.to(torch.bfloat16).float()
    out = torch.matmul(hi, v)
    if split_p:
        out = out + torch.matmul((p - hi).to(torch.bfloat16).float(), v)
    return out


def _emulate_prefill(q, k, v, causal, split_p=True):
    """flash_attention_sm90's arithmetic: (B, S, H, hd) bf16 -> bf16."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.float().permute(0, 2, 1, 3)  # (B, H, S, hd)
    kf, vf = (t.float().permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
              for t in (k, v))
    scale = torch.tensor(hd ** -0.5 * LOG2E, dtype=torch.float32)
    m = torch.full((B, H, S), MASKED)
    l = torch.zeros((B, H, S))
    acc = torch.zeros((B, H, S, hd))
    rows = torch.arange(S)[:, None]
    for k0 in range(0, T, SM90_BK):  # masked tiles add exactly nothing
        cols = torch.arange(k0, min(T, k0 + SM90_BK))[None, :]
        x = torch.matmul(qf, kf[:, :, k0:k0 + SM90_BK].transpose(-1, -2))
        x = x * scale
        if causal:
            x = x.masked_fill(cols > rows, MASKED)
        mx = torch.maximum(m, x.amax(-1))
        alpha = torch.exp2(m - mx)
        p = torch.exp2(x - mx[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + _pv(p, vf[:, :, k0:k0 + SM90_BK],
                                           split_p)
        m = mx
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(torch.bfloat16)


def _emulate_decode(q, k, v, length, split_p=True, sms=132):
    """fd_sm90's arithmetic: the wrapper's splits of T; in each, stages of
    64 / kh positions of a block's kh KV heads, whose 16-position
    pieces go to the head's DEC_WARPS / kh warps with their own (m, l,
    acc); the warps merged, then the splits (base 2). q: (B, H, hd),
    caches (B, T, KV, hd) bf16 -> (B, H, hd) bf16."""
    B, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    kh = heads_per_block(KV, G)
    warps = DEC_WARPS // kh  # a head's warps
    splits = num_splits(B, KV // kh, G, T, sms, group=16)
    split_len = -(-T // splits)
    n_valid = T if length <= 0 else min(length, T)
    qf = q.float().reshape(B, KV, G, hd)
    kf, vf = (t.float().permute(0, 2, 1, 3) for t in (k, v))  # (B,KV,T,hd)
    scale = torch.tensor(hd ** -0.5 * LOG2E, dtype=torch.float32)
    empty = -3.0e38
    parts = []  # per split: (m, l, acc) of shape (B, KV, G[, hd])
    for s in range(splits):
        t0, t_end = s * split_len, min((s + 1) * split_len, n_valid)
        m = torch.full((warps, B, KV, G), empty)
        l = torch.zeros((warps, B, KV, G))
        acc = torch.zeros((warps, B, KV, G, hd))
        for base in range(t0, t_end, 16 * warps):
            for w in range(warps):
                pos = base + 16 * w + torch.arange(16)
                ok = pos < t_end
                idx = torch.clamp(pos, max=T - 1)
                kt, vt = kf[:, :, idx], vf[:, :, idx]  # (B, KV, 16, hd)
                x = torch.matmul(qf, kt.transpose(-1, -2)) * scale
                if length <= 0:
                    x = torch.full_like(x, MASKED)
                x = x.masked_fill(~ok, float("-inf"))
                mx = torch.maximum(m[w], x.amax(-1))
                alpha = torch.exp2(m[w] - mx)
                p = torch.exp2(x - mx[..., None])
                l[w] = l[w] * alpha + p.sum(-1)
                acc[w] = acc[w] * alpha[..., None] + _pv(p, vt, split_p)
                m[w] = mx
        mm = m.amax(0)
        wgt = torch.exp2(m - mm)
        parts.append((mm, (l * wgt).sum(0), (acc * wgt[..., None]).sum(0)))
    mx = torch.stack([p[0] for p in parts]).amax(0)
    l = sum(p[1] * torch.exp2(p[0] - mx) for p in parts)
    acc = sum(p[2] * torch.exp2(p[0] - mx)[..., None] for p in parts)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, H, hd).to(torch.bfloat16)


def _gate_share(got, want):
    """max |got - want| / (ATTN_REL·(1+|want|) + 2^-8·|want|)."""
    got = torch.as_tensor(np.asarray(got, np.float64))
    want = torch.as_tensor(np.asarray(want, np.float64))
    allowed = ATTN_REL * (1 + want.abs()) + BF16_ROUND * want.abs()
    return float(((got - want).abs() / allowed).max())


def _jax_prefill(q, k, v, causal, geom):
    """The JAX kernel in interpret mode on the bf16 values as float32."""
    jq, jk, jv = (jnp.asarray(t.float().numpy()) for t in (q, k, v))
    return np.asarray(jax_fa(jq, jk, jv, causal=causal, block_q=geom[4],
                             block_k=geom[5], interpret=True))


@pytest.mark.parametrize("geom", FLASH_GEOMS,
                         ids=lambda g: "x".join(map(str, g)))
def test_attention_sm90_arithmetic_within_the_bf16_gate(geom):
    S, H, KV, hd, causal = geom[0], geom[1], geom[2], geom[3], geom[-1]
    rng = np.random.default_rng(11)
    q, k, v = (_bf16(rng, 2, S, n, hd) for n in (H, KV, KV))
    got = _emulate_prefill(q, k, v, causal).float().numpy()
    assert _gate_share(got, _jax_prefill(q, k, v, causal, geom)) <= 1.0


def test_attention_single_rounding_of_p_breaks_the_bf16_gate():
    """One bf16 rounding of P before P·V (what SDPA does) errs by up to
    2^-9 of each weight: rows with few keys and |o| near 0 land far past
    the gate, which the hi/lo split holds on the same inputs."""
    geom = FLASH_GEOMS[0]  # (128, 4, 4, 64), causal
    rng = np.random.default_rng(12)
    q, k, v = (_bf16(rng, 2, 128, 4, 64) for _ in range(3))
    want = _jax_prefill(q, k, v, True, geom)
    split = _gate_share(_emulate_prefill(q, k, v, True).float().numpy(),
                        want)
    single = _gate_share(_emulate_prefill(q, k, v, True, split_p=False)
                         .float().numpy(), want)
    assert split <= 1.0 < 4.0 < single, (split, single)


@pytest.mark.parametrize("geom", DECODE_GEOMS + [(2, 256, 2, 16, 128, 200,
                                                  64)],
                         ids=lambda g: "x".join(map(str, g)))
@pytest.mark.parametrize("length", ["geom", 0, 1, 64, "T"])
def test_decode_sm90_arithmetic_within_the_bf16_gate(geom, length):
    B, T, KV, G, hd = geom[:5]
    n = {"geom": geom[5], "T": T}.get(length, length)
    rng = np.random.default_rng(13)
    q = _bf16(rng, B, KV * G, hd)
    k, v = (_bf16(rng, B, T, KV, hd) for _ in range(2))
    got = _emulate_decode(q, k, v, n).float().numpy()
    jq, jk, jv = (jnp.asarray(t.float().numpy()) for t in (q, k, v))
    want = jax_fd(jq, jk, jv, n, block_t=geom[6], interpret=True)
    assert _gate_share(got, want) <= 1.0


def test_decode_sm90_splits_and_warps_merge_like_one_pass():
    """With many splits (sms=4096) and with one, the emulation agrees
    with itself to float32 rounding: the merges are exact algebra."""
    rng = np.random.default_rng(14)
    q = _bf16(rng, 1, 8, 64)
    k, v = (_bf16(rng, 1, 2048, 1, 64) for _ in range(2))
    many = _emulate_decode(q, k, v, 1500, sms=4096).float()
    one = _emulate_decode(q, k, v, 1500, sms=1).float()
    assert num_splits(1, 1, 8, 2048, 4096, group=16) > 1
    assert heads_per_block(1, 8) == 1
    torch.testing.assert_close(many, one, atol=2 ** -8, rtol=2 ** -7)


def test_decode_single_rounding_of_p_breaks_the_bf16_gate():
    """As for prefill: with 3 valid positions one rounding of P lands past
    the gate; the split holds it."""
    geom = (2, 128, 2, 8, 64, 3, 64)
    B, T, KV, G, hd = geom[:5]
    rng = np.random.default_rng(15)
    q = _bf16(rng, B, KV * G, hd)
    k, v = (_bf16(rng, B, T, KV, hd) for _ in range(2))
    jq, jk, jv = (jnp.asarray(t.float().numpy()) for t in (q, k, v))
    want = jax_fd(jq, jk, jv, 3, block_t=64, interpret=True)
    split = _gate_share(_emulate_decode(q, k, v, 3).float().numpy(), want)
    single = _gate_share(_emulate_decode(q, k, v, 3, split_p=False)
                         .float().numpy(), want)
    assert split <= 1.0 < 4.0 < single, (split, single)
