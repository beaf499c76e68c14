"""The arithmetic of the port's chunk-parallel SSD scan kernels
(`csrc/mamba_scan.cu`), emulated in torch on the CPU and held against the
JAX package's `ssd_scan` (Pallas, interpret mode) and its float64 oracle at
the gates the kernels are held to on the card.

The kernels run the scan in three passes: (i) each chunk's local state
s_k = (w ∘ x)ᵀ·B with w_s = exp(l_end − l_s)·dt_s, and its decay
exp(l_end); (ii) the states passed in chunk order, h_k = exp(l_end,k)·
h_{k−1} + s_k in float32; (iii) per chunk C·Bᵀ, M = tril(C·Bᵀ ∘
exp(l_t − l_s) ∘ dt_s) and y = M·x + exp(l_t)·C·h_{k−1}ᵀ. Every product
runs on the tensor cores with float32 sums a slice of 32 deep outside
them:
- float32 in 3xTF32: each operand split hi = a truncated to TF32 (13 low
  mantissa bits cleared), lo = a − hi truncated again by the tensor core;
  a product is lo·hi + hi·lo + hi·hi. A product of two TF32 values is
  exact in float32, so a float32 matmul of the parts is the tensor core's
  product up to the order of its sums (which it truncates; a slice's sums
  here round to nearest, a part only the card shows).
- bf16: x, B and C are exact in bf16, so C·Bᵀ is one product; M, h and
  w ∘ x are split into bf16 hi (rounded to nearest) + lo (the rest,
  rounded), two products each.

The backward's kernels (float32 only) are emulated for both routes
(`emulate_ssd_bwd`, `kernel=`). "mma" (`csrc/mamba_scan_bwd.cu`) runs every
product in 3xTF32 with its sum added in float32 a k-step of 8: D_k =
(exp(l) ∘ dy)ᵀ·C, the chunk states' gradients G passed in reverse in
float32, then per chunk Pᵀ = x·dyᵀ and B·Cᵀ (rows s), W, Qᵀ and Z formed
from them in float32 and multiplied as the next products' A operands
(split again), P = dy·xᵀ (rows t) for Q·B, and B·Gᵀ, x·G, dy·H. "sm90"
(`csrc/mamba_scan_bwd_sm90.cu`) sums as the tensor core does (`_tc`: each
k8 slice's lo·hi, hi·lo, hi·hi added to the float32 sum it carries and
cut toward zero, for TF32 `wgmma` and `mma.sync` alike): D_k folded into
float32 every DSTATES_FOLD steps of t; Pᵀ, B·Cᵀ, (H·dy)ᵀ, B·Gᵀ and (x·G)ᵀ
carried over their depth; dx = w ∘ (B·Gᵀ) then W·dy carried on from it
over t; over each group of SM90_GROUP heads Σ_h Qᵀ, w ∘ (x·G) and exp(l) ∘
(dy·H) folded in float32 a head, and Cᵀ·(Σ_h Q), Bᵀ·(Σ_h Q)ᵀ once a group
(dBᵀ, dCᵀ); the groups' partials added in float32. Its gate is the forward's form on
each of dx, ddt, dB, dC, Σ|terms| from `ssd_scan_bwd_ref(terms=True)`,
and on dA the same rel times the root-sum-square of its steps' Σ|terms|
(`dA_steps=True`); one TF32 rounding of W, or of the Q formed from P,
misses it (`*_bwd_single_*`), and so do dB and dC carried on the tensor
core through every head with no float32 fold (`fold=False`) on same-sign
inputs.

Gates (chip_smoke.py): float32 against float64, |Δ| <= (SSD_REL +
8·u32·max|l|)·Σ|terms| + 1e-6, Σ|terms| being the scan of |x|, |B|, |C|;
bf16 against the float32 scan of the same bf16 inputs, plus 2^-8·|ref|
for the rounding of the bf16 output. One rounding of M (TF32 or bf16, no
lo part) lands past the gate on the same inputs (`*_single_*`).
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan.kernel import ssd_scan as jax_ssd
from repro.kernels.mamba_scan.ref import ssd_scan_ref as jax_ssd_ref
from repro_torch.kernels.mamba_scan.ops import (SM90_HEADS_PER_BLOCK,
                                                 kernel_chunk)
from repro_torch.kernels.mamba_scan.ref import ssd_scan_bwd_ref, ssd_scan_ref

# one intra-op thread per test process: the suite runs in parallel workers
torch.set_num_threads(1)

SSD_REL = 1e-5            # chip_smoke.py's SSD_REL
U32 = 2.0 ** -24          # float32 unit roundoff
BF16_ROUND = 2.0 ** -8    # chip_smoke.py's BF16_ROUND
SLICE = 32                # mamba_scan.cu's kSlice
STEP = 8                  # mamba_scan_bwd.cu's k-step (m16n8k8)
TF32_MASK = -(1 << 13)    # 0xffffe000: clears 13 mantissa bits
# (S, nh, hd, ds, chunk): the MAMBA family, and chunk 256 (run as 128)
MAMBA_GEOMS = [(32, 2, 8, 8, 16), (64, 3, 16, 8, 16), (128, 1, 32, 16, 32),
               (256, 2, 64, 64, 256)]
# zamba2's widths and chunk at a narrow batch: a full group of heads and a
# partial one
TRAIN_LIKE = (256, 20, 64, 64, 128)
SM90_SOURCE = (Path(__file__).resolve().parent.parent / "src" / "repro_torch"
               / "csrc" / "mamba_scan_bwd_sm90.cu")
SM90_GROUP = SM90_HEADS_PER_BLOCK  # heads a unit of ssd_bwd_chunk_sm90
# ssd_bwd_dstates_sm90: k8 slices of t the tensor core carries before a
# float32 fold, read from the source
DSTATES_FOLD = 8 * int(re.search(
    r"kc \+= (\d+)\) \{  // \d+ steps of t a sum",
    SM90_SOURCE.read_text()).group(1))


def _tf32(x: torch.Tensor) -> torch.Tensor:
    return (x.contiguous().view(torch.int32) & TF32_MASK).view(torch.float32)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _parts(a, route, split):
    """(hi, lo) of an operand as the tensor core reads it; lo None when the
    operand is taken whole (exact in bf16, or rounded once)."""
    if route == "tf32":
        hi = _tf32(a)
        return hi, (_tf32(a - hi) if split else None)
    if route == "bf16":
        hi = _bf16(a)
        return hi, (_bf16(a - hi) if split else None)
    return a, None  # "exact": float64, no rounding


def _mm(a, b, route, split_a, split_b, step=SLICE):
    """a @ b on the tensor cores: per slice of `step` along K (the forward's
    32, the backward's k-step of 8) the small products first, then hi·hi,
    into sums of their own, added in float32."""
    out = None
    for k0 in range(0, a.shape[-1], step):
        a_hi, a_lo = _parts(a[..., k0:k0 + step], route, split_a)
        b_hi, b_lo = _parts(b[..., k0:k0 + step, :], route, split_b)
        part = None
        if a_lo is not None:
            part = a_lo @ b_hi
        if b_lo is not None:
            part = a_hi @ b_lo if part is None else part + a_hi @ b_lo
        full = a_hi @ b_hi
        part = full if part is None else part + full
        out = part if out is None else out + part
    return out


def _states(xc, dtc, Bcc, l, route, split_b):
    """Passes (i) and (ii): each chunk's local state s_k = (w ∘ x)ᵀ·B, w_s
    = exp(l_end − l_s)·dt_s, then the states passed in chunk order in
    float32; returns the state entering each chunk (B, NC, nh, hd, ds).
    Bcc: (B, NC, 1, c, ds)."""
    w = torch.exp(l[..., -1:] - l) * dtc
    s = _mm((xc * w[..., None]).transpose(-1, -2), Bcc, route, True,
            split_b)
    decay = torch.exp(l[..., -1])
    h = torch.zeros_like(s[:, 0])
    h_prev = torch.empty_like(s)
    for k in range(s.shape[1]):
        h_prev[:, k] = h
        h = decay[:, k, :, None, None] * h + s[:, k]
    return h_prev


def emulate_ssd(x, dt, A, Bc, Cc, chunk, route, split_m=True):
    """The kernels' three passes: x (B, S, nh, hd), dt (B, S, nh), A (nh,),
    Bc/Cc (B, S, ds) -> y (B, S, nh, hd). route "tf32" (float32 inputs),
    "bf16" (bf16 values as float32; y rounded to bf16) or "exact" (float64,
    no rounding: the decomposition's algebra alone)."""
    B, S, nh, hd = x.shape
    ds = Bc.shape[-1]
    c = kernel_chunk(min(chunk, S))
    NC = S // c
    tc = route == "tf32"  # x, B, C need a split (not exact in bf16)
    xc = x.reshape(B, NC, c, nh, hd).permute(0, 1, 3, 2, 4)
    dtc = dt.reshape(B, NC, c, nh).permute(0, 1, 3, 2)  # (B, NC, nh, c)
    Bcc = Bc.reshape(B, NC, c, ds)
    Ccc = Cc.reshape(B, NC, c, ds)
    l = torch.cumsum(dtc * A[:, None], -1)
    h_prev = _states(xc, dtc, Bcc[:, :, None], l, route, tc)
    # (iii) outputs
    CB = _mm(Ccc, Bcc.transpose(-1, -2), route, tc, tc)  # (B, NC, c, c)
    above = ~torch.tril(torch.ones((c, c), dtype=torch.bool))
    diff = (l[..., :, None] - l[..., None, :]).masked_fill(above,
                                                           float("-inf"))
    M = CB[:, :, None] * torch.exp(diff) * dtc[..., None, :]
    y = _mm(M, xc, route, split_m, tc)
    ch = _mm(Ccc[:, :, None], h_prev.transpose(-1, -2), route, tc, True)
    y = y + torch.exp(l)[..., None] * ch
    y = y.permute(0, 1, 3, 2, 4).reshape(B, S, nh, hd)
    return _bf16(y) if route == "bf16" else y


def _case(geom, seed, dt_range=(0.01, 0.3), a_range=(0.3, 2.0)):
    """float32 numpy inputs as tests/test_torch_mamba_scan.py makes them."""
    S, nh, hd, ds, _ = geom
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(2, S, nh, hd)).astype(np.float32),
            rng.uniform(*dt_range, size=(2, S, nh)).astype(np.float32),
            (-rng.uniform(*a_range, size=(nh,))).astype(np.float32),
            rng.normal(size=(2, S, ds)).astype(np.float32),
            rng.normal(size=(2, S, ds)).astype(np.float32))


def _torch(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _share(got, want, arrays, chunk, bf16_out=False):
    """max |Δ| / allowed at the card's gate (chip_smoke.py
    check_against_plain): (SSD_REL + 8·u32·max|l|)·Σ|terms| + 1e-6, plus
    2^-8·|want| for a bf16 output."""
    x, dt, A, Bc, Cc = (np.asarray(a, np.float64) for a in arrays)
    c = min(chunk, x.shape[1])
    max_l = np.abs(np.cumsum((dt * A).reshape(2, -1, c, x.shape[2]),
                             axis=2)).max()
    mags = ssd_scan_ref(*_torch((np.abs(x), dt, A, np.abs(Bc), np.abs(Cc)),
                                torch.float64), chunk=chunk).numpy()
    want = np.asarray(want, np.float64)
    allowed = (SSD_REL + 8 * U32 * max_l) * mags + 1e-6
    if bf16_out:
        allowed = allowed + BF16_ROUND * np.abs(want)
    got = np.asarray(got, np.float64)
    assert np.isfinite(got).all() and got.shape == want.shape
    return float((np.abs(got - want) / allowed).max())


def _jax_interpret(arrays, chunk):
    return np.asarray(jax_ssd(*(jnp.asarray(a) for a in arrays), chunk=chunk,
                              interpret=True))


@pytest.mark.parametrize("geom", MAMBA_GEOMS,
                         ids=lambda g: "x".join(map(str, g)))
def test_ssd_decomposition_is_the_scan(geom):
    """Without rounding (float64), the three passes give the port's
    float64 scan (held to the JAX oracle in tests/test_torch_mamba_scan.py)
    to float64 rounding: the decomposition is exact algebra."""
    arrays = _torch(_case(geom, seed=20), torch.float64)
    got = emulate_ssd(*arrays, geom[-1], "exact")
    want = ssd_scan_ref(*arrays, chunk=geom[-1])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("want", ["float64", "interpret"])
@pytest.mark.parametrize("geom", MAMBA_GEOMS,
                         ids=lambda g: "x".join(map(str, g)))
def test_ssd_3xtf32_within_the_float32_gate(geom, want):
    arrays = _case(geom, seed=21)
    chunk = geom[-1]
    got = emulate_ssd(*_torch(arrays), chunk, "tf32").numpy()
    ref = (np.asarray(jax_ssd_ref(*arrays)) if want == "float64"
           else _jax_interpret(arrays, chunk))
    assert _share(got, ref, arrays, chunk) <= 1.0


def test_ssd_3xtf32_large_decay_is_finite_and_within_the_gate():
    """|dt·A| up to 125 (chip_smoke.py's case): exp(l_t − l_s) for s > t
    would be inf in float32; the emulation, like the kernels, forms the
    decay only for s <= t."""
    geom = (64, 3, 16, 8, 16)
    arrays = _case(geom, seed=22, dt_range=(1.0, 5.0), a_range=(5.0, 25.0))
    got = emulate_ssd(*_torch(arrays), 16, "tf32").numpy()
    assert _share(got, jax_ssd_ref(*arrays), arrays, 16) <= 1.0


def _bf16_case(geom, seed):
    """float32 inputs with x, B and C rounded to bf16 values."""
    x, dt, A, Bc, Cc = _case(geom, seed)
    r = [_bf16(torch.from_numpy(a)).numpy() for a in (x, Bc, Cc)]
    return r[0], dt, A, r[1], r[2]


@pytest.mark.parametrize("geom", MAMBA_GEOMS,
                         ids=lambda g: "x".join(map(str, g)))
def test_ssd_bf16_within_the_bf16_gate(geom):
    """Against the JAX kernel in interpret mode run in float32 on the same
    bf16 values (chip_smoke.py's bf16 gate: the float32 scan of the same
    inputs, plus the output's rounding)."""
    arrays = _bf16_case(geom, seed=23)
    chunk = geom[-1]
    got = emulate_ssd(*_torch(arrays), chunk, "bf16").numpy()
    assert _share(got, _jax_interpret(arrays, chunk), arrays, chunk,
                  bf16_out=True) <= 1.0


def test_ssd_single_tf32_rounding_of_m_breaks_the_float32_gate():
    """M truncated to TF32 once (no lo part; x still split) errs by up to
    2^-10 of each weight: far past the float32 gate, which the split
    holds on the same inputs."""
    geom = MAMBA_GEOMS[2]
    arrays = _case(geom, seed=24)
    want = jax_ssd_ref(*arrays)
    split = _share(emulate_ssd(*_torch(arrays), 32, "tf32").numpy(), want,
                   arrays, 32)
    single = _share(emulate_ssd(*_torch(arrays), 32, "tf32",
                                split_m=False).numpy(), want, arrays, 32)
    assert split <= 1.0 < 4.0 < single, (split, single)


def test_ssd_single_bf16_rounding_of_m_breaks_the_bf16_gate():
    """M rounded to bf16 once (no lo part) errs by up to 2^-9 of each
    weight: outputs whose terms cancel land past the bf16 gate, which the
    hi/lo split holds on the same inputs."""
    geom = MAMBA_GEOMS[2]
    arrays = _bf16_case(geom, seed=25)
    want = _jax_interpret(arrays, 32)
    split = _share(emulate_ssd(*_torch(arrays), 32, "bf16").numpy(), want,
                   arrays, 32, bf16_out=True)
    single = _share(emulate_ssd(*_torch(arrays), 32, "bf16",
                                split_m=False).numpy(), want, arrays, 32,
                    bf16_out=True)
    assert split <= 1.0 < single, (split, single)


def _decay_t(l, c):
    """E[..., t, s] = exp(l_t − l_s) for s <= t, else 0."""
    above = ~torch.tril(torch.ones((c, c), dtype=torch.bool))
    return torch.exp((l[..., :, None] - l[..., None, :]).masked_fill(
        above, float("-inf")))


def _cut(v: torch.Tensor) -> torch.Tensor:
    """float64 cut toward zero to float32's 24 significant bits (the low 29
    of its 52 mantissa bits cleared), kept in float64."""
    return (v.contiguous().view(torch.int64) & -(1 << 29)).view(
        torch.float64)


def _tc(a, b, acc=None, split_a=True, split_b=True, exact=False):
    """acc + a (..., M, K) · b (..., K, N) as the tensor core sums it, TF32
    `wgmma` and `mma.sync` alike: per k8 slice lo·hi, hi·lo, then hi·hi
    (hi = the operand truncated to TF32, lo = the rest truncated: what the
    tensor core reads of each), each slice's 8 exact products added to the
    float32 sum it carries and cut toward zero; `split_a` / `split_b`
    False: that operand's hi alone. `exact`: float64, no rounding."""
    if exact:
        out = a @ b
        return out if acc is None else acc + out
    shape = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2]) + (
        a.shape[-2], b.shape[-1])
    out = torch.zeros(shape, dtype=torch.float64) if acc is None else \
        acc.double().expand(shape).clone()
    for k0 in range(0, a.shape[-1], STEP):
        u, w = a[..., k0:k0 + STEP].float(), b[..., k0:k0 + STEP, :].float()
        uh, wh = _tf32(u), _tf32(w)
        parts = ([(_tf32(u - uh), wh)] if split_a else []) + \
            ([(uh, _tf32(w - wh))] if split_b else []) + [(uh, wh)]
        for p, q in parts:
            out = _cut(out + p.double() @ q.double())
    return out.float()


def _emulate_bwd_sm90(x, dt, A, Bc, Cc, dy, dh, chunk, exact, split_w,
                      split_q, fold):
    """`emulate_ssd_bwd(kernel="sm90")`: csrc/mamba_scan_bwd_sm90.cu's sums
    (the module docstring). Rows and columns past a chunk are zeros there,
    which leave a truncated sum as it is, so the products run over the
    chunk's c steps here."""
    B, S, nh, hd = x.shape
    ds = Bc.shape[-1]
    c = kernel_chunk(min(chunk, S))
    NC = S // c
    route = "exact" if exact else "tf32"

    def tc(a, b, acc=None, split_a=True, split_b=True):
        return _tc(a, b, acc, split_a, split_b, exact)
    xc = x.reshape(B, NC, c, nh, hd).permute(0, 1, 3, 2, 4)
    dyc = dy.reshape(B, NC, c, nh, hd).permute(0, 1, 3, 2, 4)
    dtc = dt.reshape(B, NC, c, nh).permute(0, 1, 3, 2)  # (B, NC, nh, c)
    Bcc = Bc.reshape(B, NC, c, ds)
    Ccc = Cc.reshape(B, NC, c, ds)
    l = torch.cumsum(dtc * A[:, None], -1)
    L = l[..., -1]
    H = _states(xc, dtc, Bcc[:, :, None], l, route, True)
    el = torch.exp(l)
    # (i) D_k on wgmma, folded into float32 every DSTATES_FOLD steps of t
    ad = (dyc * el[..., None]).transpose(-1, -2)  # (B, NC, nh, hd, c)
    D = None
    for t0 in range(0, c, DSTATES_FOLD):
        part = tc(ad[..., t0:t0 + DSTATES_FOLD],
                  Ccc[:, :, None, t0:t0 + DSTATES_FOLD])
        D = part if D is None else D + part
    # (ii) G in reverse, float32
    G = torch.empty_like(D)
    g = torch.zeros_like(D[:, 0]) if dh is None else dh.clone()
    for k in reversed(range(NC)):
        G[:, k] = g
        g = torch.exp(L[:, k])[..., None, None] * g + D[:, k]
    # (iii) per head, then per group of heads
    E = _decay_t(l, c).transpose(-1, -2)  # [s][t]
    dts = dtc[..., :, None]  # dt_s, by row s
    BCT = tc(Bcc, Ccc.transpose(-1, -2))[:, :, None]  # [s][t], once a unit
    PT = tc(xc, dyc.transpose(-1, -2))
    QT = PT * E * dts
    W = BCT * E * dts
    Z = PT * BCT * E
    w_end = torch.exp(L[..., None] - l)
    w = w_end * dtc
    dyH = tc(H.transpose(-1, -2), dyc.transpose(-1, -2)).transpose(-1, -2)
    BG = tc(Bcc[:, :, None], G.transpose(-1, -2))  # [s][p]
    xgb = (xc * BG).sum(-1)
    dx = tc(W, dyc, acc=w[..., None] * BG, split_a=split_w)
    XG = tc(G.transpose(-1, -2), xc.transpose(-1, -2)).transpose(-1, -2)
    dB = dC = None
    # fold=False: one sum carried through every head (the whole depth)
    for h0 in range(0, nh, SM90_GROUP if fold else nh):
        heads = range(h0, min(nh, h0 + (SM90_GROUP if fold else nh)))
        if fold:
            qs = dbst = dcst = 0
            for h in heads:
                qs = qs + QT[:, :, h]
                dbst = dbst + w[:, :, h, :, None] * XG[:, :, h]
                dcst = dcst + el[:, :, h, :, None] * dyH[:, :, h]
            db = tc(Ccc.transpose(-1, -2), qs.transpose(-1, -2),
                    split_b=split_q).transpose(-1, -2) + dbst
            dc = tc(Bcc.transpose(-1, -2), qs,
                    split_b=split_q).transpose(-1, -2) + dcst
        else:  # the control: carried through the heads, no float32 fold
            db = dct = None
            for h in heads:
                db = tc(QT[:, :, h], Ccc, acc=db)
                db = tc(w[:, :, h, :, None] * xc[:, :, h], G[:, :, h], acc=db)
                dct = tc(Bcc.transpose(-1, -2), QT[:, :, h], acc=dct)
                dct = tc(H[:, :, h].transpose(-1, -2),
                         (dyc[:, :, h] * el[:, :, h, :, None]).transpose(
                             -1, -2), acc=dct)
            dc = dct.transpose(-1, -2)
        dB = db if dB is None else dB + db
        dC = dc if dC is None else dC + dc
    colz = Z.sum(-1)
    R = w * xgb
    dl = ((Z * dts).sum(-2) - dtc * colz
          + el * (dyH * Ccc[:, :, None]).sum(-1) - R)
    tail = R.sum(-1) + torch.exp(L) * (G * H).sum((-1, -2))
    suffix = torch.flip(torch.cumsum(torch.flip(dl, (-1,)), -1), (-1,)) \
        + tail[..., None]
    ddt = colz + w_end * xgb + A[:, None] * suffix
    dA = (dtc * suffix).sum((0, 1, 3))
    return (dx.permute(0, 1, 3, 2, 4).reshape(B, S, nh, hd),
            ddt.permute(0, 1, 3, 2).reshape(B, S, nh), dA,
            dB.reshape(B, S, ds), dC.reshape(B, S, ds))


def emulate_ssd_bwd(x, dt, A, Bc, Cc, dy, dh, chunk, route="tf32",
                    split_w=True, split_q=True, kernel="mma", fold=True):
    """The backward kernels' passes: (dx, ddt, dA, dB, dC) from float32
    inputs (route "tf32") or float64 ones ("exact": the decomposition's
    algebra alone), as `kernel` "mma" (csrc/mamba_scan_bwd.cu) or "sm90"
    (csrc/mamba_scan_bwd_sm90.cu) sums them. H, the state entering each
    chunk, is the forward kernels' (`emulate_ssd`'s passes (i)-(ii)).
    `split_w` / `split_q` False: W / Q taken as one TF32 rounding (no lo
    part). `fold` ("sm90"): False carries dB and dC on the tensor core
    through every head, with no float32 fold (the control)."""
    if kernel == "sm90":
        return _emulate_bwd_sm90(x, dt, A, Bc, Cc, dy, dh, chunk,
                                 route == "exact", split_w, split_q, fold)
    B, S, nh, hd = x.shape
    ds = Bc.shape[-1]
    c = kernel_chunk(min(chunk, S))
    NC = S // c

    def mm(a, b, split_a=True):
        return _mm(a, b, route, split_a, True, STEP)
    xc = x.reshape(B, NC, c, nh, hd).permute(0, 1, 3, 2, 4)
    dyc = dy.reshape(B, NC, c, nh, hd).permute(0, 1, 3, 2, 4)
    dtc = dt.reshape(B, NC, c, nh).permute(0, 1, 3, 2)  # (B, NC, nh, c)
    Bcc = Bc.reshape(B, NC, c, 1, ds).transpose(2, 3)  # (B, NC, 1, c, ds)
    Ccc = Cc.reshape(B, NC, c, 1, ds).transpose(2, 3)
    l = torch.cumsum(dtc * A[:, None], -1)
    L = l[..., -1]
    H = _states(xc, dtc, Bcc, l, route, True)  # the forward kernels'
    w_end = torch.exp(L[..., None] - l)
    # (i) D_k, (ii) G in reverse
    el = torch.exp(l)
    D = mm((dyc * el[..., None]).transpose(-1, -2), Ccc)
    G = torch.empty_like(D)
    g = torch.zeros_like(D[:, 0]) if dh is None else dh.clone()
    for k in reversed(range(NC)):
        G[:, k] = g
        g = torch.exp(L[:, k])[..., None, None] * g + D[:, k]
    # (iii) rows s: Pᵀ, B·Cᵀ, then W, Qᵀ, Z; rows t: P, then Q
    E_ts = _decay_t(l, c)
    E_st = E_ts.transpose(-1, -2)
    PT = mm(xc, dyc.transpose(-1, -2))
    CBT = mm(Bcc, Ccc.transpose(-1, -2))
    W = CBT * E_st * dtc[..., :, None]
    QT = PT * E_st * dtc[..., :, None]
    Z = PT * CBT * E_st  # [s][t]
    P = mm(dyc, xc.transpose(-1, -2))
    Q = P * E_ts * dtc[..., None, :]
    w = w_end * dtc
    XG, dyH = mm(xc, G), mm(dyc, H)
    dx = mm(W, dyc, split_w) + w[..., None] * mm(Bcc, G.transpose(-1, -2))
    dB = (mm(QT, Ccc, split_q) + w[..., None] * XG).sum(2)
    dC = (mm(Q, Bcc, split_q) + el[..., None] * dyH).sum(2)
    colz = Z.sum(-1)
    xgb = (XG * Bcc).sum(-1)
    R = w * xgb
    dl = ((Z * dtc[..., :, None]).sum(-2) - dtc * colz
          + el * (dyH * Ccc).sum(-1) - R)
    tail = R.sum(-1) + torch.exp(L) * (G * H).sum((-1, -2))
    suffix = torch.flip(torch.cumsum(torch.flip(dl, (-1,)), -1), (-1,)) \
        + tail[..., None]
    ddt = colz + w_end * xgb + A[:, None] * suffix
    dA = (dtc * suffix).sum((0, 1, 3))
    return (dx.permute(0, 1, 3, 2, 4).reshape(B, S, nh, hd),
            ddt.permute(0, 1, 3, 2).reshape(B, S, nh), dA,
            dB.reshape(B, S, ds), dC.reshape(B, S, ds))


def _bwd_case(geom, seed, **kw):
    """`_case`'s inputs with dy and dh_final, float32."""
    S, nh, hd, ds, _ = geom
    rng = np.random.default_rng(seed + 1000)
    return (*_case(geom, seed, **kw),
            rng.normal(size=(2, S, nh, hd)).astype(np.float32),
            rng.normal(size=(2, nh, hd, ds)).astype(np.float32))


def _bwd_shares(got, arrays, chunk):
    """Each output's max |Δ| / allowed at chip_smoke.py's scan-backward
    gate: (SSD_REL + 8·u32·max|l|)·Σ|terms| + 1e-6, float64 reference;
    dA's with the root-sum-square of its steps' Σ|terms|."""
    t = _torch(arrays, torch.float64)
    x, dt, A = arrays[:3]
    c = min(chunk, x.shape[1])
    max_l = np.abs(np.cumsum((np.float64(dt) * A).reshape(
        2, -1, c, x.shape[2]), axis=2)).max()
    want = ssd_scan_bwd_ref(*t, chunk=chunk)
    mags = list(ssd_scan_bwd_ref(*t, chunk=chunk, terms=True,
                                 dA_steps=True))
    mags[2] = mags[2].square().sum((0, 1, 3)).sqrt()
    out = []
    for g, w, m in zip(got, want, mags):
        assert bool(torch.isfinite(g).all()) and g.shape == w.shape
        allowed = (SSD_REL + 8 * U32 * max_l) * m + 1e-6
        out.append(float(((g.double() - w).abs() / allowed).max()))
    return out


BWD_KERNELS = ["mma", "sm90"]


@pytest.mark.parametrize("kernel", BWD_KERNELS)
@pytest.mark.parametrize("geom", MAMBA_GEOMS,
                         ids=lambda g: "x".join(map(str, g)))
def test_ssd_bwd_decomposition_is_the_reverse_pass(geom, kernel):
    """Without rounding (float64) the kernels' passes give
    `ssd_scan_bwd_ref` (held to autograd in
    tests/test_torch_mamba_scan_bwd.py) to float64 rounding."""
    arrays = _torch(_bwd_case(geom, seed=30), torch.float64)
    got = emulate_ssd_bwd(*arrays, geom[-1], "exact", kernel=kernel)
    want = ssd_scan_bwd_ref(*arrays, chunk=geom[-1])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-9,
                                   atol=1e-9 * float(w.abs().max()))


@pytest.mark.parametrize("kernel", BWD_KERNELS)
@pytest.mark.parametrize("geom", MAMBA_GEOMS + [TRAIN_LIKE],
                         ids=lambda g: "x".join(map(str, g)))
def test_ssd_bwd_3xtf32_within_the_float32_gate(geom, kernel):
    arrays = _bwd_case(geom, seed=31)
    got = emulate_ssd_bwd(*_torch(arrays), geom[-1], kernel=kernel)
    assert max(_bwd_shares(got, arrays, geom[-1])) <= 1.0


@pytest.mark.parametrize("kernel", BWD_KERNELS)
def test_ssd_bwd_3xtf32_underflowing_decays_within_the_gate(kernel):
    geom = (64, 3, 16, 8, 16)
    arrays = _bwd_case(geom, seed=32, dt_range=(1.0, 5.0),
                       a_range=(5.0, 25.0))
    got = emulate_ssd_bwd(*_torch(arrays), 16, kernel=kernel)
    assert max(_bwd_shares(got, arrays, 16)) <= 1.0


@pytest.mark.parametrize("kernel", BWD_KERNELS)
@pytest.mark.parametrize("fault,outputs", [("w", (0,)), ("q", (3, 4))],
                         ids=["W", "Q"])
def test_ssd_bwd_single_tf32_rounding_breaks_the_gate(fault, outputs,
                                                       kernel):
    """W (into dx), or Q formed from P (into dB and dC), truncated to TF32
    once (no lo part): up to 2^-10 of each term, far past the gate, which
    the split holds on the same inputs."""
    geom = MAMBA_GEOMS[2]
    arrays = _bwd_case(geom, seed=33)
    split = _bwd_shares(emulate_ssd_bwd(*_torch(arrays), 32, kernel=kernel),
                        arrays, 32)
    single = _bwd_shares(emulate_ssd_bwd(
        *_torch(arrays), 32, split_w=fault != "w", split_q=fault != "q",
        kernel=kernel), arrays, 32)
    assert max(split) <= 1.0
    assert all(single[i] > 4.0 for i in outputs), (split, single)


def test_ssd_bwd_sm90_heads_carried_on_the_tensor_core_miss_the_gate():
    """The control for ssd_bwd_chunk_sm90's float32 folds: dB and dC
    carried on the tensor core through all 32 heads (the whole depth: each
    head's Qᵀ·C, (w ∘ x)·G, Bᵀ·Qᵀ, Hᵀ·(exp(l) ∘ dy)ᵀ truncated onto one
    sum, no group partials), on same-sign x, dy, B, C with slow decays
    (max|l| ~0.3: the gate near SSD_REL), land past the gate that the
    kernel's sums — Σ_h Q and the heads' state terms folded in float32, one
    product a group of 16 — keep on the same inputs."""
    geom = (256, 2 * SM90_GROUP, 64, 64, 128)
    x, dt, A, Bc, Cc, dy, dh = _bwd_case(geom, seed=34,
                                         dt_range=(0.001, 0.01),
                                         a_range=(0.3, 0.5))
    arrays = (np.abs(x), dt, A, np.abs(Bc), np.abs(Cc), np.abs(dy),
              np.abs(dh))
    kept = _bwd_shares(emulate_ssd_bwd(*_torch(arrays), 128, kernel="sm90"),
                       arrays, 128)
    carried = _bwd_shares(emulate_ssd_bwd(*_torch(arrays), 128,
                                          kernel="sm90", fold=False),
                          arrays, 128)
    assert max(kept) <= 1.0 and min(carried[3], carried[4]) > 2.0, (
        kept, carried)
