"""B5's backward in the port (`kernels/flash_attention`: `attention_bwd_ref`
and the autograd seam of `attention`) held against the JAX package's flash
backward, the custom VJP `_flash_xla` (`repro.models.attention`: its rule
`_flash_bwd_rule`), on the same seeded numpy inputs in one process.

On the CPU `attention` runs its plain versions forward and backward (the
CUDA kernels are held against those by chip_smoke.py's phase 2 and by
tests/test_torch_cuda_kernels.py, which skip without a card).

- `attention_bwd_ref`, and `attention` under `torch.autograd.grad`, against
  `jax.vjp` of `flash_attention_xla` (chunk 16, S 64, GQA 1 and 4, hd 32 and
  64, causal: the JAX rule is causal) in float32 and float64. The gate is
  the card's: REL·(|ref| + Σ|terms|) for each of dq, dk, dv, Σ|terms| the
  plain version's magnitudes (`terms="products"`), REL = 2e-5 in float32
  (ATTN_BWD_REL: float32 sums in other orders) and 1e-6 in float64: JAX's
  rule rounds hd^-0.5 to float32 even in float64 (`jnp.sqrt(hd).astype(
  float32)`), which moves its scores by up to 2^-24 of themselves (|s| up
  to ~10 here) where the port scales by the float64 hd^-0.5.
- The bf16 kernels' arithmetic (`csrc/flash_attention_bwd_sm90.cu`),
  emulated in torch (`_emulate_bwd_bf16`: bf16 operands, S and dP summed
  as `wgmma` sums (a k16 step's exact products added and cut toward zero),
  P and dS rounded to bf16 once before their products, dk, dv and dq
  carried on the tensor core through each kernel's whole walk, outputs
  rounded to bf16), against JAX's
  `_flash_bwd_rule` run in float32 on the same bf16 values (same out, m
  and l) at phase 2's bf16 gate, 2^-8·|ref| + 2^-7·Σ|terms| with |dS| as
  P ⊙ (|dP| + |D|) (`terms="values"`); each planted fault (a zeroed dk
  tile, D left out of dS, the diagonal masked, dk without its hd^-0.5, dk
  without one middle query tile of one head or without one query head)
  must miss that gate, at GQA 8 and S = 1,024 too.
- The float32 kernels' arithmetic (`csrc/flash_attention_bwd_tf32_sm90.cu`),
  emulated in torch (`_emulate_bwd_tf32`: every product 3xTF32 as TF32
  `wgmma`s sum it — per k8 slice lo·hi, hi·lo and hi·hi, each added to the
  float32 sum and cut toward zero, TF32 by `test_torch_tf32._tf32`'s bit
  truncation; S and dP over hd; dk / dv a step of 64 rows and dq a key
  tile into sums of their own, folded in float32, dq's tiles alternating
  between two sums; the tile sizes read from the source), against JAX's
  `_flash_bwd_rule` in float32 (`jax.vjp` of `_sdpa` without a mask where
  not causal) at the float32 gate, 2e-5·(|ref| + Σ|terms|) with
  terms="products", at hd 32 / 64 / 128, GQA 1 / 4 / 8, causal and not,
  ragged S; the six planted faults (the diagonal one under `causal`) miss
  it, and so do two controls: one TF32 rounding of each operand, and dk /
  dv carried on the tensor core through a walk of 8 heads × 1,024 rows
  with no float32 fold (same-sign dv terms).
- `attention` keeps nothing for the backward where no input requires grad
  or grad mode is off (serving), and its plain forward's lse against
  JAX's m + log l.
"""
import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models import attention as jattn
from repro_torch import kernels
from repro_torch.kernels import attention
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_ref)
from test_torch_tf32 import _tf32

# one intra-op thread per test process: the suite runs in parallel workers
torch.set_num_threads(1)

ATTN_BWD_REL = 2e-5
F64_REL = 1e-6
BF16_GATE = (2.0 ** -8, 2.0 ** -7)  # on |ref|, on Σ|terms|
CHUNK = 16
# (B, S, H, KV, hd): GQA 1 and 4 at hd 32 and 64
GEOMS = [(2, 64, 4, 4, 32), (2, 64, 8, 2, 32), (1, 64, 4, 4, 64),
         (2, 64, 8, 2, 64)]


@pytest.fixture(autouse=True)
def no_kernel_launch():
    kernels.reset_launches()
    yield
    assert kernels.launches() == {k: 0 for k in kernels.KERNELS}


def _case(B, S, H, KV, hd, seed=0):
    rng = np.random.default_rng(seed)
    q, dout = (rng.normal(size=(B, S, H, hd)) for _ in range(2))
    k, v = (rng.normal(size=(B, S, KV, hd)) for _ in range(2))
    return q, k, v, dout


def _jax_cfg(H, KV):
    return dataclasses.replace(jax_reduced("tinyllama-1.1b"), n_heads=H,
                               n_kv_heads=KV, attn_logit_softcap=None)


def _jax_vjp(q, k, v, dout, H, KV):
    """(out, (dq, dk, dv)) of JAX's flash attention at chunk CHUNK."""
    cfg = _jax_cfg(H, KV)
    out, f = jax.vjp(lambda a, b, c: jattn.flash_attention_xla(
        a, b, c, cfg, chunk=CHUNK), q, k, v)
    return out, f(dout)


def _gate(got, want, mags, rel, names=("dq", "dk", "dv")) -> float:
    """Each of got within rel·(|want| + mags), or a·|want| + b·mags for
    rel = (a, b); returns the worst share."""
    a, b = rel if isinstance(rel, tuple) else (rel, rel)
    worst = 0.0
    for name, g, w, m in zip(names, got, want, mags):
        g = torch.as_tensor(np.asarray(g, np.float64)) \
            if not isinstance(g, torch.Tensor) else g.double()
        w = torch.as_tensor(np.asarray(w, np.float64)) \
            if not isinstance(w, torch.Tensor) else w.double()
        assert g.shape == w.shape, name
        allowed = a * w.abs() + b * m.double()
        share = float(((g - w).abs() / allowed.clamp(min=1e-300)).max())
        assert share <= 1.0, (name, share)
        worst = max(worst, share)
    return worst


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("geom", GEOMS, ids=lambda g: "x".join(map(str, g)))
def test_bwd_ref_and_autograd_match_jax(geom, dtype):
    B, S, H, KV, hd = geom
    q, k, v, dout = (a.astype(dtype) for a in _case(*geom))
    with jax.enable_x64(dtype == "float64"):
        jout, jgrads = _jax_vjp(*(jnp.asarray(a) for a in (q, k, v, dout)),
                                H, KV)
        jout = np.asarray(jout)
        jgrads = [np.asarray(g) for g in jgrads]
    assert jgrads[0].dtype == np.dtype(dtype)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, dout))
    out, lse = attention_ref(tq, tk, tv, causal=True, return_lse=True)
    rel = ATTN_BWD_REL if dtype == "float32" else F64_REL
    np.testing.assert_allclose(out.numpy(), jout, rtol=rel, atol=rel)
    grads, mags = attention_bwd_ref(tq, tk, tv, out, lse, tdo, causal=True,
                                    terms="products")
    assert all(g.dtype == getattr(torch, dtype) for g in grads)
    _gate(grads, jgrads, mags, rel)
    # the port's entry point under autograd: the same backward
    tq, tk, tv = (t.clone().requires_grad_() for t in (tq, tk, tv))
    y = attention(tq, tk, tv, causal=True)
    assert y.grad_fn is not None
    auto = torch.autograd.grad(y, (tq, tk, tv), tdo)
    _gate(auto, jgrads, mags, rel)


def test_lse_matches_jax_max_and_sum():
    B, S, H, KV, hd = 2, 64, 8, 2, 32
    q, k, v, _ = (a.astype(np.float32) for a in _case(B, S, H, KV, hd, 1))
    q5 = jnp.asarray(q).reshape(B, S, KV, H // KV, hd)
    _, m, l = jattn._flash_fwd_scan(q5, jnp.asarray(k), jnp.asarray(v), 0.0,
                                    CHUNK)
    # (B, KV, G, S) -> (B, H, S)
    want = np.asarray(m + jnp.log(l)).reshape(B, H, S)
    _, lse = attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                           causal=True, return_lse=True)
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-6, atol=1e-5)


def test_serving_keeps_nothing_for_a_backward():
    q, k, v, _ = (torch.from_numpy(a.astype(np.float32))
                  for a in _case(1, 64, 4, 2, 32, 2))
    assert attention(q, k, v).grad_fn is None  # no input requires grad
    q.requires_grad_()
    with torch.no_grad():
        assert attention(q, k, v).grad_fn is None
    y = attention(q, k, v)
    assert type(y.grad_fn).__name__ == "_AttentionBackward"
    assert torch.equal(y, attention(q.detach(), k, v))


# ---------------------------------------------------------------------------
# the bf16 kernel's arithmetic against JAX's rule
# ---------------------------------------------------------------------------
SOURCE = (Path(__file__).resolve().parent.parent / "src" / "repro_torch"
          / "csrc" / "flash_attention_bwd_sm90.cu")


def _constant(name: str) -> tuple:
    """A `constexpr int` of the bf16 backward's source: (its value at hd 32
    and 64, at hd 128), from `N` or `HD <= 64 ? N : M`."""
    m = re.search(rf"constexpr int {name} =(?: HD <= 64 \?)? (\d+)"
                  rf"(?: : (\d+))?;", SOURCE.read_text())
    assert m, f"{name} not found in {SOURCE.name}"
    return int(m.group(1)), int(m.group(2) or m.group(1))


K_STEP = 16                     # rows (or keys) a wgmma k16 step adds
KEY_BLOCK = _constant("kKeys")  # fa_bwd_dkdv_sm90: keys a block
Q_STEP = _constant("kRows")     # fa_bwd_dkdv_sm90: query rows a step
KEY_TILE = _constant("kKT")     # fa_bwd_dq_sm90: keys a step


def _bf16(t):
    return t.to(torch.bfloat16).to(torch.float32)


def _trunc32(v: torch.Tensor) -> torch.Tensor:
    """float64 -> float32, rounded toward zero (the tensor core's sum)."""
    f = v.to(torch.float32)
    over = f.double().abs() > v.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def _tc_matmul(a, b):
    """a (..., M, K) · b (..., K, N) as `wgmma` sums it: per k16 step the
    16 exact products of bf16 values added to the float32 sum it carries,
    cut toward zero."""
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for i in range(0, a.shape[-1], K_STEP):
        acc = _trunc32(acc.double() + a[..., i:i + K_STEP].double()
                       @ b[..., i:i + K_STEP, :].double())
    return acc


def _score_products(q, k, v, dout):
    """S (scaled) and dP of the emulation, (B, H, S, T) each, as `wgmma`
    sums them over hd: the part of `_emulate_bwd_bf16` no fault touches."""
    G = q.shape[2] // k.shape[2]
    qh, doh = (t.permute(0, 2, 1, 3) for t in (q, dout))
    kh, vh = (t.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
              for t in (k, v))
    return (_tc_matmul(qh, kh.transpose(-1, -2)) * q.shape[3] ** -0.5,
            _tc_matmul(doh, vh.transpose(-1, -2)))


def _emulate_bwd_bf16(q, k, v, out, lse, dout, fault=None, products=None):
    """flash_attention_bwd_sm90.cu's arithmetic on float32 tensors holding
    bf16 values (causal, S == T): D = rowsum(dO ⊙ O) in float32; S and dP
    as `wgmma` sums them over hd (`_tc_matmul`); P = exp(s − lse) and dS =
    P ⊙ (dP − D) in float32, each rounded to bf16 once; dv += Pᵀ · dO and
    dk += dSᵀ · q carried on the tensor core through the whole walk of
    fa_bwd_dkdv_sm90 — the G query heads of a KV head in order, each head's
    rows from its first query tile on, 16 rows a step — and dq += dS · k
    through fa_bwd_dq_sm90's walk over the keys, 16 a step. Rows a walk
    skips, or whose P is masked, add exact zeros (which leave a truncated
    sum as it is), so the walks run over every row and key here; the tile
    sizes (KEY_BLOCK, Q_STEP, KEY_TILE) set what is skipped, not the
    order. dk and dq times hd^-0.5, then all three rounded to bf16.
    `fault` plants one error: "zero_tile" (dk of keys 64-127 zeroed),
    "no_D" (dS = P ⊙ dPᵀ), "diagonal" (a key's own row masked), "dk_scale"
    (dk without hd^-0.5), "query_tile" (dk without query head 3's rows S/2
    to S/2 + 63), "query_head" (dk without the last query head).
    `products`: `_score_products` of the same inputs, where already known."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    qh, doh, oh = (t.permute(0, 2, 1, 3) for t in (q, dout, out))  # (B,H,S,hd)
    kh, vh = (t.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
              for t in (k, v))
    D = (doh * oh).sum(-1)  # (B, H, S)
    if fault == "no_D":
        D = torch.zeros_like(D)
    rows = torch.arange(S)
    s, dp = products or _score_products(q, k, v, dout)  # (B, H, S, T)
    p = torch.exp(s - lse[..., None])
    masked = rows[None, :] >= rows[:, None] if fault == "diagonal" \
        else rows[None, :] > rows[:, None]
    p = p.masked_fill(masked, 0.0)
    ds = p * (dp - D[..., None])
    pb, dsb = _bf16(p), _bf16(ds)
    dsk = dsb.clone() if fault in ("query_tile", "query_head") else dsb
    if fault == "query_tile":
        dsk[:, 3, S // 2:S // 2 + 64] = 0
    elif fault == "query_head":
        dsk[:, H - 1] = 0
    # dk, dv: (B, KV, T, hd) carried over the G heads, then the rows
    pT = pb.reshape(B, KV, G, S, S).transpose(-1, -2)
    dsT = dsk.reshape(B, KV, G, S, S).transpose(-1, -2)
    q5, do5 = (t.reshape(B, KV, G, S, hd) for t in (qh, doh))
    dk = torch.zeros((B, KV, S, hd))
    dv = torch.zeros((B, KV, S, hd))
    for g in range(G):
        for r in range(0, S, K_STEP):
            dv = _trunc32(dv.double() + pT[:, :, g, :, r:r + K_STEP].double()
                          @ do5[:, :, g, r:r + K_STEP].double())
            dk = _trunc32(dk.double() + dsT[:, :, g, :, r:r + K_STEP].double()
                          @ q5[:, :, g, r:r + K_STEP].double())
    dq = _tc_matmul(dsb, kh)  # the keys in order, 16 a step
    dk = dk * (1.0 if fault == "dk_scale" else scale)
    if fault == "zero_tile":
        dk[:, :, 64:128] = 0
    return (_bf16(dq * scale).permute(0, 2, 1, 3),
            _bf16(dk).permute(0, 2, 1, 3), _bf16(dv).permute(0, 2, 1, 3))


def _bf16_case(B, S, H, KV, hd, seed):
    """bf16 values (float32 arrays), JAX's forward on them (out rounded to
    bf16, m, l) and JAX's rule on the same values, in float32."""
    q, k, v, dout = (_bf16(torch.from_numpy(a.astype(np.float32))).numpy()
                     for a in _case(B, S, H, KV, hd, seed))
    G = H // KV
    q5 = jnp.asarray(q).reshape(B, S, KV, G, hd)
    out5, m, l = jattn._flash_fwd_scan(q5, jnp.asarray(k), jnp.asarray(v),
                                       0.0, CHUNK)
    out5 = jnp.asarray(_bf16(torch.from_numpy(np.array(out5))).numpy())
    do5 = jnp.asarray(dout).reshape(B, S, KV, G, hd)
    # the rule's layout: q (B, S, KV, G, hd), out / dout (B, KV, G, S, hd)
    want = jattn._flash_bwd_rule(
        0.0, CHUNK, (q5, jnp.asarray(k), jnp.asarray(v), out5, m, l),
        jnp.moveaxis(do5, 1, 3))
    dq = np.asarray(want[0]).reshape(B, S, H, hd)
    out = np.asarray(jnp.moveaxis(out5, 3, 1)).reshape(B, S, H, hd)
    lse = np.asarray(m + jnp.log(jnp.maximum(l, 1e-30))).reshape(B, H, S)
    inputs = tuple(torch.from_numpy(np.array(a))
                   for a in (q, k, v, out, lse, dout))
    return inputs, (dq, np.asarray(want[1]), np.asarray(want[2]))


def test_bf16_walk_tiles_are_whole_k16_steps():
    """The emulation carries dk / dv over the rows and dq over the keys in
    k16 steps, whatever the tiles: that holds while every tile the kernels
    walk is whole k16 steps, and a key block is two warpgroups of 64."""
    assert KEY_BLOCK == (2 * 64, 2 * 64)
    assert all(n % K_STEP == 0 for n in Q_STEP + KEY_TILE)


@pytest.mark.parametrize("geom", [(2, 256, 8, 2, 64), (1, 192, 4, 1, 128),
                                  (2, 128, 4, 4, 32), (1, 1024, 8, 1, 64)],
                         ids=lambda g: "x".join(map(str, g)))
def test_bf16_emulation_within_the_card_gate_and_faults_miss_it(geom):
    inputs, want = _bf16_case(*geom, seed=3)
    _, mags = attention_bwd_ref(*inputs, causal=True, terms="values")
    products = _score_products(*inputs[:3], inputs[5])
    got = _emulate_bwd_bf16(*inputs, products=products)
    share = _gate(got, want, mags, BF16_GATE)
    assert share > 0.05  # the bf16 roundings show
    for fault in ("zero_tile", "no_D", "diagonal", "dk_scale", "query_tile",
                  "query_head"):
        with pytest.raises(AssertionError):
            _gate(_emulate_bwd_bf16(*inputs, fault=fault, products=products),
                  want, mags, BF16_GATE)


# ---------------------------------------------------------------------------
# the float32 kernels' arithmetic against JAX's rule
# ---------------------------------------------------------------------------
TF32_SOURCE = SOURCE.with_name("flash_attention_bwd_tf32_sm90.cu")
LOG2E = 1.4426950408889634
TF32_K_STEP = 8  # rows, keys or hd a TF32 `wgmma` k8 slice adds


def _tf32_constant(name: str) -> dict:
    """A `constexpr int` of the float32 backward's source by head dim, from
    `N` or `HD <= 64 ? N : M`."""
    m = re.search(rf"constexpr int {name} =(?: HD <= 64 \?)? (\d+)"
                  rf"(?: : (\d+))?;", TF32_SOURCE.read_text())
    assert m, f"{name} not found in {TF32_SOURCE.name}"
    small, large = int(m.group(1)), int(m.group(2) or m.group(1))
    return {32: small, 64: small, 128: large}


TF32_ROWS = _tf32_constant("kRows")  # fa_bwd_dkdv_tf32: query rows a step
TF32_KEYS = _tf32_constant("kKeys")  # fa_bwd_dkdv_tf32: keys a block
TF32_KT = _tf32_constant("kKT")      # fa_bwd_dq_tf32: keys a step


def _cut(v: torch.Tensor) -> torch.Tensor:
    """float64 cut toward zero to float32's 24 significant bits (the low 29
    of its 52 mantissa bits cleared), kept in float64: `_trunc32` for
    float32's normal range, in fewer operations."""
    return (v.view(torch.int64) & -(1 << 29)).view(torch.float64)


def _tc3(a, b, acc=None, split=True):
    """acc + a (..., M, K) · b (..., K, N) as TF32 `wgmma`s sum it: per k8
    slice the products lo·hi, hi·lo, then hi·hi (hi = the operand truncated
    to TF32, lo = the rest truncated to TF32: what the tensor core reads of
    each), each `wgmma`'s 8 exact products added to the float32 sum it
    carries and cut toward zero; `split=False`: hi·hi alone (one TF32
    rounding of each operand)."""
    out = (torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float64)
           if acc is None else acc.double())
    for i in range(0, a.shape[-1], TF32_K_STEP):
        x, y = a[..., i:i + TF32_K_STEP], b[..., i:i + TF32_K_STEP, :]
        xh, yh = _tf32(x), _tf32(y)
        parts = ([(_tf32(x - xh), yh), (xh, _tf32(y - yh))] if split else [])
        for u, w in parts + [(xh, yh)]:
            out = _cut(out + u.double() @ w.double())
    return out.float()


def _steps(a, b, n: int, split: bool):
    """The step sums of a (..., M, K) · b (..., K, N) over K in steps of n
    (the last one padded with zeros), each `_tc3` from zero: (..., K / n,
    M, N)."""
    K = a.shape[-1]
    pad = -K % n
    a = torch.nn.functional.pad(a, (0, pad))
    b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    m = (K + pad) // n
    a = a.reshape(a.shape[:-1] + (m, n)).movedim(-2, -3)
    b = b.reshape(b.shape[:-2] + (m, n, b.shape[-1]))
    return _tc3(a, b, split=split)


def _tf32_scores(q, k, v, dout, split=True):
    """S = q·kᵀ (unscaled) and dP = dO·vᵀ, (B, H, S, T) each, as both
    kernels sum them over hd (A = q or dO rows, B = k or v)."""
    G = q.shape[2] // k.shape[2]
    qh, doh = (t.permute(0, 2, 1, 3) for t in (q, dout))
    kh, vh = (t.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
              for t in (k, v))
    return (_tc3(qh, kh.transpose(-1, -2), split=split),
            _tc3(doh, vh.transpose(-1, -2), split=split))


def _emulate_bwd_tf32(q, k, v, out, lse, dout, causal=True, fault=None,
                      split=True, fold=True, products=None):
    """flash_attention_bwd_tf32_sm90.cu's arithmetic on float32 tensors: D
    = rowsum(dO ⊙ O) in float32; S and dP as `_tf32_scores`; P = 2^(s·hd^
    -0.5·log2 e − lse·log2 e) and dS = P ⊙ (dP − D) in float32; then
    fa_bwd_dkdv_tf32's walk — the G query heads of a KV head in order, each
    head's rows in steps of TF32_ROWS — adding each step's dvᵀ = dOᵀ·P and
    dkᵀ = qᵀ·dS (`_tc3` from zero) to float32 running sums, and
    fa_bwd_dq_tf32's walk over the keys in steps of TF32_KT doing the same
    for dqᵀ = kᵀ·dSᵀ, the even and the odd steps into sums of their own (one
    a warpgroup) added at the end; dk and dq times hd^-0.5. Rows and keys a walk skips,
    or whose P is masked, add exact zeros (a truncated sum keeps its value,
    and a step of zeros folds in nothing), so the walks run over every row
    and key here. `fold=False` is the control: dk and dv carried on the
    tensor core through the whole walk (`_tc3` from the running sums).
    `fault` plants one error, as `_emulate_bwd_bf16`'s. `products`:
    `_tf32_scores` of the same inputs, where already known."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    R, KT = TF32_ROWS[hd], TF32_KT[hd]
    qh, doh, oh = (t.permute(0, 2, 1, 3) for t in (q, dout, out))
    D = (doh * oh).sum(-1)  # (B, H, S)
    if fault == "no_D":
        D = torch.zeros_like(D)
    s, dp = products or _tf32_scores(q, k, v, dout, split)
    p = torch.exp2(s * (scale * LOG2E) - (lse * LOG2E)[..., None])
    if causal:
        rows, cols = torch.arange(S)[:, None], torch.arange(T)[None, :]
        p = p.masked_fill(cols >= rows if fault == "diagonal"
                          else cols > rows, 0.0)
    ds = p * (dp - D[..., None])
    dsk = ds.clone() if fault in ("query_tile", "query_head") else ds
    if fault == "query_tile":
        dsk[:, 3, S // 2:S // 2 + 64] = 0
    elif fault == "query_head":
        dsk[:, H - 1] = 0
    # dvᵀ, dkᵀ (B, KV, hd, T): the G heads, then the rows, R a step
    doT, qT = (t.reshape(B, KV, G, S, hd).transpose(-1, -2)
               for t in (doh, qh))
    p5, ds5 = p.reshape(B, KV, G, S, T), dsk.reshape(B, KV, G, S, T)
    dvT = torch.zeros((B, KV, hd, T))
    dkT = torch.zeros((B, KV, hd, T))
    if fold:
        sv, sk = _steps(doT, p5, R, split), _steps(qT, ds5, R, split)
        for g in range(G):
            for r in range(sv.shape[3]):
                dvT = dvT + sv[:, :, g, r]
                dkT = dkT + sk[:, :, g, r]
    else:
        for g in range(G):
            for r in range(0, S, R):
                dvT = _tc3(doT[:, :, g, :, r:r + R], p5[:, :, g, r:r + R],
                           acc=dvT, split=split)
                dkT = _tc3(qT[:, :, g, :, r:r + R], ds5[:, :, g, r:r + R],
                           acc=dkT, split=split)
    # dqᵀ (B, H, hd, S): the keys, KT a step
    kT = k.permute(0, 2, 3, 1).repeat_interleave(G, dim=1)  # (B, H, hd, T)
    sq = _steps(kT, ds.transpose(-1, -2), KT, split)
    # the two warpgroups take the key tiles in turns, each with its own sum
    run = [torch.zeros((B, H, hd, S)), torch.zeros((B, H, hd, S))]
    for c in range(sq.shape[2]):
        run[c % 2] = run[c % 2] + sq[:, :, c]
    dqT = run[0] + run[1]
    dk = dkT.permute(0, 3, 1, 2) * (1.0 if fault == "dk_scale" else scale)
    if fault == "zero_tile":
        dk[:, 64:128] = 0
    return ((dqT * scale).permute(0, 3, 1, 2), dk, dvT.permute(0, 3, 1, 2))


def _f32_case(B, S, H, KV, hd, causal, seed, positive_dout=False):
    """Seeded float32 q, k, v, dout; the forward's out and lse from JAX
    (the flash scan's out, m + log l under `causal`, else `_sdpa`'s out and
    the scores' log-sum-exp), and JAX's backward on them in float32: the
    rule `_flash_bwd_rule` under `causal`, `jax.vjp` of `_sdpa` without a
    mask otherwise (the rule is causal only). `positive_dout`: |dout|, so
    that dv's terms share their sign."""
    q, k, v, dout = (a.astype(np.float32)
                     for a in _case(B, S, H, KV, hd, seed))
    if positive_dout:
        dout = np.abs(dout)
    G = H // KV
    chunk = 8  # T % chunk == 0 for the rule's scan; ragged for the kernels
    if causal:
        q5 = jnp.asarray(q).reshape(B, S, KV, G, hd)
        out5, m, l = jattn._flash_fwd_scan(q5, jnp.asarray(k),
                                           jnp.asarray(v), 0.0, chunk)
        do5 = jnp.asarray(dout).reshape(B, S, KV, G, hd)
        want = jattn._flash_bwd_rule(
            0.0, chunk, (q5, jnp.asarray(k), jnp.asarray(v), out5, m, l),
            jnp.moveaxis(do5, 1, 3))
        out = np.asarray(jnp.moveaxis(out5, 3, 1)).reshape(B, S, H, hd)
        lse = np.asarray(m + jnp.log(jnp.maximum(l, 1e-30))).reshape(B, H, S)
        want = [np.asarray(w) for w in want]
        want[0] = want[0].reshape(B, S, H, hd)
    else:
        cfg = _jax_cfg(H, KV)
        out, f = jax.vjp(lambda a, b, c: jattn._sdpa(a, b, c, cfg, None),
                         *(jnp.asarray(a) for a in (q, k, v)))
        want = [np.asarray(w) for w in f(jnp.asarray(dout))]
        scores = jnp.einsum("bshd,bthd->bhst", jnp.asarray(q),
                            jnp.repeat(jnp.asarray(k), G, axis=2))
        lse = np.asarray(jax.nn.logsumexp(
            scores / jnp.sqrt(hd).astype(jnp.float32), axis=-1))
        out = np.asarray(out)
    inputs = tuple(torch.from_numpy(np.array(a))
                   for a in (q, k, v, out, lse, dout))
    return inputs, tuple(want)


def test_tf32_tiles_fit_the_wgmma_shapes():
    """The emulation folds dk / dv every TF32_ROWS rows and dq every TF32_KT
    keys, in k8 slices: that holds while S's rows are one m64, every tile
    the kernels walk is whole 32-value (128-byte) column blocks of whole k8
    slices, and the key tiles are the n32 / n64 widths of `wgmma_rs_tf32`."""
    for hd in (32, 64, 128):
        assert TF32_ROWS[hd] == 64
        for n in (TF32_ROWS[hd], TF32_KEYS[hd], TF32_KT[hd]):
            assert n % 32 == 0 and n % TF32_K_STEP == 0
        assert TF32_KEYS[hd] in (32, 64) and TF32_KT[hd] in (32, 64)


TF32_GEOMS = [(2, 200, 4, 4, 32, True), (1, 200, 8, 2, 32, False),
              (1, 328, 8, 1, 64, True), (2, 136, 4, 1, 64, False),
              (1, 264, 8, 8, 64, True), (1, 200, 8, 1, 128, True),
              (1, 136, 4, 1, 128, False), (1, 512, 8, 1, 64, True)]


@pytest.mark.parametrize("geom", TF32_GEOMS,
                         ids=lambda g: "x".join(map(str, g[:5]))
                         + ("_causal" if g[5] else "_full"))
def test_tf32_emulation_within_the_float32_gate_and_faults_miss_it(geom):
    causal = geom[5]
    inputs, want = _f32_case(*geom, seed=5)
    _, mags = attention_bwd_ref(*inputs, causal=causal, terms="products")
    products = _tf32_scores(*inputs[:3], inputs[5])
    got = _emulate_bwd_tf32(*inputs, causal=causal, products=products)
    _gate(got, want, mags, ATTN_BWD_REL)
    for fault in ("zero_tile", "no_D", "diagonal", "dk_scale", "query_tile",
                  "query_head")[:None if causal else 2] + (
                      () if causal else ("dk_scale", "query_tile",
                                         "query_head")):
        with pytest.raises(AssertionError):
            _gate(_emulate_bwd_tf32(*inputs, causal=causal, fault=fault,
                                    products=products),
                  want, mags, ATTN_BWD_REL)


@pytest.mark.parametrize("hd", [64, 128])
def test_tf32_single_rounding_misses_the_float32_gate(hd):
    """One TF32 rounding of each operand (hi·hi alone) lands past the gate
    that 3xTF32 keeps."""
    inputs, want = _f32_case(1, 256, 4, 1, hd, True, seed=6)
    _, mags = attention_bwd_ref(*inputs, causal=True, terms="products")
    _gate(_emulate_bwd_tf32(*inputs), want, mags, ATTN_BWD_REL)
    with pytest.raises(AssertionError):
        _gate(_emulate_bwd_tf32(*inputs, split=False), want, mags,
              ATTN_BWD_REL)


def test_tf32_sums_carried_through_the_walk_miss_the_float32_gate():
    """The control for the float32 folds: dk and dv carried on the tensor
    core over the whole walk (G = 8 heads of 1,024 rows, 3,072 truncated
    sums a key), on same-sign dv terms (|dout|), land past the gate; the
    kernels' folds (a float32 add every TF32_ROWS rows) stay within it."""
    inputs, want = _f32_case(1, 1024, 8, 1, 64, True, seed=7,
                             positive_dout=True)
    _, mags = attention_bwd_ref(*inputs, causal=True, terms="products")
    products = _tf32_scores(*inputs[:3], inputs[5])
    _gate(_emulate_bwd_tf32(*inputs, products=products), want, mags,
          ATTN_BWD_REL)
    with pytest.raises(AssertionError):
        _gate(_emulate_bwd_tf32(*inputs, products=products, fold=False),
              want, mags, ATTN_BWD_REL)
