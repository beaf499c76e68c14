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
- The bf16 kernel's arithmetic, emulated in torch (`_emulate_bwd_bf16`:
  bf16 operands, P and dS rounded to bf16 once before their products,
  float32 sums a key tile, outputs rounded to bf16), against JAX's
  `_flash_bwd_rule` run in float32 on the same bf16 values (same out, m
  and l) at phase 2's bf16 gate, 2^-8·|ref| + 2^-7·Σ|terms| with |dS| as
  P ⊙ (|dP| + |D|) (`terms="values"`); each planted fault (a zeroed dk
  tile, D left out of dS, the diagonal masked, dk without its hd^-0.5, dk
  without one middle query tile of one head or without one query head)
  must miss that gate, at GQA 8 and S = 1,024 too.
- `attention` keeps nothing for the backward where no input requires grad
  or grad mode is off (serving), and its plain forward's lse against
  JAX's m + log l.
"""
import dataclasses

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
KEY_TILE = 64


def _bf16(t):
    return t.to(torch.bfloat16).to(torch.float32)


def _emulate_bwd_bf16(q, k, v, out, lse, dout, fault=None):
    """flash_attention_bwd.cu's bf16 arithmetic on float32 tensors holding
    bf16 values (causal, S == T): D = rowsum(dO ⊙ O) in float32; per key
    tile of 64, P = exp(s − lse) and dS = P ⊙ (dO · vᵀ − D) in float32 from
    exact products, P and dS rounded to bf16 once, dv += Pᵀ · dO, dk +=
    dSᵀ · q, dq += dS · k in float32; dk and dq times hd^-0.5, all three
    rounded to bf16. `fault` plants one error: "zero_tile" (dk of keys
    64-127 zeroed), "no_D" (dS = P ⊙ dPᵀ), "diagonal" (a key's own row
    masked), "dk_scale" (dk without hd^-0.5), "query_tile" (dk without
    query head 3's rows S/2 to S/2 + 63), "query_head" (dk without the
    last query head)."""
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
    dq = torch.zeros_like(qh)
    dk = torch.zeros_like(kh)
    dv = torch.zeros_like(vh)
    rows = torch.arange(S)
    for t0 in range(0, S, KEY_TILE):
        cols = torch.arange(t0, min(S, t0 + KEY_TILE))
        kt, vt = kh[:, :, cols], vh[:, :, cols]
        s = torch.matmul(qh, kt.transpose(-1, -2)) * scale
        p = torch.exp(s - lse[..., None])
        masked = cols[None, :] >= rows[:, None] if fault == "diagonal" \
            else cols[None, :] > rows[:, None]
        p = p.masked_fill(masked, 0.0)
        ds = p * (torch.matmul(doh, vt.transpose(-1, -2)) - D[..., None])
        pb, dsb = _bf16(p), _bf16(ds)
        dsk = dsb.clone() if fault in ("query_tile", "query_head") else dsb
        if fault == "query_tile":
            dsk[:, 3, S // 2:S // 2 + 64] = 0
        elif fault == "query_head":
            dsk[:, H - 1] = 0
        dv[:, :, cols] += torch.matmul(pb.transpose(-1, -2), doh)
        dk[:, :, cols] += torch.matmul(dsk.transpose(-1, -2), qh)
        dq += torch.matmul(dsb, kt)
    dk = dk.reshape(B, KV, G, S, hd).sum(2) * (
        1.0 if fault == "dk_scale" else scale)
    dv = dv.reshape(B, KV, G, S, hd).sum(2)
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


@pytest.mark.parametrize("geom", [(2, 256, 8, 2, 64), (1, 192, 4, 1, 128),
                                  (2, 128, 4, 4, 32), (1, 1024, 8, 1, 64)],
                         ids=lambda g: "x".join(map(str, g)))
def test_bf16_emulation_within_the_card_gate_and_faults_miss_it(geom):
    inputs, want = _bf16_case(*geom, seed=3)
    _, mags = attention_bwd_ref(*inputs, causal=True, terms="values")
    got = _emulate_bwd_bf16(*inputs)
    share = _gate(got, want, mags, BF16_GATE)
    assert share > 0.05  # the bf16 roundings show
    for fault in ("zero_tile", "no_D", "diagonal", "dk_scale", "query_tile",
                  "query_head"):
        with pytest.raises(AssertionError):
            _gate(_emulate_bwd_bf16(*inputs, fault=fault), want, mags,
                  BF16_GATE)
