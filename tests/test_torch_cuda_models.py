"""The port's LM stack on the card. Every test here is marked `cuda` and
skips without a CUDA device (a CUDA kernel has no CPU mode; the CPU tests
hold the model stack against the JAX package). This file imports no JAX:

    python -m pytest -m cuda tests/test_torch_cuda_models.py

- `mamba_ssd(return_state=True)`: y and the final state against the plain
  version on the same inputs, at chip_smoke.py's scan gates ((SSD_REL +
  8·u32·max|l|)·Σ|terms| + 1e-6 against float64; plus 2^-8·|ref| in bf16
  against float32).
- zamba2-1.2b, tinyllama-1.1b, granite-moe-3b-a800m and xlstm-350m at full
  width with two layers (xlstm: one mLSTM and one sLSTM layer) in bf16: a
  prefill and decode steps launch exactly the kernels the layers call
  (zamba2: one scan a Mamba layer and one bf16 attention call a shared-block
  application at prefill, one bf16 decode call an application a step;
  granite: also a histogram and four bf16 grouped GEMMs a layer, at prefill
  and at each step; xlstm: none), and decode after a prefill reproduces a
  longer prefill's last logits within chip_smoke.py's LM_CONSISTENCY (0.05
  of max|logits|).
- The same at n_layers=2 in float32 against float64 on the CPU: logits
  within chip_smoke.py's LM_F32_REL (1e-4) of max|ref|.
- A reduced config (head dim 8) is refused by the attention kernel on the
  card with its `ValueError`: no plain fallback.
- Training: tinyllama-1.1b's float32 two-layer twin, one `loss_fn`
  forward and backward on the card (one 3xTF32 B5 forward and backward a
  layer) against float64 on the CPU: the loss within 1e-5 of |ref| and
  every parameter's gradient within chip_smoke.py's TRAIN_F32_REL (1e-4)
  of its max|ref|; the bf16 model's `loss_fn` launches the bf16 kernels
  (one forward and one backward a layer) and the zamba2 pattern raises
  under grad (no backward kernel for the scan yet); granite-moe-1b-a400m
  and granite-moe-3b-a800m at two full-width layers, bf16 and float32,
  train: `loss_fn` launches a layer one histogram, four B4 forward and
  eight backward launches (dx and dw) and B5's forward and backward.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import get_config, get_reduced
from repro_torch.kernels import mamba_ssd
from repro_torch.kernels.mamba_scan.ref import ssd_scan_ref
from repro_torch.models import Model

pytestmark = pytest.mark.cuda

SSD_REL = 1e-5
U32 = 2.0 ** -24
BF16_ROUND = 2.0 ** -8
LM_CONSISTENCY = 0.05
LM_F32_REL = 1e-4
# (B, S, nh, hd, ds, chunk): tests/test_kernels.py's MAMBA family and
# zamba2's widths (64 heads of 64, d_state 64, chunk 128)
STATE_GEOMS = [(2, 32, 2, 8, 8, 16), (2, 128, 1, 32, 16, 32),
               (2, 512, 64, 64, 64, 128), (1, 300, 17, 64, 64, 100)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.reset_launches()
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("geom", STATE_GEOMS,
                         ids=lambda g: "x".join(map(str, g)))
def test_ssd_final_state_kernel(dev, geom, dtype):
    B, S, nh, hd, ds, chunk = geom
    rng = np.random.default_rng(1)
    dt_ = getattr(torch, dtype)

    def put(a, t=dt_):
        return torch.from_numpy(a.astype(np.float32)).to(dev, t)

    x = put(rng.normal(size=(B, S, nh, hd)))
    dt = put(rng.uniform(0.01, 0.3, size=(B, S, nh)), torch.float32)
    A = put(-rng.uniform(0.3, 2.0, size=(nh,)), torch.float32)
    Bc, Cc = put(rng.normal(size=(B, S, ds))), put(rng.normal(size=(B, S,
                                                                    ds)))
    y, h = mamba_ssd(x, dt, A, Bc, Cc, chunk=chunk, return_state=True)
    torch.cuda.synchronize()
    assert kernels.launches()["mamba_scan"] == 1
    assert h.shape == (B, nh, hd, ds) and h.dtype == torch.float32
    assert torch.equal(y, mamba_ssd(x, dt, A, Bc, Cc, chunk=chunk))
    up = (lambda t: t.double()) if dtype == "float32" else \
        (lambda t: t.float())
    want_y, want_h = ssd_scan_ref(up(x), dt, A, up(Bc), up(Cc), chunk=chunk,
                                  return_state=True)
    mag_y, mag_h = ssd_scan_ref(up(x.abs()), dt, A, up(Bc.abs()),
                                up(Cc.abs()), chunk=chunk, return_state=True)
    c = min(chunk, S)
    max_l = float((dt.double() * A.double()).reshape(B, -1, c, nh).cumsum(
        2).abs().max())
    rel = SSD_REL + 8 * U32 * max_l
    bf16 = BF16_ROUND if dtype == "bfloat16" else 0.0
    for got, want, mag in ((y, want_y, mag_y), (h, want_h, mag_h)):
        allowed = rel * mag.double() + 1e-6 + bf16 * want.double().abs()
        assert bool(((got.double() - want.double()).abs() <= allowed).all())


ARCHS = ["zamba2-1.2b", "tinyllama-1.1b", "granite-moe-3b-a800m",
         "xlstm-350m"]


def _full_two_layers(arch, dtype):
    cfg = get_config(arch)
    kw = {}
    if cfg.pattern == "xlstm":  # one unit: an mLSTM and an sLSTM layer
        kw["xlstm"] = dataclasses.replace(cfg.xlstm, slstm_every=2)
    return dataclasses.replace(cfg, n_layers=2, param_dtype=dtype,
                               compute_dtype=dtype, **kw)


def _launches_of(cfg, prefills, steps):
    bf16 = cfg.compute_dtype == "bfloat16"
    fa = "flash_attention_sm90" if bf16 else "flash_attention_tf32"
    fd = "flash_decode_sm90" if bf16 else "flash_decode"
    n_attn = {"zamba2": -(-cfg.n_layers // cfg.shared_attn_every),
              "xlstm": 0}.get(cfg.pattern, cfg.n_layers)
    want = {k: 0 for k in kernels.KERNELS}
    want[fa] = prefills * n_attn
    want[fd] = steps * n_attn
    if cfg.pattern == "zamba2":
        want["mamba_scan"] = prefills * cfg.n_layers
    if cfg.pattern == "moe":  # Phase 1, then hot and cold SwiGLUs
        calls = (prefills + steps) * cfg.n_layers
        want["histogram"] = calls
        want["moe_gemm_sm90" if bf16 else "moe_gemm"] = 4 * calls
    return want


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_prefill_decode_on_card(dev, arch):
    cfg = _full_two_layers(arch, "bfloat16")
    model = Model(cfg, device=dev, seed=3)
    B, S, split = 2, 256, 128
    toks = torch.randint(0, cfg.vocab_size, (B, S), device=dev,
                         generator=torch.Generator(dev).manual_seed(4),
                         dtype=torch.int32)
    kernels.reset_launches()
    full, _ = model.prefill(tokens=toks, max_len=S)
    _, caches = model.prefill(tokens=toks[:, :split], max_len=S)
    for i in range(split, S):
        step, caches = model.decode_step(caches, tokens=toks[:, i:i + 1],
                                         cache_pos=i)
    torch.cuda.synchronize()
    assert kernels.launches() == _launches_of(cfg, 2, S - split)
    assert bool(torch.isfinite(step).all())
    top = full.abs().max()
    assert float((step[:, 0] - full[:, 0]).abs().max()) <= \
        LM_CONSISTENCY * float(top)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_float32_against_float64(dev, arch):
    cfg = _full_two_layers(arch, "float32")
    model = Model(cfg, device=dev, seed=5)
    ref = copy.deepcopy(model).to(device="cpu", dtype=torch.float64)
    ref.cfg = dataclasses.replace(cfg, param_dtype="float64",
                                  compute_dtype="float64")
    toks = torch.randint(0, cfg.vocab_size, (1, 130),
                         generator=torch.Generator().manual_seed(6),
                         dtype=torch.int32)

    def run(m, t):
        logits, caches = m.prefill(tokens=t[:, :128], max_len=130)
        out = [logits]
        for i in (128, 129):
            logits, caches = m.decode_step(caches, tokens=t[:, i:i + 1],
                                           cache_pos=i)
            out.append(logits)
        return torch.cat(out, dim=1)

    kernels.reset_launches()
    got = run(model, toks.to(dev))
    torch.cuda.synchronize()
    assert kernels.launches() == _launches_of(cfg, 1, 2)
    want = run(ref, toks)
    top = float(want.abs().max())
    assert float((got.cpu().double() - want).abs().max()) <= \
        LM_F32_REL * top


def test_reduced_head_dim_is_refused_on_card(dev):
    model = Model(get_reduced("tinyllama-1.1b"), device=dev)
    toks = torch.zeros((1, 8), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="head_dim 8"):
        model.prefill(tokens=toks)


def _loss_and_grads(m, batch, device):
    loss, _ = m.loss_fn({k: torch.from_numpy(v).to(device)
                         for k, v in batch.items()})
    names = [n for n, _ in m.named_parameters()]
    return loss.detach(), dict(zip(names, torch.autograd.grad(
        loss, [p for _, p in m.named_parameters()])))


def _tokens(cfg, B, S, seed=5):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def test_tinyllama_twin_loss_fn_step_against_float64(dev):
    cfg = _full_two_layers("tinyllama-1.1b", "float32")
    model = Model(cfg, device=dev, seed=5)
    ref = copy.deepcopy(model).to(device="cpu", dtype=torch.float64)
    ref.cfg = dataclasses.replace(cfg, param_dtype="float64",
                                  compute_dtype="float64")
    batch = _tokens(cfg, 1, 256)
    loss, got = _loss_and_grads(model, batch, dev)
    torch.cuda.synchronize()
    want = {k: 0 for k in kernels.KERNELS}
    want.update(flash_attention_tf32=2, flash_attention_bwd_tf32=2)
    assert kernels.launches() == want
    rloss, rgrads = _loss_and_grads(ref, batch, "cpu")
    assert abs(float(loss) - float(rloss)) <= 1e-5 * abs(float(rloss))
    for n, w in rgrads.items():
        err = float((got[n].cpu().double() - w).abs().max())
        assert err <= LM_F32_REL * float(w.abs().max()), n


def test_bf16_loss_fn_launches_the_bf16_backward(dev):
    cfg = _full_two_layers("tinyllama-1.1b", "bfloat16")
    model = Model(cfg, device=dev, seed=6)
    loss, grads = _loss_and_grads(model, _tokens(cfg, 2, 512), dev)
    torch.cuda.synchronize()
    want = {k: 0 for k in kernels.KERNELS}
    want.update(flash_attention_sm90=2, flash_attention_bwd_bf16=2)
    assert kernels.launches() == want
    assert bool(torch.isfinite(loss))
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_scan_pattern_trains_on_card(dev, dtype):
    """Two full-width zamba2 layers (one application of the shared
    attention block): `loss_fn` forward and backward launch a Mamba layer
    one scan forward and one backward (float32: the layer lifts x, B and C)
    and B5's forward and backward once; the loss and every gradient finite,
    A_log's, dt_bias's and in_proj's gradients nonzero."""
    cfg = _full_two_layers("zamba2-1.2b", dtype)
    model = Model(cfg, device=dev, seed=7)
    loss, grads = _loss_and_grads(model, _tokens(cfg, 1, 512), dev)
    torch.cuda.synchronize()
    bf = dtype == "bfloat16"
    want = {k: 0 for k in kernels.KERNELS}
    want.update({"mamba_scan": 2, "mamba_scan_bwd": 2,
                 "flash_attention_sm90" if bf else "flash_attention_tf32": 1,
                 ("flash_attention_bwd_bf16" if bf
                  else "flash_attention_bwd_tf32"): 1})
    assert kernels.launches() == want
    assert bool(torch.isfinite(loss))
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    for n, g in grads.items():
        if n.endswith(("A_log", "dt_bias", "in_proj")):
            assert bool(g.any()), n


def test_bf16_scan_under_grad_raises_on_card(dev):
    """No bf16 backward kernel for the scan (ROADMAP A11f): a bf16
    `mamba_ssd` under grad raises; it does not run the plain version."""
    x = torch.randn((1, 128, 2, 16), device=dev).bfloat16().requires_grad_()
    dt = torch.full((1, 128, 2), 0.1, device=dev)
    bc = torch.randn((1, 128, 8), device=dev).bfloat16()
    with pytest.raises(NotImplementedError, match="A11f"):
        mamba_ssd(x, dt, -torch.ones(2, device=dev), bc, bc, chunk=64)
    assert kernels.launches() == {k: 0 for k in kernels.KERNELS}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "granite-moe-3b-a800m"])
def test_moe_pattern_trains_on_card(dev, arch, dtype):
    """Two full-width MoE layers: `loss_fn` forward and backward launch, a
    layer, one histogram, four B4 forward launches and eight backward ones
    (dx and dw of the hot and the cold SwiGLU's two GEMMs), and B5's
    forward and backward; the loss and every gradient finite, every
    expert stack's gradient nonzero."""
    cfg = _full_two_layers(arch, dtype)
    model = Model(cfg, device=dev, seed=7)
    loss, grads = _loss_and_grads(model, _tokens(cfg, 1, 512), dev)
    torch.cuda.synchronize()
    bf = dtype == "bfloat16"
    want = {k: 0 for k in kernels.KERNELS}
    want.update({"histogram": 2,
                 "moe_gemm_sm90" if bf else "moe_gemm": 8,
                 "moe_gemm_dx_sm90" if bf else "moe_gemm_dx": 8,
                 "moe_gemm_dw_sm90" if bf else "moe_gemm_dw": 8,
                 "flash_attention_sm90" if bf else "flash_attention_tf32": 2,
                 ("flash_attention_bwd_bf16" if bf
                  else "flash_attention_bwd_tf32"): 2})
    assert kernels.launches() == want
    assert bool(torch.isfinite(loss))
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    for n, g in grads.items():
        if n.endswith(("w_in", "w_out")):
            assert bool(g.any()), n
