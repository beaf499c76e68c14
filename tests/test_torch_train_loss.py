"""`repro_torch.models.Model.loss_fn` and its gradients held against the
JAX package's `jax.value_and_grad(repro.models.Model(cfg).loss_fn)` on
every reduced config (the ten `repro.configs.*.reduced()`, as
tests/test_archs_smoke.py::test_train_grad_step takes them: the six dense
and parallel ones here, the other four in
tests/test_torch_train_loss_moe_ssm.py, which uses this file's helpers),
with the JAX
`Model.init` parameters carried across by `from_jax_params` and the same
seeded numpy batch. The counterpart of that JAX test.

Each config twice: as it is (S·V under LOSS_CHUNK_THRESHOLD: the logits
whole) and through the chunked cross-entropy, by lowering
LOSS_CHUNK_THRESHOLD to 1 and LOSS_CHUNK to 8 on a test subclass of each
package's `Model` (two chunks of the 16 positions; the JAX file itself is
not touched). Also a masked loss, the chunked path's logits of 8 positions
at a time, and `forward` staying out of autograd.

On the CPU every kernel wrapper runs its plain version (attention forward
and backward, the scan, the grouped GEMM), and nothing launches.
Tolerances (float32): the loss, nll and aux within LOSS_TOL = 1e-5 of
|ref| (the largest difference seen: 1e-7 of it), every gradient tensor
within GRAD_TOL = 1e-4 of its own max|ref| (+ rtol 1e-4): float32 sums in
other orders through up to five layers, 3e-6 of the max at most seen.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models import Model as JaxModel
from repro_torch import kernels
from repro_torch.configs import get_reduced
from repro_torch.models import Model, from_jax_params

# one intra-op thread per test process: the suite runs in parallel workers
torch.set_num_threads(1)

# the dense and parallel patterns here; the zamba2, moe and xlstm configs
# in tests/test_torch_train_loss_moe_ssm.py (two files: two workers)
ARCHS = ["glm4-9b", "internlm2-20b", "tinyllama-1.1b", "command-r-35b",
         "qwen2-vl-72b", "musicgen-large"]
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
B, S = 2, 16


class _ChunkedJax(JaxModel):
    LOSS_CHUNK_THRESHOLD = 1
    LOSS_CHUNK = 8


class _Chunked(Model):
    LOSS_CHUNK_THRESHOLD = 1
    LOSS_CHUNK = 8


@pytest.fixture(autouse=True)
def no_kernel_launch():
    kernels.reset_launches()
    yield
    assert kernels.launches() == {k: 0 for k in kernels.KERNELS}


def _batch(cfg, seed=1, mask=False):
    """tests/test_archs_smoke.py's batch (tokens and targets, or the stub's
    embeddings), as numpy; with `mask`, a 0/1 mask of the positions."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S + 1))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "targets": toks[:, 1:].astype(np.int32)}
    if cfg.modality_stub:
        batch["embeds"] = (rng.normal(size=(B, S, cfg.d_model)) * 0.3
                           ).astype(np.float32)
        batch.pop("tokens")
    if mask:
        batch["mask"] = (rng.random((B, S)) < 0.7).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def _params(arch):
    """JAX's `Model.init(1)` (jitted: the same bits, a fraction of the
    time of the eager init)."""
    return jax.jit(JaxModel(jax_reduced(arch)).init, static_argnums=0)(1)


@functools.lru_cache(maxsize=None)
def _case(arch, variant):
    """(the port's state dict, the batch, JAX's loss, metrics and
    gradients as the port's state dict) for `variant` "plain", "chunked"
    or "mask": one JAX compile each."""
    jcfg = jax_reduced(arch)
    params = _params(arch)
    cfg = get_reduced(arch)
    batch = _batch(cfg, mask=variant == "mask")
    cls = _ChunkedJax if variant == "chunked" else JaxModel
    step = jax.jit(jax.value_and_grad(cls(jcfg).loss_fn, has_aux=True))
    (loss, metrics), grads = step(params, {k: jnp.asarray(v)
                                           for k, v in batch.items()})
    sd = from_jax_params(cfg, jax.tree.map(np.asarray, params), "cpu")
    g = from_jax_params(cfg, jax.tree.map(np.asarray, grads), "cpu")
    return sd, batch, float(loss), {k: float(v) for k, v in
                                    metrics.items()}, g


def _port(arch, variant):
    cfg = get_reduced(arch)
    sd, batch, *_ = _case(arch, variant)
    m = (_Chunked if variant == "chunked" else Model)(cfg, device="cpu")
    m.load_state_dict(sd, strict=True)
    return m, {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("variant", ["plain", "chunked"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_and_grads_match_jax(arch, variant):
    m, batch = _port(arch, variant)
    _, _, want, want_metrics, want_grads = _case(arch, variant)
    loss, metrics = m.loss_fn(batch)
    assert loss.dtype == torch.float32 and loss.requires_grad
    assert abs(loss.item() - want) <= LOSS_TOL * abs(want)
    for k in ("nll", "aux"):
        assert abs(float(metrics[k]) - want_metrics[k]) <= \
            LOSS_TOL * max(abs(want_metrics[k]), 1e-30), k
    assert (float(metrics["aux"]) > 0) == (m.cfg.pattern == "moe")
    names = [n for n, _ in m.named_parameters()]
    got = torch.autograd.grad(loss, [p for _, p in m.named_parameters()],
                              allow_unused=True)
    assert set(names) == set(want_grads)
    for n, g in zip(names, got):
        w = want_grads[n].numpy()
        # only the stubs' unused token table gets no gradient (JAX: zeros)
        assert g is not None or (n == "embed" and not w.any()), n
        g = np.zeros_like(w) if g is None else g.numpy()
        np.testing.assert_allclose(g, w, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * np.abs(w).max(),
                                   err_msg=n)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b"])
def test_masked_loss_matches_jax(arch):
    m, batch = _port(arch, "mask")
    _, _, want, _, want_grads = _case(arch, "mask")
    loss, _ = m.loss_fn(batch)
    assert abs(float(loss) - want) <= LOSS_TOL * abs(want)
    g = torch.autograd.grad(loss, m.embed)[0].numpy()
    w = want_grads["embed"].numpy()
    np.testing.assert_allclose(g, w, rtol=GRAD_TOL,
                               atol=GRAD_TOL * np.abs(w).max())


def test_chunked_loss_forms_logits_a_chunk_at_a_time():
    m, batch = _port("tinyllama-1.1b", "chunked")
    shapes = []
    head = m._logits

    def logits(x):
        shapes.append(tuple(x.shape))
        return head(x)
    m._logits = logits
    loss, _ = m.loss_fn(batch)
    assert shapes == [(B, 8, m.cfg.d_model)] * 2
    torch.autograd.grad(loss, m.lm_head)  # recomputed in the backward
    assert shapes == [(B, 8, m.cfg.d_model)] * 4
    plain, pbatch = _port("tinyllama-1.1b", "plain")
    assert abs(float(plain.loss_fn(pbatch)[0]) - float(loss)) <= \
        LOSS_TOL * float(loss)


def test_serving_entry_points_stay_out_of_autograd():
    m, batch = _port("tinyllama-1.1b", "plain")
    logits, _, _ = m.forward(tokens=batch["tokens"])
    assert logits.grad_fn is None
    last, caches = m.prefill(tokens=batch["tokens"], max_len=S + 1)
    assert last.grad_fn is None and caches[0].grad_fn is None
