"""The port's training substrate held against the JAX package's, on the
same seeded numpy inputs in one process: `repro_torch.data`
(`SyntheticLMStream` batches bit-equal), `repro_torch.optim`
(`lr_schedule`, `clip_by_global_norm`, `adamw_update` on float32 and bf16
trees), `repro_torch.runtime.compression` (q and scale bit-equal, the
residual, `decompress`, `wire_bytes`), and `repro_torch.runtime.Trainer`
against `repro.runtime.Trainer` on the reduced tinyllama config (10 steps,
with and without gradient accumulation and compression), plus the ports of
tests/test_substrate.py's optimizer, data, compression and trainer tests
(loss decreases and recovers from a failure; resume identical to an
uninterrupted run).

Tolerances: the schedule, the norm and float32 moments within 1e-6
relative (float32 ops in the same order; `cos` and `pow` may differ in the
last bit); bf16 parameters within one bf16 ulp (2^-7 relative: the same
float32 value rounded once, off by a float32 ulp at most); the trainer's
loss history within LOSS_REL = 1e-4 of JAX's over 10 steps (float32 sums
in other orders through the model and the optimizer, the first loss within
1e-6; Adam's normalized steps carry the differences forward).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.data import SyntheticLMStream as JaxStream
from repro.models import Model as JaxModel
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import clip_by_global_norm as jax_clip
from repro.optim import init_opt_state as jax_init_opt_state
from repro.optim import lr_schedule as jax_lr_schedule
from repro.runtime import Trainer as JaxTrainer
from repro.runtime import TrainerConfig as JaxTrainerConfig
from repro.runtime.compression import compress_gradients as jax_compress
from repro.runtime.compression import init_compression_state as jax_comp_init
from repro.runtime.compression import wire_bytes as jax_wire_bytes
from repro_torch import kernels
from repro_torch.checkpoint.manager import latest_step
from repro_torch.configs import get_reduced
from repro_torch.data import SyntheticLMStream
from repro_torch.models import Model, from_jax_params
from repro_torch.optim import (AdamWConfig, adamw_update,
                               clip_by_global_norm, init_opt_state,
                               lr_schedule)
from repro_torch.runtime import FailureInjector, Trainer, TrainerConfig
from repro_torch.runtime.compression import (compress_gradients, decompress,
                                             init_compression_state,
                                             wire_bytes)

# one intra-op thread per test process: the suite runs in parallel workers
torch.set_num_threads(1)

REL = 1e-6
BF16_ULP = 2.0 ** -7
LOSS_REL = 1e-4


@pytest.fixture(autouse=True)
def no_kernel_launch():
    kernels.reset_launches()
    yield
    assert kernels.launches() == {k: 0 for k in kernels.KERNELS}


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("hosts", [1, 4])
def test_stream_batches_are_the_jax_packages_bits(hosts):
    kw = dict(vocab_size=97, batch_size=8, seq_len=24, seed=5, noise=0.2)
    for h in range(hosts):
        a = SyntheticLMStream(**kw, host_id=h, num_hosts=hosts)
        b = JaxStream(**kw, host_id=h, num_hosts=hosts)
        assert (a.a, a.b) == (b.a, b.b)
        for step in (0, 3, 1000):
            x, y = a.batch_at(step), b.batch_at(step)
            assert set(x) == {"tokens", "targets"}
            for k in x:
                assert x[k].dtype == y[k].dtype == np.int32
                np.testing.assert_array_equal(x[k], y[k])


def test_stream_deterministic_resume_sharding_and_structure():
    s = SyntheticLMStream(vocab_size=64, batch_size=4, seq_len=16, seed=1)
    np.testing.assert_array_equal(s.batch_at(7)["tokens"],
                                  s.batch_at(7)["tokens"])
    full = SyntheticLMStream(vocab_size=64, batch_size=8, seq_len=8, seed=2)
    parts = [SyntheticLMStream(vocab_size=64, batch_size=8, seq_len=8,
                               seed=2, host_id=h, num_hosts=4)
             for h in range(4)]
    np.testing.assert_array_equal(
        np.concatenate([p.batch_at(3)["tokens"] for p in parts]),
        full.batch_at(3)["tokens"])
    clean = SyntheticLMStream(vocab_size=64, batch_size=2, seq_len=64,
                              seed=0, noise=0.0)
    b = clean.batch_at(0)
    t, y = b["tokens"][0], b["targets"][0]
    assert ((clean.a * t + clean.b) % 64 == y).all()
    with pytest.raises(ValueError, match="divide"):
        SyntheticLMStream(vocab_size=64, batch_size=6, seq_len=8,
                          num_hosts=4)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------
def test_lr_schedule_matches_jax():
    kw = dict(peak_lr=3e-4, warmup_steps=10, total_steps=100,
              min_lr_ratio=0.1)
    cfg, jcfg = AdamWConfig(**kw), JaxAdamWConfig(**kw)
    steps = [0, 1, 5, 9, 10, 11, 37, 99, 100, 101, 250]
    got = [float(lr_schedule(torch.tensor(s, dtype=torch.int32), cfg))
           for s in steps]
    want = [float(jax_lr_schedule(jnp.asarray(s, jnp.int32), jcfg))
            for s in steps]
    np.testing.assert_allclose(got, want, rtol=REL, atol=0)
    assert lr_schedule(torch.tensor(3), cfg).dtype == torch.float32


def _tree(rng, dtype):
    shapes = {"bias": (7,), "w": (6, 5), "stack": (3, 4, 5)}
    return {k: rng.normal(size=s).astype(np.float32) for k, s in
            shapes.items()}


def _as(tree, dtype):
    """numpy float32 values -> (torch tree, JAX tree) in `dtype`, sharing
    no memory (the port updates in place; JAX may alias a numpy buffer)."""
    t = {k: torch.tensor(v).to(getattr(torch, dtype)) for k, v in
         tree.items()}
    j = {k: jnp.asarray(v, getattr(jnp, dtype)) for k, v in tree.items()}
    return t, j


def _close(got, want, dtype, rel=REL):
    got, want = _np(got), np.asarray(want, np.float32)
    if dtype == "bfloat16":
        np.testing.assert_allclose(got, want, rtol=BF16_ULP, atol=0)
    else:
        np.testing.assert_allclose(got, want, rtol=rel,
                                   atol=rel * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_jax(dtype, max_norm):
    t, j = _as(_tree(np.random.default_rng(0), dtype), dtype)
    got, norm = clip_by_global_norm(t, max_norm)
    want, jnorm = jax_clip(j, max_norm)
    assert norm.dtype == torch.float32
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=REL)
    for k in t:
        assert got[k].dtype == t[k].dtype
        _close(got[k], want[k], dtype)


def _ndim_rule(params):
    """The JAX package's decay rule on these (unstacked) trees."""
    return {k: p.ndim >= 2 for k, p in params.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(dtype):
    rng = np.random.default_rng(1)
    params, jparams = _as(_tree(rng, dtype), dtype)
    state, jstate = init_opt_state(params), jax_init_opt_state(jparams)
    kw = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=2.0)
    cfg, jcfg = AdamWConfig(**kw), JaxAdamWConfig(**kw)
    for step in range(4):
        g = {k: rng.normal(size=v.shape).astype(np.float32) * (step + 1)
             for k, v in params.items()}
        grads, jgrads = _as(g, dtype)
        same, state, metrics = adamw_update(params, grads, state, cfg,
                                            _ndim_rule(params))
        assert same is params  # in place
        jparams, jstate, jmetrics = jax_adamw_update(jparams, jgrads,
                                                     jstate, jcfg)
        assert int(state["step"]) == int(jstate["step"]) == step + 1
        for key in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(metrics[key]),
                                       float(jmetrics[key]), rtol=REL)
        for k in params:
            assert params[k].dtype == getattr(torch, dtype)
            assert state["m"][k].dtype == state["v"][k].dtype == \
                torch.float32
            _close(params[k], jparams[k], dtype)
            _close(state["m"][k], jstate["m"][k], "float32")
            _close(state["v"][k], jstate["v"][k], "float32")


def test_adamw_reduces_quadratic_schedule_shape_and_clip():
    params = {"w": torch.tensor([5.0, -3.0])}
    state = init_opt_state(params)
    cfg = AdamWConfig(peak_lr=0.1, warmup_steps=5, total_steps=200,
                      weight_decay=0.0, clip_norm=100.0)
    for _ in range(150):
        adamw_update(params, {"w": 2 * params["w"]}, state, cfg,
                     _ndim_rule(params))
    assert float(params["w"].abs().max()) < 0.3
    cfg = AdamWConfig(peak_lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_ratio=0.1)
    assert float(lr_schedule(torch.tensor(0), cfg)) == 0.0
    assert abs(float(lr_schedule(torch.tensor(10), cfg)) - 1.0) < 1e-6
    assert abs(float(lr_schedule(torch.tensor(100), cfg)) - 0.1) < 1e-6
    params = {"w": torch.ones((4, 4))}
    _, _, m = adamw_update(params, {"w": torch.full((4, 4), 100.0)},
                           init_opt_state(params), AdamWConfig(clip_norm=1.0),
                           _ndim_rule(params))
    assert float(m["grad_norm"]) > 1.0  # reported before the clip


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------
def test_compression_matches_jax():
    rng = np.random.default_rng(2)
    g = {"a": rng.normal(size=(1000,)).astype(np.float32),
         "b": (rng.normal(size=(3, 300)) * np.r_[1e-3, 1.0, 50.0][:, None]
               ).astype(np.float32),
         "z": np.zeros((5, 7), np.float32)}
    g["a"][17] = 40.0  # an outlier damages its own block only
    tg, jg = _as(g, "float32")
    st, jst = init_compression_state(tg), jax_comp_init(jg)
    for _ in range(3):  # error feedback carries the residual
        payload, st = compress_gradients(tg, st)
        jpayload, jst = jax_compress(jg, jst)
        for k in g:
            q, s = payload[k]
            jq, js = jpayload[k]
            assert q.dtype == torch.int8 and s.dtype == torch.float32
            np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
            np.testing.assert_array_equal(s.numpy(), np.asarray(js))
            np.testing.assert_allclose(st.residual[k].numpy(),
                                       np.asarray(jst.residual[k]),
                                       rtol=0, atol=1e-7)
        assert wire_bytes(payload) == jax_wire_bytes(jpayload)
    bf = {k: v.to(torch.bfloat16) for k, v in tg.items()}
    out = decompress(payload, bf)
    for k in g:
        assert out[k].dtype == torch.bfloat16 and out[k].shape == bf[k].shape


def test_compression_roundtrip_error_feedback_and_wire_volume():
    rng = np.random.default_rng(0)
    grads = {"w": torch.from_numpy(rng.normal(size=(1000,)).astype(
        np.float32))}
    payload, _ = compress_gradients(grads, init_compression_state(grads))
    assert float((decompress(payload, grads)["w"] - grads["w"]).abs().max()) \
        < 0.05
    g = {"w": torch.linspace(-1, 1, 512)}
    st = init_compression_state(g)
    acc = torch.zeros(512)
    for _ in range(50):
        payload, st = compress_gradients(g, st)
        acc += decompress(payload, g)["w"]
    np.testing.assert_allclose((acc / 50).numpy(), g["w"].numpy(), atol=1e-3)
    z = {"w": torch.zeros(4096)}
    payload, _ = compress_gradients(z, init_compression_state(z))
    assert wire_bytes(payload) < 0.3 * 4096 * 4


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------
ARCH = "tinyllama-1.1b"


class _FromJax(Trainer):
    """The port's trainer started from the JAX package's `Model.init`."""

    def build_model(self, seed):
        cfg = self.model_cfg
        params = jax.jit(JaxModel(jax_reduced(ARCH)).init,
                         static_argnums=0)(seed)
        m = Model(cfg, device=self.device)
        m.load_state_dict(from_jax_params(
            cfg, jax.tree.map(np.asarray, params), self.device))
        return m


@pytest.mark.parametrize("accum,compress", [(1, False), (2, True)])
def test_trainer_matches_jax_trainer(tmp_path, accum, compress):
    kw = dict(vocab_size=256, batch_size=4, seq_len=16, seed=3)
    opt = dict(peak_lr=1e-3, warmup_steps=3, total_steps=10)
    tk = dict(total_steps=10, checkpoint_every=100, log_every=1,
              grad_accum=accum, compress_grads=compress)
    want = JaxTrainer(JaxModel(jax_reduced(ARCH)), JaxAdamWConfig(**opt),
                      JaxTrainerConfig(**tk, checkpoint_dir=str(
                          tmp_path / "jax")),
                      JaxStream(**kw)).run(seed=4)["history"]
    got = _FromJax(get_reduced(ARCH), AdamWConfig(**opt),
                   TrainerConfig(**tk, checkpoint_dir=str(tmp_path / "pt")),
                   SyntheticLMStream(**kw), device="cpu").run(
                       seed=4)["history"]
    assert [h["step"] for h in got] == [h["step"] for h in want] == \
        list(range(1, 11))
    np.testing.assert_allclose(got[0]["loss"], want[0]["loss"], rtol=REL)
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose([h[key] for h in got],
                                   [h[key] for h in want], rtol=LOSS_REL,
                                   err_msg=key)


def test_trainer_loss_decreases_and_recovers_from_failure(tmp_path):
    cfg = get_reduced(ARCH)
    stream = SyntheticLMStream(vocab_size=cfg.vocab_size, batch_size=8,
                               seq_len=32, seed=0, noise=0.05)
    tr = Trainer(cfg, AdamWConfig(peak_lr=3e-3, warmup_steps=10,
                                  total_steps=60),
                 TrainerConfig(total_steps=60, checkpoint_every=20,
                               checkpoint_dir=str(tmp_path), log_every=5),
                 stream, failure_injector=FailureInjector({30: [0]}),
                 device="cpu")
    out = tr.run()
    assert out["recoveries"] == 1
    losses = [h["loss"] for h in out["history"]]
    assert losses[-1] < losses[0] * 0.8, losses
    assert latest_step(str(tmp_path)) == 60
    # the steps 21-30 ran twice: before the failure and after the restore
    # of step 20, the same bits both times
    by_step = {}
    for h in out["history"]:
        by_step.setdefault(h["step"], []).append(h["loss"])
    assert by_step[25][0] == by_step[25][1] and by_step[30][0] == \
        by_step[30][1]


def test_trainer_resume_identical_to_uninterrupted(tmp_path):
    cfg = get_reduced(ARCH)

    def make(dirname, total):
        return Trainer(cfg, AdamWConfig(peak_lr=1e-3, warmup_steps=5,
                                        total_steps=20),
                       TrainerConfig(total_steps=total, checkpoint_every=10,
                                     checkpoint_dir=dirname, log_every=100),
                       SyntheticLMStream(vocab_size=cfg.vocab_size,
                                         batch_size=4, seq_len=16, seed=3),
                       device="cpu")

    a = make(str(tmp_path / "a"), 20).run(seed=7)
    make(str(tmp_path / "b"), 10).run(seed=7)  # the first 10 steps
    b = make(str(tmp_path / "b"), 20).run(seed=7)  # resumes at step 10
    for k, wa in a["state"]["params"].items():
        assert torch.equal(wa, b["state"]["params"][k]), k
    for k in a["state"]["opt"]["m"]:
        assert torch.equal(a["state"]["opt"]["m"][k],
                           b["state"]["opt"]["m"][k]), k
    assert int(b["state"]["opt"]["step"]) == 20


def test_trainer_needs_a_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = get_reduced(ARCH)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg, AdamWConfig(), TrainerConfig(),
                SyntheticLMStream(vocab_size=cfg.vocab_size, batch_size=2,
                                  seq_len=8))
