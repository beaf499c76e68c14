"""The port's serving launcher (`repro_torch.launch.serve`, `.specs`) held
against the JAX package's `repro.launch`, in one process.

`generate` on the reduced configs of the dense, parallel, moe, zamba2 and
xlstm patterns, with the JAX `Model.init` parameters carried by
`from_jax_params`, must give the JAX `generate`'s greedy tokens, token for
token, for 8 steps. A near-tie could flip a token between two correct
implementations, so the test first asserts that at every step the top two
logits lie further apart than twice the logit tolerance of
tests/test_torch_models.py (LOGIT_TOL·(1 + |top|) each). Temperature
sampling draws from an explicit `torch.Generator`: the same seed gives the
same tokens. `SHAPES` and `shape_applicable` equal the JAX package's;
`main()` serves a reduced config on the CPU (zamba2, granite-moe, xlstm).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_arch_ids as jax_arch_ids
from repro.configs import get_config as jax_config
from repro.configs import get_reduced as jax_reduced
from repro.launch import serve as jserve
from repro.launch import specs as jspecs
from repro.models import Model as JaxModel
from repro_torch import kernels
from repro_torch.configs import get_config, get_reduced
from repro_torch.launch import serve, specs
from repro_torch.models import Model, from_jax_params

torch.set_num_threads(1)

LOGIT_TOL = 1e-4  # tests/test_torch_models.py's whole-model tolerance
GEN = 8
ARCHS = ["glm4-9b", "internlm2-20b", "tinyllama-1.1b", "command-r-35b",
         "zamba2-1.2b", "qwen2-vl-72b", "musicgen-large",
         "granite-moe-1b-a400m", "granite-moe-3b-a800m", "xlstm-350m"]


@pytest.fixture(autouse=True)
def no_kernel_launch():
    kernels.reset_launches()
    yield
    assert kernels.launches() == {k: 0 for k in kernels.KERNELS}


@functools.lru_cache(maxsize=None)
def _models(arch):
    jm = JaxModel(jax_reduced(arch))
    params = jm.init(seed=5)
    cfg = get_reduced(arch)
    m = Model(cfg, device="cpu")
    m.load_state_dict(from_jax_params(cfg, jax.tree.map(np.asarray, params),
                                      "cpu"), strict=True)
    return jm, params, m


def _prompts(cfg, B=2, S=16, seed=7):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _teacher_forced_logits(m, seq, S):
    """The port's logits at each of the GEN steps that chose seq[:, S:]."""
    logits, caches = m.prefill(tokens=seq[:, :S], max_len=S + GEN)
    out = [logits[:, -1]]
    for i in range(GEN - 1):
        logits, caches = m.decode_step(caches, tokens=seq[:, S + i:S + i + 1],
                                       cache_pos=S + i)
        out.append(logits[:, -1])
    return torch.stack(out, dim=1)  # (B, GEN, V)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_jax(arch):
    jm, params, m = _models(arch)
    prompts = _prompts(m.cfg)
    want = np.asarray(jserve.generate(jm, params, jnp.asarray(prompts), GEN))
    got = serve.generate(m, torch.from_numpy(prompts), GEN)
    assert got.dtype == torch.int32 and got.shape == (2, 16 + GEN)
    # no step is a near-tie that the tolerance could flip
    seq = torch.from_numpy(want.copy())
    top2 = _teacher_forced_logits(m, seq, 16).topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    allowed = 2 * LOGIT_TOL * (1 + top2[..., 0].abs())
    assert bool((margin > allowed).all()), (margin - allowed).min()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "zamba2-1.2b"])
def test_temperature_sampling_draws_from_its_generator(arch):
    _, _, m = _models(arch)
    prompts = torch.from_numpy(_prompts(m.cfg))

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return serve.generate(m, prompts, GEN, temperature=0.8, generator=g)

    a, b = run(11), run(11)
    assert torch.equal(a, b)
    assert torch.equal(a[:, :16], prompts)
    assert int(a.min()) >= 0 and int(a.max()) < m.cfg.vocab_size
    assert not all(torch.equal(a, run(s)) for s in (12, 13, 14))
    # no generator: one seeded 0 on the model's device
    assert torch.equal(serve.generate(m, prompts, GEN, temperature=0.8),
                       run(0))


def test_shapes_match_jax():
    assert specs.SHAPES == jspecs.SHAPES
    for arch in jax_arch_ids():
        for shape in jspecs.SHAPES:
            assert specs.shape_applicable(get_config(arch), shape) == \
                jspecs.shape_applicable(jax_config(arch), shape), \
                (arch, shape)


def test_main_serves_the_reduced_config_on_the_cpu(capsys):
    serve.main(["--arch", "zamba2-1.2b", "--batch", "2", "--prompt-len", "8",
                "--gen", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "generated 2×4 tokens" in out and "on cpu" in out
    with pytest.raises(SystemExit, match="embeddings"):
        serve.main(["--arch", "musicgen-large", "--device", "cpu"])


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "xlstm-350m"])
def test_main_serves_the_moe_and_xlstm_patterns_on_the_cpu(arch, capsys):
    serve.main(["--arch", arch, "--batch", "2", "--prompt-len", "16",
                "--gen", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "generated 2×4 tokens" in out and "on cpu" in out


def test_model_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(get_reduced("tinyllama-1.1b"))
