"""The port's copy of the model configs (`repro_torch.configs`,
`repro_torch.models.config`) against the JAX package's: every arch id gives
the same fields (`dataclasses.asdict`) and the same parameter counts, full
size and reduced. The configs are pure Python; the port keeps its own copy
so that it never imports the JAX package."""
import dataclasses

import pytest

import repro.configs as jax_configs
import repro_torch.configs as port_configs
from repro_torch import models

ARCH_IDS = jax_configs.all_arch_ids()


def test_arch_ids_match():
    assert port_configs.all_arch_ids() == ARCH_IDS
    assert port_configs.ARCH_IDS == jax_configs.ARCH_IDS
    assert port_configs.ARCHS == jax_configs.ARCHS


@pytest.mark.parametrize("getter", ["get_config", "get_reduced"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_matches_jax(arch, getter):
    want = getattr(jax_configs, getter)(arch)
    got = getattr(port_configs, getter)(arch)
    assert type(got).__module__ == "repro_torch.models.config"
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()
    assert (got.q_dim, got.kv_dim) == (want.q_dim, want.kv_dim)


def test_models_exports_only_the_config_classes():
    """The config classes, and since the model stack was ported `Model`:
    the JAX package's `repro.models` exports."""
    assert sorted(n for n in dir(models) if not n.startswith("_")
                  and n[0].isupper()) == ["MoEConfig", "Model",
                                          "ModelConfig", "SSMConfig",
                                          "XLSTMConfig"]


def test_widths_the_attention_and_ssm_path_reads():
    """The widths chip_smoke.py's attention and SSM path takes from the
    configs: zamba2's Mamba2 (nh = 2 * 2048 / 64 = 64 heads of 64, d_state
    64, chunk 128) and shared MHA, tinyllama's GQA 8:1 and command-r's
    head_dim 128."""
    z = port_configs.get_config("zamba2-1.2b")
    assert (z.ssm.expand * z.d_model // z.ssm.head_dim, z.ssm.head_dim,
            z.ssm.d_state, z.ssm.chunk) == (64, 64, 64, 128)
    assert (z.n_heads, z.n_kv_heads, z.head_dim) == (32, 32, 64)
    t = port_configs.get_config("tinyllama-1.1b")
    assert (t.n_heads, t.n_kv_heads, t.head_dim) == (32, 4, 64)
    c = port_configs.get_config("command-r-35b")
    assert (c.n_heads, c.n_kv_heads, c.head_dim) == (64, 8, 128)
