"""The architectures the repo configures, a copy of the JAX package's
`configs` (pure Python, no weights). Each module exposes CONFIG (the
published widths) and reduced() (a CPU test size of the same family).
The port reads its kernels' widths from here (`chip_smoke.py`'s attention
and SSM path)."""
from importlib import import_module

ARCHS = [
    "glm4_9b",
    "internlm2_20b",
    "tinyllama_1_1b",
    "command_r_35b",
    "zamba2_1_2b",
    "granite_moe_1b_a400m",
    "granite_moe_3b_a800m",
    "qwen2_vl_72b",
    "musicgen_large",
    "xlstm_350m",
]

# CLI ids (--arch <id>) -> module names
ARCH_IDS = {
    "glm4-9b": "glm4_9b",
    "internlm2-20b": "internlm2_20b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "command-r-35b": "command_r_35b",
    "zamba2-1.2b": "zamba2_1_2b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "musicgen-large": "musicgen_large",
    "xlstm-350m": "xlstm_350m",
}


def get_config(arch_id: str):
    mod = import_module(f".{ARCH_IDS[arch_id]}", __package__)
    return mod.CONFIG


def get_reduced(arch_id: str):
    mod = import_module(f".{ARCH_IDS[arch_id]}", __package__)
    return mod.reduced()


def all_arch_ids():
    return list(ARCH_IDS)
