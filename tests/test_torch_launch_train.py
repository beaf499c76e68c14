"""The port's training launcher (`repro_torch.launch.train`) against the JAX
package's (`repro.launch.train`): the same flags with the same defaults,
types and choices, plus `--device` (the CUDA card unless the caller names
another device), but for `--ckpt-dir`, which defaults to a fresh directory
in place of the JAX launcher's fixed path (a run resumes from the newest
checkpoint in its directory); two steps of the reduced granite-moe-1b-a400m
config (the default arch) on the CPU end with finite losses, `--full` takes
the full config, and the card refuses the reduced config's head dims before
anything is built."""
import argparse
import json
import math
import os

import pytest
import torch

import repro.launch.train as jax_train
from repro_torch.launch import train
from repro_torch.models.model import resolve_device

# one intra-op thread per test process: the suite runs in parallel workers
torch.set_num_threads(1)


class _Parsed(Exception):
    pass


def _jax_parser(monkeypatch) -> argparse.ArgumentParser:
    """The JAX launcher's parser, caught where its `main` parses."""
    seen = {}

    def parse_args(self, args=None, namespace=None):
        seen["parser"] = self
        raise _Parsed

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", parse_args)
        with pytest.raises(_Parsed):
            jax_train.main()
    return seen["parser"]


def _flags(parser: argparse.ArgumentParser) -> dict:
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices,
                     a.nargs, type(a).__name__)
            for a in parser._actions if a.dest != "help"}


def test_flags_and_defaults_match_the_jax_launcher(monkeypatch):
    want = _flags(_jax_parser(monkeypatch))
    got = _flags(train.build_parser())
    assert set(got) - set(want) == {"device"}
    assert set(want) <= set(got)
    for dest, spec in want.items():
        if dest == "ckpt_dir":  # the default apart: a fresh directory
            assert got[dest][1] is None
            assert got[dest][:1] + got[dest][2:] == spec[:1] + spec[2:]
            continue
        assert got[dest] == spec, dest
    assert got["arch"][1] == "granite-moe-1b-a400m"


def test_device_defaults_to_cuda(monkeypatch):
    """No `--device`: the trainer gets None, which means the CUDA card (it
    raises without one, naming the CPU as the way out)."""
    assert train.build_parser().parse_args([]).device is None
    seen = {}

    class Recorder:
        def __init__(self, *a, device=None, **kw):
            seen["device"] = device
            raise _Parsed

    monkeypatch.setattr(train, "Trainer", Recorder)
    with pytest.raises(_Parsed):
        train.main(["--steps", "1", "--full"])
    assert seen["device"] is None
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA device"):
            resolve_device(None)


def test_two_steps_of_the_reduced_granite_config_on_the_cpu(tmp_path):
    out_json = tmp_path / "history.json"
    out = train.main(["--steps", "2", "--device", "cpu", "--ckpt-dir",
                      str(tmp_path / "ckpt"), "--out", str(out_json)])
    assert int(out["state"]["opt"]["step"]) == 2
    history = json.loads(out_json.read_text())
    assert history and history == out["history"]
    for h in history:
        assert math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
    assert out["recoveries"] == 0
    params = out["state"]["params"]
    assert params["blocks.0.moe.w_in"].shape == (8, 64, 128)  # reduced


def test_full_takes_the_full_config(monkeypatch):
    """`--full`: the full config (24 layers, 32 experts) on the one device,
    where the JAX launcher would bind a pod's mesh."""
    seen = {}

    class Recorder:
        def __init__(self, cfg, *a, device=None, **kw):
            seen["cfg"], seen["device"] = cfg, device
            raise _Parsed

    monkeypatch.setattr(train, "Trainer", Recorder)
    with pytest.raises(_Parsed):
        train.main(["--full", "--device", "cpu"])
    assert seen["cfg"].n_layers == 24 and seen["cfg"].moe.num_experts == 32
    assert seen["device"] == "cpu"


@pytest.mark.parametrize("argv", [[], ["--device", "cuda"],
                                  ["--arch", "tinyllama-1.1b"]])
def test_the_card_refuses_the_reduced_head_dims(monkeypatch, argv):
    """On the card the reduced configs' head dims (8, 16) are below the
    attention kernel's: the launcher says so, naming `--full` and the CPU,
    before it builds a trainer."""
    def never(*a, **kw):
        raise AssertionError("a trainer was built")

    monkeypatch.setattr(train, "Trainer", never)
    with pytest.raises(SystemExit, match="--full.*--device cpu"):
        train.main(argv)


def test_checkpoints_go_to_a_fresh_directory(monkeypatch, tmp_path):
    """No `--ckpt-dir`: each run gets a new directory under the temporary
    directory, so it never resumes from another run's checkpoint."""
    monkeypatch.setattr(train.tempfile, "tempdir", str(tmp_path))
    dirs = []

    class Recorder:
        def __init__(self, cfg, opt_cfg, tr_cfg, *a, **kw):
            dirs.append(tr_cfg.checkpoint_dir)
            raise _Parsed

    monkeypatch.setattr(train, "Trainer", Recorder)
    for _ in range(2):
        with pytest.raises(_Parsed):
            train.main(["--steps", "1", "--device", "cpu"])
    assert len(set(dirs)) == 2
    for d in dirs:
        assert os.path.dirname(d) == str(tmp_path) and os.listdir(d) == []
    with pytest.raises(_Parsed):
        train.main(["--device", "cpu", "--ckpt-dir", str(tmp_path / "c")])
    assert dirs[-1] == str(tmp_path / "c")
