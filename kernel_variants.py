"""Patched copies of one CUDA source of `src/repro_torch/csrc/`, each built
into a library of its own, for the scripts that time a kernel's design
variants side by side on one NVIDIA GPU (`gg_sm90_variants.py`,
`flash_bwd_variants.py`).

A variant is the source with one piece of text replaced, or a list of
such (old, new) pairs (None: the source as it is). Every copy is
compiled by nvcc for sm_90a with `-Xptxas=-v`, one
process a variant, all started together, beside `sm90.cuh` and `errors.cu`
(the error strings). Needs the CUDA toolkit; imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "src" / "repro_torch" / "csrc"


def build(tmp: Path, source: str, variants: dict, entry: str,
          argtypes: list) -> tuple:
    """({variant: its C entry `entry` as a ctypes function returning int},
    {variant: the path of its nvcc log}) for the copies of `source` under
    `tmp`."""
    from repro_torch.kernels import _lib

    nvcc = _lib._nvcc()
    text = (CSRC / source).read_text()
    procs = {}
    for name, patch in variants.items():
        src = text
        pairs = [] if patch is None else (
            patch if isinstance(patch, list) else [patch])
        for old, new in pairs:
            if old not in src:
                raise RuntimeError(f"{name}: {old!r} not in {source}")
            src = src.replace(old, new)
        d = tmp / name
        d.mkdir()
        (d / source).write_text(src)
        for f in ("sm90.cuh", "errors.cu"):
            (d / f).write_text((CSRC / f).read_text())
        procs[name] = subprocess.Popen(
            [nvcc, *_lib.ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
             "-Xptxas=-v", "-shared", str(d / source), str(d / "errors.cu"),
             "-o", str(d / "lib.so")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs, logs = {}, {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{out}")
        logs[name] = tmp / name / "nvcc.log"
        logs[name].write_text(out)
        fn = getattr(ctypes.CDLL(str(tmp / name / "lib.so")), entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs, logs
