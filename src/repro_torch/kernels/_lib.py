"""Build, load and launch the hand-written CUDA kernels (`../csrc/*.cu`).

The kernels have a plain C interface and are bound with `ctypes`: `nvcc`
compiles every source for Hopper (``sm_90a``) into one shared library at
first use, keyed by a hash of the sources and flags, under `../_build/`
(listed in `.gitignore`). Each source compiles in its own `nvcc` process,
all started together; nothing is built when a module is imported, so the
package imports on machines without the CUDA toolkit.

Every wrapper in `kernels/*/ops.py` checks its tensors here, launches on
torch's current stream, raises if the C entry point reports a CUDA error,
and adds one to its kernel's launch count (`launches()`), so a run can show
that its main path went through the kernels. Each launch also names its
work: the operations the kernel does on its inputs and the bytes it must
move (every tensor it is handed read or written once), which
`record_work()` collects for the roofline (`launch/roofline.py`): the
kernels launch through `ctypes`, where no dispatch mode sees them.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_ROOT = PACKAGE / "_build"
SOURCES = ("errors.cu", "histogram.cu", "segment_combine.cu",
           "stage_fused.cu", "moe_gemm.cu", "moe_gemm_bwd.cu",
           "flash_attention_tf32.cu",
           "flash_attention_sm90.cu", "flash_attention_bwd_tf32_sm90.cu",
           "flash_attention_bwd_sm90.cu", "flash_decode.cu", "mamba_scan.cu",
           "mamba_scan_bwd.cu", "mamba_scan_bwd_sm90.cu")
HEADERS = ("sm90.cuh",)  # included by the sources; part of the build's key
LIBRARY = "libtdorch_kernels.so"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
FLAGS = ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

KERNELS = ("histogram", "segment_combine", "stage_fused", "moe_gemm",
           "moe_gemm_sm90", "moe_gemm_bf16", "moe_gemm_dx",
           "moe_gemm_dx_sm90", "moe_gemm_dx_bf16", "moe_gemm_dw",
           "moe_gemm_dw_sm90", "moe_gemm_dw_bf16", "flash_attention_tf32",
           "flash_attention_sm90", "flash_attention_bwd_tf32",
           "flash_attention_bwd_bf16", "flash_decode", "flash_decode_sm90",
           "mamba_scan", "mamba_scan_bwd", "mamba_scan_bwd_mma")
_LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
Work = Callable[[], Tuple[float, float]]  # () -> (operations, bytes)
_RECORD: Optional[List[Tuple[str, float, float]]] = None


def launches() -> Dict[str, int]:
    """Launches per kernel since the last `reset_launches()`."""
    return dict(_LAUNCHES)


def reset_launches() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def count(name: str, work: Optional[Work] = None) -> None:
    """One launch of kernel `name`; `work` gives its (operations, bytes),
    called only inside `record_work()` (a count may read the card)."""
    _LAUNCHES[name] += 1
    if _RECORD is not None:
        if work is None:
            raise RuntimeError(f"kernel {name!r} names no work")
        _RECORD.append((name, *work()))


@contextlib.contextmanager
def record_work():
    """Collect (name, operations, bytes) for every launch inside;
    `work_of` sums them."""
    global _RECORD
    outer, _RECORD = _RECORD, []
    try:
        yield _RECORD
    finally:
        _RECORD = outer


def work_of(recorded) -> Tuple[float, float]:
    """(operations, bytes) summed over `record_work()`'s launches."""
    return (float(sum(r[1] for r in recorded)),
            float(sum(r[2] for r in recorded)))


def nbytes(*tensors: Optional[torch.Tensor]) -> int:
    """The bytes of the tensors given (None skipped)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    """Where the library for the current sources lives (or will)."""
    return BUILD_ROOT / _digest()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME  # finds the toolkit

    if CUDA_HOME is None or not (Path(CUDA_HOME) / "bin" / "nvcc").is_file():
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are compiled with the CUDA "
            "toolkit's nvcc (set CUDA_HOME to the toolkit)")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build() -> Path:
    """Compile the kernel library if the current sources have not been
    built yet; return its path. The compiler's output (with ``-Xptxas=-v``:
    registers, shared memory and spills per kernel) is kept beside the
    library as `nvcc.log`."""
    out_dir = build_dir()
    lib = out_dir / LIBRARY
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        jobs = []
        for name in SOURCES:
            obj = Path(tmp) / f"{name}.o"
            cmd = [nvcc, *FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
            jobs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log = []
        for name, _, proc in jobs:
            out, _ = proc.communicate()
            log.append(f"== {name}\n{out}")
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        staged = Path(tmp) / LIBRARY
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", *(str(o) for _, o, _ in jobs),
             "-o", str(staged)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed to link {LIBRARY}:\n"
                               f"{link.stdout}")
        (out_dir / "nvcc.log").write_text("\n".join(log))
        os.replace(staged, lib)  # atomic: a concurrent loader sees all or none
    return lib


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with every entry point's
    argument and result types declared."""
    lib = ctypes.CDLL(str(build()))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    f32 = ctypes.c_float
    sig = {
        "tdorch_histogram": [i32, ptr, ptr, i64, i32, i32, i32, ptr, ptr],
        "tdorch_histogram_limits": [i32, ptr],
        "tdorch_segment_combine": [i32, ptr, i32, ptr, i64, i32, i32, i32,
                                   ptr, ptr],
        "tdorch_segment_write": [i32, ptr, i32, ptr, ptr, i64, i32, i32,
                                 ptr, ptr, ptr],
        "tdorch_fused_reduce": [i32, ptr, i32, i32, ptr, ptr, i64, i32, i32,
                                i32, i32, i32, ptr, ptr],
        "tdorch_grouped_gemm": [i32, ptr, ptr, i64, i64, ptr, i32, i32,
                                i32, i32, i32, i32, i32, ptr, ptr, ptr],
        "tdorch_grouped_gemm_bf16": [i32, ptr, ptr, i64, i64, ptr, i32, i32,
                                     i32, i32, i32, i32, i32, ptr, ptr, ptr],
        "tdorch_grouped_gemm_sm90": [i32, ptr, ptr, i64, i64, ptr, i32, i32,
                                     i32, i32, i32, i32, ptr, ptr, ptr],
        # dx = dy · wᵀ: the forward's arguments, with dy for x, the depth N
        # and the output's width K
        "tdorch_grouped_gemm_dx": [i32, ptr, ptr, i64, i64, ptr, i32, i32,
                                   i32, i32, i32, i32, i32, ptr, ptr, ptr],
        "tdorch_grouped_gemm_dx_bf16": [i32, ptr, ptr, i64, i64, ptr, i32,
                                        i32, i32, i32, i32, i32, i32, ptr,
                                        ptr, ptr],
        "tdorch_grouped_gemm_dx_sm90": [i32, ptr, ptr, i64, i64, ptr, i32,
                                        i32, i32, i32, i32, i32, ptr, ptr,
                                        ptr],
        # dw: device, x, dy, sizes, M, K, N, G, the walk's chunk_rows,
        # max_chunks, blocks and max_split, [vec16,] plan, workspace, dw,
        # stream
        "tdorch_grouped_gemm_dw": [i32, ptr, ptr, ptr, *[i32] * 9, ptr, ptr,
                                   ptr, ptr],
        "tdorch_grouped_gemm_dw_bf16": [i32, ptr, ptr, ptr, *[i32] * 9, ptr,
                                        ptr, ptr, ptr],
        "tdorch_grouped_gemm_dw_sm90": [i32, ptr, ptr, ptr, *[i32] * 8, ptr,
                                        ptr, ptr, ptr],
        "tdorch_flash_attention_tf32": [i32, ptr, ptr, ptr, i32, i32, i32,
                                        i32, i32, i32, f32, i32, ptr, ptr,
                                        ptr],
        "tdorch_flash_attention_sm90": [i32, ptr, ptr, ptr, i32, i32, i32,
                                        i32, i32, i32, f32, i32, ptr, ptr,
                                        ptr],
        # ..., D, k_lo, v_lo (scratch), dq, dk, dv, stream
        "tdorch_flash_attention_bwd_tf32": [i32, ptr, ptr, ptr, ptr, ptr,
                                            ptr, i32, i32, i32, i32, i32,
                                            i32, f32, i32, ptr, ptr, ptr,
                                            ptr, ptr, ptr, ptr],
        "tdorch_flash_attention_bwd_bf16": [i32, ptr, ptr, ptr, ptr, ptr,
                                            ptr, i32, i32, i32, i32, i32,
                                            i32, f32, i32, ptr, ptr, ptr,
                                            ptr, ptr],
        "tdorch_flash_decode": [i32, ptr, ptr, ptr, ptr, i64, i32, i32, i32,
                                i32, i32, i32, i32, f32, ptr, ptr, ptr, ptr],
        "tdorch_flash_decode_sm90": [i32, ptr, ptr, ptr, ptr, i64, i32, i32,
                                     i32, i32, i32, i32, i32, i32, f32, ptr,
                                     ptr, ptr, ptr],
        "tdorch_ssd_scan": [i32, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32,
                            i32, i32, i32, ptr, ptr, ptr, ptr, ptr],
        # x, dt, A, Bc, Cc, dy, dh_final, states, l; B, S, nh, hd, ds,
        # chunk; grads (scratch), dx, ddt, dB / dC / dA partials, stream
        "tdorch_ssd_scan_bwd": [i32, *[ptr] * 9, *[i32] * 7, *[ptr] * 7],
        "tdorch_ssd_scan_bwd_sm90": [i32, *[ptr] * 9, *[i32] * 7,
                                     *[ptr] * 7],
    }
    for name, argtypes in sig.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = i32
    lib.tdorch_error_string.argtypes = [i32]
    lib.tdorch_error_string.restype = ctypes.c_char_p
    return lib


def check(rc: int, kernel: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if rc != 0:
        msg = load().tdorch_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {kernel!r} failed: {msg} "
                           f"(cudaError {rc})")


def stream(t: torch.Tensor) -> ctypes.c_void_p:
    """torch's current stream on `t`'s device, as a C pointer (the raw
    handle, without building a `torch.cuda.Stream` on every launch)."""
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(t.device.index))


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def require(t: torch.Tensor, name: str, dtypes, ndim: int,
            device: torch.device, *, dense_rows: bool = False) -> None:
    """The checks every wrapper makes before handing a pointer to CUDA.
    With `dense_rows` only the last dimension must be dense: the kernel
    takes the other strides (a view into wider rows)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}, expected one of "
                         f"{tuple(dtypes)}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if dense_rows:
        if (t.shape[-1] > 1 and t.stride(-1) != 1) or min(t.stride()) < 0:
            raise ValueError(f"{name} must have dense rows (last stride 1)")
    elif not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); anything else is refused."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain path for device {t.device}")
