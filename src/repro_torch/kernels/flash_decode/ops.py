"""Single-token decode attention over a KV cache: `decode_attention`
launches a split-K CUDA kernel (`csrc/flash_decode.cu`: `fd_sm90`, tensor
cores over a TMA-fed cache stream, for bfloat16; `fd_split`, SIMT, for
float32) for a CUDA tensor and runs the plain version (`ref.py`) for a CPU
tensor."""
from __future__ import annotations

import functools
import operator

import torch

from .. import _lib
from .ref import decode_attention_ref, decode_shapes

HEAD_DIMS = (32, 64, 128)
GROUP = 8           # query heads a float32 block serves (csrc's kGroupMax)
GROUP_SM90 = 16     # query heads a bf16 block serves (mma's 16 rows)
BLOCKS_PER_SM = 16  # split T until the grid holds about this many blocks
MIN_SPLIT = 512     # positions a split reads at least
_MAX_GRID_YZ = 65535


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def heads_per_block(KV: int, G: int) -> int:
    """KV heads a bf16 block serves (csrc's KH): 4 or 2 where they divide
    KV and the G query heads of a KV head fit one block's 16 rows, so one
    TMA box reads the neighbouring heads' rows of a position together;
    else 1."""
    if G > GROUP_SM90:
        return 1
    return next(kh for kh in (4, 2, 1) if KV % kh == 0)


def num_splits(B: int, KV: int, G: int, T: int, sms: int,
               group: int = GROUP) -> int:
    """How many blocks share one (batch row, KV head, group of up to
    `group` query heads) along T: enough for BLOCKS_PER_SM blocks an SM,
    with splits of at least MIN_SPLIT positions."""
    blocks = B * KV * -(-G // group)
    want = -(-BLOCKS_PER_SM * sms // blocks)
    return max(1, min(want, -(-T // MIN_SPLIT)))


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length) -> torch.Tensor:
    """q: (B, H, hd); k/v_cache: (B, T, KV, hd) with H % KV == 0; length:
    the valid prefix, a Python int or a 0-d integer tensor (on the card it
    is read there, with no host sync). Returns (B, H, hd) in q's dtype;
    query head h reads KV head h // (H // KV), positions >= length score
    -2.0e38. On the card q and the caches must be contiguous float32 or
    bfloat16 of one dtype, 16-byte aligned, with hd in {32, 64, 128}:
    bfloat16 launches the tensor-core kernel (counted as
    "flash_decode_sm90"), float32 the SIMT one ("flash_decode")."""
    B, H, hd, T, KV, G = decode_shapes(q, k_cache, v_cache)
    if not _lib.on_cuda(q):
        return decode_attention_ref(q, k_cache, v_cache, length)
    dev = q.device
    dtypes = (torch.float32, torch.bfloat16)
    _lib.require(q, "q", dtypes, 3, dev)
    _lib.require(k_cache, "k_cache", (q.dtype,), 4, dev)
    _lib.require(v_cache, "v_cache", (q.dtype,), 4, dev)
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} is not one of {HEAD_DIMS}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    bf16 = q.dtype == torch.bfloat16
    group = GROUP_SM90 if bf16 else GROUP
    if B > _MAX_GRID_YZ or KV * -(-G // group) > _MAX_GRID_YZ:
        raise ValueError(f"B={B}, KV={KV} exceed the kernel's grid")
    if B * T * KV * hd >= 2**62:
        raise ValueError("cache too large for the kernel's offsets")
    len_ptr, len_val = None, 0
    if isinstance(length, torch.Tensor):
        if length.numel() != 1 or length.dtype.is_floating_point or \
                length.dtype.is_complex or length.dtype == torch.bool:
            raise ValueError("length must be an integer scalar, got a "
                             f"{length.dtype} tensor of shape "
                             f"{tuple(length.shape)}")
        if length.device == dev:
            length = length.reshape(()).to(torch.int64)  # stays on the card
            len_ptr = length.data_ptr()
        elif length.device.type == "cpu":
            len_val = int(length)
        else:
            raise ValueError(f"length is on {length.device}, q on {dev}")
    else:
        len_val = operator.index(length)
    len_val = max(min(len_val, 2**62), -1)
    out = torch.empty((B, H, hd), dtype=q.dtype, device=dev)
    if B == 0:
        return out
    kh = heads_per_block(KV, G) if bf16 else 1
    splits = num_splits(B, KV // kh, G, T, _sm_count(dev.index or 0), group)
    split_len = -(-T // splits)
    part_ml = torch.empty((B * H, splits, 2), dtype=torch.float32,
                          device=dev)
    part_acc = torch.empty((B * H, splits, hd), dtype=torch.float32,
                           device=dev)
    name = "flash_decode_sm90" if bf16 else "flash_decode"
    args = (dev.index or 0, q.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), len_ptr, len_val, B, T, KV, G, hd)
    tail = (splits, split_len, hd ** -0.5, part_ml.data_ptr(),
            part_acc.data_ptr(), out.data_ptr(), _lib.stream(q))
    rc = (_lib.load().tdorch_flash_decode_sm90(*args, kh, *tail) if bf16
          else _lib.load().tdorch_flash_decode(*args, *tail))
    _lib.check(rc, name)

    def work():  # the valid prefix of the caches (all of them if <= 0)
        n = int(length) if len_ptr is not None else len_val
        n = T if n <= 0 else min(n, T)
        kv = 2 * B * n * KV * hd * k_cache.element_size()
        return 4 * B * H * n * hd, _lib.nbytes(q, out) + kv
    _lib.count(name, work)
    return out
