"""CUDA kernel wrapper: GQA decode attention over a KV-cache prefix.

The decode path's attention: one query token per batch row against the
first ``length`` slots of its cache.  The kernel is ``csrc/gqa_decode.cu``;
its header says what bounds it on an H100 and how its design serves that.

The wrapper launches the kernel on CUDA tensors and raises on anything
else; ``ops.gqa_decode`` is the entry point that takes the plain version
for CPU tensors.  ``gqa_decode_cuda.launches`` counts launches.
``split_plan`` is how the kernel cuts each row's cache over blocks.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CHUNK_TILE = 64    # slots: a chunk is whole tiles of the kernel's ring
MAX_CHUNKS = 8     # chunks of one (batch row, KV head): one cluster


@functools.cache
def _lib():
    """The kernel's library, built on first use, with its launcher's C
    signature declared."""
    lib = _build.load("gqa_decode")
    fn = lib.gqa_decode
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    return lib


@functools.cache
def split_plan(b: int, kv: int, s: int, sms: int) -> tuple:
    """(chunk_len, chunks): the kernel cuts [0, S) of every (batch row, KV
    head) into ``chunks`` chunks of ``chunk_len`` slots, one block each and
    one cluster per (row, head).  Chunks are whole ``CHUNK_TILE``s, at most
    ``MAX_CHUNKS``, and as many as it takes for two blocks per SM where S
    has the tiles; the last chunk is the only short one and none is empty.
    The lengths are on the device, so the plan depends on shapes alone."""
    tiles = -(-s // CHUNK_TILE)
    want = -(-2 * sms // max(1, b * kv))
    per = -(-tiles // max(1, min(MAX_CHUNKS, tiles, want)))
    return per * CHUNK_TILE, -(-tiles // per)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def check_head_dim(d: int, what: str) -> None:
    """The kernels take any head dim that is a multiple of 8 up to 256."""
    if d % 8 or not 8 <= d <= 256:
        raise ValueError(f"{what}: head dim {d} is not a multiple of 8 in "
                         "[8, 256]")


def gqa_decode_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    length: torch.Tensor) -> torch.Tensor:
    """q f[B, H, D]; k, v f[B, S, KV, D]; length i32[B] -> f[B, H, D].
    f32 or bf16 (one type for q, k, v); any S; H % KV == 0."""
    dev = q.device
    if (dev.type != "cuda" or k.device != dev or v.device != dev
            or length.device != dev):
        raise ValueError("gqa_decode_cuda: all tensors must be on one CUDA "
                         "device")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("gqa_decode_cuda: q, k, v must all be float32 or "
                         f"all bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if length.dtype != torch.int32:
        raise ValueError(f"gqa_decode_cuda: length must be int32, got "
                         f"{length.dtype}")
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("gqa_decode_cuda: expected q[B, H, D] and "
                         "k, v[B, S, KV, D]")
    b, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    if (k.shape[0] != b or k.shape[3] != d or kv == 0 or h % kv
            or length.shape != (b,)):
        raise ValueError(f"gqa_decode_cuda: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} length{tuple(length.shape)} "
                         "do not fit together")
    check_head_dim(d, "gqa_decode_cuda")
    if not q.is_contiguous():
        q = q.contiguous()
    if not length.is_contiguous():
        length = length.contiguous()
    # K and V arrive by 16-byte copies: contiguous, from an aligned start
    if not k.is_contiguous() or k.data_ptr() % 16:
        k = k.clone(memory_format=torch.contiguous_format)
    if not v.is_contiguous() or v.data_ptr() % 16:
        v = v.clone(memory_format=torch.contiguous_format)
    chunk_len, chunks = split_plan(b, kv, s, _sm_count(dev.index))
    out = torch.empty_like(q)
    lib = _lib()
    c_args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(),
              out.data_ptr(), b, s, h, kv, d, DTYPES[q.dtype], chunk_len,
              chunks, torch.cuda.current_stream(dev).cuda_stream)
    if dev.index == torch.cuda.current_device():
        err = lib.gqa_decode(*c_args)
    else:
        with torch.cuda.device(dev):
            err = lib.gqa_decode(*c_args)
    _build.check(lib, err, "gqa_decode")
    gqa_decode_cuda.launches += 1
    return out


gqa_decode_cuda.launches = 0
