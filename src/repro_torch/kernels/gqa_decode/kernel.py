"""CUDA kernel wrapper: GQA decode attention over a KV-cache prefix.

The decode path's attention: one query token per batch row against the
first ``length`` slots of its cache.  The kernel is ``csrc/gqa_decode.cu``;
its header says what bounds it on an H100 and how its design serves that.

The wrapper launches the kernel on CUDA tensors and raises on anything
else; ``ops.gqa_decode`` is the entry point that takes the plain version
for CPU tensors.  ``gqa_decode_cuda.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib():
    """The kernel's library, built on first use, with its launcher's C
    signature declared."""
    lib = _build.load("gqa_decode")
    fn = lib.gqa_decode
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    return lib


def check_head_dim(d: int, what: str) -> None:
    """The kernels take any head dim that is a multiple of 8 up to 256."""
    if d % 8 or not 8 <= d <= 256:
        raise ValueError(f"{what}: head dim {d} is not a multiple of 8 in "
                         "[8, 256]")


def gqa_decode_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    length: torch.Tensor) -> torch.Tensor:
    """q f[B, H, D]; k, v f[B, S, KV, D]; length i32[B] -> f[B, H, D].
    f32 or bf16 (one type for q, k, v); any S; H % KV == 0."""
    args = (q, k, v, length)
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in args):
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
    q, k, v, length = (t.contiguous() for t in args)
    out = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gqa_decode(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             length.data_ptr(), out.data_ptr(), b, s, h, kv,
                             d, DTYPES[q.dtype], stream)
    _build.check(lib, err, "gqa_decode")
    gqa_decode_cuda.launches += 1
    return out


gqa_decode_cuda.launches = 0
