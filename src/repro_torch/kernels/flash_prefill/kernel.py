"""CUDA kernel wrapper: causal / sliding-window GQA flash attention for
prefill.

The kernel is ``csrc/flash_prefill.cu``; its header says what bounds it on
an H100 and how its design serves that.  It reads q, k, v through their
strides (any layout whose head dim is contiguous), so the model's
projections go in without a transpose.

The wrapper launches the kernel on CUDA tensors and raises on anything
else; ``ops.flash_prefill`` is the entry point that takes the plain version
for CPU tensors.  ``flash_prefill_cuda.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gqa_decode.kernel import DTYPES, check_head_dim


@functools.cache
def _lib():
    """The kernel's library, built on first use, with its launcher's C
    signature declared."""
    lib = _build.load("flash_prefill")
    fn = lib.flash_prefill
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    return lib


def _readable(t: torch.Tensor) -> bool:
    """Whether the kernel can read ``t`` in place: a unit stride along D
    and, for bf16 (read by TMA), a 16-byte aligned start and strides that
    are multiples of 8 elements."""
    if t.stride(-1) != 1:
        return False
    return t.dtype != torch.bfloat16 or (
        t.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in t.stride()[:3]))


def flash_prefill_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       window: int = 0) -> torch.Tensor:
    """q f[B, S, H, D]; k, v f[B, S, KV, D]; window 0 == full causal.
    Returns f[B, S, H, D] (contiguous).  f32 or bf16; any S."""
    args = (q, k, v)
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in args):
        raise ValueError("flash_prefill_cuda: all tensors must be on one "
                         "CUDA device")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_prefill_cuda: q, k, v must all be float32 "
                         f"or all bfloat16, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("flash_prefill_cuda: expected q[B, S, H, D] and "
                         "k, v[B, S, KV, D]")
    b, s, h, d = q.shape
    kv = k.shape[2]
    if (k.shape[:2] != (b, s) or k.shape[3] != d or kv == 0 or h % kv):
        raise ValueError(f"flash_prefill_cuda: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} do not fit together")
    check_head_dim(d, "flash_prefill_cuda")
    if window < 0:
        raise ValueError(f"flash_prefill_cuda: window {window} < 0")
    q, k, v = (t if _readable(t) else t.clone(
        memory_format=torch.contiguous_format) for t in args)
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=dev)
    strides = (ctypes.c_longlong * 12)(
        *(st for t in (q, k, v, out) for st in t.stride()[:3]))
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_prefill(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                out.data_ptr(), ctypes.addressof(strides),
                                b, s, h, kv, d, int(window),
                                DTYPES[q.dtype], stream)
    _build.check(lib, err, "flash_prefill")
    flash_prefill_cuda.launches += 1
    return out


flash_prefill_cuda.launches = 0
