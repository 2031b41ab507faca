"""CUDA kernel wrapper: GQA flash attention for prefill, masked causally by
sequence index or by per-token positions, optionally windowed.

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
from typing import Optional

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
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p] * 3
    return lib


def _readable(t: torch.Tensor) -> bool:
    """Whether the kernel can read ``t`` in place: a unit stride along D
    and, for bf16 (read by TMA), a 16-byte aligned start and strides that
    are multiples of 8 elements."""
    if t.stride(-1) != 1:
        return False
    return t.dtype != torch.bfloat16 or (
        t.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in t.stride()[:3]))


def _positions(pos: torch.Tensor, shape: tuple, dev, what: str
               ) -> torch.Tensor:
    """``pos`` as a contiguous int32 tensor of ``shape`` on ``dev``: a cast
    and a copy on the device where needed, never a host read."""
    if pos.device != dev:
        raise ValueError("flash_prefill_cuda: all tensors must be on one "
                         "CUDA device")
    if tuple(pos.shape) != shape:
        raise ValueError(f"flash_prefill_cuda: {what} has shape "
                         f"{tuple(pos.shape)}, expected {shape}")
    return pos.to(torch.int32).contiguous()


def flash_prefill_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       window: int = 0, q_pos: Optional[torch.Tensor] = None,
                       k_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q f[B, Sq, H, D]; k, v f[B, Sk, KV, D]; window 0 == no window.
    Without positions the mask is causal by index and Sq == Sk; with
    q_pos i32[B, Sq] and k_pos i32[B, Sk] a pair is live when
    k_pos <= q_pos (and k_pos > q_pos - window).  Returns f[B, Sq, H, D]
    (contiguous).  f32 or bf16; any Sq and Sk."""
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
        raise ValueError("flash_prefill_cuda: expected q[B, Sq, H, D] and "
                         "k, v[B, Sk, KV, D]")
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if (q_pos is None) != (k_pos is None):
        raise ValueError("flash_prefill_cuda: give both q_pos and k_pos or "
                         "neither")
    if (k.shape[0] != b or k.shape[3] != d or kv == 0 or h % kv
            or (q_pos is None and sk != sq) or (sk == 0 and sq > 0)):
        raise ValueError(f"flash_prefill_cuda: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} do not fit together")
    check_head_dim(d, "flash_prefill_cuda")
    if window < 0:
        raise ValueError(f"flash_prefill_cuda: window {window} < 0")
    if q_pos is not None:
        q_pos = _positions(q_pos, (b, sq), dev, "q_pos")
        k_pos = _positions(k_pos, (b, sk), dev, "k_pos")
    q, k, v = (t if _readable(t) else t.clone(
        memory_format=torch.contiguous_format) for t in args)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=dev)
    strides = (ctypes.c_longlong * 12)(
        *(st for t in (q, k, v, out) for st in t.stride()[:3]))
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_prefill(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            ctypes.addressof(strides), b, sq, sk, h, kv, d, int(window),
            DTYPES[q.dtype], None if q_pos is None else q_pos.data_ptr(),
            None if k_pos is None else k_pos.data_ptr(), stream)
    _build.check(lib, err, "flash_prefill")
    flash_prefill_cuda.launches += 1
    return out


flash_prefill_cuda.launches = 0
