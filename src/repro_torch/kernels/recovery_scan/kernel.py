"""CUDA kernel wrapper: recovery validity scan over the durable areas.

After a crash the recovery procedure classifies every node (Sections 3.5 /
4.6): the member mask (stage == VALID) and a per-stage histogram, the
recovery telemetry.  The kernel is ``csrc/recovery_scan.cu``; its header
says what bounds it on an H100 and how its design serves that.

On a CPU tensor the wrapper returns the plain version (``ref.scan_ref``); on
a CUDA tensor it launches the kernel or raises.  ``scan_cuda.launches``
counts launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.recovery_scan.ref import N_STAGES, scan_ref


@functools.cache
def _lib():
    """The kernel's library, built on first use, with its launcher's C
    signature declared."""
    lib = _build.load("recovery_scan")
    fn = lib.recovery_scan
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_void_p]
    return lib


def scan_cuda(persisted: torch.Tensor):
    """persisted i32[N] -> (member mask bool[N], stage histogram i32[5]).

    The histogram counts exact matches of 0..4, as the TPU kernel does;
    that equals ``scan_ref``'s clipped count on every legal stage."""
    if persisted.device.type == "cpu":
        return scan_ref(persisted)
    if persisted.device.type != "cuda":
        raise ValueError(f"scan_cuda: unsupported device {persisted.device}")
    if persisted.dtype != torch.int32 or persisted.dim() != 1:
        raise ValueError("scan_cuda: expected a 1-D int32 tensor, got "
                         f"{persisted.dtype} of shape {tuple(persisted.shape)}")
    persisted = persisted.contiguous()
    n = persisted.shape[0]
    mask = torch.empty((n,), dtype=torch.bool, device=persisted.device)
    hist = torch.zeros((N_STAGES,), dtype=torch.int32,
                       device=persisted.device)
    lib = _lib()
    with torch.cuda.device(persisted.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.recovery_scan(persisted.data_ptr(), mask.data_ptr(),
                                hist.data_ptr(), n, stream)
    _build.check(lib, err, "recovery_scan")
    scan_cuda.launches += 1
    return mask, hist


scan_cuda.launches = 0
