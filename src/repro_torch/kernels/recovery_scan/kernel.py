"""CUDA kernel wrapper: recovery validity scan over the durable areas.

After a crash the recovery procedure classifies every node (Sections 3.5 /
4.6): the member mask (stage == VALID) and a per-stage histogram, the
recovery telemetry.  The kernel is ``csrc/recovery_scan.cu``; its header
says what bounds it on an H100 and how its design serves that.

On a CPU tensor the wrapper returns the plain version (``ref.scan_ref``); on
a CUDA tensor it launches the kernel, one device operation a scan, or
raises.  ``scan_cuda.launches`` counts launches.
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
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    return lib


@functools.cache
def _launcher():
    """The C launcher and the query of a card's current stream as a raw
    handle, resolved once (``torch.cuda.current_stream()`` builds a Stream
    object on every call)."""
    return _lib().recovery_scan, torch._C._cuda_getCurrentRawStream


_bins = {}   # (card, raw stream) -> the kernel's five bin words there


def _bins_for(dev, idx, stream):
    """The five 64-bit words through which the kernel finishes its
    histogram across blocks, one set per stream of a card: zeroed once,
    on that stream, and left at zero by every launch, so scans on one
    stream follow each other and scans on two streams share nothing."""
    bins = _bins.get((idx, stream))
    if bins is None:
        bins = torch.zeros((N_STAGES,), dtype=torch.int64, device=dev)
        _bins[idx, stream] = bins
    return bins


def scan_cuda(persisted: torch.Tensor):
    """persisted i32[N] -> (member mask bool[N], stage histogram i32[5]).

    The histogram counts exact matches of 0..4, as the TPU kernel does;
    that equals ``scan_ref``'s clipped count on every legal stage.  On the
    card this is one launch: the kernel writes every bin of the histogram,
    which is not zeroed first (the first scan on a stream also zeroes that
    stream's bin words, once)."""
    dev = persisted.device
    if dev.type == "cpu":
        return scan_ref(persisted)
    if dev.type != "cuda":
        raise ValueError(f"scan_cuda: unsupported device {dev}")
    if persisted.dtype != torch.int32 or persisted.dim() != 1:
        raise ValueError("scan_cuda: expected a 1-D int32 tensor, got "
                         f"{persisted.dtype} of shape {tuple(persisted.shape)}")
    persisted = persisted.contiguous()
    n = persisted.shape[0]
    mask = torch.empty((n,), dtype=torch.bool, device=dev)
    hist = torch.empty((N_STAGES,), dtype=torch.int32, device=dev)
    launch, raw_stream = _launcher()
    idx = dev.index
    with _build.on_device(idx):
        stream = raw_stream(idx)
        bins = _bins_for(dev, idx, stream)
        err = launch(persisted.data_ptr(), mask.data_ptr(), hist.data_ptr(),
                     bins.data_ptr(), n, stream)
    _build.check(_lib(), err, "recovery_scan")
    scan_cuda.launches += 1
    return mask, hist


scan_cuda.launches = 0
