"""CUDA kernel wrapper: bucketized hash-table probe.

The lookup path of the "bucket" index backend: the volatile index is a
set-associative table (NB buckets x W ways) and each query reads the row of
its bucket.  The kernel is ``csrc/hash_probe.cu``; its header says what
bounds it on an H100 and how its design serves that.

On a CPU tensor the wrapper returns the plain version (``ref.probe_ref``);
on a CUDA tensor it launches the kernel or raises.  ``probe_cuda.launches``
counts launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.hash_probe.ref import probe_ref


@functools.cache
def _lib():
    """The kernel's library, built on first use, with its launcher's C
    signature declared."""
    lib = _build.load("hash_probe")
    fn = lib.hash_probe
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    return lib


def probe_cuda(bucket_keys: torch.Tensor, bucket_ids: torch.Tensor,
               q_bucket: torch.Tensor, q_keys: torch.Tensor) -> torch.Tensor:
    """Node id per query, or -1.  Shapes: bucket_keys/bucket_ids i32[NB, W];
    q_bucket/q_keys i32[B].  Any NB, W and B: the TPU kernel's tile
    divisibility does not apply."""
    args = (bucket_keys, bucket_ids, q_bucket, q_keys)
    if all(t.device.type == "cpu" for t in args):
        return probe_ref(*args)
    dev = bucket_keys.device
    if dev.type != "cuda" or any(t.device != dev for t in args):
        raise ValueError("probe_cuda: all tensors must be on one CUDA device")
    if any(t.dtype != torch.int32 for t in args):
        raise ValueError("probe_cuda: expected int32 tensors")
    if (bucket_keys.dim() != 2 or bucket_ids.shape != bucket_keys.shape
            or q_bucket.dim() != 1 or q_keys.shape != q_bucket.shape):
        raise ValueError("probe_cuda: expected i32[NB, W] tables and i32[B] "
                         "queries")
    bucket_keys, bucket_ids, q_bucket, q_keys = (t.contiguous() for t in args)
    nb, w = bucket_keys.shape
    b = q_keys.shape[0]
    out = torch.empty((b,), dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.hash_probe(bucket_keys.data_ptr(), bucket_ids.data_ptr(),
                             q_bucket.data_ptr(), q_keys.data_ptr(),
                             out.data_ptr(), b, nb, w, stream)
    _build.check(lib, err, "hash_probe")
    probe_cuda.launches += 1
    return out


probe_cuda.launches = 0
