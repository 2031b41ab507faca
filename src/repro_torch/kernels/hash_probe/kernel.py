"""CUDA kernel wrappers: hash-table probes.

Two entries of ``csrc/hash_probe.cu``, one per route of the JAX package's
``probe_pallas``; the source's notes say what bounds each on an H100 and how
its design serves that.

  probe_cuda        the "bucket" backend's lookup: the volatile index is a
                    set-associative table (NB buckets x W ways) and each
                    query reads the row of its bucket.  Given no bucket
                    operand, the kernel hashes each key to its bucket
                    itself (``hash32(q) % NB``, the JAX package's
                    ``ops.lookup``), so the lookup is one launch.
  table_probe_cuda  the "probe" backend's lookup: each query reads its
                    ``max_probe``-slot window of the linear-probe table.

On CPU tensors a wrapper returns the plain version (``ref.probe_ref``,
``ref.table_lookup_ref``); on CUDA tensors it launches its kernel or
raises.  ``probe_cuda.launches`` and ``table_probe_cuda.launches`` count
launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.hash_probe.ref import probe_ref, table_lookup_ref


@functools.cache
def _lib():
    """The kernels' library, built on first use, with its launchers' C
    signatures declared."""
    lib = _build.load("hash_probe")
    fn = lib.hash_probe
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn = lib.table_probe
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    return lib


@functools.cache
def _launchers():
    """The two C launchers and the query of a card's current stream as a
    raw handle, resolved once.  ``torch.cuda.current_stream()`` builds a
    Stream object on every call; the launchers take only the handle, the
    one PyTorch's own generated launchers pass."""
    lib = _lib()
    return lib.hash_probe, lib.table_probe, torch._C._cuda_getCurrentRawStream


def probe_cuda(bucket_keys: torch.Tensor, bucket_ids: torch.Tensor,
               q_bucket: Optional[torch.Tensor], q_keys: torch.Tensor
               ) -> torch.Tensor:
    """Node id per query, or -1.  Shapes: bucket_keys/bucket_ids i32[NB, W];
    q_keys i32[B]; q_bucket i32[B], the row of each query (one outside
    [0, NB) matches nothing), or None for ``hash32(q) % NB`` (the bucket
    backend's lookup; NB >= 1), which the kernel then computes itself.  Any
    NB, W and B: the TPU kernel's tile divisibility does not apply."""
    dev = bucket_keys.device
    if (dev.type == "cpu" and bucket_ids.device.type == "cpu"
            and q_keys.device.type == "cpu"
            and (q_bucket is None or q_bucket.device.type == "cpu")):
        return probe_ref(bucket_keys, bucket_ids, q_bucket, q_keys)
    if (dev.type != "cuda" or bucket_ids.device != dev
            or q_keys.device != dev
            or (q_bucket is not None and q_bucket.device != dev)):
        raise ValueError("probe_cuda: all tensors must be on one CUDA device")
    if (bucket_keys.dtype != torch.int32 or bucket_ids.dtype != torch.int32
            or q_keys.dtype != torch.int32
            or (q_bucket is not None and q_bucket.dtype != torch.int32)):
        raise ValueError("probe_cuda: expected int32 tensors")
    if (bucket_keys.dim() != 2 or bucket_ids.shape != bucket_keys.shape
            or q_keys.dim() != 1
            or (q_bucket is not None and q_bucket.shape != q_keys.shape)):
        raise ValueError("probe_cuda: expected i32[NB, W] tables and i32[B] "
                         "queries")
    nb, w = bucket_keys.shape
    if q_bucket is None and nb == 0:
        raise ValueError("probe_cuda: no bucket to hash a key into (NB = 0)")
    b = q_keys.shape[0]
    out = torch.empty((b,), dtype=torch.int32, device=dev)
    if b == 0:
        return out
    bucket_keys, bucket_ids, q_keys = (
        x.contiguous() for x in (bucket_keys, bucket_ids, q_keys))
    qb = 0 if q_bucket is None else q_bucket.contiguous().data_ptr()
    launch, _, raw_stream = _launchers()
    idx = dev.index
    with _build.on_device(idx):
        err = launch(bucket_keys.data_ptr(), bucket_ids.data_ptr(), qb,
                     q_keys.data_ptr(), out.data_ptr(), b, nb, w,
                     raw_stream(idx))
    _build.check(_lib(), err, "hash_probe")
    probe_cuda.launches += 1
    return out


probe_cuda.launches = 0


def table_probe_cuda(table: torch.Tensor, pool_keys: torch.Tensor,
                     q_keys: torch.Tensor, max_probe: int = 128
                     ) -> torch.Tensor:
    """Node id per query key: the largest live id (>= 0) among the slots
    ``table[(hash32(q) + d) & (T - 1)]``, d < max_probe, whose pool key
    ``pool_keys[id]`` equals the query key, else -1.  The whole window is
    read, with no early exit, so the answer is right for any table.
    Shapes: table i32[T] with T a power of two (at least 4 on the card,
    where the kernel reads 4-slot groups; a table that does not start on a
    16-byte boundary is copied first), pool_keys i32[N] with N >= 1,
    q_keys i32[B]; any B (0 launches nothing)."""
    dev = table.device
    if (dev.type == "cpu" and pool_keys.device.type == "cpu"
            and q_keys.device.type == "cpu"):
        return table_lookup_ref(table, pool_keys, q_keys, max_probe)
    if (dev.type != "cuda" or pool_keys.device != dev
            or q_keys.device != dev):
        raise ValueError("table_probe_cuda: all tensors must be on one CUDA "
                         "device")
    for x in (table, pool_keys, q_keys):
        if x.dtype != torch.int32 or x.dim() != 1:
            raise ValueError("table_probe_cuda: expected 1-D int32 tensors")
    t, n, b = table.shape[0], pool_keys.shape[0], q_keys.shape[0]
    if t < 4 or t & (t - 1) or t > (1 << 30):
        raise ValueError(f"table_probe_cuda: table length {t} is not a "
                         "power of two from 4 to 2^30")
    if n < 1 or n >= (1 << 31):
        raise ValueError(f"table_probe_cuda: pool of {n} keys")
    if not 1 <= max_probe < (1 << 30):
        raise ValueError(f"table_probe_cuda: max_probe {max_probe}")
    out = torch.empty((b,), dtype=torch.int32, device=dev)
    if b == 0:
        return out
    table, pool_keys, q_keys = (x.contiguous()
                                for x in (table, pool_keys, q_keys))
    # the window arrives by 16-byte loads: from an aligned start
    if table.data_ptr() % 16:
        table = table.clone(memory_format=torch.contiguous_format)
    _, launch, raw_stream = _launchers()
    idx = dev.index
    with _build.on_device(idx):
        err = launch(table.data_ptr(), pool_keys.data_ptr(),
                     q_keys.data_ptr(), out.data_ptr(), b, t, n, max_probe,
                     raw_stream(idx))
    _build.check(_lib(), err, "table_probe")
    table_probe_cuda.launches += 1
    return out


table_probe_cuda.launches = 0
