"""CUDA kernel wrappers: hash-table probes.

Two entries of ``csrc/hash_probe.cu``, one per route of the JAX package's
``probe_pallas``; the source's notes say what bounds each on an H100 and how
its design serves that.

  probe_cuda        the "bucket" backend's lookup: the volatile index is a
                    set-associative table (NB buckets x W ways) and each
                    query reads the row of its bucket.
  table_probe_cuda  the "probe" backend's lookup: each query reads its
                    ``max_probe``-slot window of the linear-probe table.

On CPU tensors a wrapper returns the plain version (``ref.probe_ref``,
``ref.table_lookup_ref``); on CUDA tensors it launches its kernel or
raises.  ``probe_cuda.launches`` and ``table_probe_cuda.launches`` count
launches.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools

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
def _table_probe_launcher():
    """``table_probe``'s C launcher and the query of a card's current stream
    as a raw handle, resolved once.  ``torch.cuda.current_stream()`` builds
    a Stream object on every call; the launcher takes only the handle, the
    one PyTorch's own generated launchers pass."""
    return _lib().table_probe, torch._C._cuda_getCurrentRawStream


# the device guard where the tensors' card is already the current one
_SAME_DEVICE = contextlib.nullcontext()


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
    launch, raw_stream = _table_probe_launcher()
    idx = dev.index
    # the launch goes to the current device: switch only to another card
    with (_SAME_DEVICE if idx == torch.cuda.current_device()
          else torch.cuda.device(idx)):
        err = launch(table.data_ptr(), pool_keys.data_ptr(),
                     q_keys.data_ptr(), out.data_ptr(), b, t, n, max_probe,
                     raw_stream(idx))
    _build.check(_lib(), err, "table_probe")
    table_probe_cuda.launches += 1
    return out


table_probe_cuda.launches = 0
