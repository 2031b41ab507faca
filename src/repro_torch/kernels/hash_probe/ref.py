"""Plain PyTorch versions of the hash-probe lookups."""
from typing import Optional

import torch

from repro_torch.core.nvm import EMPTY, hash32


def bucket_of(keys: torch.Tensor, nb: int) -> torch.Tensor:
    """Bucket index i32 of each key in an nb-bucket table: hash32(key) % nb,
    as the JAX package's ``ops.lookup`` computes it in uint32."""
    return (hash32(keys) % nb).to(torch.int32)


def probe_ref(bucket_keys: torch.Tensor, bucket_ids: torch.Tensor,
              q_bucket: Optional[torch.Tensor], q_keys: torch.Tensor
              ) -> torch.Tensor:
    """Direct-gather reference.

    bucket_keys i32[NB, W], bucket_ids i32[NB, W] (-1 == empty way),
    q_bucket i32[B] (bucket index per query), or None for each key's
    :func:`bucket_of`, q_keys i32[B].
    Returns node id per query or -1.
    """
    if q_bucket is None:
        q_bucket = bucket_of(q_keys, bucket_keys.shape[0])
    rows_k = bucket_keys[q_bucket]          # (B, W)
    rows_i = bucket_ids[q_bucket]           # (B, W)
    match = (rows_i >= 0) & (rows_k == q_keys[:, None])
    found = torch.where(match, rows_i, torch.full_like(rows_i, -1))
    return found.amax(dim=1)


def window_rows(table: torch.Tensor, pool_keys: torch.Tensor,
                q_keys: torch.Tensor, max_probe: int = 128):
    """Each query's probe window as a bucket row of its own, as the JAX
    package's ``table_lookup`` builds them: (wkeys, wids) i32[B, max_probe]
    hold the pool key and node id of every live slot of
    ``table[(hash32(q) + d) & (T - 1)]`` for d < max_probe, TOMB and EMPTY
    masked to id -1 and key 0, and rows i32[B] is the lane index."""
    t = table.shape[0]
    n = pool_keys.shape[0]
    d = torch.arange(max_probe, dtype=torch.int64, device=q_keys.device)
    ids = table[((hash32(q_keys) & (t - 1))[:, None] + d) & (t - 1)]
    live = ids >= 0
    wkeys = torch.where(live, pool_keys[ids.clamp(0, n - 1)],
                        torch.zeros_like(ids))
    wids = torch.where(live, ids, torch.full_like(ids, EMPTY))
    rows = torch.arange(q_keys.shape[0], dtype=torch.int32,
                        device=q_keys.device)
    return wkeys, wids, rows


def table_lookup_ref(table: torch.Tensor, pool_keys: torch.Tensor,
                     q_keys: torch.Tensor, max_probe: int = 128
                     ) -> torch.Tensor:
    """Linear-probe-table lookup as the JAX package composes it: the window
    rows of :func:`window_rows` through :func:`probe_ref`.  Node id per
    query (the largest live id in its window whose pool key equals the
    query key), else -1.  table i32[T] (T a power of two), pool_keys
    i32[N], q_keys i32[B]."""
    wkeys, wids, rows = window_rows(table, pool_keys, q_keys, max_probe)
    return probe_ref(wkeys, wids, rows, q_keys)
