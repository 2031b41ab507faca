"""Wrappers tying the probe kernel to the durable-set state.

Two regimes:

  bulk         ``build_buckets`` / ``bucket_init`` pack the whole node pool
               into the (NB, W) table -- an O(N log N) argsort repack paid
               ONLY at state construction and recovery.
  incremental  ``bucket_insert`` / ``bucket_remove`` maintain the same table
               with O(B*W) per-lane scatter writes -- the hot path.  A lane
               claims the first free way of its bucket, spills to the dense
               stash on per-bucket overflow, and frees the way (or stash
               slot) on delete.

``lookup`` is then a pure read of the carried table through the CUDA kernel
``probe_cuda``, which computes each key's bucket itself (or the plain
reference).  Every function returns the same
values, at the same dtypes, as its counterpart in
``repro.kernels.hash_probe.ops``.  The JAX package's ``table_lookup`` (the
probe backend's read) is ``kernel.table_probe_cuda`` here, with its plain
version ``ref.table_lookup_ref``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.drop import set_drop, where_sized
from repro_torch.core.nvm import EMPTY, VALID
from repro_torch.kernels.hash_probe.kernel import probe_cuda
from repro_torch.kernels.hash_probe.ref import bucket_of, probe_ref

_I32 = torch.int32


def build_buckets(keys: torch.Tensor, cur: torch.Tensor, nb: int = 1024,
                  w: int = 8):
    """Pack live nodes of a durable-set pool into a (NB, W) bucket table.

    Deterministic way assignment: rank of each node among same-bucket live
    nodes (computed with a stable sort), overflowing entries left for the
    dense stash (rare under load factor <= 0.5).  Returns (bkeys, bids,
    overflow count i32[])."""
    n = keys.shape[0]
    if n >= (1 << 24):
        raise ValueError("pool size exceeds the f32-exact node-id budget "
                         "kept for parity with the JAX package")
    live = cur == VALID
    bucket = torch.where(live, bucket_of(keys, nb),
                         torch.full_like(keys, nb))   # dead -> overflow bin
    order = torch.argsort(bucket, stable=True)        # groups same bucket
    sorted_b = bucket[order]
    # rank within bucket group: the sorted run of a bucket starts at its
    # first occurrence (the JAX version's scatter-min over positions)
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)
    group_start = torch.searchsorted(sorted_b, sorted_b)
    rank = idx - group_start
    in_pool = sorted_b < nb
    ok = in_pool & (rank < w)
    flat = torch.where(ok, sorted_b.to(torch.int64) * w + rank,
                       torch.full_like(rank, nb * w))
    bkeys = set_drop(torch.zeros((nb * w,), dtype=_I32, device=keys.device),
                     flat, keys[order]).reshape(nb, w)
    bids = set_drop(torch.full((nb * w,), EMPTY, dtype=_I32,
                               device=keys.device),
                    flat, order).reshape(nb, w)
    overflow = (in_pool & (rank >= w)).sum().to(_I32)
    return bkeys, bids, overflow


def bucket_init(keys: torch.Tensor, cur: torch.Tensor, *, nb: int, w: int,
                s: int):
    """Bulk build of the full incremental index: (NB, W) bucket table plus
    the dense stash holding the live nodes that overflowed their bucket.
    Returns (bkeys, bids, skeys, sids, stash_n, overflow) -- overflow is
    True when more than ``s`` nodes spilled (data would be unreachable)."""
    bkeys, bids, _ = build_buckets(keys, cur, nb=nb, w=w)
    n = keys.shape[0]
    dev = keys.device
    flat = bids.reshape(-1)
    in_table = set_drop(torch.zeros((n,), dtype=torch.bool, device=dev),
                        torch.where(flat >= 0, flat,
                                    torch.full_like(flat, n)), True)
    stashed = (cur == VALID) & ~in_table
    spill = stashed.sum().to(_I32)
    idx = where_sized(stashed, s, -1)    # the first s stashed ids, ascending
    got = idx >= 0
    sids = torch.where(got, idx, torch.full_like(idx, EMPTY))
    skeys = torch.where(got, keys[idx.clamp(min=0)], torch.zeros_like(idx))
    return bkeys, bids, skeys, sids, spill.clamp(max=s), spill > s


def _nth_free(free: torch.Tensor, rank: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per row of ``free`` (B, K): the column of the (rank+1)-th free slot
    in ascending order, plus a found flag.  This is exactly the slot a lane
    of claim-order ``rank`` receives from sequential first-free claiming,
    because slots are only ever *consumed* within one call."""
    c = torch.cumsum(free.to(_I32), dim=1, dtype=_I32)
    hit = free & (c == (rank + 1)[:, None])
    ok = hit.any(dim=1)
    col = torch.argmax(hit.to(torch.uint8), dim=1)   # first hit, as JAX's
    return col, ok


def _earlier(b: int, device) -> torch.Tensor:
    """earlier[i, j] = j < i: lane j precedes lane i in linearization."""
    return torch.ones((b, b), dtype=torch.bool, device=device).tril(-1)


def bucket_insert(bkeys, bids, skeys, sids, stash_n, keys, ids, do):
    """Incremental insert: for lanes with do[i], place node ids[i] (key
    keys[i]) into the first free way of its bucket, or the first free dense
    stash slot when the bucket is full.

    Vectorized sequential-equivalent: lane order is the linearization order,
    and since ways/slots are only consumed here, the lane of in-bucket
    claim-rank r deterministically receives the (r+1)-th free way -- one
    O(B^2) rank computation plus ONE scatter per plane."""
    nb, w = bkeys.shape
    b = keys.shape[0]
    bucket = bucket_of(keys, nb).to(torch.int64)
    earlier = _earlier(b, keys.device)

    # claim order among do-lanes of the same bucket == sequential lane order
    same = do[:, None] & do[None, :] & (bucket[:, None] == bucket[None, :])
    rank = (same & earlier).sum(dim=1)
    way, has_way = _nth_free(bids[bucket] == EMPTY, rank)
    place = do & has_way
    flat = torch.where(place, bucket * w + way,
                       torch.full_like(bucket, nb * w))
    bkeys = set_drop(bkeys.reshape(-1), flat, keys).reshape(nb, w)
    bids = set_drop(bids.reshape(-1), flat, ids).reshape(nb, w)

    # bucket-full lanes spill to the dense stash, same claim-rank argument
    spill = do & ~has_way
    srank = (spill[:, None] & spill[None, :] & earlier).sum(dim=1)
    slot, has_slot = _nth_free((sids == EMPTY)[None, :].expand(b, -1), srank)
    put = spill & has_slot
    s = sids.shape[0]
    ts = torch.where(put, slot, torch.full_like(slot, s))
    skeys = set_drop(skeys, ts, keys)
    sids = set_drop(sids, ts, ids)
    stash_n = stash_n + put.sum().to(_I32)
    ovf = (spill & ~has_slot).any()
    return bkeys, bids, skeys, sids, stash_n, ovf


def bucket_remove(bkeys, bids, skeys, sids, stash_n, keys, ids, do):
    """Incremental delete: free the way (or dense stash slot) holding node
    ids[i] for lanes with do[i].  A live node is in the bucket table XOR
    the stash, so exactly one of the two clears fires.  Do-lanes carry
    DISTINCT node ids (the op bodies dedup by lane priority), so all
    scatter targets are distinct and one scatter per plane suffices."""
    nb, w = bkeys.shape
    bucket = bucket_of(keys, nb).to(torch.int64)

    hitw = bids[bucket] == ids[:, None]                # (B, W)
    in_table = do & hitw.any(dim=1)
    way = torch.argmax(hitw.to(torch.uint8), dim=1)
    flat = torch.where(in_table, bucket * w + way,
                       torch.full_like(bucket, nb * w))
    bids = set_drop(bids.reshape(-1), flat, EMPTY).reshape(nb, w)
    bkeys = set_drop(bkeys.reshape(-1), flat, 0).reshape(nb, w)

    hits = sids[None, :] == ids[:, None]               # (B, S)
    in_stash = do & ~in_table & hits.any(dim=1)
    slot = torch.argmax(hits.to(torch.uint8), dim=1)
    ts = torch.where(in_stash, slot, torch.full_like(slot, sids.shape[0]))
    sids = set_drop(sids, ts, EMPTY)
    skeys = set_drop(skeys, ts, 0)
    stash_n = stash_n - in_stash.sum().to(_I32)
    return (bkeys, bids, skeys, sids, stash_n,
            torch.zeros((), dtype=torch.bool, device=keys.device))


def lookup(bucket_keys, bucket_ids, q_keys, *, use_kernels=True):
    """Node id per query key through the bucket table, or -1: each key's
    row is its ``bucket_of``.  With ``use_kernels`` the call goes through
    ``probe_cuda``, which on CUDA tensors hashes and probes in one kernel
    launch and on CPU tensors runs the plain version."""
    if use_kernels:
        return probe_cuda(bucket_keys, bucket_ids, None, q_keys)
    return probe_ref(bucket_keys, bucket_ids, None, q_keys)
