"""DurableMap engine: SetSpec config + pluggable volatile-index backends.

PyTorch port of ``repro.core.engine``.  The paper's central idea is the
split between a durable node pool and a *volatile* index that is rebuilt
on recovery; the index is a swappable backend:

  probe    linear probing over ``SetState.table`` (the default; the
           paper's hash-set runs).  On the card a lookup is the CUDA kernel
           ``hash_probe.table_probe_cuda``, eight lanes a query over its
           whole probe window; writes claim and release slots with
           ``table_claim`` / ``table_release``; recovery runs
           ``recovery_scan.scan_cuda`` and rebuilds the table.
  scan     O(N) traversal lookup (the paper's linked-list runs); recovery
           runs ``recovery_scan.scan_cuda``.
  bucket   set-associative (NB buckets x W ways) index carried in
           ``SetState``: built once at make_state/recovery, updated
           incrementally by the op bodies (O(B*W) scatter), and probed by
           the CUDA kernel ``hash_probe.probe_cuda``, which hashes each key
           to its bucket itself (one launch a lookup); recovery runs the
           CUDA kernel ``recovery_scan.scan_cuda``.  Live nodes that
           overflow a bucket land in an exact dense stash the lookup also
           reads, so the backend is correct at any load factor.

The bucket and scan backends also recover from a snapshot plus the stamp
delta (:func:`hybrid_recover`, ``DurableMap.hybrid_crash_and_recover``,
driven by ``repro_torch.store.snapshot.Snapshotter``): ``recovery_scan``
classifies only the delta, and the bucket rows it touches are rebuilt.

Everything is configured by one frozen :class:`SetSpec`.  The serving-shaped
entry point is :func:`apply_batch`: a mixed contains/insert/remove lane
vector.  Mixed batches linearize phase by phase (all contains, then all
inserts, then all removes) with lane priority inside a phase.

:class:`DurableMap` is the object facade; its state lives on the device it
is given (``"cuda"`` by default).  :class:`DurableSet` is the JAX package's
deprecated legacy facade over it.
"""
from __future__ import annotations

import dataclasses
import functools
import sys
import time
import warnings
from typing import Dict, Optional, Protocol, Tuple

import numpy as np
import torch

from repro_torch.core import durable_set as DS
from repro_torch.core.device import resolve_device
from repro_torch.core.drop import set_drop, where_sized
from repro_torch.core.durable_set import SetState, MODES
from repro_torch.core.nvm import EMPTY, FREE, VALID
from repro_torch.kernels.hash_probe import ops as hp_ops
from repro_torch.kernels.hash_probe.kernel import table_probe_cuda
from repro_torch.kernels.recovery_scan import ops as rs_ops

# Mixed-batch op codes for apply_batch.  OP_NOP matches no phase, so a lane
# carrying it is an exact no-op (no state change, no psync, no n_ops, result
# False).
OP_CONTAINS, OP_INSERT, OP_REMOVE, OP_NOP = 0, 1, 2, 3


def warn_structure(message: str, stacklevel: int = 3) -> None:
    """Emit a one-shot-per-STRUCTURE RuntimeWarning.

    ``warnings.warn`` under the default filters dedups through the
    attributed caller's module ``__warningregistry__`` -- module-global
    state -- so the first structure's overflow warning would swallow a
    second structure's first overflow in the same process.  Callers latch
    one-shot per instance (``self._overflow_warned``); this helper emits
    through the normal filter machinery and then purges the registry
    entries the emission created.

    ``stacklevel`` has the meaning it would have for a direct
    ``warnings.warn`` call from the caller, +1 for this helper's frame.
    """
    try:
        registry = sys._getframe(stacklevel - 1).f_globals.setdefault(
            "__warningregistry__", {})
        before = frozenset(registry)
    except ValueError:                        # stacklevel past the stack top
        registry, before = None, frozenset()
    try:
        warnings.warn(message, RuntimeWarning, stacklevel=stacklevel)
    finally:
        if registry is not None:
            for key in set(registry) - before:
                registry.pop(key, None)       # undo the dedup record


# Node-id budget of the TPU kernel's float32 one-hot gather.  The CUDA
# kernels have no such limit; the guard stays so that both packages accept
# and refuse the same specs.
_F32_EXACT = 1 << 24


@dataclasses.dataclass(frozen=True)
class SetSpec:
    """Frozen configuration of a durable map.

    capacity      node-pool size N (max live members)
    mode          psync algorithm: "soft" | "linkfree" | "logfree"
    backend       volatile-index backend name (see BACKENDS)
    table_factor  probe-table slots per node (power-of-2 rounded)
    max_probe     linear-probe cap for the probe table
    n_buckets     bucket backend: bucket count NB (0 => derived so the
                  table holds 2x capacity at width w: next pow2 of 2N/W)
    bucket_width  bucket backend: ways per bucket W
    stash_size    bucket backend: dense-stash slots S for per-bucket
                  overflow spill (overflowing past S latches
                  ``state.overflow``)
    use_kernels   run the CUDA kernels where the backend has them (the
                  bucket and probe lookups, every backend's recovery scan);
                  else the plain PyTorch versions.  The JAX package's
                  ``probe_pallas_lookup`` has no counterpart: its gates
                  (batch % 8, % 4096 past 4096 lanes, capacity < 2^24 for
                  the f32 one-hot gather) come from the TPU's tiles, and
                  the CUDA probe-window kernel takes any batch and any
                  node id, so a probe map on the card always runs it
    """
    capacity: int
    mode: str = "soft"
    backend: str = "probe"
    table_factor: int = 4
    max_probe: int = 128
    n_buckets: int = 0
    bucket_width: int = 8
    stash_size: int = 128
    use_kernels: bool = True

    def __post_init__(self):
        if self.capacity <= 0:
            raise ValueError(f"capacity must be positive, got {self.capacity}")
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {self.mode!r}")
        for f in ("table_factor", "max_probe", "bucket_width", "stash_size"):
            if getattr(self, f) < 1:
                raise ValueError(f"{f} must be >= 1")
        if self.n_buckets < 0 or (self.n_buckets &
                                  (self.n_buckets - 1)) != 0:
            raise ValueError("n_buckets must be 0 (derived) or a power of "
                             f"two, got {self.n_buckets}")
        if self.backend == "bucket" and self.capacity >= _F32_EXACT:
            raise ValueError("bucket backend: capacity exceeds the f32-exact "
                             f"node-id budget ({_F32_EXACT})")

    def bucket_geometry(self) -> Tuple[int, int]:
        """Resolved (NB, W) for the bucket backend."""
        w = self.bucket_width
        nb = self.n_buckets
        if nb == 0:
            target = max(8, -(-2 * self.capacity // w))   # ceil(2N / W)
            nb = 1 << (target - 1).bit_length()
        return nb, w


class IndexBackend(Protocol):
    """A volatile-index backend: lookup on the hot path, validity
    classification on the recovery path, plus the index-lifecycle hooks
    (state geometry, bulk build, incremental maintenance).  Register with
    :func:`register_backend`."""
    name: str
    # True => recovery bulk-builds the linear-probe table for this backend.
    builds_probe_table: bool

    def lookup(self, spec: SetSpec, state: SetState,
               keys: torch.Tensor) -> torch.Tensor:
        """Node id per query lane, or EMPTY (-1) when absent."""
        ...

    def recover_scan(self, spec: SetSpec, persisted: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """persisted stages i32[N] -> (member mask bool[N], stage hist
        i32[5])."""
        ...

    def state_geometry(self, spec: SetSpec) -> Tuple[int, int, int]:
        """(n_buckets, bucket_width, stash_size) sizing the SetState bucket
        fields -- (0, 0, 0) for backends that do not carry a bucket index."""
        ...

    def init_index(self, spec: SetSpec, state: SetState) -> SetState:
        """Bulk-build the backend's index fields from the node pool (state
        construction / recovery only -- never the hot path)."""
        ...

    def update_index(self, spec: SetSpec, phase: str
                     ) -> Optional[DS.IndexUpdateFn]:
        """The index commit hook for ``phase`` ("insert"|"remove"), or None
        when the mutation commits with no index maintenance.  The ONLY path
        by which the op bodies touch a volatile-index structure."""
        ...


class _NullIndexMixin:
    """Lifecycle defaults for backends without a carried bucket index."""

    def state_geometry(self, spec):
        return (0, 0, 0)

    def init_index(self, spec, state):
        return state

    def update_index(self, spec, phase):
        return None

    def recover_scan(self, spec, persisted):
        # The JAX package takes the plain version here; on the card that
        # is the CUDA kernel, which returns the same integers.
        return rs_ops.recovery_scan(persisted, use_kernels=spec.use_kernels)


class ProbeBackend(_NullIndexMixin):
    """The paper's hash-set experiments: linear probing over SetState.table.

    Lookups run the CUDA kernel ``table_probe_cuda`` when ``use_kernels``
    is set and the state is on CUDA, else the windowed PyTorch lookup; both
    return the first match before an EMPTY slot on the tables the ops
    build.  Writes commit through
    :func:`DS.probe_index_update` (``table_claim`` / ``table_release``);
    recovery rebuilds the table with :func:`DS.table_build`."""
    name = "probe"
    builds_probe_table = True

    def lookup(self, spec, state, keys):
        if spec.use_kernels and state.table.is_cuda:
            return table_probe_cuda(state.table, state.keys, keys,
                                    spec.max_probe)
        return DS._lookup_probe(state, keys, max_probe=spec.max_probe)

    def update_index(self, spec, phase):
        return DS.probe_index_update(phase, spec.max_probe)


class ScanBackend(_NullIndexMixin):
    """The paper's list experiments: cost dominated by full traversal."""
    name = "scan"
    builds_probe_table = False     # _lookup_scan reads cur/keys directly

    def lookup(self, spec, state, keys):
        return DS._lookup_scan(state, keys)


class BucketBackend:
    """Set-associative index carried in SetState, probed by the CUDA kernel.

    ``bucket_init`` bulk-packs live nodes into ``state.bkeys``/``state.bids``
    at recovery; during operation ``bucket_insert``/``bucket_remove``
    maintain the table with O(B*W) scatter writes.  Lookups are pure reads:
    ``hp_ops.lookup`` over the carried table, then the dense stash.
    Recovery classification runs the ``recovery_scan`` kernel.
    """
    name = "bucket"
    builds_probe_table = False

    def lookup(self, spec, state, keys):
        found = hp_ops.lookup(state.bkeys, state.bids, keys,
                              use_kernels=spec.use_kernels)
        # The stash is read on every lookup.  The JAX version skips it while
        # ``stash_n == 0``; the result is the same, because an empty stash
        # holds only EMPTY ids, and reading it costs no host sync.
        live = state.sids >= 0
        eq = live[None, :] & (keys[:, None] == state.skeys[None, :])
        hit = eq.any(dim=1)
        sid = state.sids[torch.argmax(eq.to(torch.uint8), dim=1)]
        return torch.where((found < 0) & hit, sid, found)

    def recover_scan(self, spec, persisted):
        return rs_ops.recovery_scan(persisted, use_kernels=spec.use_kernels)

    def state_geometry(self, spec):
        nb, w = spec.bucket_geometry()
        return nb, w, spec.stash_size

    def init_index(self, spec, state):
        nb, w = spec.bucket_geometry()
        bkeys, bids, skeys, sids, stash_n, ovf = hp_ops.bucket_init(
            state.keys, state.cur, nb=nb, w=w, s=spec.stash_size)
        return state._replace(bkeys=bkeys, bids=bids, skeys=skeys, sids=sids,
                              stash_n=stash_n,
                              overflow=state.overflow | ovf)

    def update_index(self, spec, phase):
        fn = hp_ops.bucket_insert if phase == "insert" \
            else hp_ops.bucket_remove

        def update(f: DS.IndexFields, keys, ids, do):
            bkeys, bids, skeys, sids, stash_n, ovf = fn(
                f.bkeys, f.bids, f.skeys, f.sids, f.stash_n, keys, ids, do)
            return f._replace(bkeys=bkeys, bids=bids, skeys=skeys,
                              sids=sids, stash_n=stash_n), ovf
        return update


BACKENDS: Dict[str, IndexBackend] = {}


def register_backend(backend: IndexBackend) -> IndexBackend:
    """Register an IndexBackend instance under ``backend.name``."""
    BACKENDS[backend.name] = backend
    return backend


def get_backend(name: str) -> IndexBackend:
    try:
        return BACKENDS[name]
    except KeyError:
        raise KeyError(f"unknown index backend {name!r}; registered: "
                       f"{sorted(BACKENDS)}") from None


register_backend(ProbeBackend())
register_backend(ScanBackend())
register_backend(BucketBackend())


def _lookup_fn(spec: SetSpec) -> DS.LookupFn:
    backend = get_backend(spec.backend)
    return functools.partial(backend.lookup, spec)


# ---------------------------------------------------------------------------
# Functional API.  Each op takes a state and returns the new one; the JAX
# package donates the input state, so callers must rebind --
# ``state, ok = insert(state, ...)`` -- and must not use the old state
# afterwards: an implementation may update its tensors in place.
# Keys, values and op codes are int32 tensors on the state's device.
# ---------------------------------------------------------------------------


def make_state(spec: SetSpec, device="cuda") -> SetState:
    """Fresh spec-shaped state on ``device``.  The bucket index is born
    empty-canonical (all ways EMPTY), which is exactly what ``init_index``
    would build from an empty pool."""
    nb, w, s = get_backend(spec.backend).state_geometry(spec)
    return DS.make_state(spec.capacity, spec.table_factor, nb, w, s,
                         device=device)


def insert(state: SetState, keys: torch.Tensor, values: torch.Tensor, *,
           spec: SetSpec) -> Tuple[SetState, torch.Tensor]:
    backend = get_backend(spec.backend)
    return DS._insert_impl(state, keys, values, mode=spec.mode,
                           lookup_fn=_lookup_fn(spec),
                           index_update=backend.update_index(spec, "insert"))


def remove(state: SetState, keys: torch.Tensor, *,
           spec: SetSpec) -> Tuple[SetState, torch.Tensor]:
    backend = get_backend(spec.backend)
    return DS._remove_impl(state, keys, mode=spec.mode,
                           lookup_fn=_lookup_fn(spec),
                           index_update=backend.update_index(spec, "remove"))


def contains(state: SetState, keys: torch.Tensor, *,
             spec: SetSpec) -> Tuple[SetState, torch.Tensor]:
    state, present, _ = DS._contains_impl(state, keys, mode=spec.mode,
                                          lookup_fn=_lookup_fn(spec))
    return state, present


def get_impl(state: SetState, keys: torch.Tensor, *, spec: SetSpec,
             default: int = 0, active: Optional[torch.Tensor] = None
             ) -> Tuple[SetState, torch.Tensor, torch.Tensor]:
    """Get body.  ``active`` masks out lanes that must be exact no-ops."""
    state, present, ids = DS._contains_impl(state, keys, mode=spec.mode,
                                            lookup_fn=_lookup_fn(spec),
                                            active=active)
    eidx = ids.clamp(0, state.values.shape[0] - 1).to(torch.int64)
    vals = torch.where(present, state.values[eidx], default)
    return state, vals, present


def get(state: SetState, keys: torch.Tensor, *, spec: SetSpec,
        default: int = 0) -> Tuple[SetState, torch.Tensor, torch.Tensor]:
    """Value lookup: (state, values-or-default, present).  Read-path psync
    semantics are identical to contains (SOFT: free; others may flush)."""
    return get_impl(state, keys, spec=spec, default=default)


def apply_batch_impl(state: SetState, ops: torch.Tensor, keys: torch.Tensor,
                     values: torch.Tensor, *, spec: SetSpec
                     ) -> Tuple[SetState, torch.Tensor]:
    """Mixed-batch body: one contains->insert->remove phase sweep, each
    phase a plan/commit pass.  Lanes whose op code matches no phase
    (OP_NOP) are exact no-ops."""
    backend = get_backend(spec.backend)
    lookup_fn = _lookup_fn(spec)
    is_c = ops == OP_CONTAINS
    is_i = ops == OP_INSERT
    is_r = ops == OP_REMOVE
    state, r_c, ids = DS._contains_impl(state, keys, mode=spec.mode,
                                        lookup_fn=lookup_fn, active=is_c)
    # the contains phase only touches flushed/psync accounting, never the
    # index fields, so its lookup is still valid for the insert phase
    state, r_i = DS._insert_impl(
        state, keys, values, mode=spec.mode, lookup_fn=lookup_fn,
        active=is_i, existing=ids,
        index_update=backend.update_index(spec, "insert"))
    state, r_r = DS._remove_impl(
        state, keys, mode=spec.mode, lookup_fn=lookup_fn, active=is_r,
        index_update=backend.update_index(spec, "remove"))
    return state, torch.where(is_i, r_i, torch.where(is_r, r_r, r_c))


def apply_batch(state: SetState, ops: torch.Tensor, keys: torch.Tensor,
                values: torch.Tensor, *, spec: SetSpec
                ) -> Tuple[SetState, torch.Tensor]:
    """Mixed-op batch: the serving traffic shape.

    ``ops`` i32[B] of OP_CONTAINS / OP_INSERT / OP_REMOVE selects each
    lane's operation on ``keys``/``values``.  Linearization: the contains
    phase observes the pre-batch state, then inserts, then removes (so a
    remove lane deletes a key inserted by an earlier lane of the same
    batch), with lane priority inside each phase.  Returns success/presence
    per lane.
    """
    return apply_batch_impl(state, ops, keys, values, spec=spec)


def recover_impl(persisted: torch.Tensor, keys: torch.Tensor,
                 values: torch.Tensor, stamp: Optional[torch.Tensor] = None,
                 *, spec: SetSpec) -> Tuple[SetState, torch.Tensor]:
    """Recovery body.  The overflow latch is RECOMPUTED here, never
    carried: the rebuilt state starts from a fresh ``make_state`` and
    ``state.overflow`` is re-derived from the rebuilt index alone."""
    backend = get_backend(spec.backend)
    member, hist = backend.recover_scan(spec, persisted)
    nb, w, s = backend.state_geometry(spec)
    state = DS._rebuild_from_member(
        member, keys, values, spec.table_factor, spec.max_probe,
        n_buckets=nb, bucket_width=w, stash_size=s,
        build_table=backend.builds_probe_table,
        index_init=functools.partial(backend.init_index, spec),
        stamp=stamp)
    return state, hist


def recover(persisted: torch.Tensor, keys: torch.Tensor,
            values: torch.Tensor, stamp: Optional[torch.Tensor] = None, *,
            spec: SetSpec) -> Tuple[SetState, torch.Tensor]:
    """Rebuild from the durable areas (Sections 3.5 / 4.6) on their device
    through the spec's backend: classification via backend.recover_scan
    (the recovery_scan kernel), then the index bulk build.  Returns (state,
    stage histogram i32[5]).  Recovery pays no psync: payloads are already
    durable."""
    return recover_impl(persisted, keys, values, stamp, spec=spec)


def crash_and_recover(state: SetState, u: torch.Tensor, *, spec: SetSpec
                      ) -> Tuple[SetState, torch.Tensor]:
    return recover(*DS.crash(state, u), spec=spec)


# ---------------------------------------------------------------------------
# Snapshot + delta-log hybrid recovery (DESIGN.md §11).
#
# A snapshot is the CANONICAL recovered state at a watermark W: the
# snapshotter captures the durable planes off the hot path, runs the normal
# ``recover`` on them (so the stored index is exactly what a full rebuild
# would produce), and persists the result.  Every durable commit stamps its
# slot with the current epoch inside the SAME scatter that moves the stage
# word, so ``stamp > W`` is a complete delta log that costs the mutation
# path zero extra psyncs.  Hybrid recovery merges the crash-time planes
# into the snapshot at the delta slots only, and re-canonicalizes exactly
# the bucket rows those slots touch: O(delta) classification and index
# patch, bit-identical to the full-pool rebuild (bucket rows and the stash
# are pure functions of the member set in node-id order, see
# ``build_buckets``).
# ---------------------------------------------------------------------------


def supports_hybrid_recovery(spec: SetSpec) -> bool:
    """The probe backend's recovery table is built by sequential first-free
    claiming over the whole pool: a slot's final probe position depends on
    every earlier slot, so no O(delta) patch can be bit-identical.  Hybrid
    recovery supports the bucket and scan backends; probe falls back to
    the full rebuild."""
    return not get_backend(spec.backend).builds_probe_table


def _delta_bucket_patch(snap: SetState, keys2, cur2, delta_idx, gi, valid,
                        member_d, *, spec: SetSpec):
    """Re-canonicalize exactly the bucket rows affected by the delta.

    Candidates = every live node hashing to an affected bucket (the buckets
    of the delta slots' snapshot-time AND crash-time keys), gathered in
    ascending node-id order, so rank-within-bucket among the candidates
    equals rank-within-bucket in the full ``build_buckets`` repack.  The
    dense stash is globally id-ordered, so it is recomputed from (kept
    unaffected spills) + (affected-bucket spills) with the same sized pack
    ``bucket_init`` uses."""
    n = spec.capacity
    nb, w = spec.bucket_geometry()
    s = spec.stash_size
    d = delta_idx.shape[0]
    dev = keys2.device

    # affected buckets: where the delta slots' old and new keys hash
    old_member = valid & (snap.cur[gi] == VALID)
    new_member = valid & member_d
    aff = torch.zeros((nb + 1,), dtype=torch.bool, device=dev)
    for member, k_at in ((old_member, snap.keys[gi]),
                         (new_member, keys2[gi])):
        aff.index_fill_(0, torch.where(member, hp_ops.bucket_of(k_at, nb),
                                       nb).long(), True)
    aff = aff[:nb]

    # candidates: all live members of affected buckets, ascending node id.
    # k bounds them: <= w per affected bucket row (<= 2 buckets per delta
    # slot) + every pre-existing stash spill + the delta slots themselves;
    # past k the stash has overflowed (> s spills) and the latch fires.
    h2 = hp_ops.bucket_of(keys2, nb)
    cand_mask = (cur2 == VALID) & aff[h2.long()]
    k = min(n, 2 * d * w + s + d)
    cand = where_sized(cand_mask, k, n)
    cvalid = cand < n
    cg = torch.where(cvalid, cand, 0).long()
    ck = torch.where(cvalid, keys2[cg], 0)
    cb = torch.where(cvalid, h2[cg], nb)

    # rank within bucket among candidates (== rank in the full repack: the
    # stable sort groups buckets preserving ascending-id order; a group
    # starts at its bucket's first position in the sorted run)
    order = torch.argsort(cb, stable=True)
    sb = cb[order]
    rank = torch.arange(k, device=dev) - torch.searchsorted(sb, sb)
    ok = (sb < nb) & (rank < w)

    # clear affected rows, rebuild them canonically
    flat = torch.where(ok, sb.long() * w + rank, nb * w)
    bkeys = set_drop(torch.where(aff[:, None], 0, snap.bkeys).reshape(-1),
                     flat, ck[order]).reshape(nb, w)
    bids = set_drop(torch.where(aff[:, None], EMPTY, snap.bids).reshape(-1),
                    flat, cand[order]).reshape(nb, w)

    # stash: spills = kept unaffected spills + affected-bucket overflow,
    # re-packed in ascending node-id order exactly like bucket_init
    keep = (snap.sids >= 0) & ~aff[hp_ops.bucket_of(snap.skeys, nb).long()]
    spilled = ~ok & (sb < nb)
    spill_mask = torch.zeros((n,), dtype=torch.int32, device=dev)
    spill_mask = DS._max_at(spill_mask, torch.where(keep, snap.sids, 0),
                            keep)
    spill_mask = DS._max_at(spill_mask,
                            torch.where(spilled, cand[order], 0),
                            spilled) > 0
    spill = DS._count(spill_mask)
    idx = where_sized(spill_mask, s, -1)
    got = idx >= 0
    sids = torch.where(got, idx, EMPTY)
    skeys = torch.where(got, keys2[idx.clamp(min=0).long()], 0)
    return bkeys, bids, skeys, sids, spill.clamp(max=s), spill > s


def hybrid_recover(snap: SetState, persisted: torch.Tensor,
                   keys: torch.Tensor, values: torch.Tensor,
                   stamp: torch.Tensor, delta_idx: torch.Tensor, *,
                   spec: SetSpec) -> SetState:
    """Snapshot + delta-log recovery on the planes' device: O(delta) work
    on top of the restored snapshot, bit-identical to ``recover`` on the
    same crash planes.  The JAX package donates ``snap``: callers must not
    use it afterwards.

    ``snap`` is the canonical snapshot state at watermark W;
    ``persisted``/``keys``/``values``/``stamp`` are the crash-time durable
    planes; ``delta_idx`` i32[D] lists the slots with ``stamp > W`` (padded
    with ``capacity``, see :func:`pad_delta`).  Slots outside the delta are
    bit-identical between capture and crash (every durable mutation stamps
    its slot inside the commit scatter), so classification -- the
    ``recovery_scan`` kernel on the card -- runs over the gathered delta
    only.  No psync is ever issued."""
    backend = get_backend(spec.backend)
    if backend.builds_probe_table:
        raise ValueError(
            f"backend {spec.backend!r} does not support hybrid recovery "
            "(sequential probe-table build has no canonical delta patch); "
            "use the full recover()")
    n = spec.capacity
    valid = delta_idx < n
    gi = torch.where(valid, delta_idx, 0).long()
    # classification over the compacted delta only (padding -> stage FREE)
    member_d, _ = backend.recover_scan(
        spec, torch.where(valid, persisted[gi], 0))
    member_d = member_d & valid

    scat = torch.where(valid, delta_idx, n).long()   # n => dropped lane
    keys2 = set_drop(snap.keys, scat, torch.where(member_d, keys[gi], 0))
    values2 = set_drop(snap.values, scat,
                       torch.where(member_d, values[gi], 0))
    cur2 = set_drop(snap.cur, scat, DS._where_i32(member_d, VALID, FREE))
    stamp2 = set_drop(snap.stamp, scat, stamp[gi])
    was_member = valid & (snap.cur[gi] == VALID)
    state = snap._replace(
        keys=keys2, values=values2, cur=cur2, flushed=cur2, stamp=stamp2,
        size=snap.size + DS._count(member_d) - DS._count(was_member),
        epoch=stamp2.max().clamp(min=0) + 1,
    )
    if backend.state_geometry(spec)[0] > 0:   # bucket: O(delta) index patch
        bkeys, bids, skeys, sids, stash_n, ovf = _delta_bucket_patch(
            snap, keys2, cur2, delta_idx, gi, valid, member_d, spec=spec)
        return state._replace(bkeys=bkeys, bids=bids, skeys=skeys,
                              sids=sids, stash_n=stash_n, overflow=ovf)
    # scan backend: no volatile index to patch
    return state._replace(overflow=torch.zeros((), dtype=torch.bool,
                                               device=keys2.device))


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` that owns its memory: ``.numpy()`` of a CPU
    tensor is a view, which a later in-place update would change."""
    return t.detach().to("cpu", copy=True).numpy()


def _on_device(a, device, dtype=None) -> torch.Tensor:
    """A tensor on ``device`` that owns its memory, from host data:
    ``torch.as_tensor`` of a CPU array would share the array's memory."""
    return torch.tensor(np.asarray(a, dtype), device=device)


def export_pool(state: SetState) -> dict:
    """Host copies of the DURABLE node-pool planes at a dispatch boundary
    (``cur == flushed`` holds there): the exact NVM content a migration,
    resharding, or snapshot reads.  Zero psyncs -- a pure read of already
    persisted planes.  The copies own their memory, so later batches never
    change them."""
    return {"stage": _host(state.flushed), "keys": _host(state.keys),
            "values": _host(state.values), "stamp": _host(state.stamp)}


def import_pool(planes: dict, *, spec: SetSpec, device="cuda"
                ) -> Tuple[SetState, torch.Tensor]:
    """Recovery-class bulk rebuild from raw pool planes (the
    :func:`export_pool` layout) on ``device``: classification scan +
    volatile-index build, exactly like crash recovery -- and like it, zero
    psyncs.  The state owns its memory.  Returns ``(state, stage histogram
    i32[5])``."""
    dev = resolve_device(device)
    return recover(*(_on_device(planes[f], dev, np.int32)
                     for f in ("stage", "keys", "values", "stamp")),
                   spec=spec)


def _padded_len(size: int) -> int:
    return max(8, 1 << max(0, int(size) - 1).bit_length())


def pad_delta(idx: np.ndarray, capacity: int) -> np.ndarray:
    """Pad a host-side delta slot list to a power-of-two length >= 8 with
    ``capacity`` (the dropped-lane sentinel), so that the number of
    distinct delta shapes is O(log N) and both packages see the same
    ones."""
    idx = np.asarray(idx, np.int32)
    out = np.full((_padded_len(idx.size),), capacity, np.int32)
    out[:idx.size] = idx
    return out


def hybrid_hist(meta: dict, raw_stage: np.ndarray, slots: np.ndarray,
                stages: np.ndarray) -> np.ndarray:
    """The stage histogram i32[5] a full scan of the crash planes would
    count, corrected in O(delta) from the snapshot's (``meta["hist"]``,
    over the capture's raw stages): the canonical snapshot collapsed
    DELETED slots to FREE, so the stored capture-time raw stages of the
    delta ``slots`` go out and their crash-time ``stages`` come in."""
    hist = (np.asarray(meta["hist"], np.int64)
            - np.bincount(np.clip(np.asarray(raw_stage)[slots], 0, 4),
                          minlength=5)
            + np.bincount(np.clip(stages, 0, 4), minlength=5))
    return hist.astype(np.int32)


def find_delta(persisted: torch.Tensor, stamp: torch.Tensor,
               watermark: int):
    """The delta of a crash, found on the planes' device: the slots whose
    stamp is newer than ``watermark``.  Returns ``(delta_idx, slots,
    stages)``: ``delta_idx`` i32 on the device, equal to
    ``pad_delta(slots, N)``; the slots in ascending order and their
    persisted stages, as host int32 arrays.  Two host syncs (the size of
    the nonzero, and one copy of the delta and its stages), and the whole
    stamp and stage planes never cross to the host."""
    n = stamp.shape[0]
    delta = torch.nonzero(stamp > watermark).flatten().to(torch.int32)
    size = delta.numel()
    host = torch.stack([delta, persisted[delta.long()]]).cpu().numpy()
    delta_idx = torch.full((_padded_len(size),), n, dtype=torch.int32,
                           device=stamp.device)
    delta_idx[:size] = delta
    return delta_idx, host[0], host[1]


# ---------------------------------------------------------------------------
# Object facade
# ---------------------------------------------------------------------------


class MetricsMixin:
    """Observability plumbing shared by the durable-structure facades.

    Everything here is host-side and opt-in: with no registry attached a
    facade pays nothing, and even with one attached the device counters
    are only read inside ``_metrics_collect`` -- at registry SNAPSHOT time
    -- never per dispatched batch.  The host class provides ``psyncs`` /
    ``ops`` / ``__len__`` / ``overflowed`` / ``last_recovery_hist`` and
    calls ``_metrics_pre_recovery`` (before applying a crash: the device
    counters are about to reset) and ``_metrics_post_recovery`` (after the
    rebuild) from its ``crash_and_recover``.
    """
    _m = None                       # MetricsRegistry (opt-in)
    _m_name = "structure"
    _m_bridge = None
    last_recovery_seconds = None

    def attach_metrics(self, registry, name: Optional[str] = None):
        """Register this structure's telemetry with a
        :class:`repro_torch.obs.MetricsRegistry` under ``name``.  Returns
        self.  Device counters cross to the host only when the registry
        snapshots.  A sharded map partitioned over the ranks of a process
        group reads its counters by collectives: every rank attaches a
        registry and snapshots it at the same points."""
        from repro_torch.obs.bridge import DeviceCounterBridge
        if name is not None:
            self._m_name = name
        self._m = registry
        self._m_bridge = DeviceCounterBridge(registry, self._m_name)
        registry.register_collector(self._m_name, self._metrics_collect)
        return self

    def _metrics_extra(self) -> dict:
        """Subclass hook: structure-specific snapshot fields."""
        return {}

    def _metrics_collect(self) -> dict:
        b = self._m_bridge
        psyncs, ops = self.psyncs, self.ops
        b.fold(psync=psyncs, op=ops)
        out = {
            "psyncs": psyncs,                  # device counters (reset at
            "ops": ops,                        # recovery)
            "psync_total": b.total("psync"),   # monotone lifetime totals
            "ops_total": b.total("op"),
            "size": len(self),
            "overflowed": bool(self.overflowed),
            "recoveries":
                self._m.counter(f"{self._m_name}.recoveries").value,
            "recovery_psyncs":
                self._m.counter(f"{self._m_name}.recovery_psyncs").value,
        }
        if self.last_recovery_hist is not None:
            out["last_recovery_hist"] = np.asarray(
                self.last_recovery_hist).tolist()
            out["last_recovery_seconds"] = self.last_recovery_seconds
        out.update(self._metrics_extra())
        return out

    def _metrics_pre_recovery(self):
        """Fold the pre-crash counter deltas (they are about to reset)."""
        if self._m is not None:
            self._m_bridge.fold(psync=self.psyncs, op=self.ops)

    def _metrics_post_recovery(self, scanned_slots: int,
                               from_snapshot: int = 0,
                               from_delta: Optional[int] = None):
        """Record the recovery: duration, scanned-slot gauges, and the
        recovery-psync counter (exactly 0 by construction -- payloads are
        already durable; the counter existing makes that checkable)."""
        if self._m is None:
            return
        if from_delta is None:
            from_delta = scanned_slots
        m, name = self._m, self._m_name
        m.counter(f"{name}.recoveries").inc()
        m.counter(f"{name}.recovery_psyncs").inc(self.psyncs)
        m.gauge(f"{name}.last_recovery_scanned_slots").set(scanned_slots)
        m.gauge(f"{name}.last_recovery_from_snapshot_slots").set(
            from_snapshot)
        m.gauge(f"{name}.last_recovery_from_delta_slots").set(from_delta)
        m.gauge(f"{name}.last_recovery_seconds").set(
            self.last_recovery_seconds)
        m.histogram(f"span.{name}.recovery").record(
            self.last_recovery_seconds)
        self._m_bridge.mark_reset(psync=self.psyncs, op=self.ops)

    def _recheck_overflow(self):
        """Subclass hook: run the facade's one-shot overflow check."""
        self._check_overflow()

    def _post_recovery_overflow(self):
        """Recovery epilogue: the rebuild recomputed ``state.overflow`` from
        the rebuilt index, so the one-shot warning is re-armed in the same
        breath -- a genuine post-recovery overflow warns again, a spurious
        pre-crash latch is gone."""
        self._overflow_warned = False
        self._recheck_overflow()


class DurableMap(MetricsMixin):
    """Object API over the engine (single-controller usage).

    >>> m = DurableMap(SetSpec(capacity=1024, mode="soft", backend="bucket"))
    >>> m.insert([1, 2], [10, 20])
    >>> m.contains([1, 3])          # -> [True, False]
    >>> m.crash_and_recover()       # volatile index lost + rebuilt

    The state lives on ``device`` (the GPU unless the caller asks for
    another); results come back as tensors on that device.
    """

    def __init__(self, spec: Optional[SetSpec] = None, metrics=None,
                 metrics_name: str = "map", device="cuda", **spec_kwargs):
        if spec is None:
            spec = SetSpec(**spec_kwargs)
        elif spec_kwargs:
            spec = dataclasses.replace(spec, **spec_kwargs)
        get_backend(spec.backend)        # fail fast on unknown backends
        self.spec = spec
        self.device = resolve_device(device)
        self.state = make_state(spec, device=self.device)
        self.last_recovery_hist = None   # i32[5] stage histogram, post-recover
        self.last_recovery_seconds = None
        self._overflow_warned = False
        self._m_name = metrics_name
        if metrics is not None:
            self.attach_metrics(metrics, name=metrics_name)

    def _i32(self, x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x)
        return torch.as_tensor(x, dtype=torch.int32, device=self.device)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @property
    def overflowed(self) -> bool:
        """True once the index overflow latch fired: node-pool exhaustion or
        a bucket-backend stash spill past ``stash_size``.  Data may be
        unreachable from that point on -- detectable, never silent."""
        return bool(self.state.overflow)

    def _check_overflow(self):
        """One-shot warning when a mutating op latches ``state.overflow``
        instead of silently degrading lookups."""
        if not self._overflow_warned and self.overflowed:
            self._overflow_warned = True
            warn_structure(
                f"{type(self).__name__} index overflow latched "
                f"(capacity/probe/stash exhausted for spec={self.spec}); "
                "subsequent lookups may miss live keys -- grow capacity, "
                "stash_size, or shard the map", stacklevel=4)

    def insert(self, keys, values=None):
        keys = self._i32(keys)
        values = keys if values is None else self._i32(values)
        self.state, ok = insert(self.state, keys, values, spec=self.spec)
        self._check_overflow()
        return ok

    def remove(self, keys):
        self.state, ok = remove(self.state, self._i32(keys), spec=self.spec)
        return ok

    def contains(self, keys):
        self.state, ok = contains(self.state, self._i32(keys), spec=self.spec)
        return ok

    def get(self, keys, default: int = 0):
        """Values for present keys, ``default`` otherwise."""
        self.state, vals, _ = get(self.state, self._i32(keys),
                                  spec=self.spec, default=default)
        return vals

    def apply(self, ops, keys, values=None):
        """Mixed contains/insert/remove batch; see :func:`apply_batch`."""
        keys = self._i32(keys)
        values = keys if values is None else self._i32(values)
        self.state, res = apply_batch(self.state, self._i32(ops), keys,
                                      values, spec=self.spec)
        self._check_overflow()
        return res

    def _adversary(self, u) -> torch.Tensor:
        """The crash adversary on the state's device: float32 in [0, 1) per
        node, zeros when ``u`` is None."""
        if u is None:
            return torch.zeros_like(self.state.cur, dtype=torch.float32)
        if not isinstance(u, torch.Tensor):
            u = np.asarray(u, np.float32)
        return torch.as_tensor(u, dtype=torch.float32, device=self.device)

    def crash_and_recover(self, u=None):
        """Crash under the adversary ``u`` (float32 in [0, 1) per node;
        zeros by default) and rebuild from the durable planes."""
        u = self._adversary(u)
        self._metrics_pre_recovery()     # device counters are about to reset
        self._sync()
        t0 = time.perf_counter()
        self.state, hist = crash_and_recover(self.state, u, spec=self.spec)
        self._sync()                     # honest recovery timing
        self.last_recovery_seconds = time.perf_counter() - t0
        self.last_recovery_hist = hist.cpu().numpy()
        self._metrics_post_recovery(scanned_slots=self.spec.capacity)
        self._post_recovery_overflow()   # latch recomputed; warning re-armed
        return self

    # --- snapshot + delta-log hybrid recovery (DESIGN.md §11) -----------

    _SNAP_FIELDS = ("keys", "values", "cur", "stamp", "bkeys", "bids",
                    "skeys", "sids", "stash_n", "size", "overflow")

    @property
    def supports_hybrid(self) -> bool:
        return supports_hybrid_recovery(self.spec)

    def snapshot_capture(self) -> dict:
        """Cheap synchronous phase: host-copy the durable planes at a
        dispatch boundary and open a new stamp generation.  Every commit
        from here on stamps ``> W``, so the op stream IS the delta log on
        top of this capture.  Zero psyncs: every plane copied is already
        durable (``cur == flushed`` at each dispatch boundary), so this is
        a pure read of NVM."""
        w = int(self.state.epoch)
        pool = export_pool(self.state)
        cap = {"watermark": w, "raw_stage": pool["stage"],
               "keys": pool["keys"], "values": pool["values"],
               "stamp": pool["stamp"]}
        self.state = self.state._replace(epoch=torch.full(
            (), w + 1, dtype=torch.int32, device=self.device))
        return cap

    def snapshot_build(self, cap: dict):
        """Expensive phase, safe in a background thread (a pure function of
        the captured host copies; it runs on the device's default stream):
        canonicalize the capture by running the normal ``recover`` on it,
        so the stored snapshot is exactly the full-rebuild state at
        watermark W and hybrid recovery can patch it in O(delta).  Returns
        (planes, meta) for the store."""
        st, hist = import_pool({"stage": cap["raw_stage"],
                                "keys": cap["keys"],
                                "values": cap["values"],
                                "stamp": cap["stamp"]},
                               spec=self.spec, device=self.device)
        planes = {f: _host(getattr(st, f)) for f in self._SNAP_FIELDS}
        planes["raw_stage"] = cap["raw_stage"]
        meta = {"kind": "map", "watermark": cap["watermark"],
                "hist": hist.tolist()}
        return planes, meta

    def _snapshot_state(self, planes: dict) -> SetState:
        """The canonical snapshot state on the map's device from stored
        planes (the probe ``table`` is all-EMPTY for hybrid-capable
        backends, so ``make_state`` provides it; counters restart at zero
        exactly as full recovery's do).  Every leaf owns its memory, so
        the planes never change under later batches."""
        def leaf(f):
            return _on_device(planes[f], self.device)
        cur = leaf("cur")
        return make_state(self.spec, device=self.device)._replace(
            keys=leaf("keys"), values=leaf("values"), cur=cur, flushed=cur,
            stamp=leaf("stamp"), bkeys=leaf("bkeys"), bids=leaf("bids"),
            skeys=leaf("skeys"), sids=leaf("sids"), stash_n=leaf("stash_n"),
            size=leaf("size"), overflow=leaf("overflow"))

    def hybrid_crash_and_recover(self, planes: dict, meta: dict, u=None):
        """Crash (losing the volatile index) and recover from the stored
        snapshot + the stamp delta instead of the full pool: O(delta)
        classification and index patch, bit-identical to
        ``crash_and_recover`` under the same adversary ``u``.  The delta is
        found and gathered on the device (:func:`find_delta`).  Recovery
        psyncs: exactly 0, as always."""
        u = self._adversary(u)
        n = self.spec.capacity
        self._metrics_pre_recovery()
        self._sync()
        t0 = time.perf_counter()
        crashed = DS.crash(self.state, u)
        delta_idx, delta, stage_d = find_delta(crashed[0], crashed[3],
                                               int(meta["watermark"]))
        snap = self._snapshot_state(planes)
        self.state = hybrid_recover(snap, *crashed, delta_idx,
                                    spec=self.spec)
        self.last_recovery_hist = hybrid_hist(meta, planes["raw_stage"],
                                              delta, stage_d)
        self._sync()
        self.last_recovery_seconds = time.perf_counter() - t0
        self._metrics_post_recovery(scanned_slots=int(delta.size),
                                    from_snapshot=n - int(delta.size),
                                    from_delta=int(delta.size))
        self._post_recovery_overflow()
        return self

    @property
    def psyncs(self):
        return int(self.state.n_psync)

    @property
    def ops(self):
        return int(self.state.n_ops)

    def __len__(self):
        return int(self.state.size)

    def __repr__(self):
        return (f"DurableMap(size={len(self)}, psyncs={self.psyncs}, "
                f"spec={self.spec})")


class DurableSet(DurableMap):
    """Deprecated legacy surface: use ``DurableMap(SetSpec(...))``.

    The old ``index=`` kwarg maps 1:1 onto backend names.
    """

    def __init__(self, capacity: int, mode: str = "soft",
                 index: str = "probe", device="cuda"):
        warnings.warn("DurableSet is deprecated; use "
                      "DurableMap(SetSpec(capacity=..., mode=..., "
                      "backend=...))", DeprecationWarning, stacklevel=2)
        super().__init__(SetSpec(capacity=capacity, mode=mode, backend=index),
                         device=device)
        self.mode, self.index = mode, index
