"""DurableMap engine: SetSpec config + pluggable volatile-index backends.

PyTorch port of ``repro.core.engine``.  The paper's central idea is the
split between a durable node pool and a *volatile* index that is rebuilt
on recovery; the index is a swappable backend:

  probe    linear probing over ``SetState.table`` (the default; the
           paper's hash-set runs).  On the card a lookup is the CUDA kernel
           ``hash_probe.table_probe_cuda``, one warp per query over its
           whole probe window; writes claim and release slots with
           ``table_claim`` / ``table_release``; recovery runs
           ``recovery_scan.scan_cuda`` and rebuilds the table.
  scan     O(N) traversal lookup (the paper's linked-list runs); recovery
           runs ``recovery_scan.scan_cuda``.
  bucket   set-associative (NB buckets x W ways) index carried in
           ``SetState``: built once at make_state/recovery, updated
           incrementally by the op bodies (O(B*W) scatter), and probed by
           the CUDA kernel ``hash_probe.probe_cuda``; recovery runs the
           CUDA kernel ``recovery_scan.scan_cuda``.  Live nodes that
           overflow a bucket land in an exact dense stash the lookup also
           reads, so the backend is correct at any load factor.

Everything is configured by one frozen :class:`SetSpec`.  The serving-shaped
entry point is :func:`apply_batch`: a mixed contains/insert/remove lane
vector.  Mixed batches linearize phase by phase (all contains, then all
inserts, then all removes) with lane priority inside a phase.

:class:`DurableMap` is the object facade; its state lives on the device it
is given (``"cuda"`` by default).
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
from repro_torch.core.durable_set import SetState, MODES
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
        snapshots."""
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

    def crash_and_recover(self, u=None):
        """Crash under the adversary ``u`` (float32 in [0, 1) per node;
        zeros by default) and rebuild from the durable planes."""
        if u is None:
            u = torch.zeros_like(self.state.cur, dtype=torch.float32)
        elif not isinstance(u, torch.Tensor):
            u = np.asarray(u, np.float32)
        u = torch.as_tensor(u, dtype=torch.float32, device=self.device)
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
