"""Online shard resharding: S -> 2S split and 2S -> S merge with live
migration (DESIGN.md §12, "Elastic capacity").

PyTorch port of ``repro.core.resize``.  A full map GROWS instead of
latching overflow or shedding lanes -- extendible-hashing style, over the
stacked-pool sharded map of :mod:`repro_torch.core.shard`:

  prefix refinement   shard id is the high ``log2(S)`` bits of
                      ``hash32(key)`` (``shard_of``), so an S -> 2S
                      split is pure prefix refinement: parent shard p
                      partitions into exactly children 2p and 2p+1 by
                      the NEXT hash bit.  In-shard placement consumes
                      the LOW bits, so it is untouched by a resize.
  positional copy     migration is NON-compacting: child slot i is
                      parent slot i when the node's next hash bit
                      selects that child, else FREE.  The child planes
                      are a pure elementwise function of the parent
                      planes (:func:`split_planes`): an incremental
                      chunked copy + a commit-time delta patch is
                      bit-identical to an atomic mask-split, and a
                      restarted migration simply overwrites any partial
                      copy.
  split frontier      a single durable integer f: parents < f are
                      COMMITTED (traffic routes to their children),
                      parents >= f still own their keys.  Advancing f
                      is ONE durable stamp, so a crash at ANY step
                      recovers to fully-parent or fully-child per shard.
  psync discipline    migration writes are RECOVERY-CLASS bulk persists
                      (one per copied chunk, one per commit patch, one
                      per frontier stamp), counted in a SEPARATE
                      host-side ``migration_psyncs`` counter -- the hot
                      path keeps its bound (SOFT: 1 psync per successful
                      update, 0 per read or failed op) to the last digit
                      during and after a migration, and recovery still
                      pays 0.

Per-parent protocol (split; merge is the mirror image over pairs):

  1. open a delta generation: watermark W_p := epoch[p], bump epoch[p]
     (volatile, free) -- every commit to p from here on stamps > W_p
  2. chunked positional copy of p's durable planes into two host child
     buffers (traffic keeps routing to p; each chunk is one bulk persist)
  3. commit at a dispatch boundary: re-copy the delta slots (stamp >
     W_p), bulk-persist, rebuild both children with the normal recovery
     path (``engine.import_pool`` on the map's device: ``recovery_scan``
     on the card, zero psyncs), install them as rows 2p / 2p+1 of the
     target map
  4. advance the frontier: ONE durable stamp.

No step ever clears the parent row on NVM: aggregates (len / overflowed)
mask by the frontier instead.  Merge places child 2p positionally and
child 2p+1's live nodes into ascending free slots (:func:`merge_planes`);
a merge whose pair does not fit refuses at begin (and again at commit).

On the card every host read of the state is a device-to-host copy that
owns its memory (``RT._to_host``, ``engine._host``): the sharded map
writes its rows in place, so a view would change under the migration.
A chunk's four planes cross in one copy; the commit finds its delta on
the device and copies only the delta slots.

Under ``use_shard_map`` in a process group of several ranks
(:mod:`repro_torch.launch.mesh`) the old and the new map each hold their
own rows on every rank, and a resize moves rows between ranks when S
crosses the world size (D changes: a split 1 -> 2 or 2 -> 4, a merge 4 -> 2
or 2 -> 1 over 4 ranks; with D fixed, children 2p and 2p+1 sit on their
parent's rank).  The migration's host state -- the open unit, its
watermarks and child buffers, the frontier, the counters -- is the same
on every rank, so every rank makes the same calls and collectives in the
same order: the rank holding a source row copies it to the host and
broadcasts the planes (no broadcast where every rank holds the row), every
rank fills the same buffers, and the rank holding each destination row
rebuilds it (``import_pool``) at its local index.  A merge that does not
fit raises on every rank.  The JAX package runs the same protocol on the
global arrays under ``shard_map``; the rows come out equal.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import engine as E
from repro_torch.core import router as RT
from repro_torch.core import shard as SH
from repro_torch.core.engine import (MetricsMixin, OP_CONTAINS, OP_INSERT,
                                     OP_NOP, OP_REMOVE, SetSpec)
from repro_torch.core.nvm import FREE, VALID
from repro_torch.core.shard import ShardSpec, ShardedDurableMap, np_shard_of

PLANES = ("stage", "keys", "values", "stamp")


def check_resizable_placement(sspec) -> None:
    """Refuse strided placement wherever storage rows can differ from
    shard ids (several stage-1 groups, or a mesh): the migration and the
    plane functions move storage row u as shard u, so such a resize would
    lose acknowledged keys (the JAX package loses them; ROADMAP C)."""
    if sspec.placement == "strided" and (sspec.n_device_groups > 1
                                         or sspec.use_shard_map):
        raise ValueError(
            "resizing a strided map with several device groups "
            f"(n_device_groups={sspec.n_device_groups}, use_shard_map="
            f"{sspec.use_shard_map}) is refused: the migration moves storage "
            "row u as shard u, and under strided placement storage rows "
            "are not shard ids, so keys would be lost; use "
            "placement='contiguous'")


class ResizeCapacityError(RuntimeError):
    """A 2S -> S merge does not fit: some pair's live nodes exceed the
    per-shard capacity.  The map is left fully consistent (the failing
    pair was not committed); drain it or split back instead."""


# ---------------------------------------------------------------------------
# Canonical plane resharding (pure host functions -- the spec the online
# engine, the offline comparator, and the snapshot elastic restore share).
# ---------------------------------------------------------------------------


def split_planes(planes: dict, n_shards: int) -> dict:
    """Atomic mask-split of stacked (S, N) pool planes into (2S, N):
    child 2p+c keeps parent p's slot i exactly when the slot is live
    (stage VALID) and the node's next hash bit equals c; every other
    child slot is canonical FREE/0.  Positional: child slot i == parent
    slot i, the invariant the online chunked copy relies on."""
    stage = np.asarray(planes["stage"])
    keys = np.asarray(planes["keys"])
    vals = np.asarray(planes["values"])
    stamp = np.asarray(planes["stamp"])
    s, n = stage.shape
    assert s == n_shards, (s, n_shards)
    member = stage == VALID
    # next hash bit = low bit of the shard id at 2S (prefix refinement)
    bit = np_shard_of(keys.reshape(-1), 2 * n_shards).reshape(s, n) & 1
    out = {k: np.zeros((2 * s, n), np.int32) for k in PLANES}
    for c in (0, 1):
        m = member & (bit == c)
        out["stage"][c::2] = np.where(m, VALID, FREE)
        out["keys"][c::2] = np.where(m, keys, 0)
        out["values"][c::2] = np.where(m, vals, 0)
        out["stamp"][c::2] = np.where(m, stamp, 0)
    return out


def merge_pair(a: dict, b: dict) -> dict:
    """Canonical merge of two sibling shards' (N,) planes: child ``a``
    (the even child) keeps its slots positionally; child ``b``'s live
    nodes go to ascending free slots.  Raises
    :class:`ResizeCapacityError` when they do not fit."""
    n = a["stage"].shape[0]
    out = {k: np.where(a["stage"] == VALID, np.asarray(a[k]), 0)
           .astype(np.int32) for k in ("keys", "values", "stamp")}
    out["stage"] = np.where(a["stage"] == VALID, VALID, FREE).astype(np.int32)
    src = np.flatnonzero(b["stage"] == VALID)
    free = np.flatnonzero(out["stage"] == FREE)
    if src.size > free.size:
        raise ResizeCapacityError(
            f"merge does not fit: {src.size} live nodes in the odd child "
            f"but only {free.size} free slots beside the even child's "
            f"{n - free.size} (capacity {n} per shard)")
    dst = free[:src.size]
    out["stage"][dst] = VALID
    for k in ("keys", "values", "stamp"):
        out[k][dst] = np.asarray(b[k])[src]
    return out


def merge_planes(planes: dict, n_shards: int) -> dict:
    """Atomic merge of stacked (2S, N) pool planes into (S, N) by
    :func:`merge_pair` per sibling pair."""
    s2 = np.asarray(planes["stage"]).shape[0]
    assert s2 == n_shards and s2 % 2 == 0, (s2, n_shards)
    rows = []
    for u in range(s2 // 2):
        a = {k: np.asarray(planes[k])[2 * u] for k in planes}
        b = {k: np.asarray(planes[k])[2 * u + 1] for k in planes}
        rows.append(merge_pair(a, b))
    return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


def reshard_planes(planes: dict, n_shards: int, new_n_shards: int) -> dict:
    """Reshard stacked pool planes across any power-of-two factor by
    repeated :func:`split_planes` / :func:`merge_planes` -- the offline
    comparator for the online engine and the loader for snapshot-aware
    elastic restore (``repro_torch.store.snapshot.load_resharded``)."""
    for nm in PLANES:
        if nm not in planes:
            raise KeyError(f"reshard_planes needs plane {nm!r}")
    s, t = n_shards, new_n_shards
    if s < 1 or (s & (s - 1)) or t < 1 or (t & (t - 1)):
        raise ValueError(f"shard counts must be powers of two ({s} -> {t})")
    out = {k: np.asarray(planes[k], np.int32) for k in PLANES}
    while s < t:
        out = split_planes(out, s)
        s *= 2
    while s > t:
        out = merge_planes(out, s)
        s //= 2
    return out


# ---------------------------------------------------------------------------
# The durable frontier register.
# ---------------------------------------------------------------------------


class MigrationFrontier:
    """The resize root record: a tiny durable register holding the
    migration phase and the committed-unit frontier.  Advancing it is
    ONE durable stamp (``stamp()``); everything else about an
    in-progress unit (watermarks, partial copies) is volatile-or-
    overwritten, so this register alone decides what a crash recovers
    to.  Modeled host-side (like the psync counters); ``psyncs`` counts
    its stamps and feeds ``migration_psyncs``."""
    __slots__ = ("phase", "committed", "units", "psyncs")

    def __init__(self):
        self.phase = "idle"              # "idle" | "split" | "merge"
        self.committed = 0               # units < committed are durable
        self.units = 0                   # total migration units this phase
        self.psyncs = 0                  # durable stamps of this register

    def stamp(self, phase: str, committed: int, units: int) -> None:
        """Durably persist (phase, frontier): one psync."""
        self.phase = phase
        self.committed = committed
        self.units = units
        self.psyncs += 1

    def __repr__(self):
        return (f"MigrationFrontier({self.phase}, "
                f"{self.committed}/{self.units})")


# ---------------------------------------------------------------------------
# The elastic facade.
# ---------------------------------------------------------------------------


class ElasticShardedMap(MetricsMixin):
    """A :class:`ShardedDurableMap` that can change S online.

    >>> m = ElasticShardedMap(SetSpec(capacity=1 << 16, backend="bucket"),
    ...                       n_shards=4)              # on the GPU
    >>> m.insert(keys, vals)            # normal traffic
    >>> m.begin_split()                 # open an S -> 2S migration
    >>> while not m.step():             # interleave with traffic freely
    ...     m.apply(ops, keys, vals)    # routed by the split frontier
    >>> m.n_shards                      # -> 8
    >>> m.crash_and_recover()           # legal at ANY point above

    The facade mirrors the ``ShardedDurableMap`` API (insert / remove /
    contains / get / apply / crash_and_recover / psyncs / ops / len /
    overflowed) and adds ``begin_split`` / ``begin_merge`` / ``step`` /
    ``split`` / ``merge``.  During a migration, batches are partitioned
    host-side by the frontier -- lanes of committed units run against
    the new-geometry map, the rest against the old one; same-key lanes
    always share a unit, so per-key order (linearization) is preserved.
    Both maps, and every child rebuilt at a commit, live on ``device``.

    Constraints: router v2 and ``pipeline_depth == 1`` (the frontier
    protocol commits at dispatch boundaries; the synchronous facade IS
    always at one); no strided placement with several device groups
    (:func:`check_resizable_placement`).  Aggregates mask retired rows by
    the frontier; the old map is dropped entirely once every unit
    committed.

    Under ``use_shard_map`` in a process group every rank makes the same
    calls with the same batches (see the module docstring): the traffic,
    the migration steps, ``len``, ``overflowed``, ``psyncs``, ``ops`` and
    ``repr`` are collectives there.  ``device`` is the rank's own.
    """

    def __init__(self, spec=None, n_shards: Optional[int] = None,
                 migrate_chunk: int = 4096, metrics=None,
                 metrics_name: str = "elastic_map", device="cuda",
                 **spec_kwargs):
        self.map = ShardedDurableMap(spec, n_shards=n_shards, device=device,
                                     **spec_kwargs)
        check_resizable_placement(self.map.sspec)
        if self.map.sspec.router != "v2":
            raise ValueError("ElasticShardedMap requires router='v2' "
                             "(frontier-masked gets use the stage-1 plan)")
        if self.map.sspec.pipeline_depth != 1:
            raise ValueError(
                "ElasticShardedMap requires pipeline_depth=1: the frontier "
                "protocol commits at dispatch boundaries and the pipelined "
                "facade keeps batches staged across them")
        if migrate_chunk < 1:
            raise ValueError("migrate_chunk must be >= 1")
        self.device = self.map.device
        self.migrate_chunk = int(migrate_chunk)
        self.target: Optional[ShardedDurableMap] = None
        self.frontier = MigrationFrontier()
        self._mig = None                 # volatile per-unit progress
        self._psync_base = 0             # retired maps' device counters
        self._ops_base = 0
        self.migration_psyncs = 0        # recovery-class bulk persists
        self.migrated_nodes = 0          # live nodes moved, lifetime
        self.splits = 0                  # completed S -> 2S migrations
        self.merges = 0                  # completed 2S -> S migrations
        self.last_migration_seconds = None
        self._t_begin = None
        self._overflow_warned = False
        # brand the inner map's one-shot overflow warning with the remedy
        # this facade actually offers (begin_split, not a bigger spec)
        self.map._overflow_message = self._overflow_message
        self._m_name = metrics_name
        if metrics is not None:
            self.attach_metrics(metrics, name=metrics_name)

    # -- geometry ----------------------------------------------------------

    @property
    def sspec(self) -> ShardSpec:
        return self.map.sspec

    @property
    def spec(self) -> SetSpec:
        return self.map.spec

    @property
    def n_shards(self) -> int:
        return self.map.n_shards

    @property
    def migrating(self) -> bool:
        return self.frontier.phase != "idle"

    @property
    def capacity(self) -> int:
        """Total live capacity of the CURRENT geometry (grows across a
        split -- the whole point)."""
        return self.sspec.effective_capacity

    def fill_factor(self) -> float:
        """Live fraction of the current geometry's capacity (the
        ``--autosplit`` watermark input)."""
        return len(self) / max(1, self.capacity)

    # -- traffic -----------------------------------------------------------

    def _route_to_target(self, keys: np.ndarray) -> np.ndarray:
        """True per lane iff its migration unit has committed (the lane
        belongs to the NEW geometry)."""
        sid = np_shard_of(keys, self.map.n_shards)
        unit = sid if self.frontier.phase == "split" else sid >> 1
        return unit < self.frontier.committed

    def _apply(self, ops, keys, values):
        ops, keys, values = (SH._host_i32(a) for a in (ops, keys, values))
        if not self.migrating or self.frontier.committed == 0:
            return self.map.apply(ops, keys, values)
        sel = self._route_to_target(keys)
        if sel.all():
            return self.target.apply(ops, keys, values)
        if not sel.any():
            return self.map.apply(ops, keys, values)
        # frontier-split batch: OP_NOP holes are exact no-ops, so each
        # map executes only its own lanes in original order (same-key
        # lanes share a unit -> per-key linearization is preserved)
        res_old = self.map.apply(np.where(sel, OP_NOP, ops), keys, values)
        res_new = self.target.apply(np.where(sel, ops, OP_NOP), keys, values)
        return np.where(sel, res_new, res_old)

    def insert(self, keys, values=None):
        keys = SH._host_i32(keys)
        values = keys if values is None else SH._host_i32(values)
        return self._apply(np.full(keys.shape, OP_INSERT, np.int32), keys,
                           values)

    def remove(self, keys):
        keys = SH._host_i32(keys)
        return self._apply(np.full(keys.shape, OP_REMOVE, np.int32), keys,
                           keys)

    def contains(self, keys):
        keys = SH._host_i32(keys)
        return self._apply(np.full(keys.shape, OP_CONTAINS, np.int32), keys,
                           keys)

    def apply(self, ops, keys, values=None):
        keys = SH._host_i32(keys)
        values = keys if values is None else SH._host_i32(values)
        return self._apply(ops, keys, values)

    @staticmethod
    def _masked_get(m: ShardedDurableMap, keys, active, default):
        """Value lookup restricted to ``active`` lanes (OP_NOP holes are
        never transported by stage 1, so inactive lanes cost nothing)."""
        ops = np.where(active, OP_CONTAINS, OP_NOP).astype(np.int32)
        plan = RT.host_route(m.sspec, ops, keys, keys)
        m.last_route = plan
        m.state, fl = RT.dispatch_plan(m.state, plan, sspec=m.sspec,
                                       kind="get", default=default)
        vals, _, dropped, drop_mask = fl.force()
        m._finish(vals, dropped, drop_mask)
        return vals

    def get(self, keys, default: int = 0):
        keys = SH._host_i32(keys)
        if not self.migrating or self.frontier.committed == 0:
            return self.map.get(keys, default)
        sel = self._route_to_target(keys)
        if sel.all():
            return self.target.get(keys, default)
        if not sel.any():
            return self.map.get(keys, default)
        v_old = self._masked_get(self.map, keys, ~sel, default)
        v_new = self._masked_get(self.target, keys, sel, default)
        return np.where(sel, v_new, v_old)

    def precompile(self, batch: int, partial=None):
        budgets = self.map.precompile(batch, partial=partial)
        if self.target is not None:
            self.target.precompile(batch, partial=partial)
        return budgets

    def pipeline_flush(self):
        return self                      # synchronous by construction

    # -- migration engine --------------------------------------------------

    def begin_split(self) -> None:
        """Open an S -> 2S migration: build the (empty) target map and
        durably record the phase with frontier 0.  Traffic continues;
        drive the copy with :meth:`step`."""
        if self.migrating:
            raise RuntimeError(f"migration already running: {self.frontier}")
        self.target = ShardedDurableMap(self.sspec.split_spec(),
                                        device=self.device)
        self.target._overflow_message = self._overflow_message
        self._t_begin = time.perf_counter()
        self.frontier.stamp("split", 0, self.map.n_shards)
        self.migration_psyncs += 1
        self._mig = None
        self._note("resize_splits_started")

    def begin_merge(self) -> None:
        """Open a 2S -> S migration.  Refuses upfront when any sibling
        pair's CURRENT live nodes exceed the per-shard capacity (the
        commit re-checks against the final planes and raises too --
        never a silent drop)."""
        if self.migrating:
            raise RuntimeError(f"migration already running: {self.frontier}")
        if self.map.n_shards < 2:
            raise ValueError("cannot merge a 1-shard map")
        (sizes,) = SH.whole_rows(self.sspec, E._host(self.map.state.size))
        pair = sizes[0::2] + sizes[1::2]
        cap = self.sspec.per_shard_capacity
        if int(pair.max()) > cap:
            raise ResizeCapacityError(
                f"merge refused: pair sizes {pair.tolist()} exceed the "
                f"per-shard capacity {cap}")
        self.target = ShardedDurableMap(self.sspec.merge_spec(),
                                        device=self.device)
        self.target._overflow_message = self._overflow_message
        self._t_begin = time.perf_counter()
        self.frontier.stamp("merge", 0, self.map.n_shards // 2)
        self.migration_psyncs += 1
        self._mig = None
        self._note("resize_merges_started")

    def step(self) -> bool:
        """Advance the migration by one increment -- one chunk of the
        current unit's copy, or that unit's commit once its copy is
        done.  Interleave freely with traffic; returns True when the
        whole migration has completed (and immediately when idle)."""
        if not self.migrating:
            return True
        f = self.frontier.committed
        if f >= self.frontier.units:
            self._finalize()
            return True
        t0 = time.perf_counter()
        if self._mig is None:
            self._open_unit(f)
        if self._mig["next"] < self.sspec.per_shard_capacity:
            self._copy_chunk()
        else:
            self._commit_unit()
        if self._m is not None:
            self._m.histogram(f"span.{self._m_name}.resize_step").record(
                time.perf_counter() - t0)
        if self.frontier.committed >= self.frontier.units:
            self._finalize()
            return True
        return False

    def split(self) -> "ElasticShardedMap":
        """Blocking convenience: run a full S -> 2S split to completion
        (no interleaved traffic)."""
        self.begin_split()
        while not self.step():
            pass
        return self

    def merge(self) -> "ElasticShardedMap":
        """Blocking convenience: run a full 2S -> S merge to completion."""
        self.begin_merge()
        while not self.step():
            pass
        return self

    def _open_unit(self, u: int) -> None:
        """Open unit ``u``: record per-child watermarks and bump their
        epochs so every commit from here on stamps into the delta.  The
        bumped epoch is a new tensor: a snapshot capture may still hold
        the old one."""
        split = self.frontier.phase == "split"
        rows = (u,) if split else (2 * u, 2 * u + 1)
        m = self.map
        st = m.state
        (epoch,) = SH.whole_rows(self.sspec, E._host(st.epoch))
        wm = {r: int(epoch[r]) for r in rows}
        new_epoch = st.epoch.clone()
        for r in rows:
            if r in m.rows:              # the rank holding the row bumps it
                new_epoch[m.local_row(r)] += 1
        m.state = st._replace(epoch=new_epoch)
        n = self.sspec.per_shard_capacity
        shape = (2, n) if split else (n,)
        self._mig = {
            "unit": u, "wm": wm, "next": 0,
            "buf": {k: np.zeros(shape, np.int32) for k in PLANES},
        }

    def _from_holder(self, row: int, read, k: int,
                     n: Optional[int] = None) -> list:
        """The ``k`` host arrays ``read(local index)`` gives of storage row
        ``row`` of the old map, read on the process holding the row and,
        on a mesh, sent to every rank in ONE broadcast.  ``n`` is each
        array's length where every rank knows it; else the holder
        broadcasts it first."""
        m = self.map
        if m.mesh is None:               # every process holds every row
            return read(row)
        src = m.mesh.holder(row, m.n_shards, RT.mesh_groups(m.sspec))
        mine = read(m.local_row(row)) if m.mesh.rank == src else None
        if n is None:
            n = m.mesh.broadcast(mine[0].size if mine else 0, src=src)
        return m.mesh.broadcast_arrays(src, mine, [(n,)] * k)

    def _read_row(self, row: int, lo: int, hi: int) -> dict:
        """Host copy of one shard row's durable planes over [lo, hi), the
        four planes in one device-to-host copy (and one broadcast on a
        mesh) -- at a dispatch boundary ``flushed`` IS the persisted
        stage."""
        def read(i):
            st = self.map.state
            return RT._to_host(st.flushed[i, lo:hi], st.keys[i, lo:hi],
                               st.values[i, lo:hi], st.stamp[i, lo:hi])
        return dict(zip(PLANES, self._from_holder(row, read, 4, hi - lo)))

    def _read_delta(self, row: int, watermark: int):
        """The slots of one shard row stamped past ``watermark`` (found
        on the device) and their durable planes: ``(slots i64[D], planes
        dict)``, copied to the host in one transfer."""
        def read(i):
            st = self.map.state
            idx = torch.nonzero(st.stamp[i] > watermark).flatten()
            return RT._to_host(idx, st.flushed[i][idx], st.keys[i][idx],
                               st.values[i][idx], st.stamp[i][idx])
        host = self._from_holder(row, read, 5)
        return host[0].astype(np.int64), dict(zip(PLANES, host[1:]))

    def _copy_split(self, src: dict, where) -> int:
        """Positional copy of the parent planes ``src`` (slots ``where``:
        a slice or an index list) into the two child buffers; returns
        live nodes copied.  Overwrites unconditionally -- re-copying a
        slot (crash restart, delta patch) is idempotent by
        construction."""
        member = src["stage"] == VALID
        bit = np_shard_of(src["keys"], 2 * self.map.n_shards) & 1
        buf = self._mig["buf"]
        for c in (0, 1):
            m = member & (bit == c)
            buf["stage"][c, where] = np.where(m, VALID, FREE)
            for k in ("keys", "values", "stamp"):
                buf[k][c, where] = np.where(m, src[k], 0)
        return int(member.sum())

    def _copy_merge(self, src: dict, where) -> int:
        """Positional copy of the EVEN child's slots into the merged
        buffer (the odd child is placed wholesale at commit)."""
        member = src["stage"] == VALID
        buf = self._mig["buf"]
        buf["stage"][where] = np.where(member, VALID, FREE)
        for k in ("keys", "values", "stamp"):
            buf[k][where] = np.where(member, src[k], 0)
        return int(member.sum())

    def _copy_chunk(self) -> None:
        mig = self._mig
        lo = mig["next"]
        hi = min(lo + self.migrate_chunk, self.sspec.per_shard_capacity)
        if self.frontier.phase == "split":
            self._copy_split(self._read_row(mig["unit"], lo, hi),
                             slice(lo, hi))
        else:
            self._copy_merge(self._read_row(2 * mig["unit"], lo, hi),
                             slice(lo, hi))
        mig["next"] = hi
        self.migration_psyncs += 1       # ONE bulk persist of the chunk

    def _commit_unit(self) -> None:
        """Commit the open unit at the current dispatch boundary: patch
        the delta (slots whose stamp moved past the watermark while the
        copy ran), bulk-persist, rebuild the destination shard(s)
        through the normal recovery path (zero psyncs), install them in
        the target map (on a mesh, on the rank holding each), and durably
        advance the frontier (one psync)."""
        mig = self._mig
        u = mig["unit"]
        if self.frontier.phase == "split":
            delta, src = self._read_delta(u, mig["wm"][u])
            if delta.size:
                self._copy_split(src, delta)
            buf = mig["buf"]
            rows = {2 * u: {k: buf[k][0] for k in buf},
                    2 * u + 1: {k: buf[k][1] for k in buf}}
        else:
            a, b = 2 * u, 2 * u + 1
            delta, src = self._read_delta(a, mig["wm"][a])
            if delta.size:
                self._copy_merge(src, delta)
            # odd child placed wholesale from its FINAL planes (its own
            # delta is thereby included); raises before anything commits
            n = self.sspec.per_shard_capacity
            rows = {u: merge_pair(mig["buf"], self._read_row(b, 0, n))}
        self.migration_psyncs += 1       # ONE bulk persist of the patch
        moved = 0
        tgt = self.target
        for row, planes in sorted(rows.items()):
            moved += int(np.sum(planes["stage"] == VALID))
            if row not in tgt.rows:      # another rank holds it
                continue
            state_r, _ = E.import_pool(planes, spec=self.sspec.shard_spec(),
                                       device=self.device)
            SH._write_row(tgt.state, tgt.local_row(row), state_r)
        self.frontier.stamp(self.frontier.phase, u + 1, self.frontier.units)
        self.migration_psyncs += 1       # the frontier advance
        self.migrated_nodes += moved
        self._mig = None
        if self._m is not None:
            m, nm = self._m, self._m_name
            m.counter(f"{nm}.resize_migrated_nodes").inc(moved)
            m.gauge(f"{nm}.resize_frontier").set(self.frontier.committed)

    def _finalize(self) -> None:
        """Every unit committed: retire the old map (fold its device
        counters into the host bases so psync/op totals stay continuous)
        and durably flip the phase back to idle."""
        phase = self.frontier.phase
        self._psync_base += self.map.psyncs
        self._ops_base += self.map.ops
        self.map, self.target = self.target, None
        self.frontier.stamp("idle", 0, 0)
        self.migration_psyncs += 1
        self._mig = None
        if phase == "split":
            self.splits += 1
            self._note("resize_splits")
        else:
            self.merges += 1
            self._note("resize_merges")
        if self._t_begin is not None:
            self.last_migration_seconds = time.perf_counter() - self._t_begin
            self._t_begin = None
            if self._m is not None:
                self._m.histogram(
                    f"span.{self._m_name}.resize_total").record(
                        self.last_migration_seconds)
        self._post_recovery_overflow()   # fresh latch for the new geometry

    def _note(self, counter: str) -> None:
        if self._m is not None:
            self._m.counter(f"{self._m_name}.{counter}").inc()

    # -- crash + recovery --------------------------------------------------

    def crash_and_recover(self, u=None, seed: int = 0):
        """Power failure at ANY point of the protocol.  Durable: both
        maps' NVM planes and the frontier register.  Volatile (lost):
        the open unit's watermarks and partial copy -- the restarted
        migration re-opens the unit and overwrites positionally, so
        partial child writes are harmless by construction.  Committed
        ops are never lost and recovery pays ZERO psyncs (both rebuilds
        are the normal recovery path; ``u`` is the old map's adversary,
        the target draws its own from ``seed + 1``)."""
        self._metrics_pre_recovery()
        t0 = time.perf_counter()
        self.map.crash_and_recover(u, seed=seed)
        hist = np.asarray(self.map.last_recovery_hist)
        if self.target is not None:
            # committed rows rebuild from their durable planes;
            # uncommitted rows are empty (partial copies are ignored --
            # the frontier never advanced past them)
            self.target.crash_and_recover(None, seed=seed + 1)
            hist = hist + np.asarray(self.target.last_recovery_hist)
        self._mig = None                 # volatile migration state lost
        self._psync_base = 0             # device counters reset too
        self._ops_base = 0
        self.last_recovery_hist = hist
        self.last_recovery_seconds = time.perf_counter() - t0
        self._metrics_post_recovery(
            scanned_slots=(self.map.n_shards +
                           (self.target.n_shards if self.target else 0))
            * self.sspec.per_shard_capacity)
        self._post_recovery_overflow()
        return self

    # snapshots attach to the inner maps' planes at a fixed S; across a
    # geometry change use store.snapshot.load_resharded (full rebuild)
    supports_hybrid = False

    # -- aggregates (frontier-masked during a migration) -------------------

    def _masked(self, old_vec: np.ndarray, new_vec: np.ndarray):
        """(authoritative old rows, authoritative new rows) -- the old
        map's un-migrated tail and the target's committed head."""
        f = self.frontier.committed
        if self.frontier.phase == "split":
            return old_vec[f:], new_vec[:2 * f]
        return old_vec[2 * f:], new_vec[:f]

    def _both(self, leaf: str):
        """The per-shard leaf of both maps, frontier-masked, from one
        device-to-host copy (and, on a mesh, each map's whole rows: a
        collective)."""
        old, new = RT._to_host(getattr(self.map.state, leaf),
                               getattr(self.target.state, leaf))
        (old,) = SH.whole_rows(self.map.sspec, old)
        (new,) = SH.whole_rows(self.target.sspec, new)
        return self._masked(old, new)

    def __len__(self):
        if not self.migrating:
            return len(self.map)
        o, n = self._both("size")
        return int(o.sum()) + int(n.sum())

    @property
    def overflowed(self) -> bool:
        if not self.migrating:
            return self.map.overflowed
        o, n = self._both("overflow")
        return bool(o.any()) or bool(n.any())

    def _overflow_message(self) -> str:
        return (f"ElasticShardedMap index overflow latched "
                f"(spec={self.spec}); begin_split() to grow online")

    def _check_overflow(self):
        if not self._overflow_warned and self.overflowed:
            self._overflow_warned = True
            E.warn_structure(self._overflow_message(), stacklevel=4)

    @property
    def psyncs(self):
        """Hot-path psyncs (device counters + retired maps' fold) --
        migration bulk persists are NOT here; see
        ``migration_psyncs``."""
        n = self._psync_base + self.map.psyncs
        if self.target is not None:
            n += self.target.psyncs
        return n

    @property
    def ops(self):
        n = self._ops_base + self.map.ops
        if self.target is not None:
            n += self.target.ops
        return n

    @property
    def router_dropped(self) -> int:
        n = self.map.router_dropped
        if self.target is not None:
            n += self.target.router_dropped
        return n

    @property
    def last_drop_mask(self):
        return self.map.last_drop_mask   # facade paths keep maps in step

    last_recovery_hist = None

    def _metrics_extra(self) -> dict:
        return {
            "n_shards": self.n_shards,
            "capacity": self.capacity,
            "fill_factor": self.fill_factor(),
            "migration": {
                "phase": self.frontier.phase,
                "frontier": self.frontier.committed,
                "units": self.frontier.units,
                "frontier_psyncs": self.frontier.psyncs,
            },
            "migration_psyncs": self.migration_psyncs,
            "migrated_nodes": self.migrated_nodes,
            "splits": self.splits,
            "merges": self.merges,
            "router_dropped": self.router_dropped,
            "last_migration_seconds": self.last_migration_seconds,
        }

    def __repr__(self):
        mig = f", {self.frontier}" if self.migrating else ""
        return (f"ElasticShardedMap(size={len(self)}, "
                f"n_shards={self.n_shards}, psyncs={self.psyncs}{mig})")
