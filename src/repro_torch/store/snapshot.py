"""Background snapshotter: marries the checkpoint store to the durable
engine (DESIGN.md §11, "snapshot + delta-log hybrid recovery").

The hot path is untouched -- a snapshot is a pure READ of planes every
psync'd commit already made durable, so the mutation path gains exactly
zero psyncs and zero fences.  The split:

  capture   synchronous, cheap: host-copy the durable planes at a dispatch
            boundary and open a new stamp generation (the watermark W).
            From here on every commit stamps its slot ``> W`` -- the
            existing op stream IS the delta log.
  build     asynchronous, off the hot path: canonicalize the capture by
            running the normal full recovery over it (the stored snapshot
            is therefore EXACTLY the state a full-pool rebuild would
            produce at W) and persist it through
            :class:`~repro_torch.store.checkpoint.CheckpointManager` in the
            atomic ``dirs`` layout -- a crash mid-save leaves ignored
            ``.tmp-*`` residue, never a half-snapshot selected as latest.
  recover   load the latest COMMITTED snapshot, classify only the slots
            whose persisted stamp is newer than its watermark (the delta),
            and patch -- O(delta since last snapshot) instead of
            O(capacity), bit-identical to the full scan, zero psyncs.

Cadence is levanter-style: a step trigger, a wall-clock trigger, or both
(:class:`SnapshotPolicy`); ``maybe_snapshot(step)`` is designed to be
called once per serving batch.  Works with any facade exposing the
snapshot hooks.  Backends without a canonical O(delta) index patch
(probe) fall back to the full rebuild transparently.

PyTorch port of ``repro.store.snapshot``.  The port's ``DurableMap``,
``ShardedDurableMap`` (per-shard watermark vector) and ``DurableQueue``
have the hooks; ``load_resharded`` restores a sharded-map snapshot at
another shard count.  The store layout is the JAX package's, so either
package restores the other's snapshots.

A sharded map in a process group (``use_shard_map``; its ``group``) is
snapshotted by one :class:`Snapshotter` per rank on one directory, which
every rank must see (a local path on one host, a shared file system
across hosts).  Each rank captures, builds and writes the rows it holds,
as the JAX package's ``shard_map`` recovers each device's rows: at the
capture rank 0 creates the step's tmp directory with every plane's
``.npy`` at its whole shape (one broadcast tells the ranks it is there),
each rank's background thread recovers its rows and writes their byte
range of each file, and rank 0 writes the manifest and renames once every
rank's part has ended.  The store holds the files a one-device map's
would, byte for byte; no plane crosses between ranks, and no background
thread runs a collective (a ``gloo`` collective there would interleave
with the dispatch's).  Where every rank holds every row (D = 1), rank 0
alone builds and writes, as one process would.  The ranks agree at their
main-thread calls (``maybe_snapshot``, ``snapshot``, ``wait``, ``recover``,
``close``): one all-gather of each rank's part status and the meta of its
rows (watermark and stage histogram), and after rank 0's rename one
broadcast.  Recovery reads the step rank 0 last committed, sent to every
rank, and raises on every rank when any rank's view of the directory lacks
it; each rank reads only its rows of the stored planes.
"""
from __future__ import annotations

import dataclasses
import time
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import wait as futures_wait
from typing import Optional

import numpy as np
import torch

from repro_torch.core import engine as E
from repro_torch.core import router as RT
from repro_torch.core import shard as SH
from repro_torch.core.resize import (ElasticShardedMap,
                                     check_resizable_placement,
                                     reshard_planes)
from repro_torch.store.checkpoint import CheckpointManager


@dataclasses.dataclass(frozen=True)
class SnapshotPolicy:
    """Cadence policy: a snapshot is due when EITHER trigger fires.

    every_steps   snapshot when this many steps passed since the last one
    every_secs    wall-clock cadence (monotonic time)

    Both ``None`` (the default) means only explicit ``snapshot()`` calls.
    """
    every_steps: Optional[int] = None
    every_secs: Optional[float] = None

    def due(self, step: int, last_step: int, now: float,
            last_time: float) -> bool:
        if (self.every_steps is not None
                and step - last_step >= self.every_steps):
            return True
        if (self.every_secs is not None
                and now - last_time >= self.every_secs):
            return True
        return False


class Snapshotter:
    """Owns one structure's snapshot lifecycle + its store directory.

    >>> m = DurableMap(SetSpec(capacity=1 << 16, backend="bucket"))  # GPU
    >>> snap = Snapshotter(m, "/ckpt/map", SnapshotPolicy(every_steps=100))
    >>> for step, batch in enumerate(traffic):
    ...     m.apply(*batch)
    ...     snap.maybe_snapshot(step)     # async; hot path pays a capture
    ...                                   # only when the cadence fires
    >>> snap.recover()                    # crash: snapshot + delta rebuild

    At most one build is in flight; ``maybe_snapshot`` while one is
    running is a no-op (the cadence clock keeps running, so the next due
    step captures).  Metrics (optional; default: the structure's attached
    registry): ``span.<name>.snapshot`` duration histogram,
    ``<name>.snapshot_bytes_written`` counter,
    ``<name>.snapshot_age_seconds`` gauge, and a ``<name>.snapshotter``
    collector -- all reachable from ``MetricsRegistry.snapshot()``.

    On a map in a process group (see the module docstring) every rank
    makes the same calls, and the future of a step completes only at a
    main-thread call on every rank (``maybe_snapshot``, ``snapshot``,
    ``wait``, ``recover`` or ``close``) once rank 0 has renamed the step:
    its build ends in the background, but the group agrees on it there.
    ``wait()`` returns the committed step on every rank, or raises on
    every rank when any rank's part failed (nothing is committed then).
    """

    def __init__(self, structure, directory: str,
                 policy: Optional[SnapshotPolicy] = None, keep: int = 2,
                 metrics=None, name: Optional[str] = None):
        self.structure = structure
        self.policy = policy or SnapshotPolicy()
        # a map in a process group: every rank writes its rows (rank 0 all
        # of them where the rows are not partitioned), and the group agrees
        # on each step by collectives on the main thread
        self.group = getattr(structure, "group", None)
        self._per = (structure.n_shards // RT.mesh_groups(structure.sspec)
                     if self.group is not None else 0)  # rows a rank writes
        self._part = None               # (step, part future, t0, bytes)
        self.store = CheckpointManager(directory, layout="dirs", keep=keep)
        self._name = name or getattr(structure, "_m_name", "structure")
        self._m = metrics if metrics is not None \
            else getattr(structure, "_m", None)
        self._pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="snapshotter")
        self._pending: Optional[Future] = None
        self.snapshots = 0                       # committed this lifetime
        self.last_duration = None                # capture->committed seconds
        self._last_step = 0
        self._last_time = time.monotonic()       # cadence clock
        self._last_commit_time = None            # age gauge clock
        self._next_step = (self.store.latest_step() or 0) + 1
        if self._m is not None:
            self._m.register_collector(f"{self._name}.snapshotter",
                                       self._collect)
        # a structure restored beside pre-existing snapshots must stamp
        # STRICTLY above every stored watermark (see _fix_epoch)
        self._fix_epoch()

    @property
    def supports_hybrid(self) -> bool:
        return bool(getattr(self.structure, "supports_hybrid", False))

    # -- snapshotting ------------------------------------------------------

    def maybe_snapshot(self, step: Optional[int] = None) -> Optional[Future]:
        """Cadence check; captures + schedules a background build when the
        policy says so.  Returns the build future, or None.  In a group,
        rank 0's decision holds on every rank, and a step in flight is
        committed here once every rank's part has ended."""
        step = self._next_step if step is None else step
        now = time.monotonic()
        if not self.supports_hybrid:
            return None
        due = self.policy.due(step, self._last_step, now, self._last_time)
        if self.group is None:               # one build in flight at a time
            due = due and (self._pending is None or self._pending.done())
        elif self._pending is None:
            due = bool(self.group.broadcast(due))  # rank 0 decides for all
        else:
            due = self._settle(block=False, due=due)
        return self.snapshot(step) if due else None

    def snapshot(self, step: Optional[int] = None) -> Future:
        """Capture NOW (synchronous, cheap -- a host copy of already-durable
        planes) and build + persist in the background.  Returns the future
        of the committed step id (in a group, completed at a later
        main-thread call: see the class docstring)."""
        if not self.supports_hybrid:
            raise ValueError(
                f"{type(self.structure).__name__} spec has no canonical "
                "O(delta) patch (probe backend); snapshots would never be "
                "consulted -- recovery falls back to the full scan")
        self.wait()                           # serialize with a prior build
        step = self._next_step if step is None else step
        self._next_step = step + 1
        self._last_step = step
        self._last_time = time.monotonic()
        t0 = time.perf_counter()
        cap = self.structure.snapshot_capture()
        if self.group is None:
            self._pending = self._pool.submit(self._build_and_save, step,
                                              cap, t0)
            return self._pending
        made = None
        if self.group.rank == 0:
            try:
                self.store.begin_rows(step, self.structure.snapshot_layout())
            except Exception as e:            # raised below, on every rank
                made = e
        if not self.group.broadcast(made is None):
            if made is not None:
                raise made
            raise RuntimeError(f"snapshot step {step}: rank 0 could not "
                               f"create it in {self.store.dir!r}")
        self._part = (step, self._pool.submit(self._write_part, step, cap),
                      t0, self.store.bytes_written)
        self._pending = Future()
        return self._pending

    def _build_and_save(self, step: int, cap: dict, t0: float) -> int:
        planes, meta = self.structure.snapshot_build(cap)
        b0 = self.store.bytes_written
        self.store.save(step, planes, extra=meta)
        self._record(t0, int(np.max(meta["watermark"])),
                     self.store.bytes_written - b0)
        return step

    def _write_part(self, step: int, cap: dict):
        """A rank's part of a step in a group, in its background thread:
        build its rows and write them into the files rank 0 created.  No
        collective.  Returns the meta of its rows."""
        planes, meta = self.structure.snapshot_build(cap)
        if len(cap["rows"]):
            try:
                self.store.write_rows(step, cap["rows"].start, planes)
            except FileNotFoundError as e:
                raise _Unshared(f"snapshot step {step} is missing from "
                                f"this rank's view of {self.store.dir!r}"
                                ) from e
        return meta

    def _record(self, t0: float, watermark: int, nbytes: int):
        self.last_duration = time.perf_counter() - t0
        self._last_commit_time = time.monotonic()
        self.snapshots += 1
        if self._m is not None:
            m, n = self._m, self._name
            m.histogram(f"span.{n}.snapshot").record(self.last_duration)
            m.counter(f"{n}.snapshot_bytes_written").inc(nbytes)
            m.counter(f"{n}.snapshots").inc()
            m.gauge(f"{n}.last_snapshot_watermark").set(watermark)

    def _settle(self, block: bool, due: bool = False) -> bool:
        """The group's agreement on the step in flight, on the main thread
        of every rank: ONE all-gather of each rank's part status, rank 0's
        ``due`` and the meta of the rank's rows.  While a part runs (and
        ``block`` is False) the step stays in flight and this returns
        False.  Once every part has ended, rank 0 commits (the manifest
        and the rename), one broadcast tells every rank, and the step's
        future completes; if any rank's part, or the commit, failed, it
        raises on every rank and nothing is committed.  Returns rank 0's
        ``due``."""
        step, part, t0, b0 = self._part
        if block:
            futures_wait([part])
        per, s = self._per, self.structure.n_shards
        vec = np.zeros((3 + 6 * per,), np.int32)
        vec[1] = bool(due)
        if not part.done():
            vec[0] = _RUNNING
        elif part.exception() is not None:
            vec[0] = (_UNSHARED if isinstance(part.exception(), _Unshared)
                      else _FAILED)
        else:
            vec[0] = _DONE
            meta = part.result()
            w = np.asarray(meta["watermark"], np.int32)
            if w.size:                       # a rank that wrote rows
                vec[2] = w.max()
                vec[3:3 + per] = w
                vec[3 + per:] = np.asarray(meta["hist"]).reshape(-1)
        (got,) = self.group.gather([vec], [vec.shape], self.group.world)
        codes, due = got[:, 0], bool(got[0, 1])
        if (codes == _RUNNING).any():
            return False
        self._part = None
        pending, self._pending = self._pending, None
        bad = np.flatnonzero(codes != _DONE)
        if bad.size:
            raise self._failure(step, bad, codes, part, pending)
        err = None
        if self.group.rank == 0:
            try:
                # ranks 0 .. D - 1 wrote the rows in order
                self.store.commit_rows(step, self.structure.snapshot_meta(
                    got[:, 3:3 + per].reshape(-1)[:s],
                    got[:, 3 + per:].reshape(-1, 5)[:s]))
            except Exception as e:            # raised below, on every rank
                err = e
        if not self.group.broadcast(err is None):
            err = err or RuntimeError(
                f"snapshot step {step}: rank 0 failed to commit it")
            pending.set_exception(err)
            raise err
        self._record(t0, int(got[:, 2].max()), self.store.bytes_written - b0)
        pending.set_result(step)
        return due

    def _failure(self, step, bad, codes, part, pending) -> Exception:
        """The error every rank raises for a step whose part failed on the
        ranks ``bad``: the directory message where a rank's view lacked the
        step, else the first failing rank, with this rank's own error."""
        if (codes == _UNSHARED).any():
            e = RuntimeError(
                f"snapshot step {step}, created by rank 0, is missing from "
                f"the view of {self.store.dir!r} of rank(s) "
                f"{np.flatnonzero(codes == _UNSHARED).tolist()}: every rank "
                "of a mesh must snapshot to one directory that all of them "
                "see")
        else:
            mine = part.exception()
            e = RuntimeError(
                f"snapshot step {step} was not committed: the part of "
                f"rank(s) {bad.tolist()} failed"
                + (f" (here: {mine!r})" if mine is not None else ""))
        pending.set_exception(e)
        return e

    def wait(self) -> Optional[int]:
        """Block until the in-flight build (if any) commits, and return its
        step.  In a group this is a collective: it returns the same step
        on every rank once rank 0 has renamed it, or raises on every
        rank."""
        if self._pending is None:
            return None
        if self.group is not None:
            step = self._part[0]
            self._settle(block=True)
            return step
        step = self._pending.result()
        self._pending = None
        return step

    # -- recovery ----------------------------------------------------------

    def recover(self, u=None):
        """Crash the structure and recover through the latest COMMITTED
        snapshot + the stamp delta; falls back to the full-pool scan when
        no snapshot is committed or the backend lacks a canonical patch.
        An in-flight build that has not reached its rename is exactly what
        a real crash would destroy -- only committed steps count (a
        cancelled-too-late build still commits a CONSISTENT snapshot, so
        recovery through it is equally bit-identical, just cheaper)."""
        if self._pending is not None:
            # in a group the ranks settle the step together: a build runs
            # on to its end there
            if self.group is not None or not self._pending.cancel():
                try:
                    self.wait()               # too late to die mid-save
                except Exception:
                    pass    # a FAILED build is a crashed save: it left at
                    #       worst ignored .tmp-* residue, never a committed
                    #       step, so recovery proceeds from the last one
            self._pending = None
        step = self.store.latest_step()
        if self.group is not None:
            step = _committed_on_every_rank(self.group, self.store, step)
        if step is None or not self.supports_hybrid:
            self.structure.crash_and_recover(u)
        else:
            # in a group each rank copies only its rows of the mapped files
            planes = self.store.restore(step, mmap=self.group is not None)
            meta = self.store.extra(step)
            self.structure.hybrid_crash_and_recover(planes, meta, u)
        self._fix_epoch()
        return self.structure

    def _fix_epoch(self):
        """Stamp-generation monotonicity across snapshots WITHOUT
        intervening commits: recovery re-derives the epoch from the
        surviving stamps (``max(stamp) + 1``), but a capture bumps the
        live epoch unconditionally, so a stored watermark may exceed every
        stamp on NVM.  Raise the epoch strictly above every stored
        watermark or future deltas could stamp below it and be missed."""
        w = None
        for s in self.store.committed:
            extra = self.store.extra(s)
            if not extra or "watermark" not in extra:
                continue
            ws = np.asarray(extra["watermark"], np.int32)
            w = ws if w is None else np.maximum(w, ws)
        if w is None:
            return
        if self.group is not None:
            w = self.structure.rows_of(w)
        st = self.structure.state
        self.structure.state = st._replace(epoch=torch.maximum(
            st.epoch, torch.tensor(np.asarray(w + 1, np.int32),
                                   device=st.epoch.device)))

    # -- observability -------------------------------------------------------

    def _collect(self) -> dict:
        age = (time.monotonic() - self._last_commit_time
               if self._last_commit_time is not None else None)
        if self._m is not None and age is not None:
            self._m.gauge(f"{self._name}.snapshot_age_seconds").set(age)
        return {
            "snapshots": self.snapshots,
            "latest_step": self.store.latest_step(),
            "bytes_written": self.store.bytes_written,
            "in_flight": int(self._pending is not None
                             and not self._pending.done()),
            "age_seconds": age,
            "last_duration_seconds": self.last_duration,
        }

    def close(self):
        try:
            self.wait()
        except Exception:
            pass    # a failed build already surfaced via its future;
            #       teardown still must release the pool and the store
        self._pool.shutdown()
        self.store.close()


_RUNNING, _DONE, _FAILED, _UNSHARED = 1, 2, 3, 4   # a rank's part status


class _Unshared(OSError):
    """A rank's view of the store lacks the step rank 0 created."""


def _committed_on_every_rank(mesh, store, step: Optional[int]
                             ) -> Optional[int]:
    """The step rank 0 last committed (its build has ended), sent to every
    rank, so every rank takes the same recovery path with the same
    collectives.  Raises on every rank when any rank's store does not hold
    it: the directory is not one that every rank sees."""
    got = mesh.broadcast(-1 if step is None else step)
    step = None if got < 0 else got
    store.refresh()
    missing = step is not None and step not in store.committed
    if mesh.any(missing):
        raise RuntimeError(
            f"snapshot step {step}, committed by rank 0, is missing from "
            f"another rank's view of {store.dir!r}: "
            "every rank of a mesh must snapshot to one directory that "
            "all of them see")
    return step


# ---------------------------------------------------------------------------
# Elastic restore: rebuild a sharded map from a snapshot taken at a
# DIFFERENT shard count (DESIGN.md §12).
# ---------------------------------------------------------------------------


def load_resharded(directory: str, spec, n_shards: int, elastic: bool = True,
                   device="cuda", **shard_kwargs):
    """Restore the latest committed sharded-map snapshot into a map with
    ``n_shards`` shards on ``device`` -- not necessarily the count the
    snapshot was taken at.  The stored CANONICAL planes (``cur``/``keys``/
    ``values``/``stamp`` -- exactly what a full-pool rebuild at the old S
    would produce; the raw pre-canonicalization stage plane is
    deliberately not used) are resharded on the host by prefix refinement
    (:func:`repro_torch.core.resize.reshard_planes`) and rebuilt with the
    normal per-shard recovery at the new geometry (``recovery_scan`` once
    per new shard on the card): zero psyncs, and the result is
    bit-identical to recovering at the old S and then running a full
    offline split/merge.

    ``spec`` is the per-shard-compatible base :class:`SetSpec` (snapshots
    store planes, not specs); the per-shard pool size must match the
    stored one -- resharding moves nodes ACROSS shards, never resizes a
    shard's pool.  Returns an
    :class:`~repro_torch.core.resize.ElasticShardedMap` (``elastic=False``:
    a plain :class:`~repro_torch.core.shard.ShardedDurableMap`).  Strided
    placement with several device groups is refused, as for a resize
    (:func:`~repro_torch.core.resize.check_resizable_placement`).

    Under ``use_shard_map`` in a process group every rank calls it with
    the same arguments on one directory that every rank sees: every rank
    reads the step rank 0 found committed (and raises where its view
    lacks it), reshards the whole planes on the host and recovers only
    the rows it holds at the new geometry, whose D may differ from the
    snapshot's."""
    store = CheckpointManager(directory, layout="dirs")
    try:
        if elastic:
            m = ElasticShardedMap(spec, n_shards=n_shards, device=device,
                                  **shard_kwargs)
            inner = m.map
        else:
            m = SH.ShardedDurableMap(spec, n_shards=n_shards, device=device,
                                     **shard_kwargs)
            inner = m
            check_resizable_placement(inner.sspec)
        group = RT.group_mesh(inner.sspec)
        step = store.latest_step()
        if group is not None:
            step = _committed_on_every_rank(group, store, step)
        if step is None:
            raise FileNotFoundError(
                f"no committed snapshot under {directory!r}")
        planes = store.restore(step)
        canon = {"stage": np.asarray(planes["cur"]),
                 "keys": np.asarray(planes["keys"]),
                 "values": np.asarray(planes["values"]),
                 "stamp": np.asarray(planes["stamp"])}
        s_old, per = canon["stage"].shape
        if inner.sspec.per_shard_capacity != per:
            raise ValueError(
                f"per-shard capacity mismatch: snapshot has {per}-slot "
                f"pools, target spec provisions "
                f"{inner.sspec.per_shard_capacity} -- resharding moves "
                "nodes across shards, it cannot resize a shard's pool")
        out = reshard_planes(canon, s_old, n_shards)
        state, hist = SH.recover(
            *(E._on_device(inner.rows_of(out[f]), inner.device, np.int32)
              for f in ("stage", "keys", "values", "stamp")),
            sspec=inner.sspec)
        # stamp strictly above every stored watermark (see _fix_epoch):
        # the watermark vector is per OLD shard, so after resharding the
        # safe bound is the global max (the same on every rank)
        w = None
        for s in store.committed:
            extra = store.extra(s)
            if extra and "watermark" in extra:
                ws = int(np.max(np.asarray(extra["watermark"])))
                w = ws if w is None else max(w, ws)
        if group is not None:
            w = group.max(-1 if w is None else w)
            w = None if w < 0 else w
        if w is not None:
            state = state._replace(epoch=state.epoch.clamp(min=w + 1))
        inner.state = state
        (inner.last_recovery_hist_shards,) = SH.whole_rows(inner.sspec,
                                                           E._host(hist))
        inner.last_recovery_hist = inner.last_recovery_hist_shards.sum(axis=0)
        if elastic:
            m.last_recovery_hist = inner.last_recovery_hist
        return m
    finally:
        store.close()
