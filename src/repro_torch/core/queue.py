"""Durable lock-free MPMC ring queue on the shared stage machine.

PyTorch port of ``repro.core.queue``.  The paper's durable-set recipe is
structure-agnostic: a node's durable lifecycle is the monotone FREE ->
INVALID -> PAYLOAD -> VALID -> DELETED machine of
:mod:`repro_torch.core.nvm`, all writes to one cache line, recovery a pure
classification of persisted stages.  *Durable Queues: The Second
Amendment* (PAPERS.md) shows the same discipline yields a durable FIFO
queue with provably low flush counts; this module is that construction on
the engine's batched lane model (DESIGN.md §7):

  ring          N = capacity slots (power of two).  Element *tickets* are
                a monotone virtual sequence; ticket t lives in slot
                ``t & (N-1)``, so slot reuse is a fresh stage-machine
                incarnation (a slot is re-enqueued only after its previous
                dequeue's psync -- the ring-distance guard
                ``ticket < head + N`` implies the prior incarnation is
                flushed-DELETED).
  enqueue       plan/commit: active lanes claim tickets by lane rank (rank
                r takes ticket tail+r; distinct tickets hit distinct
                slots), then ONE scatter per state plane commits
                payload+stage: cur=VALID, flushed=VALID.  Lanes past the
                free-space budget fail (queue full): result False, ZERO
                psync.
  dequeue       ranks claim tickets head+r; wins gather the payload and
                commit cur=DELETED, flushed=DELETED in one scatter.  Lanes
                past ``tail`` fail (queue empty): result False, ZERO psync.
  psync         SOFT: exactly 1 per successful enqueue/dequeue, 0 for
                failed ops, 0 for reads (peek), 0 during recovery.
                logfree models the link-persist baseline at 2 per
                successful op.
  recovery      head/tail are VOLATILE (rebuilt, never persisted).
                :func:`recover` classifies persisted stages with the
                ``recovery_scan`` kernel (the CUDA kernel on the card, its
                plain version on the CPU) and reconstructs on the device:
                live elements = persisted-VALID slots in ticket order;
                head = min live ticket (else one past the newest
                persisted-DELETED ticket); tail = one past the max live
                ticket.  A hole in the live range latches ``overflow`` --
                detectable, never silent.

Every function returns the same values, at the same dtypes, as its JAX
counterpart (int32 planes and cursors, saturating int32 counters).  The
hot path never reads ``head`` or ``tail`` on the host: the budgets stay
0-d device tensors, and stage writes take sources filled on the device.
There is no ``jit``: each ``_impl`` body is also the public function's.

:class:`DurableQueue` mirrors the :class:`DurableMap` facade (psyncs / ops
/ len / overflowed / crash_and_recover / snapshot hooks), so the serving
spine in :mod:`repro_torch.launch.serve` composes the two behind one idiom.
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import durable_set as DS
from repro_torch.core.device import resolve_device
from repro_torch.core.drop import set_drop
from repro_torch.core.durable_set import MODES
from repro_torch.core.engine import (MetricsMixin, _host, _on_device,
                                     find_delta, hybrid_hist, warn_structure)
from repro_torch.core.nvm import FREE, VALID, DELETED, crash_persisted_stage
from repro_torch.kernels.recovery_scan import ops as rs_ops

_I32 = torch.int32
_BIG = torch.iinfo(_I32).max


@dataclasses.dataclass(frozen=True)
class QueueSpec:
    """Frozen configuration of a durable queue.

    capacity     ring slots N (power of two: slot = ticket & (N-1))
    mode         psync discipline: "soft" (1 psync per successful op, the
                 bound) | "linkfree" (same count here: the queue has no
                 read-side helping) | "logfree" (2 per successful op, the
                 link-persist baseline)
    use_kernels  classify recovery stages with the CUDA ``recovery_scan``
                 kernel (on a CUDA state); else its plain version
    """
    capacity: int
    mode: str = "soft"
    use_kernels: bool = True

    def __post_init__(self):
        c = self.capacity
        if c < 1 or (c & (c - 1)) != 0:
            raise ValueError("capacity must be a power of two (ring slot = "
                             f"ticket & (N-1)), got {c}")
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {self.mode!r}")

    def psync_per_success(self) -> int:
        """Explicit psyncs per successful enqueue/dequeue (failed ops
        always pay zero)."""
        return 2 if self.mode == "logfree" else 1


class QueueState(NamedTuple):
    """Durable ring + volatile cursors + psync accounting: the same 12
    leaves at the same dtypes as ``repro.core.queue.QueueState``.

    ``head``/``tail`` are the volatile FIFO cursors (next dequeue / next
    enqueue ticket); a crash discards them and recovery reconstructs both
    from persisted stages alone.
    """
    # --- durable area; vals/tickets persist once stage >= PAYLOAD
    vals: torch.Tensor      # i32[N] element payloads
    tickets: torch.Tensor   # i32[N] slot incarnation ticket
    cur: torch.Tensor       # i32[N] volatile lifecycle stage
    flushed: torch.Tensor   # i32[N] stage covered by the last explicit psync
    stamp: torch.Tensor     # i32[N] epoch of the last durable commit per slot
    # --- volatile cursors (never persisted)
    head: torch.Tensor      # i32[] next dequeue ticket
    tail: torch.Tensor      # i32[] next enqueue ticket
    # --- accounting (saturating i32[])
    n_psync: torch.Tensor   # explicit flush+fence count
    n_ops: torch.Tensor     # attempted operations (failed ones included)
    overflow: torch.Tensor  # bool[] full-enqueue-rejected / invariant latch
    epoch: torch.Tensor     # i32[] VOLATILE generation counter


def make_state(spec: QueueSpec, device="cuda") -> QueueState:
    """An empty queue on ``device``; ``epoch`` starts at 1 (stamp 0 means
    never committed)."""
    dev = resolve_device(device)
    n = spec.capacity

    def zeros(shape, dtype=_I32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return QueueState(
        vals=zeros((n,)), tickets=zeros((n,)), cur=zeros((n,)),
        flushed=zeros((n,)), stamp=zeros((n,)),
        head=zeros(()), tail=zeros(()),
        n_psync=zeros((), DS.COUNTER_DTYPE), n_ops=zeros((), DS.COUNTER_DTYPE),
        overflow=zeros((), torch.bool),
        epoch=torch.ones((), dtype=_I32, device=dev),
    )


def size(state: QueueState) -> torch.Tensor:
    """Live element count (tail - head), an i32[] on the state's device."""
    return state.tail - state.head


# ---------------------------------------------------------------------------
# Plan/commit hot path.  Both ops share the rank-claim plan: active lanes
# take consecutive tickets by lane rank, wins are the ranks inside the
# cursor budget, and the commit is one scatter per touched state plane.
# ---------------------------------------------------------------------------


def _rank_claim(active: torch.Tensor, base: torch.Tensor,
                budget: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ticket per lane, win mask): active lane of rank r claims ticket
    base+r and wins iff r < budget.  The rank is an int32 cumsum, as JAX's
    (torch's default would be int64)."""
    rank = torch.cumsum(active.to(_I32), 0, dtype=_I32) - 1
    return base + rank, active & (rank < budget)


def _commit(state: QueueState, win: torch.Tensor, slot: torch.Tensor,
            stage: int, n: int):
    """The stage commit scatter of the winning lanes: (sidx, cur, flushed,
    stamp).  Lanes that lost write the sentinel index ``n``; the stage
    source is filled on the device, so no Python scalar crosses to it."""
    sidx = DS._where_i32(win, slot, n)
    fill = torch.full_like(sidx, stage)
    cur = set_drop(state.cur, sidx, fill)
    flushed = set_drop(state.flushed, sidx, fill)
    stamp = set_drop(state.stamp, sidx, state.epoch.expand(sidx.shape[0]))
    return sidx, cur, flushed, stamp


def enqueue_impl(state: QueueState, vals: torch.Tensor, *, spec: QueueSpec,
                 active: Optional[torch.Tensor] = None
                 ) -> Tuple[QueueState, torch.Tensor, torch.Tensor]:
    """Batched enqueue: (state, ok[B], ticket-or-minus-1[B]).

    Winning lanes' slots held a flushed-DELETED (or never-used FREE)
    incarnation -- the ``rank < N - size`` budget guarantees it -- so the
    commit recycles them directly: payload + ticket + cur/flushed=VALID
    land in one scatter per plane, modeling write-INVALID -> payload ->
    makeValid -> psync with the per-op psync counted exactly."""
    if active is None:
        active = torch.ones(vals.shape, dtype=torch.bool, device=vals.device)
    n = spec.capacity
    ticket, win = _rank_claim(active, state.tail, n - size(state))
    sidx, cur, flushed, stamp = _commit(state, win, ticket & (n - 1),
                                        VALID, n)
    count = DS._count(win)
    return QueueState(
        vals=set_drop(state.vals, sidx, vals),
        tickets=set_drop(state.tickets, sidx, ticket),
        cur=cur, flushed=flushed, stamp=stamp,
        head=state.head,
        tail=state.tail + count,
        n_psync=DS._bump(state.n_psync, count * spec.psync_per_success()),
        n_ops=DS._bump(state.n_ops, DS._count(active)),
        overflow=state.overflow | (active & ~win).any(),
        epoch=state.epoch,
    ), win, DS._where_i32(win, ticket, -1)


def _head_batch(state: QueueState, want: torch.Tensor, n: int,
                default: int):
    """The rank-claim of the head batch: (ticket, win, slot, value-or-
    default) per lane."""
    ticket, win = _rank_claim(want, state.head, size(state))
    slot = ticket & (n - 1)
    got = DS._where_i32(win, state.vals[slot.clamp(0, n - 1).long()],
                        default)
    return ticket, win, slot, got


def dequeue_impl(state: QueueState, want: torch.Tensor, *, spec: QueueSpec,
                 default: int = 0
                 ) -> Tuple[QueueState, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """Batched dequeue: lanes with ``want`` pop in lane order.  Returns
    (state, value-or-default[B], ok[B], ticket-or-minus-1[B]).

    The commit is mark -> psync collapsed: cur=DELETED, flushed=DELETED in
    one scatter.  Empty-queue lanes fail with zero psync."""
    n = spec.capacity
    ticket, win, slot, got = _head_batch(state, want, n, default)
    _, cur, flushed, stamp = _commit(state, win, slot, DELETED, n)
    count = DS._count(win)
    return QueueState(
        vals=state.vals, tickets=state.tickets,
        cur=cur, flushed=flushed, stamp=stamp,
        head=state.head + count,
        tail=state.tail,
        n_psync=DS._bump(state.n_psync, count * spec.psync_per_success()),
        n_ops=DS._bump(state.n_ops, DS._count(want)),
        overflow=state.overflow,
        epoch=state.epoch,
    ), got, win, DS._where_i32(win, ticket, -1)


def enqueue(state: QueueState, vals: torch.Tensor, *, spec: QueueSpec
            ) -> Tuple[QueueState, torch.Tensor, torch.Tensor]:
    """Batched durable enqueue: (state, ok[B], ticket[B])."""
    return enqueue_impl(state, vals, spec=spec)


def dequeue(state: QueueState, want: torch.Tensor, *, spec: QueueSpec,
            default: int = 0
            ) -> Tuple[QueueState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched durable dequeue: (state, values[B], ok[B], ticket[B])."""
    return dequeue_impl(state, want, spec=spec, default=default)


def peek(state: QueueState, want: torch.Tensor, *, spec: QueueSpec,
         default: int = 0
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Volatile read of the head batch WITHOUT consuming it: (values[B],
    ok[B], ticket[B]).  Pure -- no state change, no psync, not an op (the
    serving spine peeks, processes, records the completion durably, and
    only then commits the dequeue)."""
    ticket, win, _, got = _head_batch(state, want, spec.capacity, default)
    return got, win, DS._where_i32(win, ticket, -1)


# ---------------------------------------------------------------------------
# Crash + recovery
# ---------------------------------------------------------------------------


def crash(state: QueueState, u: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Power failure: head/tail (the volatile cursors) are LOST.  Returns
    only what NVM holds -- per-slot persisted stage, ticket/value payloads
    and the epoch stamp plane; ``u`` float32 in [0, 1) per slot drives the
    eviction adversary."""
    persisted = crash_persisted_stage(state.cur, state.flushed, u)
    return persisted, state.tickets, state.vals, state.stamp


def _cursors(member: torch.Tensor, tickets: torch.Tensor,
             max_del: torch.Tensor):
    """(head, tail, hole latch) from the live mask and ticket plane: head
    is the min live ticket, else one past the newest retired ticket
    ``max_del``; tail one past the max live ticket, else head.  Live
    tickets must be exactly [head, tail)."""
    any_m = member.any()
    min_live = torch.where(member, tickets, _BIG).min()
    max_live = torch.where(member, tickets, -_BIG).max()
    head = torch.where(any_m, min_live, max_del + 1)
    tail = torch.where(any_m, max_live + 1, head)
    return head, tail, (tail - head) != DS._count(member)


def recover_impl(persisted: torch.Tensor, tickets: torch.Tensor,
                 vals: torch.Tensor, stamp: Optional[torch.Tensor] = None,
                 *, spec: QueueSpec) -> Tuple[QueueState, torch.Tensor]:
    """Rebuild head/tail from persisted stages alone, on their device:

      live    persisted == VALID  (enqueue completed, dequeue not durable)
      head    min live ticket; with no live element, one past the newest
              persisted-DELETED ticket (all those dequeues completed)
      tail    one past the max live ticket (else == head)

    A hole in [head, tail) latches ``overflow``.  No psync is ever issued:
    payloads are already durable.  Returns (state, stage histogram
    i32[5])."""
    member, hist = rs_ops.recovery_scan(persisted,
                                        use_kernels=spec.use_kernels)
    max_del = torch.where(persisted == DELETED, tickets, -1).max()
    head, tail, hole = _cursors(member, tickets, max_del)
    cur = DS._where_i32(member, VALID, FREE)
    if stamp is None:
        stamp = torch.zeros_like(tickets)
        epoch = torch.ones((), dtype=_I32, device=tickets.device)
    else:
        # Recovery never writes NVM: stamps survive verbatim; the next
        # generation starts strictly above every durable stamp.
        epoch = stamp.max().clamp(min=0) + 1
    zero = torch.zeros((), dtype=DS.COUNTER_DTYPE, device=tickets.device)
    return QueueState(
        vals=torch.where(member, vals, 0),
        tickets=torch.where(member, tickets, 0),
        cur=cur, flushed=cur, stamp=stamp,
        head=head, tail=tail,
        n_psync=zero, n_ops=zero.clone(),
        overflow=hole,
        epoch=epoch,
    ), hist


recover = recover_impl


def crash_and_recover(state: QueueState, u: torch.Tensor, *, spec: QueueSpec
                      ) -> Tuple[QueueState, torch.Tensor]:
    return recover(*crash(state, u), spec=spec)


def hybrid_recover_impl(snap: QueueState, persisted: torch.Tensor,
                        tickets: torch.Tensor, vals: torch.Tensor,
                        stamp: torch.Tensor, delta_idx: torch.Tensor,
                        *, spec: QueueSpec) -> QueueState:
    """Snapshot + delta-log recovery (DESIGN.md §11).

    ``snap`` is the canonical recovered state at watermark W (its
    ``head``/``tail`` are the capture-time cursors); the other planes are
    crash-time NVM contents and ``delta_idx`` i32[D] lists the slots with
    ``stamp > W`` (padded with ``capacity``).  Classification runs over
    the gathered delta only; the cursors come from the full-recovery
    formulas on the merged planes, with one subtlety: the newest durably
    retired ticket is either in the delta or was already retired at
    capture, where FIFO contiguity pins it to ``snap.head - 1``.
    Bit-identical to ``recover`` on the same crash planes; no psync."""
    n = spec.capacity
    valid = delta_idx < n
    gi = torch.where(valid, delta_idx, 0).long()
    d_per = torch.where(valid, persisted[gi], 0)
    member_d, _ = rs_ops.recovery_scan(d_per, use_kernels=spec.use_kernels)
    member_d = member_d & valid

    scat = DS._where_i32(valid, delta_idx, n)       # index n => dropped
    tickets_d = torch.where(valid, tickets[gi], 0)
    tickets2 = set_drop(snap.tickets, scat,
                        torch.where(member_d, tickets_d, 0))
    vals2 = set_drop(snap.vals, scat, torch.where(member_d, vals[gi], 0))
    cur2 = set_drop(snap.cur, scat, DS._where_i32(member_d, VALID, FREE))
    stamp2 = set_drop(snap.stamp, scat, stamp[gi])

    max_del_delta = torch.where(valid & (d_per == DELETED), tickets_d,
                                -1).max()
    head, tail, hole = _cursors(cur2 == VALID, tickets2,
                                torch.maximum(snap.head - 1, max_del_delta))
    zero = torch.zeros((), dtype=DS.COUNTER_DTYPE, device=tickets.device)
    return snap._replace(
        vals=vals2, tickets=tickets2, cur=cur2, flushed=cur2, stamp=stamp2,
        head=head, tail=tail, n_psync=zero, n_ops=zero.clone(),
        overflow=hole, epoch=stamp2.max().clamp(min=0) + 1,
    )


hybrid_recover = hybrid_recover_impl


# ---------------------------------------------------------------------------
# Object facade (mirrors DurableMap)
# ---------------------------------------------------------------------------


class DurableQueue(MetricsMixin):
    """Object API over the durable ring queue (single-controller usage).

    >>> q = DurableQueue(QueueSpec(capacity=1024))   # on the GPU
    >>> q.enqueue([7, 8, 9])          # -> [True, True, True], 3 psyncs
    >>> q.crash_and_recover()         # head/tail lost + rebuilt
    >>> q.dequeue(2)                  # -> ([7, 8], [True, True])

    The state lives on ``device`` (the GPU unless the caller asks for
    another).  ``enqueue`` returns its ``ok`` lanes as a tensor on that
    device; ``dequeue`` and ``peek`` return host numpy arrays, as the JAX
    facade does.  Pass ``metrics=MetricsRegistry(...)`` to expose
    psync/op totals, size, the overflow latch and recovery spans through
    the registry's ``snapshot()``; ``metrics_name`` namespaces them.
    """

    def __init__(self, spec: Optional[QueueSpec] = None, metrics=None,
                 metrics_name: str = "queue", device="cuda", **spec_kwargs):
        if spec is None:
            spec = QueueSpec(**spec_kwargs)
        elif spec_kwargs:
            spec = dataclasses.replace(spec, **spec_kwargs)
        self.spec = spec
        self.device = resolve_device(device)
        self.state = make_state(spec, device=self.device)
        self.last_recovery_hist = None    # i32[5] stage histogram
        self.last_recovery_seconds = None
        self._tickets = None              # the last enqueue's, on the device
        self._overflow_warned = False
        self._m_name = metrics_name
        if metrics is not None:
            self.attach_metrics(metrics, name=metrics_name)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @property
    def last_tickets(self) -> Optional[np.ndarray]:
        """Tickets of the last enqueue batch (-1 for a failed lane), read
        from the device on first access only."""
        if isinstance(self._tickets, torch.Tensor):
            self._tickets = self._tickets.cpu().numpy()
        return self._tickets

    @property
    def overflowed(self) -> bool:
        """True once the latch fired: an enqueue was rejected on a full
        ring, or recovery found a FIFO-range hole.  Detectable, never
        silent (the queue analogue of ``DurableMap.overflowed``)."""
        return bool(self.state.overflow)

    def _check_overflow(self):
        if not self._overflow_warned and self.overflowed:
            self._overflow_warned = True
            warn_structure(
                f"DurableQueue full: an enqueue was rejected (or recovery "
                f"found a FIFO hole) for spec={self.spec}; rejected lanes "
                "returned False -- drain faster or grow capacity",
                stacklevel=4)

    def enqueue(self, vals):
        if not isinstance(vals, torch.Tensor):
            vals = np.asarray(vals)
        vals = torch.as_tensor(vals, dtype=_I32, device=self.device)
        self.state, ok, self._tickets = enqueue(self.state, vals,
                                                spec=self.spec)
        self._check_overflow()
        return ok

    def _want(self, n: int) -> torch.Tensor:
        return torch.ones((n,), dtype=torch.bool, device=self.device)

    @staticmethod
    def _to_host(vals: torch.Tensor, ok: torch.Tensor):
        """(values int32, ok bool) numpy arrays in one device-to-host
        copy."""
        host = torch.stack([vals, ok.to(_I32)]).cpu().numpy()
        return host[0], host[1].astype(bool)

    def dequeue(self, n: int, default: int = 0):
        """Pop up to ``n`` elements; returns (values, ok) numpy arrays."""
        self.state, vals, ok, _ = dequeue(self.state, self._want(n),
                                          spec=self.spec, default=default)
        return self._to_host(vals, ok)

    def peek(self, n: int, default: int = 0):
        """Read up to ``n`` head elements without consuming (no psync)."""
        vals, ok, _ = peek(self.state, self._want(n), spec=self.spec,
                           default=default)
        return self._to_host(vals, ok)

    def _adversary(self, u) -> torch.Tensor:
        """The crash adversary on the state's device: float32 in [0, 1) per
        slot, zeros when ``u`` is None."""
        if u is None:
            return torch.zeros_like(self.state.cur, dtype=torch.float32)
        if not isinstance(u, torch.Tensor):
            u = np.asarray(u, np.float32)
        return torch.as_tensor(u, dtype=torch.float32, device=self.device)

    def crash_and_recover(self, u=None):
        """Crash under the adversary ``u`` (float32 in [0, 1) per slot;
        zeros by default) and rebuild the cursors from the durable
        planes."""
        u = self._adversary(u)
        self._metrics_pre_recovery()      # counters are about to reset
        self._sync()
        t0 = time.perf_counter()
        self.state, hist = crash_and_recover(self.state, u, spec=self.spec)
        self._sync()                      # honest recovery timing
        self.last_recovery_seconds = time.perf_counter() - t0
        self.last_recovery_hist = hist.cpu().numpy()
        self._metrics_post_recovery(scanned_slots=self.spec.capacity)
        self._post_recovery_overflow()    # latch recomputed; warning re-armed
        return self

    # --- snapshot + delta-log hybrid recovery (DESIGN.md §11) -----------

    _SNAP_FIELDS = ("vals", "tickets", "cur", "stamp", "head", "tail",
                    "overflow")

    supports_hybrid = True    # the ring has no order-dependent index

    def snapshot_capture(self) -> dict:
        """Host-copy the durable planes at a dispatch boundary and open a
        new stamp generation (the watermark discipline of
        ``DurableMap.snapshot_capture``; zero psyncs -- a pure NVM read).
        The copies own their memory."""
        st = self.state
        w = int(st.epoch)
        cap = {"watermark": w, "raw_stage": _host(st.flushed),
               "tickets": _host(st.tickets), "vals": _host(st.vals),
               "stamp": _host(st.stamp)}
        self.state = st._replace(epoch=torch.full(
            (), w + 1, dtype=_I32, device=self.device))
        return cap

    def snapshot_build(self, cap: dict):
        """Canonicalize the capture with the normal ``recover`` (safe in a
        background thread); the stored snapshot is the full-rebuild state
        at the watermark, cursors included.  Returns (planes, meta) in the
        JAX package's layout."""
        st, hist = recover(*(_on_device(cap[f], self.device, np.int32)
                             for f in ("raw_stage", "tickets", "vals",
                                       "stamp")), spec=self.spec)
        planes = {f: _host(getattr(st, f)) for f in self._SNAP_FIELDS}
        planes["raw_stage"] = cap["raw_stage"]
        meta = {"kind": "queue", "watermark": cap["watermark"],
                "hist": hist.tolist()}
        return planes, meta

    def _snapshot_state(self, planes: dict) -> QueueState:
        """The canonical snapshot state on the queue's device from stored
        planes; every leaf owns its memory."""
        def leaf(f):
            return _on_device(planes[f], self.device)
        cur = leaf("cur")
        return make_state(self.spec, device=self.device)._replace(
            vals=leaf("vals"), tickets=leaf("tickets"), cur=cur, flushed=cur,
            stamp=leaf("stamp"), head=leaf("head"), tail=leaf("tail"),
            overflow=leaf("overflow"))

    def hybrid_crash_and_recover(self, planes: dict, meta: dict, u=None):
        """Crash (losing head/tail) and recover from the stored snapshot +
        the stamp delta, found on the device (:func:`find_delta`);
        bit-identical to ``crash_and_recover`` under the same adversary.
        Recovery psyncs: exactly 0."""
        u = self._adversary(u)
        n = self.spec.capacity
        self._metrics_pre_recovery()
        self._sync()
        t0 = time.perf_counter()
        crashed = crash(self.state, u)
        delta_idx, delta, stage_d = find_delta(crashed[0], crashed[3],
                                               int(meta["watermark"]))
        self.state = hybrid_recover(self._snapshot_state(planes), *crashed,
                                    delta_idx, spec=self.spec)
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
        return int(size(self.state))

    def __repr__(self):
        return (f"DurableQueue(size={len(self)}, psyncs={self.psyncs}, "
                f"spec={self.spec})")
