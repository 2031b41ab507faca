"""Instruction-granularity sequential oracle of the paper's algorithms.

This is the *reference semantics* used by the hypothesis property tests:
every durable write and every psync is an explicit event, a crash may land
between any two events, and per cache line (== per node) the adversary picks
a persisted prefix that is at least the last explicit flush (clflush) and at
most the full write history (arbitrary eviction) -- the exact memory model
of the paper (TSO + clflush, Section 2 and Appendix A).

The oracle executes one operation at a time (the JAX batch dimension maps
lanes to this sequential order), so linearization order is the program
order; durable linearizability then reduces to checking, per key, that the
recovered membership is consistent with a crash-consistent cut:

  * every operation completed before the crash is reflected, and
  * the single operation pending at the crash (if any) may or may not be.

A copy of ``repro.core.oracle`` (pure Python, no JAX), so that the port's
property tests run where only the port is installed.  It follows the same
traces as the original, event for event.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

FREE, INVALID, PAYLOAD, VALID, DELETED = 0, 1, 2, 3, 4


@dataclass
class Node:
    key: int = 0
    value: int = 0
    cur: int = FREE          # volatile stage
    flushed: int = FREE      # last explicitly psynced stage
    history: List[int] = field(default_factory=lambda: [FREE])


@dataclass
class OpRecord:
    kind: str                # insert / remove / contains
    key: int
    result: Optional[bool]   # None while pending
    completed: bool = False


class OracleSet:
    """Sequential durable set with explicit psync events; mode selects the
    flush discipline (linkfree / soft / logfree)."""

    def __init__(self, capacity: int, mode: str = "soft"):
        assert mode in ("linkfree", "soft", "logfree")
        self.mode = mode
        self.nodes = [Node() for _ in range(capacity)]
        self.index: Dict[int, int] = {}       # volatile: key -> node id
        self.psyncs = 0
        self.events = 0                       # durable-write event counter
        self.ops: List[OpRecord] = []
        self.crashed = False

    # -- low-level durable events ------------------------------------------
    def _write_stage(self, nid: int, stage: int):
        n = self.nodes[nid]
        n.cur = stage
        n.history.append(stage)
        self.events += 1

    def _psync(self, nid: int):
        n = self.nodes[nid]
        if n.flushed < n.cur:
            n.flushed = n.cur
        self.psyncs += 1
        self.events += 1

    def _alloc(self) -> int:
        for i, n in enumerate(self.nodes):
            if n.cur == FREE or (n.cur == DELETED and n.flushed == DELETED):
                if n.cur == DELETED:          # recycle: fresh incarnation
                    n.history = [FREE]
                    n.cur = n.flushed = FREE
                return i
        raise RuntimeError("capacity exhausted")

    # -- operations (each yields at every durable event via step budget) ----
    def insert(self, key: int, value: int, budget: Optional[int] = None) -> Optional[bool]:
        """Run insert; if ``budget`` events are exhausted mid-op, the op is
        left pending (crash point).  Returns result or None if pending."""
        rec = OpRecord("insert", key, None)
        self.ops.append(rec)
        steps = _Budget(budget)

        if key in self.index:
            nid = self.index[key]
            node = self.nodes[nid]
            # help: make the racing insert durable before reporting failure
            if self.mode in ("linkfree",) and node.flushed < VALID:
                if steps.spend(self, rec):
                    return None
                self._psync(nid)
            rec.result, rec.completed = False, True
            return False

        nid = self._alloc()
        node = self.nodes[nid]
        # flipV1 (fence) -> payload -> link -> makeValid -> psync
        if steps.spend(self, rec):
            return None
        self._write_stage(nid, INVALID)
        if steps.spend(self, rec):
            return None
        node.key, node.value = key, value
        self._write_stage(nid, PAYLOAD)
        if steps.spend(self, rec):
            return None
        if self.mode == "soft":
            # SOFT: PNode.create completes (valid + psync) BEFORE the
            # volatile linearization point (state -> INSERTED).
            self._write_stage(nid, VALID)
            if steps.spend(self, rec):
                return None
            self._psync(nid)
            if steps.spend(self, rec):
                return None
            self.index[key] = nid
        else:
            # link-free: link while invalid, then makeValid, then psync.
            self.index[key] = nid
            if steps.spend(self, rec):
                return None
            self._write_stage(nid, VALID)
            if steps.spend(self, rec):
                return None
            self._psync(nid)
            if self.mode == "logfree":
                if steps.spend(self, rec):
                    return None
                self._psync(nid)  # pointer persist (second cache line)
        rec.result, rec.completed = True, True
        return True

    def remove(self, key: int, budget: Optional[int] = None) -> Optional[bool]:
        rec = OpRecord("remove", key, None)
        self.ops.append(rec)
        steps = _Budget(budget)

        if key not in self.index:
            rec.result, rec.completed = False, True
            return False
        nid = self.index[key]
        # mark / intend-to-delete -> psync -> unlink
        if steps.spend(self, rec):
            return None
        self._write_stage(nid, DELETED)
        if steps.spend(self, rec):
            return None
        self._psync(nid)
        if self.mode == "logfree":
            if steps.spend(self, rec):
                return None
            self._psync(nid)      # pointer persist
        if steps.spend(self, rec):
            return None
        del self.index[key]       # trim (volatile only)
        rec.result, rec.completed = True, True
        return True

    def contains(self, key: int, budget: Optional[int] = None) -> Optional[bool]:
        rec = OpRecord("contains", key, None)
        self.ops.append(rec)
        steps = _Budget(budget)
        present = key in self.index and self.nodes[self.index[key]].cur == VALID
        if present and self.mode in ("linkfree", "logfree"):
            nid = self.index[key]
            if self.nodes[nid].flushed < VALID:
                if steps.spend(self, rec):
                    return None
                self._psync(nid)
        rec.result, rec.completed = True, True
        return present

    # -- crash + recovery ----------------------------------------------------
    def crash(self, evictions: List[int]) -> List[Tuple[int, int, int]]:
        """Crash now.  ``evictions[i]`` biases node i's persisted stage within
        [flushed, cur] (adversarial cache eviction).  Returns the NVM image:
        (persisted_stage, key, value) per node."""
        self.crashed = True
        image = []
        for n, ev in zip(self.nodes, evictions):
            lo_idx = n.history.index(n.flushed) if n.flushed in n.history else 0
            hi_idx = len(n.history) - 1
            pick = min(hi_idx, max(lo_idx, lo_idx + ev))
            image.append((n.history[pick], n.key, n.value))
        return image

    @staticmethod
    def recover(image: List[Tuple[int, int, int]]) -> Dict[int, int]:
        """Recovery scan: persisted VALID -> member (key -> value)."""
        out = {}
        for stage, key, value in image:
            if stage == VALID:
                out[key] = value
        return out

    # -- durable-linearizability check ---------------------------------------
    def check_recovery(self, recovered: Dict[int, int]) -> Tuple[bool, str]:
        """Recovered set must equal the completed-op semantics, modulo the
        one pending operation (which may or may not have taken effect)."""
        expected: Dict[int, int] = {}
        pending_key = None
        pending_kind = None
        for rec in self.ops:
            if not rec.completed:
                pending_key, pending_kind = rec.key, rec.kind
                continue
            if rec.kind == "insert" and rec.result:
                expected[rec.key] = 1
            elif rec.kind == "remove" and rec.result:
                expected.pop(rec.key, None)
        exp_keys = set(expected)
        got = set(recovered)
        flex = {pending_key} if pending_kind in ("insert", "remove") else set()
        if got - exp_keys - flex:
            return False, f"ghost keys {got - exp_keys - flex}"
        if exp_keys - got - flex:
            return False, f"lost keys {exp_keys - got - flex}"
        return True, "ok"


class OracleQueue:
    """Sequential durable FIFO queue with explicit psync events -- the
    instruction-granularity reference for ``repro_torch.core.queue`` (and
    the JAX package's ``repro.core.queue``), following the *Durable Queues:
    The Second Amendment* discipline on the same stage machine (and the
    same op-trace interface as :class:`OracleSet`: every
    durable write and psync is an event, ``budget`` crashes mid-op, the
    per-slot adversary picks a persisted stage in [flushed, cur]).

    Slot reuse is ring-shaped: ticket t lives in slot ``t % capacity`` and
    a slot is recycled (fresh incarnation) only after its previous
    dequeue's psync -- guaranteed by the full-queue check, exactly the
    batched engine's ring-distance guard.  ``Node.key`` carries the
    ticket, ``Node.value`` the payload.
    """

    def __init__(self, capacity: int, mode: str = "soft"):
        assert mode in ("linkfree", "soft", "logfree")
        self.mode = mode
        self.capacity = capacity
        self.nodes = [Node() for _ in range(capacity)]
        self.head = 0                         # volatile: next dequeue ticket
        self.tail = 0                         # volatile: next enqueue ticket
        self.psyncs = 0
        self.events = 0
        self.ops: List[OpRecord] = []
        self.crashed = False

    # -- low-level durable events (same shape as OracleSet) -----------------
    def _write_stage(self, nid: int, stage: int):
        n = self.nodes[nid]
        n.cur = stage
        n.history.append(stage)
        self.events += 1

    def _psync(self, nid: int):
        n = self.nodes[nid]
        if n.flushed < n.cur:
            n.flushed = n.cur
        self.psyncs += 1
        self.events += 1

    # -- operations ---------------------------------------------------------
    def enqueue(self, value: int, budget: Optional[int] = None
                ) -> Optional[bool]:
        """Append ``value``; False when the ring is full (zero psync), None
        when the event ``budget`` ran out mid-op (crash point)."""
        rec = OpRecord("enqueue", value, None)
        self.ops.append(rec)
        steps = _Budget(budget)

        if self.tail - self.head >= self.capacity:
            rec.result, rec.completed = False, True
            return False
        nid = self.tail % self.capacity
        node = self.nodes[nid]
        if node.cur == DELETED:               # recycle: fresh incarnation
            assert node.flushed == DELETED    # dequeue psync'd before return
            node.history = [FREE]
            node.cur = node.flushed = FREE
        # flipV1 -> payload (ticket + value) -> makeValid -> psync
        if steps.spend(self, rec):
            return None
        self._write_stage(nid, INVALID)
        if steps.spend(self, rec):
            return None
        node.key, node.value = self.tail, value
        self._write_stage(nid, PAYLOAD)
        if steps.spend(self, rec):
            return None
        self._write_stage(nid, VALID)
        if steps.spend(self, rec):
            return None
        self._psync(nid)
        if self.mode == "logfree":
            if steps.spend(self, rec):
                return None
            self._psync(nid)                  # pointer persist
        if steps.spend(self, rec):
            return None
        self.tail += 1                        # volatile publish (SOFT order)
        rec.result, rec.completed = True, True
        return True

    def dequeue(self, budget: Optional[int] = None
                ) -> Optional[Tuple[bool, Optional[int]]]:
        """Pop the head: (True, value), (False, None) on empty (zero
        psync), or None when the budget crashed the op."""
        rec = OpRecord("dequeue", 0, None)
        self.ops.append(rec)
        steps = _Budget(budget)

        if self.head == self.tail:
            rec.result, rec.completed = False, True
            return False, None
        nid = self.head % self.capacity
        node = self.nodes[nid]
        rec.key = node.value                  # record the popped payload
        # mark deleted -> psync -> advance head (volatile)
        if steps.spend(self, rec):
            return None
        self._write_stage(nid, DELETED)
        if steps.spend(self, rec):
            return None
        self._psync(nid)
        if self.mode == "logfree":
            if steps.spend(self, rec):
                return None
            self._psync(nid)                  # pointer persist
        if steps.spend(self, rec):
            return None
        self.head += 1
        rec.result, rec.completed = True, True
        return True, node.value

    # -- crash + recovery ---------------------------------------------------
    def crash(self, evictions: List[int]) -> List[Tuple[int, int, int]]:
        """Crash now; same adversary contract as :meth:`OracleSet.crash`.
        Returns the NVM image: (persisted_stage, ticket, value) per slot."""
        self.crashed = True
        image = []
        for n, ev in zip(self.nodes, evictions):
            lo_idx = n.history.index(n.flushed) if n.flushed in n.history else 0
            hi_idx = len(n.history) - 1
            pick = min(hi_idx, max(lo_idx, lo_idx + ev))
            image.append((n.history[pick], n.key, n.value))
        return image

    @staticmethod
    def recover(image: List[Tuple[int, int, int]]
                ) -> Tuple[List[int], int, int]:
        """Recovery: persisted VALID slots in ticket order are the live
        FIFO; head/tail reconstructed from persisted stages alone.
        Returns (contents front-to-back, head, tail)."""
        live = sorted((t, v) for stage, t, v in image if stage == VALID)
        dels = [t for stage, t, _ in image if stage == DELETED]
        head = live[0][0] if live else (max(dels) + 1 if dels else 0)
        tail = live[-1][0] + 1 if live else head
        return [v for _, v in live], head, tail

    # -- durable-linearizability check --------------------------------------
    def check_recovery(self, recovered: List[int]) -> Tuple[bool, str]:
        """Recovered FIFO contents must equal the completed-op replay,
        modulo the single pending operation: a pending enqueue may or may
        not have appended, a pending dequeue may or may not have popped."""
        exp: List[int] = []
        pending = None
        for rec in self.ops:
            if not rec.completed:
                pending = rec
                continue
            if rec.kind == "enqueue" and rec.result:
                exp.append(rec.key)
            elif rec.kind == "dequeue" and rec.result:
                exp.pop(0)
        ok = [tuple(exp)]
        if pending is not None and pending.kind == "enqueue":
            ok.append(tuple(exp) + (pending.key,))
        if pending is not None and pending.kind == "dequeue" and exp:
            ok.append(tuple(exp[1:]))
        if tuple(recovered) in ok:
            return True, "ok"
        return False, (f"recovered {recovered} not in any crash-consistent "
                       f"cut {ok} (pending={pending})")


class _Budget:
    """Counts down durable events; signals the crash point when exhausted."""

    def __init__(self, budget: Optional[int]):
        self.left = budget

    def spend(self, oracle: "OracleSet", rec: OpRecord) -> bool:
        if self.left is None:
            return False
        if self.left <= 0:
            return True
        self.left -= 1
        return False
