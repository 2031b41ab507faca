"""Batched durable lock-free sets in PyTorch: link-free, SOFT and log-free.

PyTorch port of the part of ``repro.core.durable_set`` that the bucket index
backend runs.  A batch of B lanes plays the role of B racing threads;
conflicts inside a batch are resolved by lane priority (lowest lane index
wins the "CAS").  The three algorithms share the node-pool + volatile-index
machinery and differ in *when they psync*:

  soft      1 psync per successful update, 0 per read, 0 for helped/failed
            ops.
  linkfree  1 psync per successful update; failed inserts / contains may
            psync once more to make a racing insert durable before
            reporting; duplicate-lane contention causes extra helper
            flushes.
  logfree   every update additionally persists the link write (2 psyncs per
            update), plus 2 per duplicate lane.

The mutation path is plan/commit: a mode-independent planning stage
(``plan_insert`` / ``plan_remove``) followed by the node-pool scatter and ONE
backend-owned ``index_update`` hook over :class:`IndexFields`.

Every function returns the same values, at the same dtypes, as its JAX
counterpart; the counters are saturating int32, as JAX keeps them in its
default 32-bit mode.  Functions build new tensors and leave their inputs
unchanged.  The legacy string-index wrappers (``insert_batch`` /
``remove_batch`` / ``contains_batch`` / ``recover`` /
``crash_and_recover``) keep the JAX package's ``index="probe"|"scan"``
interface; a probe lookup on the card runs the ``table_probe`` kernel,
as the engine's probe backend does.

The linear-probe table's searches evaluate each lane's whole probe window
in one pass, where the JAX package walks it in chunks of 16 slots
inside a ``lax.while_loop`` that stops once every lane has resolved: the
first event of the whole window is the one the chunked walk finds, and on
the card every extra round would be a dozen more launches on a path the
host's launches already bound.  ``table_claim`` keeps its data-dependent
loop and reads one flag per round on the host.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.drop import set_drop
from repro_torch.core.nvm import (FREE, VALID, DELETED, EMPTY, TOMB,
                                  hash32, crash_persisted_stage)
from repro_torch.kernels.hash_probe.kernel import table_probe_cuda

MODES = ("linkfree", "soft", "logfree")

# Counter dtype for n_psync / n_ops: int32, and every increment saturates at
# INT32_MAX instead of wrapping negative on long runs.
COUNTER_DTYPE = torch.int32
COUNTER_MAX = torch.iinfo(COUNTER_DTYPE).max

_I32 = torch.int32


def _bump(counter: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Saturating counter increment (delta >= 0): never wraps past the max."""
    return counter + torch.minimum(delta.to(COUNTER_DTYPE),
                                   COUNTER_MAX - counter)


def _count(mask: torch.Tensor) -> torch.Tensor:
    """Number of True lanes, as an i32[] (JAX's ``jnp.sum`` of int32)."""
    return mask.sum().to(_I32)


class SetState(NamedTuple):
    """Durable areas + volatile index + psync accounting.

    The same 16 leaves at the same dtypes as ``repro.core.durable_set``'s
    ``SetState``.  Backends that do not use a given structure carry it at
    zero size, so state *shape* is a function of the spec that created it.
    """
    # --- durable area (node pool); keys/values persist once stage >= PAYLOAD
    keys: torch.Tensor      # i32[N]
    values: torch.Tensor    # i32[N]
    cur: torch.Tensor       # i32[N] volatile lifecycle stage
    flushed: torch.Tensor   # i32[N] stage covered by the last explicit psync
    stamp: torch.Tensor     # i32[N] epoch of the last durable mutation
    # --- volatile index (never persisted -- the paper's core idea)
    table: torch.Tensor     # i32[T] node id, EMPTY or TOMB; linear probing
    bkeys: torch.Tensor     # i32[NB, W] bucket-table way keys
    bids: torch.Tensor      # i32[NB, W] bucket-table way node ids, EMPTY free
    skeys: torch.Tensor     # i32[S] dense-stash keys (bucket overflow spill)
    sids: torch.Tensor      # i32[S] dense-stash node ids, EMPTY == free slot
    stash_n: torch.Tensor   # i32[] stash-occupancy latch
    # --- accounting (saturating i32[])
    n_psync: torch.Tensor   # explicit flush+fence count
    n_ops: torch.Tensor     # completed operations
    size: torch.Tensor      # i32[] live member count
    overflow: torch.Tensor  # bool[] capacity / probe-length / stash latch
    epoch: torch.Tensor     # i32[] VOLATILE current generation


def make_state(capacity: int, table_factor: int = 4, n_buckets: int = 0,
               bucket_width: int = 0, stash_size: int = 0,
               device="cuda") -> SetState:
    """Fresh state on ``device``.  An all-EMPTY bucket table IS the
    canonical empty index -- no separate bulk build is needed here."""
    dev = resolve_device(device)
    n = int(capacity)
    t = 1 << max(3, (n * table_factor - 1).bit_length())

    def zeros(shape, dtype=_I32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def empty(shape):
        return torch.full(shape, EMPTY, dtype=_I32, device=dev)

    return SetState(
        keys=zeros((n,)), values=zeros((n,)), cur=zeros((n,)),
        flushed=zeros((n,)), stamp=zeros((n,)),
        table=empty((t,)),
        bkeys=zeros((n_buckets, bucket_width)),
        bids=empty((n_buckets, bucket_width)),
        skeys=zeros((stash_size,)), sids=empty((stash_size,)),
        stash_n=zeros(()),
        n_psync=zeros((), COUNTER_DTYPE), n_ops=zeros((), COUNTER_DTYPE),
        size=zeros(()),
        overflow=zeros((), torch.bool),
        epoch=torch.ones((), dtype=_I32, device=dev),  # stamp 0: never
    )


# ---------------------------------------------------------------------------
# Volatile index: linear-probe lookup, sequential-scan variant, and the
# probe table's writers.
# ---------------------------------------------------------------------------

MAX_PROBE = 128

# Member ids per table_claim call when recovery rebuilds the probe table:
# each claim round builds B x B conflict matrices, 16 M entries at 4096.
REBUILD_CHUNK = 4096

LookupFn = Callable[[SetState, torch.Tensor], torch.Tensor]


class IndexFields(NamedTuple):
    """The volatile-index slice of :class:`SetState` -- everything a backend
    may maintain on the mutation path.  The commit stage hands this bundle
    to the backend's ``update_index`` hook."""
    table: torch.Tensor
    bkeys: torch.Tensor
    bids: torch.Tensor
    skeys: torch.Tensor
    sids: torch.Tensor
    stash_n: torch.Tensor


def index_fields(state: SetState) -> IndexFields:
    return IndexFields(state.table, state.bkeys, state.bids, state.skeys,
                       state.sids, state.stash_n)


# Index commit hook: ``(fields, keys, node_ids, do-mask) -> (fields,
# overflow)``.  ``None`` means the mutation commits with no index upkeep.
IndexUpdateFn = Callable[[IndexFields, torch.Tensor, torch.Tensor,
                          torch.Tensor], Tuple[IndexFields, torch.Tensor]]


class MutationPlan(NamedTuple):
    """Planning-stage output shared by link-free/SOFT/log-free: lookup join,
    in-batch dedup, phase classification and (for inserts) batch-wide
    allocation ranks.  Mode-independent."""
    existing: torch.Tensor  # i32[B] node id from the lookup, EMPTY if absent
    found: torch.Tensor     # bool[B] existing >= 0
    win: torch.Tensor       # bool[B] lanes that commit the mutation
    lose_dup: torch.Tensor  # bool[B] active lanes that lost the in-batch race
    targets: torch.Tensor   # i32[B] node id committed (alloc slot / existing)
    count: torch.Tensor     # i32[]  number of winning lanes
    overflow: torch.Tensor  # bool[] node-pool exhaustion (insert plans only)


def _home(keys: torch.Tensor, t: int) -> torch.Tensor:
    """Home slot i32 of each key in a table of ``t`` (a power of two)
    slots: ``hash32(keys) & (t - 1)``."""
    return (hash32(keys) & (t - 1)).to(_I32)


def _window(keys: torch.Tensor, t: int, max_probe: int) -> torch.Tensor:
    """(B, max_probe) int64 slot of each probe step d: (home + d) & (t-1)."""
    d = torch.arange(max_probe, dtype=torch.int64, device=keys.device)
    return (_home(keys, t).to(torch.int64)[:, None] + d) & (t - 1)


def _first(mask: torch.Tensor) -> torch.Tensor:
    """(B, 1) column of the first True of each row (0 when none), as
    ``jnp.argmax`` of a bool plane: argmax returns the first maximum."""
    return torch.argmax(mask.to(torch.uint8), dim=1, keepdim=True)


def _lookup_probe(state: SetState, keys: torch.Tensor,
                  max_probe: int = MAX_PROBE) -> torch.Tensor:
    """Windowed linear-probe lookup -> node id or EMPTY per lane: the first
    match-or-EMPTY event in probe order decides, as the sequential probe
    does."""
    n = state.keys.shape[0]
    ids = state.table[_window(keys, state.table.shape[0], max_probe)]
    match = (ids >= 0) & (state.keys[ids.clamp(0, n - 1)] == keys[:, None])
    event = match | (ids == EMPTY)
    fd = _first(event)
    hit = event.any(dim=1) & match.gather(1, fd)[:, 0]
    return _where_i32(hit, ids.gather(1, fd)[:, 0], EMPTY)


def _lookup_scan(state: SetState, keys: torch.Tensor) -> torch.Tensor:
    """O(N)-traversal lookup: models the paper's *list* experiments, where
    operation cost is dominated by walking the linked structure.  Builds a
    B x N plane."""
    live = state.cur == VALID
    eq = live[None, :] & (keys[:, None] == state.keys[None, :])
    return _where_i32(eq.any(dim=1), _first(eq)[:, 0], EMPTY)


def _lookup(state: SetState, keys: torch.Tensor, index: str) -> torch.Tensor:
    """The legacy wrappers' lookup: ``"scan"`` traverses the pool, any
    other index probes the table -- through the ``table_probe`` kernel
    when the state is on the card, as ``engine.ProbeBackend`` does."""
    if index == "scan":
        return _lookup_scan(state, keys)
    if state.table.is_cuda:
        return table_probe_cuda(state.table, state.keys, keys, MAX_PROBE)
    return _lookup_probe(state, keys)


def _table_write_ref(table: torch.Tensor, keys: torch.Tensor,
                     ids: torch.Tensor, do: torch.Tensor,
                     max_probe: int = MAX_PROBE
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """REFERENCE sequential writer: insert (key -> id) pairs for lanes with
    do[i] into the first EMPTY/TOMB slot of the key's window, lane by lane.
    The lane loop *is* the linearization order that :func:`table_claim`
    reproduces.  It reads each lane's flags on the host: tests only."""
    t = table.shape[0]
    pos = _window(keys, t, max_probe)
    table = table.clone()
    ovf = False
    for i in range(keys.shape[0]):
        if not bool(do[i]):
            continue
        free = table[pos[i]] < 0
        if bool(free.any()):
            table[pos[i, _first(free[None])[0, 0]]] = ids[i]
        else:
            ovf = True
    return table, torch.tensor(ovf, device=table.device)


def _table_delete_ref(table: torch.Tensor, keys: torch.Tensor,
                      ids: torch.Tensor, do: torch.Tensor,
                      max_probe: int = MAX_PROBE) -> torch.Tensor:
    """REFERENCE sequential deleter: tombstone the slot holding id for lanes
    with do[i], lane by lane; a lane's search stops at the first slot that
    holds its id or is EMPTY.  Host reads per lane: tests only."""
    t = table.shape[0]
    pos = _window(keys, t, max_probe)
    table = table.clone()
    for i in range(keys.shape[0]):
        if not bool(do[i]):
            continue
        window = table[pos[i]]
        hit = window == ids[i]
        fd = _first((hit | (window == EMPTY))[None])[0, 0]
        if bool(hit[fd]):
            table[pos[i, fd]] = TOMB
    return table


def table_claim(table: torch.Tensor, keys: torch.Tensor, ids: torch.Tensor,
                do: torch.Tensor, max_probe: int = MAX_PROBE
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Parallel first-free slot claiming, equal to the sequential
    ``_table_write_ref`` (and to the JAX package's ``table_claim``).

    Each round every pending lane finds its candidate, the first free
    (EMPTY or TOMB) slot of its whole window.  Lane i commits only when no
    earlier pending lane's window covers i's candidate: s_i is free, so an
    earlier lane can land on it only if its window covers it, and slots
    are only consumed within a call.  The round's commits are therefore
    placements the sequential writer makes; they land in ONE scatter, to
    distinct slots (a later lane with the same candidate is blocked).  A
    lane with no free slot in its window fails and latches the overflow.
    Each round the lowest pending lane commits or fails, so the loop ends
    within B rounds (1 in the uncontended common case).  The loop's
    condition is one host read per round.  Returns (table, overflow)."""
    t = table.shape[0]
    b = keys.shape[0]
    h = _home(keys, t)
    pos = _window(keys, t, max_probe)
    lane = torch.arange(b, device=keys.device)
    j_before_i = lane[:, None] < lane[None, :]             # [j, i]: j < i
    pending = do
    ovf = torch.zeros((), dtype=torch.bool, device=table.device)
    while True:
        free = table[pos] < 0                              # (B, P)
        has = free.any(dim=1)
        s = pos.gather(1, _first(free))[:, 0].to(_I32)     # candidate slot
        ovf = ovf | (pending & ~has).any()
        contender = pending & has
        # reach[j, i]: does contender j's window cover lane i's slot?
        reach = ((s[None, :] - h[:, None]) & (t - 1)) < max_probe
        blocked = (contender[:, None] & j_before_i & reach).any(dim=0)
        commit = contender & ~blocked
        table = set_drop(table, _where_i32(commit, s, t), ids)
        pending = contender & ~commit
        if not bool(pending.any()):
            return table, ovf


def table_release(table: torch.Tensor, keys: torch.Tensor, ids: torch.Tensor,
                  do: torch.Tensor, max_probe: int = MAX_PROBE
                  ) -> torch.Tensor:
    """Parallel tombstoning, equal to ``_table_delete_ref``: each lane's
    first hit-or-EMPTY event in its window, and all trims in ONE scatter
    against the pre-call table (delete searches never interact: a TOMB is
    neither EMPTY nor another lane's id, and do-lanes carry distinct
    ids)."""
    t = table.shape[0]
    pos = _window(keys, t, max_probe)
    window = table[pos]                                    # (B, P)
    hit = window == ids[:, None]
    event = hit | (window == EMPTY)
    fd = _first(event)
    ok = do & event.any(dim=1) & hit.gather(1, fd)[:, 0]
    return set_drop(table, _where_i32(ok, pos.gather(1, fd)[:, 0], t), TOMB)


def probe_index_update(phase: str, max_probe: int = MAX_PROBE
                       ) -> IndexUpdateFn:
    """The linear-probe table's commit hook: claim on insert, release on
    remove.  Bound by ``ProbeBackend.update_index``."""
    if phase == "insert":
        def update(f: IndexFields, keys, ids, do):
            table, ovf = table_claim(f.table, keys, ids, do, max_probe)
            return f._replace(table=table), ovf
    else:
        def update(f: IndexFields, keys, ids, do):
            table = table_release(f.table, keys, ids, do, max_probe)
            return f._replace(table=table), torch.zeros(
                (), dtype=torch.bool, device=keys.device)
    return update


def table_build(table: torch.Tensor, keys: torch.Tensor,
                member: torch.Tensor, max_probe: int = MAX_PROBE,
                chunk: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Recovery's bulk build of the probe table: ``_table_write_ref`` over
    every node id with do = member, which the JAX package runs as one
    sequential loop over the pool.  Here the member ids, in id order, go
    through ``table_claim`` in chunks of ``chunk`` (``REBUILD_CHUNK`` when
    None) with the overflow latches OR-ed: non-members write nothing, each
    claim equals the sequential writer over its chunk, and chunks applied
    in turn equal it over their concatenation.  Compacting the member ids
    is one host read.  Returns (table, overflow)."""
    chunk = REBUILD_CHUNK if chunk is None else chunk
    ids = torch.nonzero(member).flatten().to(_I32)
    ovf = torch.zeros((), dtype=torch.bool, device=table.device)
    for s in range(0, ids.shape[0], chunk):
        c = ids[s:s + chunk]
        table, o = table_claim(table, keys[c], c,
                               torch.ones_like(c, dtype=torch.bool),
                               max_probe)
        ovf = ovf | o
    return table, ovf


def _alloc(state: SetState, need: torch.Tensor, count: torch.Tensor):
    """Pick ``count`` free node slots; lane i gets the cumsum(need)-th one.

    Free slots are nodes at FREE or flushed-DELETED stage.  The lane of
    claim-rank r takes the (r+1)-th free slot in index order -- a binary
    search over the free-mask cumsum."""
    free = (state.cur == FREE) | ((state.cur == DELETED)
                                  & (state.flushed == DELETED))
    c = torch.cumsum(free.to(_I32), 0, dtype=_I32)
    total = c[-1]
    rank = torch.cumsum(need.to(_I32), 0, dtype=_I32) - 1  # lane -> rank
    slot = torch.searchsorted(c, rank + 1, right=False).to(_I32)
    ok = need & (rank < total)
    lane_slot = torch.where(ok, slot, torch.full_like(slot, -1))
    return lane_slot, total < count


def _dedup_first(keys: torch.Tensor,
                 active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """True for the first lane carrying each distinct key (lane-priority
    CAS).  With an ``active`` mask only active lanes compete.  Builds B x B
    matrices: keep B to a few thousand lanes."""
    b = keys.shape[0]
    same = keys[:, None] == keys[None, :]
    earlier = torch.ones((b, b), dtype=torch.bool,
                         device=keys.device).tril(-1)
    if active is None:
        return ~(same & earlier).any(dim=1)
    blocked = (same & earlier & active[None, :]).any(dim=1)
    return active & ~blocked


def plan_insert(state: SetState, keys: torch.Tensor, active: torch.Tensor,
                existing: torch.Tensor) -> MutationPlan:
    """Insert plan: winners are first-lanes of absent keys, capped by the
    free-node supply; ``targets`` carries the claimed slot per winning
    lane."""
    found = existing >= 0
    first = _dedup_first(keys, active)
    win = first & ~found
    lose_dup = active & ~first & ~found
    count = _count(win)
    slots, ovf = _alloc(state, win, count)
    win = win & (slots >= 0)                     # drop lanes on pool overflow
    return MutationPlan(existing=existing, found=found, win=win,
                        lose_dup=lose_dup, targets=slots, count=_count(win),
                        overflow=ovf)


def plan_remove(state: SetState, keys: torch.Tensor, active: torch.Tensor,
                existing: torch.Tensor) -> MutationPlan:
    """Remove plan: winners are first-lanes of present keys; ``targets`` is
    the node id being retired (the lookup result)."""
    found = existing >= 0
    first = _dedup_first(keys, active)
    win = first & found
    lose_dup = active & ~first & found
    return MutationPlan(existing=existing, found=found, win=win,
                        lose_dup=lose_dup, targets=existing,
                        count=_count(win),
                        overflow=torch.zeros((), dtype=torch.bool,
                                             device=keys.device))


def _max_at(dst: torch.Tensor, idx: torch.Tensor,
            src: torch.Tensor) -> torch.Tensor:
    """``dst.at[idx].max(src)``."""
    return dst.scatter_reduce(0, idx.to(torch.int64), src.to(dst.dtype),
                              "amax", include_self=True)


def _where_i32(cond: torch.Tensor, a, b) -> torch.Tensor:
    """``jnp.where`` over int32 tensors or Python ints, keeping int32.
    Python ints stay kernel arguments: moving one to the device first would
    be a copy that synchronizes the host with the stream."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return torch.where(cond, a, b).to(_I32)
    return cond.to(_I32) * (a - b) + b


def _active(keys: torch.Tensor, active: Optional[torch.Tensor]):
    if active is None:
        return torch.ones(keys.shape, dtype=torch.bool, device=keys.device)
    return active


def _insert_impl(state: SetState, keys: torch.Tensor, values: torch.Tensor,
                 *, mode: str, lookup_fn: LookupFn,
                 active: Optional[torch.Tensor] = None,
                 existing: Optional[torch.Tensor] = None,
                 index_update: Optional[IndexUpdateFn] = None
                 ) -> Tuple[SetState, torch.Tensor]:
    """``existing`` lets a caller reuse a lookup already performed against a
    state whose index fields are unchanged.  ``index_update`` is the
    backend's index commit hook; None commits the node pool only."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    active = _active(keys, active)
    if existing is None:
        existing = lookup_fn(state, keys)

    # --- plan: dedup, classification, allocation ranks ---------------------
    plan = plan_insert(state, keys, active, existing)
    win, slots, count = plan.win, plan.targets, plan.count
    n = state.keys.shape[0]
    sidx = _where_i32(win, slots, n)                # index n => dropped

    # --- commit: node pool, then the backend's index fields ----------------
    keys_a = set_drop(state.keys, sidx, keys)
    vals_a = set_drop(state.values, sidx, values)
    # flipV1 -> payload -> makeValid, then psync: cur=VALID, flushed=VALID.
    cur = set_drop(state.cur, sidx, VALID)
    flushed = set_drop(state.flushed, sidx, VALID)
    # The epoch stamp rides the same commit scatter (same cache line as the
    # stage word): it costs no psync of its own.
    stamp = set_drop(state.stamp, sidx, state.epoch)

    fields = index_fields(state)
    iovf = torch.zeros((), dtype=torch.bool, device=keys.device)
    if index_update is not None:
        fields, iovf = index_update(fields, keys, slots, win)

    # --- psync accounting (mode-specific, computed from the plan) ----------
    new_psync = count
    if mode == "logfree":
        new_psync = new_psync * 2                    # + pointer persist
    if mode == "linkfree":
        # A failed insert makes the racing insert durable before returning
        # false; only pre-existing *unflushed* nodes pay.
        eidx = existing.clamp(0, n - 1).to(torch.int64)
        helper = active & plan.found & (state.flushed[eidx] < VALID) \
            & (state.cur[eidx] == VALID)
        hidx = torch.where(helper, eidx, torch.zeros_like(eidx))
        flushed = _max_at(flushed, hidx, _where_i32(helper, VALID, 0))
        stamp = _max_at(stamp, hidx, _where_i32(helper, state.epoch, 0))
        # Contention model: duplicate lanes re-flush the winner.
        new_psync = new_psync + _count(helper) + _count(plan.lose_dup)
    if mode == "logfree":
        new_psync = new_psync + 2 * _count(plan.lose_dup)

    return SetState(
        keys=keys_a, values=vals_a, cur=cur, flushed=flushed, stamp=stamp,
        table=fields.table, bkeys=fields.bkeys, bids=fields.bids,
        skeys=fields.skeys, sids=fields.sids, stash_n=fields.stash_n,
        n_psync=_bump(state.n_psync, new_psync),
        n_ops=_bump(state.n_ops, _count(active)),
        size=state.size + count,
        overflow=state.overflow | plan.overflow | iovf,
        epoch=state.epoch,
    ), win


def _remove_impl(state: SetState, keys: torch.Tensor, *, mode: str,
                 lookup_fn: LookupFn, active: Optional[torch.Tensor] = None,
                 existing: Optional[torch.Tensor] = None,
                 index_update: Optional[IndexUpdateFn] = None
                 ) -> Tuple[SetState, torch.Tensor]:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    active = _active(keys, active)
    if existing is None:
        existing = lookup_fn(state, keys)

    # --- plan --------------------------------------------------------------
    plan = plan_remove(state, keys, active, existing)
    win, count = plan.win, plan.count

    # --- commit ------------------------------------------------------------
    eidx = existing.clamp(0, state.keys.shape[0] - 1).to(torch.int64)
    # mark (INTEND_TO_DELETE -> destroy psync -> DELETED); flushed follows
    # because every algorithm persists the delete before returning.
    mark = _max_at(torch.zeros_like(state.cur),
                   torch.where(win, eidx, torch.zeros_like(eidx)),
                   win.to(state.cur.dtype)).to(torch.bool)
    cur = _where_i32(mark, DELETED, state.cur)
    flushed = _where_i32(mark, DELETED, state.flushed)
    stamp = torch.where(mark, state.epoch, state.stamp)

    fields = index_fields(state)
    if index_update is not None:
        fields, _ = index_update(fields, keys, existing, win)

    # --- psync accounting --------------------------------------------------
    new_psync = count
    if mode == "logfree":
        new_psync = new_psync * 2 + 2 * _count(plan.lose_dup)
    if mode == "linkfree":
        new_psync = new_psync + _count(plan.lose_dup)

    return SetState(
        keys=state.keys, values=state.values, cur=cur, flushed=flushed,
        stamp=stamp,
        table=fields.table, bkeys=fields.bkeys, bids=fields.bids,
        skeys=fields.skeys, sids=fields.sids, stash_n=fields.stash_n,
        n_psync=_bump(state.n_psync, new_psync),
        n_ops=_bump(state.n_ops, _count(active)),
        size=state.size - count,
        overflow=state.overflow,
        epoch=state.epoch,
    ), win


def _contains_impl(state: SetState, keys: torch.Tensor, *, mode: str,
                   lookup_fn: LookupFn, active: Optional[torch.Tensor] = None
                   ) -> Tuple[SetState, torch.Tensor, torch.Tensor]:
    """Returns (state, present-per-lane, node-id-per-lane).

    SOFT: zero psync (wait-free read).  Link-free: a positive answer is made
    durable first (flush with flag elision).  Log-free: link-and-persist
    read flush when the link is not yet persisted (modeled like link-free).
    """
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    active = _active(keys, active)
    existing = lookup_fn(state, keys)
    found = existing >= 0
    eidx = existing.clamp(0, state.keys.shape[0] - 1).to(torch.int64)
    present = active & found & (state.cur[eidx] == VALID)

    new_psync = torch.zeros((), dtype=_I32, device=keys.device)
    flushed = state.flushed
    stamp = state.stamp
    if mode in ("linkfree", "logfree"):
        need = present & (state.flushed[eidx] < VALID)
        nidx = torch.where(need, eidx, torch.zeros_like(eidx))
        flushed = _max_at(flushed, nidx, _where_i32(need, VALID, 0))
        # The read-side flush durably changes the slot: stamp it.
        stamp = _max_at(stamp, nidx, _where_i32(need, state.epoch, 0))
        new_psync = _count(need)

    state = state._replace(
        flushed=flushed, stamp=stamp,
        n_psync=_bump(state.n_psync, new_psync),
        n_ops=_bump(state.n_ops, _count(active)),
    )
    return state, present, existing


# ---------------------------------------------------------------------------
# Legacy string-index wrappers (see repro_torch.core.engine for the SetSpec /
# backend-protocol surface).  Like the engine's functional API they may
# update the state's tensors in place: callers rebind the state.
# ---------------------------------------------------------------------------

def insert_batch(state: SetState, keys: torch.Tensor, values: torch.Tensor,
                 mode: str = "soft", index: str = "probe"
                 ) -> Tuple[SetState, torch.Tensor]:
    """Batched insert; returns success per lane (False == key already
    present).  The legacy surface always maintains the probe table (scan
    lookups simply never read it)."""
    return _insert_impl(state, keys, values, mode=mode,
                        lookup_fn=lambda s, k: _lookup(s, k, index),
                        index_update=probe_index_update("insert"))


def remove_batch(state: SetState, keys: torch.Tensor, mode: str = "soft",
                 index: str = "probe") -> Tuple[SetState, torch.Tensor]:
    """Batched remove; success == key was present and this lane won the
    race."""
    return _remove_impl(state, keys, mode=mode,
                        lookup_fn=lambda s, k: _lookup(s, k, index),
                        index_update=probe_index_update("remove"))


def contains_batch(state: SetState, keys: torch.Tensor, mode: str = "soft",
                   index: str = "probe") -> Tuple[SetState, torch.Tensor]:
    """Batched contains (see :func:`_contains_impl` for the per-mode psync
    story)."""
    state, present, _ = _contains_impl(
        state, keys, mode=mode, lookup_fn=lambda s, k: _lookup(s, k, index))
    return state, present


# ---------------------------------------------------------------------------
# Crash + recovery
# ---------------------------------------------------------------------------

def crash(state: SetState, u: torch.Tensor):
    """Power failure: the volatile index is lost.  Returns only what NVM
    holds: per-node persisted stage, key/value payloads, and the stamp
    plane.  ``u`` in [0,1) per node drives the eviction adversary."""
    persisted = crash_persisted_stage(state.cur, state.flushed, u)
    return persisted, state.keys, state.values, state.stamp


def _rebuild_from_member(member: torch.Tensor, keys: torch.Tensor,
                         values: torch.Tensor, table_factor: int = 4,
                         max_probe: int = MAX_PROBE, n_buckets: int = 0,
                         bucket_width: int = 0, stash_size: int = 0,
                         build_table: bool = True,
                         index_init: Optional[Callable[[SetState], SetState]]
                         = None,
                         stamp: Optional[torch.Tensor] = None) -> SetState:
    """Shared recovery rebuild: member mask -> fresh SetState (free list +
    volatile-index reconstruction) on the device of ``keys``.
    ``index_init`` is the backend's bulk index build (``bucket_init`` for
    the bucket backend); ``build_table`` is False for backends that never
    read the linear-probe table, which is otherwise rebuilt by
    :func:`table_build`."""
    n = keys.shape[0]
    state = make_state(n, table_factor, n_buckets, bucket_width, stash_size,
                       device=keys.device)
    cur = _where_i32(member, VALID, FREE)
    zero = torch.zeros_like(keys)
    state = state._replace(
        keys=torch.where(member, keys, zero),
        values=torch.where(member, values, zero),
        cur=cur, flushed=cur,
        size=_count(member),
    )
    if stamp is not None:
        # Recovery never writes NVM: the stamp plane survives verbatim, and
        # the next generation starts strictly above every durable stamp.
        state = state._replace(
            stamp=stamp, epoch=stamp.max().clamp(min=0) + 1)
    if build_table:
        table, ovf = table_build(state.table, state.keys, member, max_probe)
        state = state._replace(table=table, overflow=state.overflow | ovf)
    if index_init is not None:
        state = index_init(state)
    return state


def recover(persisted: torch.Tensor, keys: torch.Tensor, values: torch.Tensor,
            stamp: Optional[torch.Tensor] = None,
            table_factor: int = 4) -> SetState:
    """Rebuild a fresh set from the durable areas (Sections 3.5 / 4.6) on
    their device: persisted == VALID -> member; everything else -> free
    list.  No psync is ever issued: payloads are already durable."""
    return _rebuild_from_member(persisted == VALID, keys, values,
                                table_factor, stamp=stamp)


def crash_and_recover(state: SetState, u: torch.Tensor,
                      table_factor: int = 4) -> SetState:
    return recover(*crash(state, u), table_factor=table_factor)
