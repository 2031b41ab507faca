"""Router v2: device-local two-stage routing with adaptive lane budgets.

PyTorch port of ``repro.core.router``.  The single-stage router
(``shard.route``) computes the full (S, L) lane grid globally; router v2
splits the work in two stages:

  stage 1 (host)   numpy, before anything reaches the device: the mixed
                   batch is split into D per-group sub-batches by the top
                   ``log2(D)`` bits of the shard id (itself the top
                   ``log2(S)`` bits of ``hash32``).  The same pass measures
                   the realized per-shard occupancy histogram.
  stage 2 (device) the sort/segment router, per group, over the group's
                   ``S/D`` local shards, with an ADAPTIVE lane budget:
                   L = the smallest power of two covering the realized max
                   shard occupancy (clamped to ``[min_lane_budget,
                   max_lane_budget or B]``).  A skewed batch widens L
                   instead of dropping lanes; drops happen ONLY when the
                   operator caps the budget (``max_lane_budget``).

Placement (``ShardSpec.placement``) decides which global shards a group
owns when S >> D -- "contiguous" (group d owns shard block
[d*S/D, (d+1)*S/D): storage row == global shard id) or "strided" (group d
owns {d, d+D, d+2D, ...}).  Placement only permutes the storage order of
the stacked state's leading axis; per-shard semantics, psync accounting
and recovery are row-local and unaffected.

Conformance: on any drop-free trace, for any D, any placement and any
adaptive budget, router v2 executes exactly the same lanes in exactly the
same per-shard order as the v1 router, so results, state and psync
counters are bit-identical.  Under budget pressure the drop sets differ by
design: v1's static budget sheds skew that uncapped v2 widens L to absorb.

On one device the D groups are logical: each group's shards run one after
another (``repro_torch.core.shard.run_shards``), where the JAX package
vmaps them.  Under ``use_shard_map`` in a ``torch.distributed`` group of
several ranks (one process per GPU, :mod:`repro_torch.launch.mesh`), the D
groups are the ranks, as the JAX package partitions them over a device
mesh with ``shard_map``: each rank holds its group's S/D rows, runs its own
sub-batch on them, and :meth:`InFlight.force` all-gathers every rank's
per-lane results on the host.  Stage 1 runs on every rank on the whole
batch, so no lane and no state crosses between ranks.  The sub-batches
cross to the device once per batch, and :meth:`InFlight.force` brings the
results back to the host in one copy; the pipelined facade defers that
force.  Every routing artifact is volatile, so deferring the gather-back
changes no durability obligation.

This module does not import :mod:`repro_torch.core.shard` at import time
(shard.py imports it); ``sspec`` arguments are duck-typed ``ShardSpec``
instances.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core import engine as E
from repro_torch.core.drop import set_drop
from repro_torch.core.engine import OP_CONTAINS, OP_NOP
from repro_torch.core.nvm import hash32, np_hash32

PLACEMENTS = ("contiguous", "strided")

_I32 = torch.int32

NEEDS_RANKS = (
    "use_shard_map with {n} visible CUDA devices needs one process per GPU: "
    "start them with torchrun (torchrun --nproc_per_node={n} ...) or "
    "torch.distributed.init_process_group (repro_torch.launch.mesh.spawn "
    "does it on one host) and build the map in every rank; without "
    "use_shard_map the map stays on one device")


# ---------------------------------------------------------------------------
# Placement: global shard id <-> storage row of the stacked state's dim0.
# ---------------------------------------------------------------------------


def mesh_devices(sspec) -> int:
    """Ranks the shard axis can split over: the largest power-of-two
    divisor of n_shards that the initialized process group has ranks for
    (1 == one device: the shards run one after another).  Several visible
    CUDA devices and no process group raise: one process would hide the
    other devices."""
    if not sspec.use_shard_map:
        return 1
    # lazy core -> launch import, only on the opt-in multi-device path
    from repro_torch.launch.mesh import world_size
    avail = world_size()
    if avail == 0:
        n = torch.cuda.device_count()
        if n > 1:
            raise RuntimeError(NEEDS_RANKS.format(n=n))
    d = sspec.n_shards
    while d > 1 and d > avail:
        d //= 2
    return d


def mesh_groups(sspec) -> int:
    """D when the shards are partitioned over the process group's ranks --
    ``use_shard_map`` and the stage-1 group count equal to the mesh size
    (the JAX package's ``_use_mesh``) -- else 1: every rank then runs the
    one-device path on the whole state, as JAX runs plain vmap."""
    d = mesh_devices(sspec)
    return d if d > 1 and resolve_groups(sspec) == d else 1


def shard_mesh(sspec):
    """The :class:`~repro_torch.launch.mesh.ShardMesh` the map's rows are
    partitioned over, or None on the one-device path."""
    if mesh_groups(sspec) == 1:
        return None
    from repro_torch.launch.mesh import current_mesh
    return current_mesh()


def local_rows(sspec) -> range:
    """The storage rows this process holds: all S on the one-device path,
    the rank's block of S/D on a mesh (none on a rank past D)."""
    mesh = shard_mesh(sspec)
    if mesh is None:
        return range(sspec.n_shards)
    return mesh.rows(sspec.n_shards, mesh_groups(sspec))


def group_mesh(sspec):
    """The :class:`~repro_torch.launch.mesh.ShardMesh` of the process group
    a ``use_shard_map`` map lives in, whether or not its rows are
    partitioned (a resize or a reload can change that), or None without a
    group of several ranks."""
    if not sspec.use_shard_map:
        return None
    from repro_torch.launch.mesh import current_mesh, world_size
    return current_mesh() if world_size() > 1 else None


def resolve_groups(sspec) -> int:
    """Stage-1 group count D: an explicit ``n_device_groups`` override, or
    the mesh size (1 unless ``use_shard_map`` on a multi-device process).
    Always a power of two dividing ``n_shards``."""
    g = sspec.n_device_groups or mesh_devices(sspec)
    return min(g, sspec.n_shards)


def np_storage_rows(sspec, n_groups: int) -> np.ndarray:
    """Storage row per GLOBAL shard id, i32[S] (identity for contiguous)."""
    s = sspec.n_shards
    sid = np.arange(s, dtype=np.int32)
    if sspec.placement == "contiguous" or n_groups <= 1:
        return sid
    per = s // n_groups
    return (sid % n_groups) * per + sid // n_groups


def _np_row_of(keys: np.ndarray, sspec, n_groups: int) -> np.ndarray:
    """Storage row per key (host twin of the stage-2 math)."""
    s = sspec.n_shards
    if s == 1:
        return np.zeros(keys.shape, np.int32)
    sbits = s.bit_length() - 1
    sid = (np_hash32(keys) >> np.uint32(32 - sbits)).astype(np.int32)
    if sspec.placement == "contiguous" or n_groups <= 1:
        return sid
    per = s // n_groups
    return (sid % n_groups) * per + sid // n_groups


def _pow2_at_least(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def adaptive_lane_budget(sspec, batch: int, max_occ: int) -> int:
    """Stage-2 lane budget: the smallest power of two >= the REALIZED max
    per-shard occupancy, clamped to [min_lane_budget, max_lane_budget or
    B].  The ``max_lane_budget`` cap is the only source of drops."""
    if sspec.n_shards == 1:
        return max(int(batch), 1)
    lane = max(_pow2_at_least(max_occ), min(sspec.min_lane_budget, batch))
    if sspec.max_lane_budget:
        lane = min(lane, sspec.max_lane_budget)
    return max(1, min(lane, batch))


def budget_candidates(sspec, batch: int) -> Tuple[int, ...]:
    """Every value :func:`adaptive_lane_budget` can return for a B-lane
    batch, found by sweeping the pow2 occupancy steps."""
    batch = max(int(batch), 1)
    if sspec.n_shards == 1:
        return (batch,)
    return tuple(sorted({adaptive_lane_budget(sspec, batch, 1 << i)
                         for i in range(batch.bit_length() + 1)}))


# ---------------------------------------------------------------------------
# Host routing scratch: pooled per-(D, Bd, B) numpy buffers, recycled once
# the batch that used them has been forced, so steady-state routing
# allocates no grid.
# ---------------------------------------------------------------------------


class _Scratch:
    """One reusable stage-1 buffer set for a (D, Bd, B) geometry."""
    __slots__ = ("key", "d_ops", "d_keys", "d_vals", "slot")

    def __init__(self, key):
        d, bd, b = key
        self.key = key
        self.d_ops = np.empty((d, bd), np.int32)
        self.d_keys = np.empty((d, bd), np.int32)
        self.d_vals = np.empty((d, bd), np.int32)
        self.slot = np.empty((b,), np.int64)


class _ScratchPool:
    """Free-list of :class:`_Scratch` sets keyed by geometry.
    ``grid_allocs`` counts real buffer allocations; at a steady-state
    geometry it stays flat."""

    def __init__(self):
        self._free = {}
        self.grid_allocs = 0
        self.acquires = 0
        self.releases = 0

    def acquire(self, d: int, bd: int, b: int) -> _Scratch:
        key = (d, bd, b)
        self.acquires += 1
        free = self._free.get(key)
        if free:
            return free.pop()
        self.grid_allocs += 1
        return _Scratch(key)

    def release(self, scratch) -> None:
        if scratch is not None:
            self.releases += 1
            self._free.setdefault(scratch.key, []).append(scratch)

    def stats(self) -> dict:
        return {"grid_allocs": self.grid_allocs, "acquires": self.acquires,
                "releases": self.releases,
                "free": sum(len(v) for v in self._free.values())}


_POOL = _ScratchPool()

_ARANGE_CACHE: dict = {}


def _cached_arange(n: int) -> np.ndarray:
    """Read-only ``arange(n, dtype=int64)`` shared across fast-path plans."""
    a = _ARANGE_CACHE.get(n)
    if a is None:
        a = np.arange(n, dtype=np.int64)
        a.setflags(write=False)
        _ARANGE_CACHE[n] = a
    return a


def scratch_stats() -> dict:
    """Pool counters for the allocation-regression test."""
    return _POOL.stats()


def release_plan(plan: "RoutePlan") -> None:
    """Return a plan's scratch set to the pool (callers must not release
    the same plan twice)."""
    _POOL.release(plan.scratch)


# ---------------------------------------------------------------------------
# Stage 1: host-side group split (numpy).
# ---------------------------------------------------------------------------


class RoutePlan(NamedTuple):
    """Stage-1 output: per-group sub-batches + the metadata to invert them.

    d_ops/d_keys/d_vals  (D, Bd) np.int32 sub-batches in group order,
                         padded with OP_NOP / key 0 (exact no-ops)
    slot                 i64[B]: flat index into the (D, Bd) plane per
                         original lane (-1 for OP_NOP input lanes, which
                         are not transported)
    groups               D
    lane_budget          adaptive stage-2 budget L
    max_occ              realized max per-shard occupancy (real lanes)
    occupancy            i64[S] realized occupancy per storage row
    scratch              pooled buffer set backing the grids and the slot
                         map (None when the plan owns its arrays)
    """
    d_ops: np.ndarray
    d_keys: np.ndarray
    d_vals: np.ndarray
    slot: np.ndarray
    groups: int
    lane_budget: int
    max_occ: int
    occupancy: np.ndarray
    scratch: object = None


def host_route(sspec, ops: np.ndarray, keys: np.ndarray,
               values: np.ndarray) -> RoutePlan:
    """Stage 1: split a B-lane mixed batch into D per-group sub-batches by
    shard-id high bits (storage-row block), measuring per-shard occupancy
    along the way.  Lane order is preserved inside every sub-batch;
    ``OP_NOP`` input lanes are not transported at all."""
    ops = np.asarray(ops, np.int32)
    keys = np.asarray(keys, np.int32)
    values = np.asarray(values, np.int32)
    b = int(keys.shape[0])
    s = sspec.n_shards
    d = resolve_groups(sspec)
    per = s // d

    row = _np_row_of(keys, sspec, d)
    real = ops != OP_NOP
    occupancy = np.bincount(row[real], minlength=s)
    max_occ = int(occupancy.max()) if b else 0
    lane_budget = adaptive_lane_budget(sspec, max(b, 1), max_occ)

    if d == 1 and b and real.all():
        # one group, no caller padding: the sub-batch IS the batch, padded
        # to the pow2 Bd bucket
        bd = _pow2_at_least(b)
        sc = _POOL.acquire(1, bd, b)
        sc.d_ops[0, :b] = ops
        sc.d_ops[0, b:] = OP_NOP
        sc.d_keys[0, :b] = keys
        sc.d_keys[0, b:] = 0
        sc.d_vals[0, :b] = values
        sc.d_vals[0, b:] = 0
        return RoutePlan(sc.d_ops, sc.d_keys, sc.d_vals, _cached_arange(b),
                         1, lane_budget, max_occ, occupancy, sc)

    gid = row // per
    counts = np.bincount(gid[real], minlength=d)
    bd = _pow2_at_least(max(int(counts.max()) if b else 0, 1))

    sc = _POOL.acquire(d, bd, b)
    d_ops, d_keys, d_vals, slot = sc.d_ops, sc.d_keys, sc.d_vals, sc.slot
    d_ops.fill(OP_NOP)
    d_keys.fill(0)
    d_vals.fill(0)
    slot.fill(-1)
    if b:
        # stable group-major order; rank within group = sub-batch position
        lanes = np.flatnonzero(real)
        order = lanes[np.argsort(gid[lanes], kind="stable")]
        g_sorted = gid[order]
        seg0 = np.searchsorted(g_sorted, np.arange(d))
        rank = np.arange(order.size) - seg0[g_sorted]
        d_ops[g_sorted, rank] = ops[order]
        d_keys[g_sorted, rank] = keys[order]
        d_vals[g_sorted, rank] = values[order]
        slot[order] = g_sorted.astype(np.int64) * bd + rank
    return RoutePlan(d_ops, d_keys, d_vals, slot, d, lane_budget, max_occ,
                     occupancy, sc)


def host_gather(grid, slot: np.ndarray, fill) -> np.ndarray:
    """Invert stage 1 for per-lane results: (D, Bd) -> [B], ``fill`` for
    lanes that were never transported (OP_NOP input padding)."""
    flat = np.asarray(grid).reshape(-1)
    if flat.size == 0:
        return np.full(slot.shape, fill, dtype=np.asarray(fill).dtype)
    got = flat[np.clip(slot, 0, flat.size - 1)]
    return np.where(slot >= 0, got, fill)


# ---------------------------------------------------------------------------
# Stage 2: per-group sort/segment router over the group's local shards, on
# the device.
# ---------------------------------------------------------------------------


def _local_row(keys: torch.Tensor, sspec, n_groups: int) -> torch.Tensor:
    """Local shard row (within the group's block) per key, from hash32
    bits alone: stage 1 already put the lane in this group."""
    s = sspec.n_shards
    per = s // n_groups
    if per == 1:
        return torch.zeros(keys.shape, dtype=_I32, device=keys.device)
    sbits = s.bit_length() - 1
    # hash32 is the uint32 widened to int64: shift, then narrow
    sid = (hash32(keys) >> (32 - sbits)).to(_I32)
    if sspec.placement == "contiguous" or n_groups <= 1:
        return sid & (per - 1)             # low log2(S/D) bits of sid
    return sid >> (n_groups.bit_length() - 1)   # strided: row = sid // D


def segment_route(sid: torch.Tensor, n_rows: int, lane: int):
    """The stable sort/segment scheme both routers share: lanes sorted by
    row id (``sid`` in [0, n_rows]), each lane's rank within its row, and
    its flat (row, rank) slot in an (n_rows, lane) grid, ``n_rows * lane``
    where the rank is past the budget.  Returns (order, sorted ids, keep,
    flat)."""
    b = sid.shape[0]
    dev = sid.device
    order = torch.argsort(sid, stable=True)
    ssort = sid[order]
    idx = torch.arange(b, dtype=_I32, device=dev)
    seg0 = torch.full((n_rows + 1,), b, dtype=_I32, device=dev).scatter_reduce(
        0, ssort.long(), idx, "amin", include_self=True)
    pos = idx - seg0[ssort.long()]
    keep = (pos < lane) & (ssort < n_rows)
    flat = torch.where(keep, ssort * lane + pos, n_rows * lane)
    return order, ssort, keep, flat


def grid_scatter(x: torch.Tensor, order: torch.Tensor, flat: torch.Tensor,
                 n_rows: int, lane: int, fill: int) -> torch.Tensor:
    """``jnp.full((R * L,), fill).at[flat].set(x[order], mode="drop")``
    reshaped to (R, L)."""
    base = torch.full((n_rows * lane,), fill, dtype=_I32, device=x.device)
    return set_drop(base, flat.long(), x[order]).reshape(n_rows, lane)


def slot_of(order: torch.Tensor, keep: torch.Tensor,
            flat: torch.Tensor) -> torch.Tensor:
    """Flat grid slot per ORIGINAL lane, -1 where dropped: ``order`` is a
    permutation, so one scatter writes every lane."""
    vals = torch.where(keep, flat, -1).to(_I32)
    return torch.empty_like(vals).scatter_(0, order, vals)


def route_local(ops: torch.Tensor, keys: torch.Tensor, values: torch.Tensor,
                *, sspec, n_groups: int, lane_budget: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor, torch.Tensor]:
    """Stage 2: one group's (Bd,) sub-batch -> its (S/D, L) local lane
    grid.  OP_NOP padding lanes are parked on the virtual row ``S/D`` so
    they never consume budget.  Returns ``(r_ops, r_keys, r_vals, slot,
    dropped)`` with ``slot[i] == -1`` for dropped/padding lanes;
    ``dropped`` counts REAL lanes past the budget (only possible under a
    ``max_lane_budget`` cap)."""
    per = sspec.n_shards // n_groups
    lane = lane_budget
    local = _local_row(keys, sspec, n_groups)
    local = torch.where(ops == OP_NOP, per, local)        # park padding
    order, _, keep, flat = segment_route(local, per, lane)
    r_ops = grid_scatter(ops, order, flat, per, lane, OP_NOP)
    r_keys = grid_scatter(keys, order, flat, per, lane, 0)
    r_vals = grid_scatter(values, order, flat, per, lane, 0)
    slot = slot_of(order, keep, flat)
    dropped = (~keep & (ops[order] != OP_NOP)).sum().to(_I32)
    return r_ops, r_keys, r_vals, slot, dropped


def _grid_gather(grid: torch.Tensor, slot: torch.Tensor, fill
                 ) -> torch.Tensor:
    """Inverse of :func:`route_local` for per-lane results."""
    flat = grid.reshape(-1)
    got = flat[slot.clamp(0, flat.shape[0] - 1).long()]
    return torch.where(slot >= 0, got, fill)


# ---------------------------------------------------------------------------
# Dispatch: per group, stage 2 then the group's shards one after another
# (the JAX package's vmap over the group axis and over its shards), or,
# on a mesh, this rank's group only (its shard_map block).
# ---------------------------------------------------------------------------


def _group_dispatch(group_fn, state, lanes, *, sspec, groups: int):
    """Run ``group_fn(state, rows, *lane_rows)`` once per group, in group
    order, where ``rows`` are the storage rows of the group's shards (the
    JAX package's reshape of the state to (D, S/D, ...)); stack the
    per-group outputs on a new leading axis.  Returns ``(state, outputs)``.

    On a mesh of D == ``groups`` ranks (``shard_map``) the rank runs only
    its own group, on its local rows 0..S/D-1, and its outputs keep a
    leading axis of 1; a rank past D runs nothing and its outputs are
    None.  :meth:`InFlight.force` gathers the ranks' rows."""
    per = sspec.n_shards // groups
    mesh = shard_mesh(sspec)              # then groups == D
    if mesh is not None:
        from repro_torch.launch.mesh import shard_map
        out = shard_map(lambda *x: group_fn(state, range(per), *x), mesh,
                        groups, *lanes)
        return state, (None if out is None else
                       tuple(o.unsqueeze(0) for o in out))
    outs = [group_fn(state, range(g * per, (g + 1) * per),
                     *(x[g] for x in lanes)) for g in range(groups)]
    return state, tuple(torch.stack(o) for o in zip(*outs))


def _apply_v2(state, d_ops: torch.Tensor, d_keys: torch.Tensor,
              d_vals: torch.Tensor, *, sspec, groups: int, lane_budget: int):
    """Group-local mixed-op dispatch: per group, stage-2 route the (Bd,)
    sub-batch into the (S/D, L) local grid and run ``apply_batch_impl`` on
    each local shard.  Returns (stacked state, ((D, Bd) results, (D,)
    per-group dropped counts, (D, Bd) per-lane kept mask -- False exactly
    for the real lanes stage 2 dropped past a ``max_lane_budget`` cap)),
    the outputs as :func:`_group_dispatch` gives them.  The state's
    tensors are updated in place."""
    from repro_torch.core.shard import run_shards
    spec = sspec.shard_spec()

    def body(st, o, k, v):
        return E.apply_batch_impl(st, o, k, v, spec=spec)

    def group_fn(st, rows, o, k, v):
        r_ops, r_keys, r_vals, slot, dropped = route_local(
            o, k, v, sspec=sspec, n_groups=groups, lane_budget=lane_budget)
        outs = run_shards(st, body, rows, r_ops, r_keys, r_vals)
        r_res = torch.stack([x[0] for x in outs])
        kept = (slot >= 0) | (o == OP_NOP)
        return _grid_gather(r_res, slot, False), dropped, kept

    return _group_dispatch(group_fn, state, (d_ops, d_keys, d_vals),
                           sspec=sspec, groups=groups)


def _get_v2(state, d_keys: torch.Tensor, d_active: torch.Tensor, *, sspec,
            groups: int, lane_budget: int, default: int = 0):
    """Group-local value lookup; same routing as :func:`_apply_v2`.  The
    outputs are ((D, Bd) values, (D, Bd) present, (D,) dropped, (D, Bd)
    kept)."""
    from repro_torch.core.shard import run_shards
    spec = sspec.shard_spec()

    def body(st, k, a):
        return E.get_impl(st, k, spec=spec, default=default, active=a)

    def group_fn(st, rows, k, act):
        ops = torch.where(act, OP_CONTAINS, OP_NOP).to(_I32)
        r_ops, r_keys, _, slot, dropped = route_local(
            ops, k, k, sspec=sspec, n_groups=groups,
            lane_budget=lane_budget)
        outs = run_shards(st, body, rows, r_keys, r_ops == OP_CONTAINS)
        r_vals = torch.stack([x[0] for x in outs])
        r_pres = torch.stack([x[1] for x in outs])
        vals = _grid_gather(r_vals, slot, default).to(_I32)
        pres = _grid_gather(r_pres, slot, False)
        kept = (slot >= 0) | ~act
        return vals, pres, dropped, kept

    return _group_dispatch(group_fn, state, (d_keys, d_active),
                           sspec=sspec, groups=groups)


# ---------------------------------------------------------------------------
# Host entry points (stage 1 + stage 2/dispatch + host gather-back).
# ---------------------------------------------------------------------------


class InFlight:
    """A dispatched-but-unforced v2 batch.

    Holds the device tensors of the stage-2 dispatch plus the stage-1
    :class:`RoutePlan` needed to invert them.  ``force()`` copies them to
    the host in one transfer (on a mesh, then all-gathers every rank's
    rows: a collective), returns the per-lane numpy results, and recycles
    the plan's scratch set.  ``kind`` is "apply" (``force() -> (results
    bool[B], dropped, drop_mask bool[B])``) or "get" (``force() -> (values
    i32[B], present bool[B], dropped, drop_mask bool[B])``).
    ``drop_mask[i]`` is True exactly when real lane i was shed past a
    ``max_lane_budget`` cap -- its result is NOT a successful no-op.
    """
    __slots__ = ("kind", "plan", "outs", "default", "mesh", "_forced")

    def __init__(self, kind: str, plan: RoutePlan, outs, default: int = 0,
                 mesh=None):
        self.kind = kind
        self.plan = plan
        self.outs = outs          # device tensors (None: nothing ran here)
        self.default = default
        self.mesh = mesh          # ShardMesh of a partitioned map, or None
        self._forced = None

    def _host_outs(self) -> list:
        """The (D, ...) host arrays of the outputs."""
        if self.mesh is None:
            return _to_host(*self.outs)
        bd = self.plan.d_ops.shape[1]
        shapes = ([(bd,), (), (bd,)] if self.kind == "apply" else
                  [(bd,), (bd,), (), (bd,)])
        local = None if self.outs is None else _to_host(*self.outs)
        return self.mesh.gather(local, shapes, self.plan.groups)

    def force(self):
        if self._forced is None:
            plan = self.plan
            empty = plan.slot.size == 0
            if self.kind == "apply":
                if empty:
                    self._forced = (np.zeros((0,), bool), 0,
                                    np.zeros((0,), bool))
                else:
                    res, dropped, kept = self._host_outs()
                    self._forced = (host_gather(res.astype(bool), plan.slot,
                                                False),
                                    int(dropped.sum()),
                                    ~host_gather(kept.astype(bool),
                                                 plan.slot, True))
            else:
                if empty:
                    self._forced = (np.zeros((0,), np.int32),
                                    np.zeros((0,), bool), 0,
                                    np.zeros((0,), bool))
                else:
                    vals, pres, dropped, kept = self._host_outs()
                    self._forced = (
                        host_gather(vals, plan.slot, np.int32(self.default)),
                        host_gather(pres.astype(bool), plan.slot, False),
                        int(dropped.sum()),
                        ~host_gather(kept.astype(bool), plan.slot, True))
            self.outs = None
            _POOL.release(plan.scratch)
        return self._forced


def _to_host(*ts):
    """int32 host copies of device tensors, in ONE device-to-host copy."""
    flat = torch.cat([t.reshape(-1).to(_I32) for t in ts]).cpu().numpy()
    out, at = [], 0
    for t in ts:
        out.append(flat[at:at + t.numel()].reshape(tuple(t.shape)))
        at += t.numel()
    return out


def _lanes_to(device, *planes) -> torch.Tensor:
    """The stage-1 planes on ``device`` in ONE host-to-device copy.  The
    stacked copy owns its memory, so the pooled scratch may be recycled."""
    return torch.from_numpy(np.stack(planes)).to(device)


def dispatch_plan(state, plan: RoutePlan, *, sspec, kind: str = "apply",
                  default: int = 0):
    """Dispatch the stage-2 work for a stage-1 plan without reading its
    results back.  Returns ``(state, InFlight)``; an empty plan is a no-op
    whose scratch is recycled immediately.  On a mesh each rank runs its
    own sub-batch row, and the InFlight's force gathers the ranks'
    results."""
    if plan.slot.size == 0:
        _POOL.release(plan.scratch)
        return state, InFlight(kind, plan._replace(scratch=None), None,
                               default)
    dev = state.keys.device
    mesh = shard_mesh(sspec)
    if kind == "apply":
        lanes = _lanes_to(dev, plan.d_ops, plan.d_keys, plan.d_vals)
        state, outs = _apply_v2(
            state, lanes[0], lanes[1], lanes[2], sspec=sspec,
            groups=plan.groups, lane_budget=plan.lane_budget)
        return state, InFlight(kind, plan, outs, mesh=mesh)
    lanes = _lanes_to(dev, plan.d_ops, plan.d_keys)
    state, outs = _get_v2(
        state, lanes[1], lanes[0] == OP_CONTAINS, sspec=sspec,
        groups=plan.groups, lane_budget=plan.lane_budget, default=default)
    return state, InFlight(kind, plan, outs, default, mesh=mesh)


def apply_batch_v2_async(state, ops, keys, values, *, sspec):
    """Two-stage routed mixed-op batch WITHOUT the read-back: stage 1
    routes on the host, stage 2 is dispatched, and the gather-back is
    deferred to ``InFlight.force()``.  Returns ``(state, InFlight)``."""
    plan = host_route(sspec, ops, keys, values)
    return dispatch_plan(state, plan, sspec=sspec, kind="apply")


def get_v2_async(state, keys, *, sspec, default: int = 0):
    """Deferred two-stage value lookup; see :func:`apply_batch_v2_async`."""
    keys = np.asarray(keys, np.int32)
    ops = np.full(keys.shape, OP_CONTAINS, np.int32)
    plan = host_route(sspec, ops, keys, keys)
    return dispatch_plan(state, plan, sspec=sspec, kind="get",
                         default=default)


def apply_batch_v2(state, ops, keys, values, *, sspec):
    """Two-stage routed mixed-op batch.  Returns ``(state, results
    bool[B] (numpy), dropped int, drop_mask bool[B], plan RoutePlan)``."""
    state, fl = apply_batch_v2_async(state, ops, keys, values, sspec=sspec)
    out, dropped, drop_mask = fl.force()
    return state, out, dropped, drop_mask, fl.plan


def get_v2(state, keys, *, sspec, default: int = 0):
    """Two-stage routed value lookup.  Returns ``(state, values i32[B],
    present bool[B], dropped int, drop_mask bool[B], plan)``."""
    state, fl = get_v2_async(state, keys, sspec=sspec, default=default)
    out_v, out_p, dropped, drop_mask = fl.force()
    return state, out_v, out_p, dropped, drop_mask, fl.plan


def precompile(state, batch: int, *, sspec, partial=None):
    """The JAX package traces and compiles the stage-2 program here (under
    ``shard_map`` on a mesh) for every budget the adaptive chooser can
    select for a B-lane batch; eager PyTorch has nothing to compile, on
    one device or on a mesh, and no rank waits for another.  Returns
    ``(state, budgets)`` with the same budget tuple and the state
    untouched.  ``partial`` is accepted for the JAX signature and has no
    effect."""
    return state, budget_candidates(sspec, max(int(batch), 1))
