"""Sharded DurableMap: hash-partitioned shard runtime on one GPU, or on
one process per GPU under ``use_shard_map``.

PyTorch port of ``repro.core.shard``.  S *independent* durable sets, each
with its own node pool and volatile index, multiply capacity while keeping
the per-partition psync story (SOFT stays at 1 psync per update per shard,
so the global bound is unchanged).  Crash and recovery compose the same
way: each shard's volatile index is rebuilt from its own pool.

Layout:

  partitioning  shard id = the HIGH ``log2(S)`` bits of ``hash32(key)``.
                The in-shard structures consume the LOW bits (bucket index,
                probe table), so shard routing is independent of in-shard
                placement.
  state         one stacked :class:`SetState` with a leading shard axis:
                every leaf of the per-shard state gains dim0 == S, each
                shard in its own memory.
  routing       router="v2" (default): the two-stage router of
                :mod:`repro_torch.core.router` -- stage 1 splits the batch
                into per-group sub-batches on the host, stage 2 sort/
                segment-routes each group's lanes into its (S/D, L) local
                grid with an ADAPTIVE lane budget; drops happen only under
                an explicit ``max_lane_budget`` cap.  router="v1" keeps the
                single-stage :func:`route`: the global (S, L) grid with the
                static L ~ lane_factor*B/S budget, dropping a shard's
                excess lanes past L (result False, counted, warned once).
  placement     ``ShardSpec.placement`` selects which shards share a group:
                "contiguous" blocks or "strided" interleaving -- a pure
                storage-row permutation.
  execution     the JAX package runs every shard in ONE vmapped dispatch.
                Here :func:`run_shards` runs the single-shard bodies of
                :mod:`repro_torch.core.engine` once per shard, in shard
                order, on the views ``leaf[s]``: each shard computes what
                an independent body on that shard computes, which is what
                vmap gives.  The kernels therefore launch once per shard
                per batch (``hash_probe`` or ``table_probe`` on lookups,
                ``recovery_scan`` on recovery).  One dispatch over the
                shard axis is ROADMAP queue A, item 7c.
  mesh          under ``use_shard_map`` in a ``torch.distributed`` group of
                several ranks (:mod:`repro_torch.launch.mesh`), the D
                ranks stand in for the JAX package's ``shard_map`` mesh:
                rank r holds storage rows ``r*S/D .. (r+1)*S/D - 1`` of
                every leaf on its own device and runs only those rows'
                bodies.  Every rank calls the facade with the same batches
                and gets the same results; only host-side lane results and
                counters cross between ranks (a ``gloo`` all-gather), never
                state.  The facade's counters (``psyncs``, ``ops``,
                ``len``, ``overflowed``) are collectives there: read them
                on every rank.
  recovery      ``crash_and_recover`` draws an independent adversary ``u``
                per shard and rebuilds every volatile index.

:class:`ShardedDurableMap` mirrors the :class:`DurableMap` API (insert /
remove / contains / get / apply / crash_and_recover / psyncs / ops / len /
overflowed); its results come back as host numpy arrays.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import durable_set as DS
from repro_torch.core import engine as E
from repro_torch.core import router as RT
from repro_torch.core.device import resolve_device
from repro_torch.core.durable_set import SetState
from repro_torch.core.engine import (MetricsMixin, OP_CONTAINS, OP_INSERT,
                                     OP_NOP, OP_REMOVE, SetSpec)
from repro_torch.core.nvm import hash32, np_hash32

_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """Frozen configuration of a sharded durable map.

    base            per-map :class:`SetSpec`; ``base.capacity`` is the
                    TOTAL capacity, split evenly across shards (every other
                    knob -- mode, backend, geometry -- applies per shard)
    n_shards        shard count S (power of two: routing takes the high
                    ``log2(S)`` bits of ``hash32``)
    router          "v2" (default): the two-stage router with adaptive lane
                    budgets; "v1": the single-stage global sort/segment
                    router with the static ``lane_factor`` budget
    placement       shard->group storage order when S >> D: "contiguous"
                    (group d owns the shard-id block, storage row == global
                    shard id) or "strided" (group d owns shards {d, d+D,
                    d+2D, ...})
    lane_factor     v1 only: head-room multiplier sizing the per-shard
                    lane budget L(B) = next_pow2(lane_factor * ceil(B/S))
    min_lane_budget lower clamp on L; batches of B <= min_lane_budget get
                    L == B, i.e. routing can never drop a lane
    max_lane_budget v2 only: upper cap on the adaptive budget (0 = uncapped,
                    the default -- the adaptive router then NEVER drops).
                    With a cap, a shard receiving more lanes drops the
                    excess (counted + warned, like v1 past its budget)
    n_device_groups v2 only: explicit stage-1 group count D (0 = auto: the
                    mesh size under ``use_shard_map``, else 1).  On one
                    device the groups are logical: they change the route,
                    not the device; on a mesh a count other than the mesh
                    size keeps every rank on the one-device path over the
                    whole state, as JAX keeps plain vmap
    pipeline_depth  v2 only: depth of the dispatch pipeline through
                    :class:`ShardedDurableMap` (1 = synchronous).  At depth
                    k the facade keeps the newest batch STAGED host-side
                    (stage-1 routed, not yet dispatched) and up to k-1
                    dispatched batches un-forced, on the one default
                    stream.  Results, state and psync counters equal depth
                    1; a crash abandons only the staged batch
    use_shard_map   partition the shards over the ranks of the initialized
                    ``torch.distributed`` group, one process per GPU (D =
                    the largest power of two dividing S that the world has
                    ranks for).  One rank, or no group, stays on the
                    one-device path, as the JAX package stays on plain
                    vmap; several visible CUDA devices and no group raise
                    ``RuntimeError``
    """
    base: SetSpec
    n_shards: int = 8
    router: str = "v2"
    placement: str = "contiguous"
    lane_factor: int = 2
    min_lane_budget: int = 32
    max_lane_budget: int = 0
    n_device_groups: int = 0
    pipeline_depth: int = 1
    use_shard_map: bool = False

    def __post_init__(self):
        s = self.n_shards
        if s < 1 or (s & (s - 1)) != 0:
            raise ValueError(f"n_shards must be a power of two, got {s}")
        if self.router not in ("v1", "v2"):
            raise ValueError(f"router must be 'v1' or 'v2', got "
                             f"{self.router!r}")
        if self.placement not in RT.PLACEMENTS:
            raise ValueError(f"placement must be one of {RT.PLACEMENTS}, "
                             f"got {self.placement!r}")
        if self.lane_factor < 1:
            raise ValueError("lane_factor must be >= 1")
        if self.min_lane_budget < 1:
            raise ValueError("min_lane_budget must be >= 1")
        if self.max_lane_budget < 0:
            raise ValueError("max_lane_budget must be >= 0 (0 = uncapped)")
        g = self.n_device_groups
        if g < 0 or (g & (g - 1)) != 0:
            raise ValueError("n_device_groups must be 0 (auto) or a power "
                             f"of two, got {g}")
        if g > s:
            raise ValueError(f"n_device_groups ({g}) cannot exceed "
                             f"n_shards ({s})")
        if self.pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1, got "
                             f"{self.pipeline_depth}")
        if self.base.capacity < self.n_shards:
            raise ValueError(
                f"base.capacity ({self.base.capacity}) must be >= n_shards "
                f"({self.n_shards}): every shard needs at least one slot")
        if self.router == "v1":
            # fail loudly instead of silently ignoring v2-only knobs
            for knob, neutral in (("placement", "contiguous"),
                                  ("max_lane_budget", 0),
                                  ("n_device_groups", 0),
                                  ("pipeline_depth", 1)):
                if getattr(self, knob) != neutral:
                    raise ValueError(
                        f"{knob} is a v2-only knob; the v1 router ignores "
                        f"it (got {knob}={getattr(self, knob)!r})")

    @property
    def per_shard_capacity(self) -> int:
        """Per-shard node-pool capacity.  An even split keeps the exact
        quotient; a non-divisible total rounds the ceil quotient UP to the
        next power of two (``effective_capacity`` surfaces the total)."""
        per, rem = divmod(self.base.capacity, self.n_shards)
        if rem == 0:
            return per
        return 1 << max(0, per).bit_length()

    @property
    def effective_capacity(self) -> int:
        """TOTAL capacity actually provisioned: ``per_shard_capacity *
        n_shards``."""
        return self.per_shard_capacity * self.n_shards

    def shard_spec(self) -> SetSpec:
        """The per-shard SetSpec (``capacity == per_shard_capacity``)."""
        return dataclasses.replace(self.base,
                                   capacity=self.per_shard_capacity)

    def with_n_shards(self, n_shards: int) -> "ShardSpec":
        """The same per-shard geometry at a different shard count."""
        return dataclasses.replace(
            self, n_shards=n_shards,
            base=dataclasses.replace(
                self.base, capacity=self.per_shard_capacity * n_shards))

    def split_spec(self) -> "ShardSpec":
        """Child geometry of an S -> 2S split (per-shard capacity kept)."""
        return self.with_n_shards(self.n_shards * 2)

    def merge_spec(self) -> "ShardSpec":
        """Parent geometry of a 2S -> S merge (per-shard capacity kept)."""
        if self.n_shards < 2:
            raise ValueError("cannot merge below one shard")
        return self.with_n_shards(self.n_shards // 2)

    def lane_budget(self, batch: int) -> int:
        """v1 per-shard lane slots L for a B-lane batch: small batches
        route loss-free (L == B); large ones take L ~ lane_factor * B / S."""
        if self.n_shards == 1 or batch <= self.min_lane_budget:
            return batch
        per = -(-batch // self.n_shards) * self.lane_factor
        return min(batch, 1 << max(per - 1, self.min_lane_budget - 1)
                   .bit_length())


# ---------------------------------------------------------------------------
# Partitioning + v1 router
# ---------------------------------------------------------------------------


def shard_of(keys: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Shard id per key (i32): the high log2(S) bits of hash32."""
    if n_shards == 1:
        return torch.zeros(keys.shape, dtype=_I32, device=keys.device)
    bits = n_shards.bit_length() - 1
    # hash32 is the uint32 widened to int64: shift first, then narrow
    return (hash32(keys) >> (32 - bits)).to(_I32)


def np_shard_of(keys: np.ndarray, n_shards: int) -> np.ndarray:
    """Host-side twin of :func:`shard_of`."""
    keys = np.asarray(keys)
    if n_shards == 1:
        return np.zeros(keys.shape, np.int32)
    bits = n_shards.bit_length() - 1
    return (np_hash32(keys) >> np.uint32(32 - bits)).astype(np.int32)


def route(ops: torch.Tensor, keys: torch.Tensor, values: torch.Tensor, *,
          n_shards: int, lane_budget: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                     torch.Tensor]:
    """Sort/segment router: B mixed lanes -> an (S, L) per-shard lane grid.

    Lanes are stably sorted by shard id, so per-shard lane priority equals
    global lane priority.  Each lane lands at its rank within the shard's
    segment; ranks >= L are DROPPED (reported, not executed).  Unused
    slots carry ``OP_NOP`` / key 0.  Returns ``(r_ops, r_keys, r_values,
    slot, dropped)``: the (S, L) grids, the flat grid slot per original
    lane (-1 == dropped), and the dropped-lane count."""
    s, l = n_shards, lane_budget
    sid = shard_of(keys, s)
    order, _, keep, flat = RT.segment_route(sid, s, l)
    r_ops = RT.grid_scatter(ops, order, flat, s, l, OP_NOP)
    r_keys = RT.grid_scatter(keys, order, flat, s, l, 0)
    r_vals = RT.grid_scatter(values, order, flat, s, l, 0)
    slot = RT.slot_of(order, keep, flat)
    dropped = (~keep).sum().to(_I32)
    return r_ops, r_keys, r_vals, slot, dropped


def gather(grid: torch.Tensor, slot: torch.Tensor, fill) -> torch.Tensor:
    """Inverse of :func:`route` for per-lane results: (S, L) -> [B], with
    ``fill`` for dropped lanes."""
    return RT._grid_gather(grid, slot, fill)


def np_v1_drop_mask(keys: np.ndarray, *, n_shards: int, lane_budget: int
                    ) -> np.ndarray:
    """Host twin of the v1 :func:`route` drop decision: True per lane iff
    its rank within its shard segment is past the budget (v1 routes OP_NOP
    lanes like any other)."""
    keys = np.asarray(keys, np.int32)
    b = keys.shape[0]
    sid = np_shard_of(keys, n_shards)
    order = np.argsort(sid, kind="stable")
    seg0 = np.searchsorted(sid[order], np.arange(n_shards))
    pos = np.arange(b) - seg0[sid[order]]
    mask = np.zeros((b,), bool)
    mask[order] = pos >= lane_budget
    return mask


# ---------------------------------------------------------------------------
# Stacked state + the per-shard executor
# ---------------------------------------------------------------------------


def make_state(sspec: ShardSpec, device="cuda") -> SetState:
    """Stacked fresh state on ``device``: every SetState leaf gains a
    leading shard axis (dim0 == S, or this rank's S/D rows on a mesh),
    each slice exactly ``engine.make_state(shard_spec)`` in memory of its
    own (``repeat``, never an ``expand``ed view that would share one
    shard's writes)."""
    base = E.make_state(sspec.shard_spec(), device=device)
    s = len(RT.local_rows(sspec))
    return SetState(*(x.unsqueeze(0).repeat((s,) + (1,) * x.dim())
                      for x in base))


def _write_row(state: SetState, s: int, new: SetState) -> None:
    """Write one shard's new state into row ``s`` of the stacked leaves.
    A leaf the body updated in place (the row view itself) needs no copy;
    a leaf that aliases other memory of the stacked state is cloned first,
    so no copy reads a row another copy has already overwritten."""
    storages = {leaf.untyped_storage().data_ptr() for leaf in state
                if leaf.numel()}
    todo = []
    for leaf, x in zip(state, new):
        dst = leaf[s]
        if x.numel() == 0 or (x.data_ptr() == dst.data_ptr()
                              and x.stride() == dst.stride()):
            continue
        if x.untyped_storage().data_ptr() in storages:
            x = x.clone()
        todo.append((dst, x))
    for dst, x in todo:
        dst.copy_(x)


def run_shards(state: SetState, body, rows, *args) -> list:
    """Run ``body(state_s, *args_s)`` for each storage row ``s`` of
    ``rows``, in order, where ``state_s`` holds the views ``leaf[s]`` and
    ``args_s`` the i-th entry of each argument, and write the state it
    returns back into row ``s`` of ``state`` in place.  ``body`` returns
    ``(new state, *outputs)``; the list of each shard's outputs comes
    back.  This is the JAX package's vmap over the shard axis: every
    shard computes what the single-shard body computes on it."""
    outs = []
    for i, s in enumerate(rows):
        view = SetState(*(leaf[s] for leaf in state))
        new, *extra = body(view, *(a[i] for a in args))
        _write_row(state, s, new)
        outs.append(extra)
    return outs


def _on(device, *arrays) -> list:
    """Host int32 lane vectors (numpy or tensors) on ``device``, the numpy
    ones in ONE host-to-device copy."""
    if all(isinstance(a, torch.Tensor) for a in arrays):
        return [a.to(device=device, dtype=_I32) for a in arrays]
    host = np.stack([_host_i32(a) for a in arrays])
    return list(torch.from_numpy(host).to(device))


def _host_i32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().astype(np.int32, copy=False)
    return np.asarray(x, np.int32)


def whole_rows(sspec: ShardSpec, *parts: np.ndarray) -> list:
    """Whole (S, ...) host arrays from this process's rows of each (int32
    planes): the parts themselves on the one-device path; on a mesh, one
    all-gather of every rank's rows (a collective), as ``shard_map``'s
    ``out_specs`` assembles them."""
    mesh = RT.shard_mesh(sspec)
    if mesh is None:
        return list(parts)
    d, s = RT.mesh_groups(sspec), sspec.n_shards
    tails = [p.shape[1:] for p in parts]
    got = mesh.gather(parts if parts[0].shape[0] else None,
                      [(s // d,) + t for t in tails], d)
    return [g.reshape((s,) + t).astype(p.dtype)
            for g, t, p in zip(got, tails, parts)]


def _all_rows(sspec: ShardSpec, outs: list, like: torch.Tensor,
              *fields) -> list:
    """Each output ``i`` of ``fields`` (pairs of index and dtype) as an
    (S, L) tensor on ``like``'s device: this process's shards stacked, and
    on a mesh every rank's rows (:func:`whole_rows`)."""
    if RT.shard_mesh(sspec) is None:
        return [torch.stack([x[i] for x in outs]).to(dt) for i, dt in fields]
    l = like.shape[-1]
    local = (RT._to_host(*(torch.stack([x[i] for x in outs])
                           for i, _ in fields)) if outs else
             [np.zeros((0, l), np.int32)] * len(fields))
    return [torch.from_numpy(g).to(device=like.device, dtype=dt)
            for g, (_, dt) in zip(whole_rows(sspec, *local), fields)]


def _apply_impl(state: SetState, ops: torch.Tensor, keys: torch.Tensor,
                values: torch.Tensor, *, sspec: ShardSpec
                ) -> Tuple[SetState, torch.Tensor, torch.Tensor]:
    """Route a mixed batch and run every shard.  Returns (stacked state,
    per-lane result, dropped-lane count).  On a mesh every rank routes the
    whole batch, runs its own rows and all-gathers the (S, L) results."""
    spec = sspec.shard_spec()
    l = sspec.lane_budget(keys.shape[0])
    r_ops, r_keys, r_vals, slot, dropped = route(
        ops, keys, values, n_shards=sspec.n_shards, lane_budget=l)
    rows = RT.local_rows(sspec)
    mine = slice(rows.start, rows.stop)
    outs = run_shards(
        state, lambda st, o, k, v: E.apply_batch_impl(st, o, k, v,
                                                      spec=spec),
        range(len(rows)), r_ops[mine], r_keys[mine], r_vals[mine])
    (r_res,) = _all_rows(sspec, outs, r_ops, (0, torch.bool))
    return state, gather(r_res, slot, False), dropped


def apply_batch(state: SetState, ops: torch.Tensor, keys: torch.Tensor,
                values: torch.Tensor, *, sspec: ShardSpec
                ) -> Tuple[SetState, torch.Tensor, torch.Tensor]:
    """Sharded mixed-op batch through the v1 router.  Linearization is per
    shard (phase order with lane priority); shards are disjoint key
    spaces, so any interleaving of per-shard histories is a legal global
    history.  As in the engine's functional API, callers rebind the state
    (its tensors are updated in place)."""
    return _apply_impl(state, ops, keys, values, sspec=sspec)


def insert(state: SetState, keys: torch.Tensor, values: torch.Tensor, *,
           sspec: ShardSpec) -> Tuple[SetState, torch.Tensor, torch.Tensor]:
    ops = torch.full(keys.shape, OP_INSERT, dtype=_I32, device=keys.device)
    return _apply_impl(state, ops, keys, values, sspec=sspec)


def remove(state: SetState, keys: torch.Tensor, *, sspec: ShardSpec
           ) -> Tuple[SetState, torch.Tensor, torch.Tensor]:
    ops = torch.full(keys.shape, OP_REMOVE, dtype=_I32, device=keys.device)
    return _apply_impl(state, ops, keys, keys, sspec=sspec)


def contains(state: SetState, keys: torch.Tensor, *, sspec: ShardSpec
             ) -> Tuple[SetState, torch.Tensor, torch.Tensor]:
    ops = torch.full(keys.shape, OP_CONTAINS, dtype=_I32, device=keys.device)
    return _apply_impl(state, ops, keys, keys, sspec=sspec)


def get(state: SetState, keys: torch.Tensor, *, sspec: ShardSpec,
        default: int = 0
        ) -> Tuple[SetState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sharded value lookup: (state, values-or-default, present, dropped).
    On a mesh as :func:`apply_batch`."""
    spec = sspec.shard_spec()
    l = sspec.lane_budget(keys.shape[0])
    ops = torch.full(keys.shape, OP_CONTAINS, dtype=_I32, device=keys.device)
    r_ops, r_keys, _, slot, dropped = route(
        ops, keys, keys, n_shards=sspec.n_shards, lane_budget=l)
    rows = RT.local_rows(sspec)
    mine = slice(rows.start, rows.stop)
    outs = run_shards(
        state, lambda st, k, a: E.get_impl(st, k, spec=spec,
                                           default=default, active=a),
        range(len(rows)), r_keys[mine], (r_ops == OP_CONTAINS)[mine])
    r_vals, r_pres = _all_rows(sspec, outs, r_keys, (0, _I32),
                               (1, torch.bool))
    vals = gather(r_vals, slot, default).to(_I32)
    present = gather(r_pres, slot, False)
    return state, vals, present, dropped


# ---------------------------------------------------------------------------
# Router dispatch: v2 two-stage (default) vs the v1 single stage.
# ---------------------------------------------------------------------------


def dispatch_batch(state: SetState, ops, keys, values, *, sspec: ShardSpec
                   ) -> Tuple[SetState, np.ndarray, int, np.ndarray,
                              Optional[RT.RoutePlan]]:
    """Route + execute a mixed batch through the spec's router.  Returns
    ``(state, per-lane results (host), dropped count, per-lane drop mask,
    stage-1 plan-or-None)``.  ``drop_mask[i]`` is True exactly when lane i
    was shed past the lane budget -- its result is NOT a successful no-op;
    callers retry or reshard (all-False on drop-free traces)."""
    if sspec.router == "v1":
        b = _host_i32(keys).shape[0]
        state, res, dropped = apply_batch(
            state, *_on(state.keys.device, ops, keys, values), sspec=sspec)
        host = RT._to_host(res, dropped)
        d = int(host[1])
        mask = np_v1_drop_mask(
            _host_i32(keys), n_shards=sspec.n_shards,
            lane_budget=sspec.lane_budget(b)) if d else np.zeros((b,), bool)
        return state, host[0].astype(bool), d, mask, None
    return RT.apply_batch_v2(state, _host_i32(ops), _host_i32(keys),
                             _host_i32(values), sspec=sspec)


def dispatch_get(state: SetState, keys, *, sspec: ShardSpec,
                 default: int = 0):
    """Value lookup through the spec's router; returns ``(state, values,
    present, dropped, drop_mask, plan-or-None)``, host arrays."""
    keys = _host_i32(keys)
    if sspec.router == "v1":
        b = keys.shape[0]
        state, vals, present, dropped = get(
            state, *_on(state.keys.device, keys), sspec=sspec,
            default=default)
        vals, present, dropped = RT._to_host(vals, present, dropped)
        d = int(dropped)
        mask = np_v1_drop_mask(
            keys, n_shards=sspec.n_shards,
            lane_budget=sspec.lane_budget(b)) if d else np.zeros((b,), bool)
        return state, vals, present.astype(bool), d, mask, None
    return RT.get_v2(state, keys, sspec=sspec, default=default)


# ---------------------------------------------------------------------------
# Crash + per-shard recovery
# ---------------------------------------------------------------------------


def crash(state: SetState, u: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Power failure across all shards.  ``u`` is the per-shard adversary,
    (S, N_shard) in [0, 1); the stage-machine crash is elementwise, so the
    stacked state needs no per-shard loop."""
    return DS.crash(state, u)


def recover(persisted: torch.Tensor, keys: torch.Tensor, values: torch.Tensor,
            stamp: Optional[torch.Tensor] = None, *,
            sspec: ShardSpec) -> Tuple[SetState, torch.Tensor]:
    """Per-shard recovery on the planes' device: every shard's
    classification (the ``recovery_scan`` kernel on the card) and
    volatile-index rebuild, one shard after another, into a fresh stacked
    state.  Returns (stacked state, per-shard stage histogram i32[S, 5]).
    On a mesh the planes, the state and the histogram are this rank's
    rows."""
    spec = sspec.shard_spec()
    out = make_state(sspec, device=keys.device)
    planes = (persisted, keys, values) + (() if stamp is None else (stamp,))

    def body(st, *p):
        return E.recover_impl(*p, spec=spec)

    outs = run_shards(out, body, range(out.keys.shape[0]), *planes)
    if not outs:                          # a mesh rank past D: no rows
        return out, torch.zeros((0, 5), dtype=_I32, device=keys.device)
    return out, torch.stack([x[0] for x in outs])


def hybrid_recover(snap: SetState, persisted: torch.Tensor,
                   keys: torch.Tensor, values: torch.Tensor,
                   stamp: torch.Tensor, delta_idx: torch.Tensor, *,
                   sspec: ShardSpec) -> SetState:
    """Per-shard snapshot + delta-log recovery: every leading axis is the
    shard axis (``delta_idx`` is (S, D), padded per shard with the shard
    capacity), each shard through ``engine.hybrid_recover``.  Equal to
    :func:`recover` on the same crash planes.  ``snap`` is updated in
    place and returned: callers must not use it as a snapshot again.  On
    a mesh every argument is this rank's rows."""
    spec = sspec.shard_spec()

    def body(st, p, k, v, t, d):
        return (E.hybrid_recover(st, p, k, v, t, d, spec=spec),)

    run_shards(snap, body, range(snap.keys.shape[0]), persisted, keys,
               values, stamp, delta_idx)
    return snap


def crash_and_recover(state: SetState, u: torch.Tensor, *, sspec: ShardSpec
                      ) -> Tuple[SetState, torch.Tensor]:
    return recover(*crash(state, u), sspec=sspec)


# ---------------------------------------------------------------------------
# Object facade (mirrors DurableMap)
# ---------------------------------------------------------------------------


class _LazyBatch:
    """Deferred per-lane results of a pipelined batch (array-like).

    Returned by :class:`ShardedDurableMap` mutators/lookups when
    ``pipeline_depth > 1``.  Reading it -- ``np.asarray``, iteration,
    indexing, ``.value()`` -- forces the pipeline up to and including this
    batch.  A crash that strikes while the batch is still STAGED (stage-1
    routed but never dispatched) abandons it: the batch never executed and
    paid zero psyncs; reading an abandoned handle raises ``RuntimeError``.
    """
    __slots__ = ("_owner", "_kind", "_plan", "_default", "_inflight",
                 "_value", "_present", "_dropped", "_drop_mask",
                 "_abandoned")

    def __init__(self, owner, kind: str, plan, default: int = 0):
        self._owner = owner
        self._kind = kind                 # "apply" | "get"
        self._plan = plan
        self._default = default
        self._inflight = None             # set when dispatched
        self._value = None
        self._present = None
        self._dropped = None
        self._drop_mask = None
        self._abandoned = False

    @property
    def abandoned(self) -> bool:
        return self._abandoned

    def value(self) -> np.ndarray:
        """Per-lane results (forces the pipeline through this batch)."""
        if self._abandoned:
            raise RuntimeError(
                "pipelined batch was abandoned by a crash before dispatch "
                "(never executed, zero psyncs); re-submit it after recovery")
        if self._value is None:
            self._owner._force_through(self)
        return self._value

    @property
    def present(self) -> np.ndarray:
        """For get batches: the per-lane presence mask (forces)."""
        self.value()
        return self._present

    @property
    def dropped(self) -> int:
        """Router-dropped lane count for this batch (forces)."""
        self.value()
        return self._dropped

    @property
    def drop_mask(self) -> np.ndarray:
        """Per-lane drop mask for this batch (forces)."""
        self.value()
        return self._drop_mask

    def __array__(self, dtype=None, copy=None):
        v = np.asarray(self.value())
        return v.astype(dtype) if dtype is not None else v

    def __iter__(self):
        return iter(self.value())

    def __len__(self):
        return len(self.value())

    def __getitem__(self, i):
        return self.value()[i]

    def __repr__(self):
        if self._abandoned:
            return "_LazyBatch(abandoned)"
        if self._value is None:
            stage = "staged" if self._inflight is None else "in-flight"
            return f"_LazyBatch({self._kind}, {stage})"
        return f"_LazyBatch({self._kind}, forced={self._value!r})"


class ShardedDurableMap(MetricsMixin):
    """DurableMap facade over S independent shards on one device, or over
    the ranks of a process group under ``use_shard_map`` (each rank holds
    its S/D rows; see the module docstring).

    >>> m = ShardedDurableMap(SetSpec(capacity=65536, backend="bucket"),
    ...                       n_shards=8)                  # on the GPU
    >>> m.insert([1, 2], [10, 20])
    >>> m.contains([1, 3])          # -> array([True, False])
    >>> m.crash_and_recover()       # per-shard adversary and rebuild

    Every backend registered with the engine works unchanged.  Routing past
    the lane budget drops lanes (counted in ``router_dropped``, warned
    once, result False) -- impossible for batches of <= ``min_lane_budget``
    lanes.  Results come back as host numpy arrays.  On a mesh every rank
    makes the same calls with the same arguments: a crash adversary ``u``
    is the whole (S, N) one, of which each rank takes its rows.  The
    counters ``psyncs``, ``ops``, ``len`` and ``overflowed`` are
    collectives there, read by every rank at the same point (so is a
    metrics registry's snapshot: every rank attaches one); ``repr`` shows
    this rank's rows alone and runs no collective.

    A snapshot of a map in a group (:class:`~repro_torch.store.snapshot.
    Snapshotter`) is captured, built and written by each rank for the
    rows it holds (``snapshot_rows``), as the JAX package's ``shard_map``
    recovers each device's rows; where every rank holds every row (D = 1),
    rank 0 alone does it.
    """

    def __init__(self, spec=None, n_shards: Optional[int] = None,
                 metrics=None, metrics_name: str = "sharded_map",
                 device="cuda", **spec_kwargs):
        if isinstance(spec, ShardSpec):
            if n_shards is not None:
                spec_kwargs["n_shards"] = n_shards
            sspec = dataclasses.replace(spec, **spec_kwargs) \
                if spec_kwargs else spec
        else:
            shard_kw = {k: spec_kwargs.pop(k)
                        for k in ("router", "placement", "lane_factor",
                                  "min_lane_budget", "max_lane_budget",
                                  "n_device_groups", "pipeline_depth",
                                  "use_shard_map")
                        if k in spec_kwargs}
            if spec is None:
                spec = SetSpec(**spec_kwargs)
            elif spec_kwargs:
                spec = dataclasses.replace(spec, **spec_kwargs)
            sspec = ShardSpec(base=spec,
                              n_shards=8 if n_shards is None else n_shards,
                              **shard_kw)
        E.get_backend(sspec.base.backend)     # fail fast
        sspec.shard_spec()                    # validate per-shard geometry
        self.sspec = sspec
        self.mesh = RT.shard_mesh(sspec)      # None: the one-device path
        self.rows = RT.local_rows(sspec)      # storage rows held here
        self.group = RT.group_mesh(sspec)     # the ranks it lives among
        self.device = resolve_device(
            device if self.group is None else self.group.device(device))
        self.state = make_state(sspec, device=self.device)
        self.last_recovery_hist = None        # i32[5], summed over shards
        self.last_recovery_hist_shards = None  # i32[S, 5]
        self.router_dropped = 0
        self.last_route = None                # v2: stage-1 RoutePlan
        self.last_drop_mask = None            # bool[B] of the last batch
        self.pipeline_abandoned = 0           # staged batches lost to crash
        self._staged = None                   # routed, not yet dispatched
        self._pending = []                    # dispatched, not yet forced
        self._overflow_warned = False
        self._dropped_warned = False
        self._m_name = metrics_name
        if metrics is not None:
            self.attach_metrics(metrics, name=metrics_name)

    @property
    def spec(self) -> SetSpec:
        """The per-shard SetSpec actually executing."""
        return self.sspec.shard_spec()

    @property
    def n_shards(self) -> int:
        return self.sspec.n_shards

    @property
    def overflowed(self) -> bool:
        """True once ANY shard latched its index overflow."""
        self._dispatch_staged()
        flag = bool(self.state.overflow.any())
        return flag if self.mesh is None else self.mesh.any(flag)

    def rows_of(self, x):
        """This process's rows of a whole (S, ...) array: all of it on the
        one-device path."""
        return x[self.rows.start:self.rows.stop]

    def local_row(self, row: int) -> int:
        """This process's index of storage row ``row`` in the state's
        leaves.  Raises ``IndexError`` where the process does not hold the
        row: a read or write of it there would hit another row."""
        if row not in self.rows:
            raise IndexError(f"storage row {row} is not held here (rows "
                             f"{self.rows.start}:{self.rows.stop} of "
                             f"{self.n_shards})")
        return row - self.rows.start

    def _total(self, t) -> int:
        """A counter summed over this process's shards, and over the ranks
        on a mesh."""
        v = int(t)
        return v if self.mesh is None else self.mesh.sum(v)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _finish(self, res, dropped, drop_mask=None,
                check_overflow: bool = True):
        if drop_mask is not None:
            self.last_drop_mask = drop_mask
        d = int(dropped)
        if d:
            self.router_dropped += d
            if not self._dropped_warned:
                self._dropped_warned = True
                knob = ("raise or clear max_lane_budget"
                        if self.sspec.router == "v2" else
                        "raise lane_factor")
                E.warn_structure(
                    f"ShardedDurableMap dropped {d} lane(s): a shard "
                    f"received more than the lane budget; {knob} "
                    f"or submit smaller batches (sspec={self.sspec})",
                    stacklevel=4)
        # the overflow latch lives in device state; checking it reads the
        # device on EVERY batch, so the pipelined path defers it to
        # pipeline_flush() instead of checking per forced batch
        if check_overflow and not self._overflow_warned and self.overflowed:
            self._overflow_warned = True
            E.warn_structure(self._overflow_message(), stacklevel=4)
        return res

    def _overflow_message(self) -> str:
        return (f"ShardedDurableMap index overflow latched on a shard "
                f"(spec={self.spec}); lookups may miss live keys -- grow "
                "capacity, stash_size, or n_shards")

    # -- pipeline (pipeline_depth > 1) --------------------------------------
    #
    # The newest batch is STAGED (stage-1 routed on the host, not yet
    # dispatched); up to depth-1 older batches are dispatched but not yet
    # forced.  Batch order is strictly FIFO, so linearization, results,
    # state and psync counters equal the synchronous path's.  A crash
    # abandons only the staged batch: it never executed and paid zero
    # psyncs.

    def _submit(self, kind, ops, keys, values, default: int = 0):
        self._dispatch_staged()               # batch n-1 is dispatched
        if kind == "get":
            keys = _host_i32(keys)
            ops = np.full(keys.shape, OP_CONTAINS, np.int32)
            values = keys
        plan = RT.host_route(self.sspec, ops, keys, values)
        handle = _LazyBatch(self, kind, plan, default)
        self._staged = handle
        self.last_route = plan
        while len(self._pending) > self.sspec.pipeline_depth - 1:
            self._force_oldest()
        return handle

    def _dispatch_staged(self):
        h = self._staged
        if h is None:
            return
        self._staged = None
        self.state, h._inflight = RT.dispatch_plan(
            self.state, h._plan, sspec=self.sspec, kind=h._kind,
            default=h._default)
        self._pending.append(h)

    def _force_oldest(self):
        h = self._pending.pop(0)
        out = h._inflight.force()
        if h._kind == "apply":
            h._value, h._dropped, h._drop_mask = out
        else:
            h._value, h._present, h._dropped, h._drop_mask = out
        self._finish(h._value, h._dropped, h._drop_mask,
                     check_overflow=False)

    def _force_through(self, handle):
        """Force the pipeline, in submit order, through ``handle``."""
        if handle is self._staged:
            self._dispatch_staged()
        while self._pending and handle._value is None \
                and not handle._abandoned:
            self._force_oldest()

    def pipeline_flush(self):
        """Dispatch the staged batch, force every pending batch, and run
        the deferred overflow check.  A no-op on a synchronous map."""
        self._dispatch_staged()
        while self._pending:
            self._force_oldest()
        self._finish(None, 0)                 # deferred overflow check
        return self

    def scratch_stats(self) -> dict:
        """Routing scratch-pool counters (module-wide): ``grid_allocs``,
        ``acquires``, ``releases`` (recycles, including the scratch of a
        batch abandoned by a crash) and ``free``."""
        return RT.scratch_stats()

    def _recheck_overflow(self):
        self._finish(None, 0)

    def _metrics_extra(self) -> dict:
        route = None
        if self.last_route is not None:
            route = {"lane_budget": self.last_route.lane_budget,
                     "groups": self.last_route.groups,
                     "max_occ": self.last_route.max_occ}
        return {
            "n_shards": self.n_shards,
            "router_dropped": self.router_dropped,
            "pipeline_abandoned": self.pipeline_abandoned,
            "pipeline_staged": int(self._staged is not None),
            "pipeline_pending": len(self._pending),
            "scratch": self.scratch_stats(),
            "last_route": route,
        }

    def _apply(self, ops, keys, values):
        if self.sspec.pipeline_depth > 1:
            return self._submit("apply", ops, keys, values)
        self.state, res, dropped, drop_mask, plan = dispatch_batch(
            self.state, ops, keys, values, sspec=self.sspec)
        if plan is not None:
            self.last_route = plan
        return self._finish(res, dropped, drop_mask)

    def insert(self, keys, values=None):
        keys = _host_i32(keys)
        values = keys if values is None else _host_i32(values)
        return self._apply(np.full(keys.shape, OP_INSERT, np.int32), keys,
                           values)

    def remove(self, keys):
        keys = _host_i32(keys)
        return self._apply(np.full(keys.shape, OP_REMOVE, np.int32), keys,
                           keys)

    def contains(self, keys):
        keys = _host_i32(keys)
        return self._apply(np.full(keys.shape, OP_CONTAINS, np.int32), keys,
                           keys)

    def get(self, keys, default: int = 0):
        """Values for present keys, ``default`` otherwise."""
        if self.sspec.pipeline_depth > 1:
            return self._submit("get", None, keys, None, default)
        self.state, vals, _, dropped, drop_mask, plan = dispatch_get(
            self.state, keys, sspec=self.sspec, default=default)
        if plan is not None:
            self.last_route = plan
        return self._finish(vals, dropped, drop_mask)

    def apply(self, ops, keys, values=None):
        """Mixed contains/insert/remove batch; see :func:`apply_batch`."""
        keys = _host_i32(keys)
        values = keys if values is None else _host_i32(values)
        return self._apply(_host_i32(ops), keys, values)

    def precompile(self, batch: int, partial=None):
        """The v2 lane budgets the adaptive chooser can pick for
        ``batch``-lane batches -- the tuple the JAX package compiles a
        program for.  Eager PyTorch compiles nothing: the map's contents
        and counters are untouched."""
        if self.sspec.router != "v2":
            return ()
        self._dispatch_staged()               # keep FIFO order intact
        self.state, budgets = RT.precompile(self.state, batch,
                                            sspec=self.sspec,
                                            partial=partial)
        return budgets

    def _pre_crash(self):
        """Shared crash prologue: ABANDON the staged batch (never
        dispatched: it executed nothing and paid zero psyncs), force every
        already-dispatched batch (committed work), and fold the device
        counters that the rebuild is about to reset."""
        if self._staged is not None:
            h, self._staged = self._staged, None
            RT.release_plan(h._plan)
            h._abandoned = True
            self.pipeline_abandoned += 1
            if self._m is not None:
                self._m.counter(
                    f"{self._m_name}.pipeline_abandoned").inc()
        while self._pending:
            self._force_oldest()
        self._metrics_pre_recovery()          # counters are about to reset

    def _adversary(self, u, seed: int) -> torch.Tensor:
        """This process's rows of the crash adversary (S, N) float32, on
        the map's device; by default an INDEPENDENT uniform draw per shard
        from ``seed``, as the JAX package draws it (the whole draw on
        every rank of a mesh, so the crash is the one-device map's)."""
        if u is None:
            u = np.random.default_rng(seed).random(
                (self.n_shards, self.spec.capacity)).astype(np.float32)
        if not isinstance(u, torch.Tensor):
            u = np.asarray(u, np.float32)
        return torch.as_tensor(self.rows_of(u), dtype=torch.float32,
                               device=self.device)

    def crash_and_recover(self, u=None, seed: int = 0):
        """Crash all shards and rebuild each one.  ``u`` defaults to an
        INDEPENDENT uniform adversary per shard.  Pipelined maps: a batch
        still STAGED at crash time is abandoned (its handle raises on
        read, ``pipeline_abandoned`` counts it); dispatched batches are
        committed work and are forced before the crash."""
        self._pre_crash()
        u = self._adversary(u, seed)
        self._sync()
        t0 = time.perf_counter()
        self.state, hist = crash_and_recover(self.state, u, sspec=self.sspec)
        (self.last_recovery_hist_shards,) = whole_rows(self.sspec,
                                                       E._host(hist))
        self.last_recovery_hist = self.last_recovery_hist_shards.sum(axis=0)
        self._sync()                          # honest recovery timing
        self.last_recovery_seconds = time.perf_counter() - t0
        self._metrics_post_recovery(
            scanned_slots=self.n_shards * self.spec.capacity)
        self._post_recovery_overflow()    # latch recomputed; warning re-armed
        return self

    # --- snapshot + delta-log hybrid recovery (DESIGN.md §11) -----------
    #
    # The watermark discipline of ``DurableMap``, per shard: the watermark
    # is an (S,) epoch vector, the delta list an (S, D) grid padded per
    # shard.

    _SNAP_FIELDS = E.DurableMap._SNAP_FIELDS

    @property
    def supports_hybrid(self) -> bool:
        return E.supports_hybrid_recovery(self.spec)

    @property
    def snapshot_rows(self) -> range:
        """The storage rows this process captures, builds and writes in a
        snapshot: the rows it holds, save where every rank of a group holds
        every row (D = 1), where rank 0 writes them all and the others
        none."""
        if self.mesh is None and self.group is not None \
                and self.group.rank != 0:
            return range(0)
        return self.rows

    def snapshot_capture(self) -> dict:
        """Flush the pipeline to a clean dispatch boundary, host-copy this
        process's ``snapshot_rows`` of the durable planes and their
        epochs, and open a new stamp generation on every shard it holds.
        Zero psyncs -- a pure NVM read -- and no collective save the
        flush's: no plane crosses between ranks.  ``rows`` names the
        storage rows of the copies."""
        self.pipeline_flush()
        rows = self.snapshot_rows
        mine = slice(0, len(rows))           # they are the first held
        st = self.state
        cap = {"rows": rows, "watermark": E._host(st.epoch[mine]),
               "raw_stage": E._host(st.flushed[mine]),
               "keys": E._host(st.keys[mine]),
               "values": E._host(st.values[mine]),
               "stamp": E._host(st.stamp[mine])}
        self.state = st._replace(epoch=st.epoch + 1)
        return cap

    def snapshot_build(self, cap: dict):
        """Canonicalize a capture with the normal per-shard ``recover`` of
        its rows on this process's device (one ``recovery_scan`` a row on
        the card), under a spec of those rows alone, so it runs no
        collective (safe in a background thread).  Returns (planes, meta)
        of the captured rows: every plane keeps its leading shard axis;
        ``snapshot_meta`` of the whole watermark and histogram is what the
        store keeps.  In a group the step this build belongs to commits,
        and its future completes, only at a later main-thread call of the
        :class:`~repro_torch.store.snapshot.Snapshotter` on every rank."""
        k = len(cap["rows"])
        if not k:                            # a rank that writes no row
            return {}, self.snapshot_meta(cap["watermark"],
                                          np.zeros((0, 5), np.int32))
        sspec = dataclasses.replace(self.sspec, use_shard_map=False,
                                    n_device_groups=0).with_n_shards(k)
        st, hist = recover(*(E._on_device(cap[f], self.device, np.int32)
                             for f in ("raw_stage", "keys", "values",
                                       "stamp")), sspec=sspec)
        planes = {f: E._host(getattr(st, f)) for f in self._SNAP_FIELDS}
        planes["raw_stage"] = cap["raw_stage"]
        return planes, self.snapshot_meta(cap["watermark"], E._host(hist))

    @staticmethod
    def snapshot_meta(watermark, hist) -> dict:
        """The manifest ``extra`` of a snapshot: the per-shard watermark
        (S,) and stage histogram (S, 5), as the JAX package stores them."""
        return {"kind": "sharded_map",
                "watermark": np.asarray(watermark).tolist(),
                "hist": np.asarray(hist).tolist()}

    def snapshot_layout(self) -> dict:
        """Each stored plane's numpy dtype and whole (S, ...) shape: what
        ``snapshot_build`` of every row gives, without building."""
        def whole(t):
            return (E._host(t[:0]).dtype,
                    (self.n_shards,) + tuple(t.shape[1:]))
        out = {f: whole(getattr(self.state, f)) for f in self._SNAP_FIELDS}
        out["raw_stage"] = whole(self.state.flushed)
        return out

    def _snapshot_state(self, planes: dict) -> SetState:
        """The canonical stacked snapshot state on the map's device (this
        process's rows of the stored planes); every leaf owns its
        memory."""
        def leaf(f):
            return E._on_device(self.rows_of(planes[f]), self.device)
        cur = leaf("cur")
        return make_state(self.sspec, device=self.device)._replace(
            keys=leaf("keys"), values=leaf("values"), cur=cur,
            flushed=cur.clone(), stamp=leaf("stamp"), bkeys=leaf("bkeys"),
            bids=leaf("bids"), skeys=leaf("skeys"), sids=leaf("sids"),
            stash_n=leaf("stash_n"), size=leaf("size"),
            overflow=leaf("overflow"))

    def _find_delta(self, persisted, stamp, watermark):
        """Each shard's delta (stamp newer than its watermark), found on
        the device: ``(delta_idx i32[S, D] on the device, shard rows,
        slots, persisted stages)``, the last three host arrays in
        row-major order.  D is the largest shard's delta count rounded up
        to a power of two, at least 8, as in the JAX package (the largest
        over every rank's shards on a mesh).  ``watermark`` and the rows
        are this process's."""
        s, n = stamp.shape
        w = torch.as_tensor(np.asarray(watermark, np.int32).reshape(-1, 1),
                            device=stamp.device)
        nz = torch.nonzero(stamp > w)
        rows, cols = nz[:, 0], nz[:, 1]
        host = RT._to_host(rows, cols, persisted[rows, cols])
        rows, cols, stages = (a.astype(np.int64) for a in host)
        counts = np.bincount(rows, minlength=s)
        dmax = int(counts.max()) if s else 0
        if self.mesh is not None:
            dmax = self.mesh.max(dmax)
        d = E._padded_len(dmax)
        start = np.concatenate([[0], np.cumsum(counts)[:-1]])
        delta_idx = np.full((s, d), n, np.int32)
        delta_idx[rows, np.arange(rows.size) - start[rows]] = cols
        return (torch.from_numpy(delta_idx).to(stamp.device), rows, cols,
                stages)

    def hybrid_crash_and_recover(self, planes: dict, meta: dict, u=None,
                                 seed: int = 0):
        """Crash all shards and recover from the stored snapshot + each
        shard's stamp delta; equal to ``crash_and_recover`` under the same
        adversary.  Staged-batch abandonment follows the same rules.
        Recovery psyncs: exactly 0."""
        self._pre_crash()
        u = self._adversary(u, seed)
        n = self.spec.capacity
        self._sync()
        t0 = time.perf_counter()
        crashed = crash(self.state, u)
        delta_idx, rows, cols, stages = self._find_delta(
            crashed[0], crashed[3],
            self.rows_of(np.asarray(meta["watermark"])))
        # the stage histogram a full scan would count, corrected in
        # O(delta) from the snapshot's: the capture-time raw stages of the
        # delta slots go out, their crash-time stages come in
        hist = self.rows_of(
            np.asarray(meta["hist"], np.int64)).copy()         # (S, 5)
        raw = self.rows_of(np.asarray(planes["raw_stage"]))
        np.add.at(hist, (rows, np.clip(raw[rows, cols], 0, 4)), -1)
        np.add.at(hist, (rows, np.clip(stages, 0, 4)), 1)
        snap = self._snapshot_state(planes)
        self.state = hybrid_recover(snap, *crashed, delta_idx,
                                    sspec=self.sspec)
        (self.last_recovery_hist_shards,) = whole_rows(
            self.sspec, hist.astype(np.int32))
        self.last_recovery_hist = self.last_recovery_hist_shards.sum(axis=0)
        self._sync()
        self.last_recovery_seconds = time.perf_counter() - t0
        n_delta = self._total(rows.size)
        total = self.n_shards * n
        self._metrics_post_recovery(scanned_slots=n_delta,
                                    from_snapshot=total - n_delta,
                                    from_delta=n_delta)
        self._post_recovery_overflow()
        return self

    @property
    def psyncs(self):
        # dispatch the staged batch first so the counters reflect every
        # submitted batch
        self._dispatch_staged()
        return self._total(self.state.n_psync.sum())

    @property
    def ops(self):
        self._dispatch_staged()
        return self._total(self.state.n_ops.sum())

    def __len__(self):
        self._dispatch_staged()
        return self._total(self.state.size.sum())

    def __repr__(self):
        if self.mesh is None:
            return (f"ShardedDurableMap(size={len(self)}, "
                    f"psyncs={self.psyncs}, n_shards={self.n_shards}, "
                    f"spec={self.spec})")
        # one rank's view: no collective, so any rank may print it alone
        self._dispatch_staged()
        st = self.state
        return (f"ShardedDurableMap(rank={self.mesh.rank}, "
                f"rows={self.rows.start}:{self.rows.stop}, "
                f"local_size={int(st.size.sum())}, "
                f"local_psyncs={int(st.n_psync.sum())}, "
                f"n_shards={self.n_shards}, spec={self.spec})")
