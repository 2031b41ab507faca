"""Process-group mesh for the sharded durable map: one process per GPU.

PyTorch port of the helpers the JAX package's sharded map takes from
``repro.launch.mesh`` (``compat_make_mesh``, ``compat_shard_map``).  JAX
partitions the shard axis over a 1-D ``("shards",)`` device mesh inside one
controller; here a ``torch.distributed`` process group of D ranks stands in
for the mesh, one process per GPU, because the map's path is bound by the
host's launches: one Python thread driving D cards would issue their
launches one after another.

  rows      rank r holds storage rows ``r*S/D .. (r+1)*S/D - 1`` of every
            state leaf -- the rows ``PartitionSpec("shards")`` gives device
            r.  Ranks past D (a world that is not a power of two dividing
            S) hold none.
  bodies    each rank runs its own rows' shard bodies with the existing
            kernels, on its own device.
  outputs   the shard bodies never communicate (the JAX program under
            ``shard_map`` has no collective), so only host-side lane
            results and counters cross between ranks: :meth:`ShardMesh.
            gather` is ``out_specs=P("shards")``, an all-gather of each
            rank's rows into the (D, ...) array, over a ``gloo`` group of
            its own (made with ``dist.new_group(backend="gloo")``, so it
            works under any default group, NCCL included).
  resize    an online split or merge (``repro_torch.core.resize``) moves
            rows between ranks through the host: the rank holding a
            source row copies it to the host and
            :meth:`ShardMesh.broadcast_arrays` sends the planes to every
            rank, where the rank holding each destination row rebuilds
            it.

Every method of :class:`ShardMesh` but ``rows``, ``holder`` and ``device``
is a collective: every rank calls it, in the same order.  The map's facade
keeps that order because every rank makes the same calls on the same
batches.

:class:`ModelMesh` is the model's mesh: the group's ranks laid out on a
named grid, ``("data", "model")`` or ``("pod", "data", "model")``, as
``compat_make_mesh`` lays out JAX's devices (row-major: rank r of a (2, 2)
grid is JAX's device r).  Each line of each axis has a ``gloo`` group of
its own, so a role's collective (the sequence-sharded decode's combine
over ``model``) runs among the ranks that hold the other parts of the
same rows.

:func:`spawn` starts a group on one host (the tests run 4 ``gloo`` ranks on
the CPU; on the card the ranks may share one GPU).  ``torchrun`` or any
other launcher that initializes the default group works as well.
"""
from __future__ import annotations

import dataclasses
import datetime
import itertools
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

_TIMEOUT = datetime.timedelta(minutes=10)   # a collective's wait, per call
_SPAWN_TIMEOUT = 900.0                      # seconds for a spawned group

_MESH = None          # (default group, ShardMesh): one gloo group per group


def rank_device(rank: int, requested="cuda") -> torch.device:
    """A rank's device: ``cuda:(rank % device_count)`` for a bare
    ``"cuda"``, else what the caller asked for (``"cpu"``, or a card by
    index)."""
    dev = torch.device(requested)
    n = torch.cuda.device_count()
    if dev.type == "cuda" and dev.index is None and n:
        return torch.device("cuda", rank % n)
    return dev


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """This process's place in the group: its rank, the world size, and the
    ``gloo`` group of the host-side collectives."""
    rank: int
    world: int
    group: object

    def rows(self, n_shards: int, d: int) -> range:
        """The storage rows this rank holds when S shards split over D
        ranks: its contiguous block of S/D, none past rank D - 1."""
        per = n_shards // d
        if self.rank >= d:
            return range(0)
        return range(self.rank * per, (self.rank + 1) * per)

    def holder(self, row: int, n_shards: int, d: int) -> int:
        """The rank holding storage row ``row`` when S shards split over D
        ranks (the inverse of :meth:`rows`); rank 0 when D is 1, where
        every rank holds every row."""
        return row // (n_shards // d) if d > 1 else 0

    def device(self, requested="cuda") -> torch.device:
        """The rank's device: ``cuda:(rank % device_count)`` for a bare
        ``"cuda"``, else what the caller asked for (``"cpu"``, or a card
        by index)."""
        return rank_device(self.rank, requested)

    def gather(self, parts: Optional[Sequence[np.ndarray]],
               shapes: Sequence[tuple], d: int) -> list:
        """``out_specs=P("shards")``: each output's rows from ranks 0 to
        D - 1, stacked into a (D, *shape) int32 array on every rank, in ONE
        all-gather.  ``parts`` are this rank's outputs (each of ``shape``
        or with a leading axis of 1); a rank past D holds none and passes
        None."""
        sizes = [int(np.prod(s, dtype=np.int64)) for s in shapes]
        n = sum(sizes)
        if parts is None:
            flat = np.zeros((n,), np.int32)
        else:
            flat = np.concatenate([np.asarray(p, np.int32).reshape(-1)
                                   for p in parts]) if parts else \
                np.zeros((0,), np.int32)
        if flat.size != n:
            raise ValueError(f"gather: {flat.size} values for shapes "
                             f"{list(shapes)}")
        got = [torch.empty((n,), dtype=torch.int32)
               for _ in range(self.world)]
        dist.all_gather(got, torch.from_numpy(flat), group=self.group)
        rows = torch.stack(got[:d]).numpy()
        out, at = [], 0
        for s, k in zip(shapes, sizes):
            out.append(rows[:, at:at + k].reshape((d,) + tuple(s)))
            at += k
        return out

    def _reduce(self, value: int, op) -> int:
        t = torch.tensor([int(value)], dtype=torch.int64)
        dist.all_reduce(t, op=op, group=self.group)
        return int(t[0])

    def sum(self, value: int) -> int:
        return self._reduce(value, dist.ReduceOp.SUM)

    def max(self, value: int) -> int:
        return self._reduce(value, dist.ReduceOp.MAX)

    def any(self, flag: bool) -> bool:
        return bool(self._reduce(bool(flag), dist.ReduceOp.MAX))

    def broadcast(self, value: int, src: int = 0) -> int:
        """Rank ``src``'s value on every rank (a decision rank 0 takes, such
        as whether a snapshot is due or which step recovery reads, made the
        same everywhere; the length of what rank ``src`` sends next)."""
        t = torch.tensor([int(value)], dtype=torch.int64)
        dist.broadcast(t, src=src, group=self.group)
        return int(t[0])

    def broadcast_arrays(self, src: int, arrays: Optional[Sequence],
                         shapes: Sequence[tuple]) -> list:
        """Rank ``src``'s int32 host arrays on every rank, in ONE broadcast
        of their concatenation.  Rank ``src`` passes its arrays; every rank
        passes their ``shapes`` (the other ranks pass None for
        ``arrays``).  Each rank gets arrays that own their memory."""
        sizes = [int(np.prod(s, dtype=np.int64)) for s in shapes]
        if self.rank == src:
            flat = np.concatenate([np.asarray(a, np.int32).reshape(-1)
                                   for a in arrays]) if sizes else \
                np.zeros((0,), np.int32)
            if flat.size != sum(sizes):
                raise ValueError(f"broadcast_arrays: {flat.size} values for "
                                 f"shapes {list(shapes)}")
            t = torch.from_numpy(flat)
        else:
            t = torch.empty((sum(sizes),), dtype=torch.int32)
        dist.broadcast(t, src=src, group=self.group)
        flat = t.numpy()
        out, at = [], 0
        for s, k in zip(shapes, sizes):
            out.append(flat[at:at + k].reshape(tuple(s)))
            at += k
        return out

    def barrier(self) -> None:
        dist.barrier(group=self.group)


Axes = Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class ModelMesh:
    """This rank's place on a named grid of the group's ranks.

    ``axis_names`` and ``sizes`` are the grid (JAX's ``mesh.axis_names``
    and ``mesh.shape``); ``groups`` maps a tuple of axis names to the
    ``gloo`` group of this rank's line along those axes (the ranks whose
    other coordinates equal this rank's).  An axis of size 1 has no group:
    a reduction over it is the identity.  Made by :func:`make_model_mesh`
    (a collective); a mesh made directly, with no groups, describes a grid
    (``shape``, the specs of ``launch/specs.py``) and refuses a
    collective."""
    axis_names: Axes
    sizes: Tuple[int, ...]
    rank: int = 0
    groups: Dict[Axes, object] = dataclasses.field(default_factory=dict,
                                                   compare=False)

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes) or \
                len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"mesh axes {self.axis_names} and sizes "
                             f"{self.sizes} do not match")
        if not 0 <= self.rank < self.world:
            raise ValueError(f"rank {self.rank} outside a mesh of "
                             f"{self.world}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def world(self) -> int:
        return int(np.prod(self.sizes, dtype=np.int64))

    @property
    def coords(self) -> Tuple[int, ...]:
        """This rank's coordinate on each axis, row-major."""
        return tuple(int(c) for c in np.unravel_index(self.rank, self.sizes))

    @staticmethod
    def _axes(axes) -> Axes:
        return tuple(axes) if isinstance(axes, (tuple, list)) else (axes,)

    def axis_size(self, axes) -> int:
        """The ranks on a line of ``axes`` (a name or a tuple of names; 1
        for None)."""
        if axes is None:
            return 1
        shape = self.shape
        return int(np.prod([shape[a] for a in self._axes(axes)],
                           dtype=np.int64))

    def coord(self, axes) -> int:
        """This rank's index on its line of ``axes``: the block of a dim
        split over them that it holds (row-major over a tuple, as
        ``PartitionSpec(("pod", "data"))`` assigns blocks)."""
        if axes is None:
            return 0
        at = dict(zip(self.axis_names, self.coords))
        idx = 0
        for a in self._axes(axes):
            idx = idx * self.shape[a] + at[a]
        return idx

    def all_reduce(self, t: torch.Tensor, op, axes) -> torch.Tensor:
        """``t`` reduced in place by ``op`` (a ``dist.ReduceOp``) over the
        ranks of this rank's line of ``axes``; returns ``t``.  A collective
        of that line: each of its ranks calls it, in the same order."""
        if self.axis_size(axes) == 1:
            return t
        dist.all_reduce(t, op=op, group=self._group(axes))
        return t

    def _group(self, axes):
        named = set(self._axes(axes))
        key = tuple(a for a in self.axis_names if a in named)
        if key not in self.groups:
            raise RuntimeError(f"the mesh has no process group over {key}: "
                               "make it with make_model_mesh")
        return self.groups[key]

    def all_gather(self, t: torch.Tensor, axes) -> torch.Tensor:
        """The flat ``t`` of each rank of this rank's line of ``axes``,
        concatenated in their coordinate order (one ``all_gather`` into a
        tensor); ``t`` itself on a line of one rank.  Trap: ``gloo`` on
        card tensors.  PyTorch's backend table lists only ``broadcast``
        and ``all_reduce`` for it, but with torch 2.11 on an H100 it took
        this and ``reduce_scatter`` of card tensors, bf16 included, and
        gathered a layer's blocks faster than an ``all_reduce`` of a
        zero-filled whole (PERF.md gives both times)."""
        if self.axis_size(axes) == 1:
            return t
        out = t.new_empty((self.axis_size(axes) * t.numel(),))
        _ALL_GATHER(out, t.contiguous().view(-1), group=self._group(axes))
        return out

    def reduce_scatter(self, t: torch.Tensor, axes) -> torch.Tensor:
        """Chunk ``coord(axes)`` of the flat ``t`` summed over this rank's
        line of ``axes`` (``t`` holds one equal chunk a rank, in
        coordinate order; one ``reduce_scatter`` into a tensor); ``t``
        itself on a line of one rank."""
        n = self.axis_size(axes)
        if n == 1:
            return t
        out = t.new_empty((t.numel() // n,))
        _REDUCE_SCATTER(out, t.contiguous().view(-1), dist.ReduceOp.SUM,
                        group=self._group(axes))
        return out


# the tensor forms of all_gather and reduce_scatter (renamed *_single in
# later torch releases, the old names kept as deprecated aliases)
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def _lines(sizes: Tuple[int, ...], along: Tuple[int, ...]) -> list:
    """The rank lists of every line of a row-major grid along the dims
    ``along``, in a fixed order."""
    ranks = np.arange(int(np.prod(sizes, dtype=np.int64))).reshape(sizes)
    rest = [d for d in range(len(sizes)) if d not in along]
    moved = np.transpose(ranks, rest + list(along))
    return [[int(r) for r in line.reshape(-1)]
            for line in moved.reshape(-1, int(np.prod(
                [sizes[d] for d in along], dtype=np.int64)))]


def make_model_mesh(sizes: Sequence[int],
                    axis_names: Optional[Sequence[str]] = None) -> ModelMesh:
    """The :class:`ModelMesh` of the initialized default group laid out on
    ``sizes`` (2 sizes: ``("data", "model")``; 3: ``("pod", "data",
    "model")``), with a ``gloo`` group for each line of each set of axes
    (``("pod", "data")`` is the ``dp`` role; the whole grid reduces the
    train step's grad norm).
    Every rank makes every group, in one order: call it on every rank.
    Without a group, a grid of one rank has no groups to make."""
    sizes = tuple(int(n) for n in sizes)
    if axis_names is None:
        axis_names = {2: ("data", "model"),
                      3: ("pod", "data", "model")}.get(len(sizes))
        if axis_names is None:
            raise ValueError(f"no default axis names for {len(sizes)} axes")
    axis_names = tuple(axis_names)
    world = int(np.prod(sizes, dtype=np.int64))
    if not (dist.is_available() and dist.is_initialized()):
        if world != 1:
            raise RuntimeError(f"a mesh of {world} ranks needs an "
                               "initialized torch.distributed group")
        return ModelMesh(axis_names, sizes)
    if dist.get_world_size() != world:
        raise ValueError(f"a mesh of {sizes} ({world} ranks) in a group "
                         f"of {dist.get_world_size()}")
    rank = dist.get_rank()
    # every set of axes, in the grid's order: a role's axes (dp's ("pod",
    # "data")) and the axes that split a leaf (launch/specs.py::gather)
    keys = [key for n in range(1, len(axis_names) + 1)
            for key in itertools.combinations(axis_names, n)]
    groups = {}
    for key in keys:
        along = tuple(axis_names.index(a) for a in key)
        for line in _lines(sizes, along):
            if len(line) == 1:
                continue
            group = dist.new_group(ranks=line, backend="gloo",
                                   timeout=_TIMEOUT)
            if rank in line:
                groups[key] = group
    return ModelMesh(axis_names, sizes, rank, groups)


def world_size() -> int:
    """Ranks in the initialized default process group; 0 without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 0


def current_mesh() -> ShardMesh:
    """The :class:`ShardMesh` of the initialized default group.  Its
    ``gloo`` group is made once per default group, on the first call,
    which every rank makes at the same point (it is a collective)."""
    global _MESH
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no torch.distributed process group is "
                           "initialized")
    world = dist.group.WORLD
    if _MESH is None or _MESH[0] is not world:
        group = dist.new_group(backend="gloo", timeout=_TIMEOUT)
        _MESH = (world, ShardMesh(dist.get_rank(), dist.get_world_size(),
                                  group))
    return _MESH[1]


def shard_map(body, mesh: ShardMesh, d: int, *rows):
    """Run ``body(*row_r)`` on this rank's row ``r`` of each (D, ...)
    argument, as ``shard_map`` runs the per-device program on device r's
    block; a rank past D runs nothing and returns None.  The outputs stay
    on the rank: :meth:`ShardMesh.gather` stacks them when they are read."""
    if mesh.rank >= d:
        return None
    return body(*(x[mesh.rank] for x in rows))


# ---------------------------------------------------------------------------
# Starting a group on one host
# ---------------------------------------------------------------------------


def _rank_main(fn, rank: int, world: int, init: str, out, args) -> None:
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=init, rank=rank,
                                world_size=world, timeout=_TIMEOUT)
        try:
            out.put((rank, True, fn(rank, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:                       # reported, then re-raised
        out.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn, world: int, *args) -> list:
    """Run ``fn(rank, *args)`` in ``world`` fresh processes that form a
    ``gloo`` process group, and return their results in rank order.

    The processes start by the ``spawn`` method (``fn``, its arguments and
    its result are pickled: ``fn`` must be importable by name), rendezvous
    through a file in a temporary directory (no TCP port to race for), run
    on one intra-op thread each, and destroy the group at the end.  A rank
    that raises, dies or is still running after ``_SPAWN_TIMEOUT`` seconds
    fails the call, and every rank is stopped."""
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    init = "file://" + os.path.join(tmp, "rendezvous")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, init, out, args), daemon=True)
             for r in range(world)]
    results, errors = {}, []
    try:
        for p in procs:
            p.start()
        end = time.monotonic() + _SPAWN_TIMEOUT
        while len(results) + len(errors) < world:
            try:
                rank, ok, value = out.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead and not errors:
                    errors.append(f"rank {procs.index(dead[0])} died with "
                                  f"exit code {dead[0].exitcode}")
                if errors or time.monotonic() > end:
                    break
                continue
            if ok:
                results[rank] = value
            else:
                errors.append(f"rank {rank} raised:\n{value}")
                break
        if not errors and len(results) < world:
            errors.append(f"ranks {sorted(set(range(world)) - set(results))}"
                          f" did not finish in {_SPAWN_TIMEOUT} s")
    finally:
        for p in procs:
            if p.pid is None:                 # never started
                continue
            p.join(timeout=10.0 if not errors else 1.0)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
        shutil.rmtree(tmp, ignore_errors=True)
    if errors:
        raise RuntimeError("spawn: " + "\n".join(errors))
    return [results[r] for r in range(world)]
