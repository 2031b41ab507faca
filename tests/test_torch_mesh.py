"""The port's sharded map partitioned over 4 ``gloo`` ranks against the JAX
package's ``shard_map`` over 4 fake CPU devices.

The same seeded scenarios (8 shards, capacity 256, 32-lane batches, as the
sharded files use) run twice: in two JAX subprocesses with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``, half the scenarios
each (each scenario's state must be partitioned over the mesh:
``len(keys.sharding.device_set)`` is the mesh size), and in one spawn of 4
ranks of the port (``repro_torch.launch.mesh.spawn``) shared by every case
of the file, each rank on the CPU.  All three run at the same time.

Every rank's rows of every state leaf must equal the JAX global leaf's
rows, and every rank's results, drop masks, ``psyncs``, ``ops``, ``len``,
``router_dropped`` and per-shard stage histograms must equal JAX's, bit
for bit: under router v2 (bucket and probe, contiguous and strided), v1, a
``max_lane_budget`` cap that drops lanes, ``pipeline_depth`` 2, crash and
recovery, a bucket snapshot with hybrid recovery, the three modes, 2
shards over 4 ranks (ranks 2 and 3 hold no rows) and ``n_device_groups``
2 (every rank on the one-device path over the whole state).  A metrics
registry attached on every rank collects JAX's counters; ``repr`` runs no
collective.

Snapshots: each rank captures and builds exactly its own rows, no
``torch.distributed`` call runs off a main thread, a snapshot's
collectives carry only the small meta (never a plane), and the stored
``.npy`` files and manifest equal the JAX run's byte for byte.  A map
whose rows every rank holds (one shard, or ``n_device_groups`` 2) has one
writer a step and the same committed step on every rank; a rank whose
build is slow neither hangs the group nor lets a rank report a step that
was not committed; a snapshot directory the ranks do not share raises on
every rank."""
import contextlib
import faulthandler
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.store.snapshot import Snapshotter  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
RANKS = 4
B, CAP, S, KEY_RANGE = 32, 256, 8, 160
FIELDS = ("keys", "values", "cur", "flushed", "stamp", "table", "bkeys",
          "bids", "skeys", "sids", "stash_n", "n_psync", "n_ops", "size",
          "overflow", "epoch")


def _batches(seed, n):
    rng = np.random.default_rng([seed, 33])
    out = []
    for _ in range(n):
        ops = rng.choice(3, B, p=(0.3, 0.5, 0.2)).astype(np.int32)
        keys = rng.integers(0, KEY_RANGE, B).astype(np.int32)
        out.append(("apply", ops, keys, (keys * 3 + 1).astype(np.int32)))
    return out


def _get(seed, default=0):
    keys = np.random.default_rng([seed, 34]).integers(
        0, 2 * KEY_RANGE, B).astype(np.int32)
    return ("get", keys, default)


def _crash_run(seed, before=4, after=2):
    """Mixed batches, a read, a crash under a seeded adversary, more
    batches and a read."""
    t = _batches(seed, before + after)
    return (t[:before] + [_get(seed), ("crash", seed)] + t[before:]
            + [_get(seed + 1, default=-7)])


def _snapshot_run(seed):
    """Two snapshots through the cadence policy, then recovery through the
    second (hybrid: the snapshot and each shard's delta)."""
    t = _batches(seed, 6)
    return (t[:2] + [("snapshot",)] + t[2:3] + [("snapshot",)] + t[3:4]
            + [("recover",)] + t[4:] + [_get(seed)])


def _pipelined_run(seed):
    t = _batches(seed, 6)
    return t[:3] + [_get(seed), ("crash", seed)] + t[3:] + [_get(seed + 1)]


SCENARIOS = {
    "bucket": (dict(backend="bucket"), {}, _crash_run(1)),
    "bucket_strided": (dict(backend="bucket"), dict(placement="strided"),
                       _crash_run(2)),
    "probe": (dict(backend="probe"), {}, _crash_run(3)),
    "probe_strided": (dict(backend="probe"), dict(placement="strided"),
                      _crash_run(4)),
    "v1": (dict(backend="bucket"),
           dict(router="v1", lane_factor=1, min_lane_budget=1),
           _crash_run(5)),
    "capped": (dict(backend="bucket"),
               dict(max_lane_budget=2, min_lane_budget=1), _crash_run(6)),
    "pipelined": (dict(backend="bucket"), dict(pipeline_depth=2),
                  _pipelined_run(7)),
    "snapshot": (dict(backend="bucket"), {}, _snapshot_run(8)),
    "linkfree": (dict(backend="bucket", mode="linkfree"), {},
                 _crash_run(9)),
    "logfree": (dict(backend="bucket", mode="logfree"), {}, _crash_run(10)),
    "two_shards": (dict(backend="bucket"), dict(n_shards=2), _crash_run(11)),
    "groups2": (dict(backend="bucket"), dict(n_device_groups=2),
                _crash_run(12)),
}


def run_scenario(api, name, snap_dir, **map_kw):
    """Drive one scenario through either package's facade (``api``: its
    ``ShardedDurableMap``, ``SetSpec``, ``Snapshotter``; ``map_kw`` goes to
    the map, as a metrics registry does on the port's side).  Returns the
    records as int arrays -- per step ``res{i}`` / ``drop{i}`` (a batch
    abandoned by a crash records ``abandoned{i}``) or ``hist{i}``, the
    counters, and ``leaf_<field>`` of the map's state -- and the map."""
    spec_kw, shard_kw, steps = SCENARIOS[name]
    shard_kw = {"n_shards": S, **shard_kw}
    m = api.ShardedDurableMap(api.SetSpec(capacity=CAP, **spec_kw),
                              use_shard_map=True, **api.map_kw, **shard_kw,
                              **map_kw)
    rec, handles, sn = {}, {}, None
    for i, step in enumerate(steps):
        kind = step[0]
        if kind in ("apply", "get"):
            out = (m.apply(*step[1:]) if kind == "apply" else
                   m.get(step[1], default=step[2]))
            if m.sspec.pipeline_depth > 1:
                handles[i] = out
            else:
                rec[f"res{i}"] = np.asarray(out).astype(np.int32)
                rec[f"drop{i}"] = np.asarray(m.last_drop_mask, np.int32)
        elif kind == "crash":
            m.crash_and_recover(seed=step[1])
            rec[f"hist{i}"] = np.asarray(m.last_recovery_hist_shards)
        elif kind == "snapshot":             # due at every step
            sn = sn or api.Snapshotter(m, snap_dir,
                                       api.SnapshotPolicy(every_steps=1))
            sn.maybe_snapshot()
            sn.wait()
        else:
            sn.recover()
            rec[f"hist{i}"] = np.asarray(m.last_recovery_hist_shards)
            rec["snapshot_step"] = np.asarray([sn.store.latest_step()])
            sn.close()
    m.pipeline_flush()
    for i, h in handles.items():
        if h.abandoned:
            rec[f"abandoned{i}"] = np.ones((1,), np.int32)
        else:
            rec[f"res{i}"] = np.asarray(h).astype(np.int32)
            rec[f"drop{i}"] = np.asarray(h.drop_mask, np.int32)
    rec["counters"] = np.asarray(
        [m.psyncs, m.ops, len(m), m.router_dropped, m.overflowed,
         m.pipeline_abandoned], np.int64)
    for f in FIELDS:
        rec[f"leaf_{f}"] = api.leaf(m.state, f)
    return rec, m


# ``torch.distributed`` calls that move data or wait for other ranks
COLLECTIVES = ("all_gather", "all_gather_into_tensor", "all_gather_object",
               "all_reduce", "gather", "broadcast", "broadcast_object_list",
               "barrier", "reduce", "scatter", "send", "recv", "isend",
               "irecv")
_WATCH = {"depth": 0, "bytes": [], "off_main": []}


def _nbytes(args) -> int:
    n = 0
    for a in args:
        if isinstance(a, torch.Tensor):
            n += a.numel() * a.element_size()
        elif isinstance(a, (list, tuple)):
            n += _nbytes(a)
    return n


@contextlib.contextmanager
def _watch_collectives():
    """Wrap every ``torch.distributed`` collective: a call off the main
    thread is recorded in ``_WATCH["off_main"]`` and raises; inside a
    snapshot call of :class:`_WatchedSnapshotter` the bytes of the tensors
    a call is given (sent and received) add to the call's entry of
    ``_WATCH["bytes"]``."""
    import torch.distributed as dist
    real = {n: getattr(dist, n) for n in COLLECTIVES if hasattr(dist, n)}

    def wrap(name, f):
        def call(*a, **k):
            if threading.current_thread() is not threading.main_thread():
                _WATCH["off_main"].append(name)
                raise AssertionError(f"dist.{name} off the main thread")
            if _WATCH["depth"]:
                _WATCH["bytes"][-1] += _nbytes(list(a) + list(k.values()))
            return f(*a, **k)
        return call
    _WATCH.update(depth=0, bytes=[], off_main=[])
    for n, f in real.items():
        setattr(dist, n, wrap(n, f))
    try:
        yield _WATCH
    finally:
        for n, f in real.items():
            setattr(dist, n, f)


class _WatchedSnapshotter(Snapshotter):
    """The port's :class:`Snapshotter`, its ``maybe_snapshot`` and ``wait``
    each counted as one entry of ``_WATCH["bytes"]``."""

    @contextlib.contextmanager
    def _counted(self):
        if not _WATCH["depth"]:
            _WATCH["bytes"].append(0)
        _WATCH["depth"] += 1
        try:
            yield
        finally:
            _WATCH["depth"] -= 1

    def maybe_snapshot(self, step=None):
        with self._counted():
            return super().maybe_snapshot(step)

    def wait(self):
        with self._counted():
            return super().wait()


class _TorchAPI:
    from repro_torch.core.engine import SetSpec
    from repro_torch.core.shard import ShardedDurableMap
    from repro_torch.store.snapshot import SnapshotPolicy
    Snapshotter = _WatchedSnapshotter
    map_kw = {"device": "cpu"}

    @staticmethod
    def leaf(state, f):
        return getattr(state, f).numpy().copy()


def _collected(reg, steps):
    """What a registry attached on every rank collects of the map, beside
    the number of recoveries the scenario's steps make."""
    got = reg.snapshot()["collected"]["sharded_map"]
    return (np.asarray([got["psyncs"], got["ops"], got["size"],
                        got["overflowed"], got["recoveries"]], np.int64),
            sum(step[0] in ("crash", "recover") for step in steps))


def _mesh_edges(rank, snap_root):
    """A map on the mesh that prints its rows with no collective, captures
    and builds only its rows (a 2-shard map: none on ranks 2 and 3), and
    refuses to commit a snapshot to a directory that is not shared: each
    rank snapshots to a directory of its own."""
    import torch.distributed as dist
    from repro_torch.core.engine import SetSpec
    from repro_torch.core.shard import ShardedDurableMap
    out = {}
    m = ShardedDurableMap(SetSpec(capacity=CAP, backend="bucket"),
                          n_shards=S, use_shard_map=True, device="cpu")
    m.insert(np.arange(40, dtype=np.int32))

    def no_collective(*a, **k):
        raise AssertionError("repr ran a collective")
    names = ("all_reduce", "all_gather", "gather", "broadcast", "barrier")
    real = {n: getattr(dist, n) for n in names}
    try:
        for n in names:
            setattr(dist, n, no_collective)
        out["repr"] = repr(m)
    finally:
        for n, f in real.items():
            setattr(dist, n, f)
    for s in (S, 2):
        two = ShardedDurableMap(SetSpec(capacity=CAP, backend="bucket"),
                                n_shards=s, use_shard_map=True, device="cpu")
        two.insert(np.arange(40, dtype=np.int32))
        st = two.state
        held = {"watermark": st.epoch, "raw_stage": st.flushed,
                "keys": st.keys, "values": st.values, "stamp": st.stamp}
        held = {f: t.numpy().copy() for f, t in held.items()}
        cap = two.snapshot_capture()
        planes, meta = two.snapshot_build(cap)
        out[f"capture{s}"] = {
            "rows": (cap["rows"].start, cap["rows"].stop),
            "held": (two.rows.start, two.rows.stop),
            "equal": [f for f in held if np.array_equal(cap[f], held[f])],
            "built": sorted({p.shape[0] for p in planes.values()}),
            "meta_rows": len(meta["watermark"])}
    sn = Snapshotter(m, os.path.join(snap_root, "own", str(rank)))
    try:
        sn.snapshot()
        sn.wait()
        sn.recover()
    except RuntimeError as e:
        out["unshared"] = str(e)
    sn.close()
    return out


def _single_writer(rank, snap_root, name, shard_kw):
    """A ``use_shard_map`` map whose rows every rank holds (D = 1),
    snapshotted six times through ``maybe_snapshot(every_steps=1)`` and
    recovered: the steps each ``wait()`` returned, what raised, the steps
    whose files this rank's store wrote (a whole ``save`` or rows), the
    step recovered through and a digest of the state."""
    import hashlib
    from repro_torch.core.engine import SetSpec
    from repro_torch.core.shard import ShardedDurableMap
    from repro_torch.store import checkpoint as CK
    from repro_torch.store.snapshot import SnapshotPolicy
    saves, cls = set(), CK.CheckpointManager
    real = {n: getattr(cls, n) for n in ("save", "write_rows")
            if hasattr(cls, n)}

    def counted(f):
        def call(self, step, *a, **k):
            saves.add(step)
            return f(self, step, *a, **k)
        return call
    out = {"waits": [], "raised": []}
    for n, f in real.items():
        setattr(cls, n, counted(f))
    try:
        m = ShardedDurableMap(SetSpec(capacity=CAP, backend="bucket"),
                              use_shard_map=True, device="cpu", **shard_kw)
        sn = Snapshotter(m, os.path.join(snap_root, "single", name),
                         SnapshotPolicy(every_steps=1))
        for _, ops, keys, vals in _batches(13, 6):
            m.apply(ops, keys, vals)
            try:
                sn.maybe_snapshot()
                out["waits"].append(sn.wait())
            except Exception as e:
                out["raised"].append(repr(e))
        m.apply(*_batches(14, 1)[0][1:])
        try:
            sn.recover()
        except Exception as e:
            out["raised"].append(repr(e))
        out["recovered"] = sn.store.latest_step()
        out["digest"] = hashlib.sha1(b"".join(
            t.numpy().tobytes() for t in m.state)).hexdigest()
        sn.close()
    finally:
        for n, f in real.items():
            setattr(cls, n, f)
    out["saves"] = sorted(saves)
    return out


def _slow_rank(rank, snap_root):
    """An 8-shard map on the mesh whose rank 2 builds each snapshot a
    second late: a snapshot, four more batches each with a cadence check
    (every step is due), ``wait()`` and recovery.  A hang ends the rank
    after 120 s (``faulthandler``), which fails the spawn."""
    from repro_torch.core.engine import SetSpec
    from repro_torch.core.shard import ShardedDurableMap
    from repro_torch.store.snapshot import SnapshotPolicy
    faulthandler.dump_traceback_later(120, exit=True)
    try:
        m = ShardedDurableMap(SetSpec(capacity=CAP, backend="bucket"),
                              n_shards=S, use_shard_map=True, device="cpu")
        if rank == 2:
            build = m.snapshot_build

            def slow(cap):
                time.sleep(1.0)
                return build(cap)
            m.snapshot_build = slow
        sn = Snapshotter(m, os.path.join(snap_root, "slow"),
                         SnapshotPolicy(every_steps=1))
        batches = _batches(15, 5)
        m.apply(*batches[0][1:])
        futures = [sn.maybe_snapshot()]
        polls = []
        for _, ops, keys, vals in batches[1:]:
            m.apply(ops, keys, vals)
            f = sn.maybe_snapshot()
            polls.append(f is not None)
            futures += [f] if f is not None else []
        waited = sn.wait()
        got = [f.result() for f in futures]
        sn.recover()
        out = {"polls": polls, "waited": waited, "futures": got,
               "recovered": sn.store.latest_step(),
               "committed": list(sn.store.committed)}
        sn.close()
        return out
    finally:
        faulthandler.cancel_dump_traceback_later()


SINGLE_WRITER = {"one_shard": dict(n_shards=1),
                 "groups2": dict(n_shards=S, n_device_groups=2)}


def torch_rank(rank, snap_root):
    """One rank of the port: every scenario with a metrics registry
    attached, with the storage rows this rank holds and its state's
    device, then an ``ElasticShardedMap`` on the mesh split from 8 to 16
    shards (``tests/test_torch_mesh_resize.py`` holds resizes against
    JAX), and the edges of :func:`_mesh_edges`."""
    from repro_torch.core.engine import SetSpec
    from repro_torch.core.resize import ElasticShardedMap
    from repro_torch.obs import MetricsRegistry
    out = {}
    for name in SCENARIOS:
        reg = MetricsRegistry()
        with _watch_collectives() as watch:
            rec, m = run_scenario(_TorchAPI, name,
                                  os.path.join(snap_root, name), metrics=reg)
        rec["off_main"] = list(watch["off_main"])
        rec["snapshot_bytes"] = list(watch["bytes"])
        rec["collected"], rec["recoveries"] = _collected(
            reg, SCENARIOS[name][2])
        rec["rows"] = np.asarray([m.rows.start, m.rows.stop], np.int64)
        rec["device"] = str(m.state.keys.device)
        # the crash adversary this rank applies to its rows (a facade
        # crash lands where cur == flushed, so no result shows it)
        rec["adversary"] = m._adversary(None, 3).numpy()
        out[name] = rec
    em = ElasticShardedMap(SetSpec(capacity=CAP), n_shards=S,
                           use_shard_map=True, device="cpu")
    keys = np.arange(40, dtype=np.int32)
    em.insert(keys)
    em.split()
    out["resize"] = (em.n_shards, len(em), em.map.rows,
                     bool(em.contains(keys).all()))
    out["edges"] = _mesh_edges(rank, snap_root)
    out["single"] = {n: _single_writer(rank, snap_root, n, kw)
                     for n, kw in SINGLE_WRITER.items()}
    out["slow"] = _slow_rank(rank, snap_root)
    return out


def _rows_of(name, rank):
    """The rows a rank holds in a scenario, by the mesh rule: D is the
    largest power of two dividing S with D <= 4 ranks, unless
    n_device_groups asks for another count (then every rank holds all)."""
    shard_kw = SCENARIOS[name][1]
    s = shard_kw.get("n_shards", S)
    d = min(s, RANKS)
    if shard_kw.get("n_device_groups", d) != d:
        return (0, s)
    per = s // d
    return (rank * per, (rank + 1) * per) if rank < d else (0, 0)


def jax_main(out_dir, names):
    """The JAX side, in a subprocess with 4 fake CPU devices: the named
    scenarios under ``use_shard_map``, their records saved to
    ``<out_dir>/<name>.npz``."""
    import jax
    from repro.core.engine import SetSpec
    from repro.core.shard import ShardedDurableMap
    from repro.store.snapshot import Snapshotter, SnapshotPolicy

    class API:
        map_kw = {}

        @staticmethod
        def leaf(state, f):
            return np.asarray(getattr(state, f))

    API.SetSpec, API.ShardedDurableMap = SetSpec, ShardedDurableMap
    API.Snapshotter, API.SnapshotPolicy = Snapshotter, SnapshotPolicy
    assert jax.device_count() == RANKS, jax.device_count()
    os.makedirs(out_dir, exist_ok=True)
    for name in names:
        rec, m = run_scenario(API, name, os.path.join(out_dir, "snap", name))
        s = m.n_shards
        if "n_device_groups" not in SCENARIOS[name][1]:
            # the state is partitioned over the mesh of min(S, 4) devices
            got = len(m.state.keys.sharding.device_set)
            assert got == min(s, RANKS), (name, got)
        np.savez(os.path.join(out_dir, f"{name}.npz"), **rec)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    # compiling is most of the JAX side's time: XLA's optimizations, which
    # change no integer result, cost a third of it
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_DISABLE_MOST_OPTIMIZATIONS="1",
               PYTHONPATH=os.pathsep.join([SRC, HERE]),
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") +
                          " --xla_force_host_platform_device_count="
                          f"{RANKS}").strip())
    jax_dir = str(tmp / "jax")
    # the JAX side is bound by compiling ~6 programs a scenario: two
    # subprocesses take half the scenarios each
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import test_torch_mesh as t; "
         f"t.jax_main({jax_dir!r}, {list(SCENARIOS)[i::2]!r})"],
        env=env, cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(2)]
    try:
        ranks = spawn(torch_rank, RANKS, str(tmp / "torch"))
    except BaseException:
        for proc in procs:
            proc.kill()
            proc.communicate()
        raise
    for proc in procs:
        log, _ = proc.communicate(timeout=900)
        assert proc.returncode == 0, log[-4000:]
    jax = {n: dict(np.load(os.path.join(jax_dir, f"{n}.npz")))
           for n in SCENARIOS}
    return jax, ranks, tmp


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_mesh_ranks_match_jax_shard_map(runs, name):
    jax, ranks, _ = runs
    want = jax[name]
    for rank, out in enumerate(ranks):
        got = out[name]
        lo, hi = got["rows"]
        assert (lo, hi) == _rows_of(name, rank)
        for f in FIELDS:
            w = want[f"leaf_{f}"][lo:hi]
            g = got[f"leaf_{f}"]
            assert g.dtype == w.dtype and g.shape == w.shape, (
                rank, f, g.dtype, w.dtype, g.shape, w.shape)
            np.testing.assert_array_equal(g, w, err_msg=f"rank {rank} {f}")
        assert got["device"] == "cpu"
        u = np.random.default_rng(3).random(
            want["leaf_cur"].shape).astype(np.float32)   # JAX's draw, seed 3
        np.testing.assert_array_equal(got["adversary"], u[lo:hi])
        keys = {k for k in want if not k.startswith("leaf_")}
        assert keys == {k for k in got if not k.startswith("leaf_")
                        and k not in ("rows", "device", "adversary",
                                      "collected", "recoveries",
                                      "off_main", "snapshot_bytes")}, rank
        for k in keys:
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"rank {rank} {k}")


def test_mesh_scenarios_drop_crash_and_snapshot(runs):
    """The scenarios reach what they are for: lanes dropped, a batch
    abandoned, the snapshot recovered through, rows on every rank."""
    jax, ranks, tmp = runs
    for name in ("v1", "capped"):
        assert jax[name]["counters"][3] > 0, name
    assert jax["pipelined"]["counters"][5] == 1
    assert any(k.startswith("abandoned") for k in jax["pipelined"])
    assert jax["snapshot"]["snapshot_step"][0] == 2
    for out in ranks:
        assert out["snapshot"]["snapshot_step"][0] == 2
    assert [tuple(o["two_shards"]["rows"]) for o in ranks] == \
        [(0, 1), (1, 2), (0, 0), (0, 0)]
    assert [o["resize"] for o in ranks] == [
        (2 * S, 40, range(4 * r, 4 * r + 4), True) for r in range(RANKS)]
    # every rank wrote its rows into the files a one-device map writes
    names = sorted(os.listdir(tmp / "torch" / "snapshot"))
    assert names == sorted(os.listdir(tmp / "jax" / "snap" / "snapshot"))
    step = [n for n in names if n.startswith("step_")]
    assert step and sorted(os.listdir(tmp / "torch" / "snapshot" /
                                      step[0])) == \
        sorted(os.listdir(tmp / "jax" / "snap" / "snapshot" / step[0]))


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_mesh_metrics_on_every_rank_match_jax(runs, name):
    """A registry attached on every rank collects the whole map's psyncs,
    ops, size and overflow latch -- JAX's -- and counts the recoveries."""
    jax, ranks, _ = runs
    psyncs, ops, size, _, overflowed, _ = jax[name]["counters"]
    for rank, out in enumerate(ranks):
        got = out[name]
        np.testing.assert_array_equal(
            got["collected"],
            [psyncs, ops, size, overflowed, got["recoveries"]],
            err_msg=f"rank {rank}")
        assert got["recoveries"] > 0


def test_mesh_repr_capture_and_unshared_snapshot_directory(runs):
    """``repr`` shows a rank's own rows with no collective; a capture holds
    exactly the rows the rank holds; a snapshot to a directory that the
    ranks do not share raises on every rank."""
    _, ranks, _ = runs
    for rank, out in enumerate(ranks):
        edges = out["edges"]
        lo, hi = 2 * rank, 2 * rank + 2
        assert f"rank={rank}, rows={lo}:{hi}, local_size=" in \
            edges["repr"], edges["repr"]
        cap = edges[f"capture{S}"]
        assert cap["rows"] == cap["held"] == (lo, hi), (rank, cap)
        assert len(cap["equal"]) == 5, (rank, cap)
        assert "every rank of a mesh must snapshot to one directory" in \
            edges.get("unshared", ""), (rank, edges)


def test_mesh_capture_and_build_hold_only_the_rank_rows(runs):
    """Each rank captures and builds exactly its rows: 2 of 8 shards on
    every rank; of a 2-shard map one row on ranks 0 and 1, none on ranks 2
    and 3 (past D)."""
    _, ranks, _ = runs
    for rank, out in enumerate(ranks):
        for s, per in ((S, S // RANKS), (2, 1)):
            cap = out["edges"][f"capture{s}"]
            want = ((rank * per, (rank + 1) * per) if rank * per < s
                    else (0, 0))
            k = want[1] - want[0]
            assert cap["rows"] == cap["held"] == want, (rank, s, cap)
            assert len(cap["equal"]) == 5, (rank, s, cap)
            assert cap["built"] == ([k] if k else []), (rank, s, cap)
            assert cap["meta_rows"] == k, (rank, s, cap)


@pytest.mark.parametrize("name", list(SINGLE_WRITER))
def test_mesh_map_with_every_row_on_every_rank_has_one_writer(runs, name):
    """Where every rank holds every row (one shard; ``n_device_groups`` 2
    on 4 ranks), rank 0 alone writes each step's files, every rank's
    ``wait()`` returns it, no rank raises, and every rank recovers through
    the same step to the same state."""
    _, ranks, _ = runs
    got = [out["single"][name] for out in ranks]
    for rank, g in enumerate(got):
        assert g["raised"] == [], (rank, g["raised"])
        assert g["waits"] == list(range(1, 7)), (rank, g["waits"])
        assert g["recovered"] == 6, (rank, g)
        assert g["digest"] == got[0]["digest"], rank
    assert [g["saves"] for g in got] == [list(range(1, 7))] + [[]] * 3


def test_mesh_snapshot_runs_no_collective_off_the_main_thread(runs):
    """Every ``torch.distributed`` call of every scenario, the snapshot's
    included, ran on a rank's main thread."""
    _, ranks, _ = runs
    for rank, out in enumerate(ranks):
        for name in SCENARIOS:
            assert out[name]["off_main"] == [], (rank, name)


def test_mesh_snapshot_collectives_carry_only_meta(runs):
    """Each snapshot call's collectives (``maybe_snapshot`` with its
    capture, ``wait`` with its commit) move at most the meta -- every
    rank's status and its rows' watermark and (S/D, 5) histogram, sent and
    received, in int32 -- and a few 8-byte control words, never a plane."""
    _, ranks, _ = runs
    per = S // RANKS
    meta = 4 * 2 * RANKS * (3 + 6 * per)
    plane = 4 * S * (CAP // S)              # one (S, N) int32 plane
    assert meta + 8 * 8 < plane
    for rank, out in enumerate(ranks):
        # 2 x (maybe_snapshot, wait), then close's wait with nothing left
        calls = out["snapshot"]["snapshot_bytes"]
        assert len(calls) == 5 and calls[4] == 0, (rank, calls)
        for i in (0, 2):
            assert 0 < calls[i] + calls[i + 1] <= meta + 8 * 8, (rank, calls)


def test_mesh_slow_rank_neither_hangs_nor_reports_an_uncommitted_step(runs):
    """Rank 2 builds a second late: the cadence checks while it builds
    commit nothing and start nothing, alike on every rank; every rank's
    ``wait()``, futures and recovery agree on the step that was
    committed."""
    _, ranks, _ = runs
    got = [out["slow"] for out in ranks]
    for rank, g in enumerate(got):
        assert g["polls"] == got[0]["polls"], (rank, g)
        assert g["polls"][0] is False, (rank, g)
        assert g["futures"] == got[0]["futures"], (rank, g)
        assert g["futures"][-1] == g["waited"] == g["recovered"], (rank, g)
        assert g["waited"] == got[0]["waited"], (rank, g)
    assert got[0]["futures"] == list(range(1, 1 + len(got[0]["futures"])))
    assert got[0]["waited"] in got[0]["committed"]


def test_mesh_snapshot_files_equal_jax_byte_for_byte(runs):
    """The snapshot scenario's stored ``.npy`` files, written by every
    rank for its rows, are the JAX run's byte for byte, and the manifests
    (leaves and ``extra``: the watermark and the stage histograms) are
    equal."""
    _, _, tmp = runs
    mine, theirs = tmp / "torch" / "snapshot", tmp / "jax" / "snap" / \
        "snapshot"
    steps = sorted(n for n in os.listdir(theirs) if n.startswith("step_"))
    assert steps == sorted(n for n in os.listdir(mine)
                           if n.startswith("step_")) and steps
    for step in steps:
        files = sorted(os.listdir(theirs / step))
        assert files == sorted(os.listdir(mine / step))
        for fn in files:
            a, b = (d / step / fn for d in (mine, theirs))
            if fn == "manifest.json":
                ma, mb = (json.loads(x.read_bytes()) for x in (a, b))
                assert ma["leaves"] == mb["leaves"], step
                assert ma["extra"] == mb["extra"], step
            else:
                assert a.read_bytes() == b.read_bytes(), (step, fn)


def test_mesh_rank_device(monkeypatch):
    """A rank's device: ``cuda:(rank % device_count)`` for a bare "cuda",
    what the caller names otherwise."""
    from repro_torch.launch.mesh import ShardMesh
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = ShardMesh(rank=3, world=4, group=None)
    assert mesh.device("cuda") == torch.device("cuda", 1)
    assert mesh.device("cuda:0") == torch.device("cuda", 0)
    assert mesh.device("cpu") == torch.device("cpu")
    assert mesh.rows(8, 4) == range(6, 8) and mesh.rows(2, 2) == range(0)
