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
collective; only rank 0 receives a snapshot's whole capture; and recovery
through a snapshot directory the ranks do not share raises on every rank."""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.mesh import spawn  # noqa: E402

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


class _TorchAPI:
    from repro_torch.core.engine import SetSpec
    from repro_torch.core.shard import ShardedDurableMap
    from repro_torch.store.snapshot import Snapshotter, SnapshotPolicy
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
    the whole planes on rank 0 alone, and refuses to recover through a
    snapshot directory that is not shared: each rank snapshots to a
    directory of its own."""
    import torch.distributed as dist
    from repro_torch.core.engine import SetSpec
    from repro_torch.core.shard import ShardedDurableMap
    from repro_torch.store.snapshot import Snapshotter
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
    cap = m.snapshot_capture()
    out["capture"] = [cap[f] is not None for f in
                      ("watermark", "raw_stage", "keys", "values", "stamp")]
    sn = Snapshotter(m, os.path.join(snap_root, "own", str(rank)))
    sn.snapshot()
    sn.wait()
    try:
        sn.recover()
    except RuntimeError as e:
        out["unshared"] = str(e)
    sn.close()
    return out


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
        rec, m = run_scenario(_TorchAPI, name, os.path.join(snap_root, name),
                              metrics=reg)
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
    env = dict(os.environ, JAX_PLATFORMS="cpu",
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
                                      "collected", "recoveries")}, rank
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
    # rank 0 alone wrote, the files a one-device map writes
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
    """``repr`` shows a rank's own rows with no collective; only rank 0
    receives the whole capture; recovery through a snapshot directory
    that the ranks do not share raises on every rank."""
    _, ranks, _ = runs
    for rank, out in enumerate(ranks):
        edges = out["edges"]
        lo, hi = 2 * rank, 2 * rank + 2
        assert f"rank={rank}, rows={lo}:{hi}, local_size=" in \
            edges["repr"], edges["repr"]
        assert edges["capture"] == [rank == 0] * 5, (rank, edges)
        assert "every rank of a mesh must snapshot to one directory" in \
            edges.get("unshared", ""), (rank, edges)


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
