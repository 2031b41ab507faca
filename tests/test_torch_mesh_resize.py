"""The port's online resize and ``load_resharded`` over 4 ``gloo`` ranks
against the JAX package's under ``shard_map`` over 4 fake CPU devices.

The same seeded scenarios (64 slots a shard, 32-lane batches,
``migrate_chunk`` 16, the bucket and the probe backend) run in two JAX
subprocesses with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``,
one backend each, and in one spawn of 4 ranks of the port
(``repro_torch.launch.mesh.spawn``), each rank on the CPU, all at the same
time.  Every map is built with ``use_shard_map=True``: over 4 ranks a map
of S shards holds its rows on D = min(S, 4) ranks, so rows move between
ranks wherever S crosses 4.

  split     an online split 2 -> 4 (D 2 -> 4) with a mixed batch, a
            ``get`` and a ``contains`` between ``step()``s, then 4 -> 8
            (D fixed: each parent's children stay on its rank);
  merges    an online merge 8 -> 4 under reads and removes, blocking
            merges 4 -> 2 -> 1 (D 4 -> 2 -> 1), and a split 1 -> 2 from
            the state that every rank holds;
  crashes   a crash right after ``begin_split``, mid-copy, right after
            the first commit and mid-merge, each migration then finished;
  capacity  ``ResizeCapacityError`` at ``begin_merge`` and at the commit
            (inserts after the begin overfill the pair), then a drain and
            the merge finished;
  load      ``load_resharded`` of a 4-shard mesh snapshot at 2, 8 and 16
            shards, elastic and not.

Every rank's rows of every leaf of ``map`` and ``target`` must equal the
JAX global leaves' rows at every checkpoint, and every rank's results,
``psyncs``, ``ops``, ``len``, ``overflowed``, ``migration_psyncs``,
``migrated_nodes``, the frontier's fields and the recovery histograms must
equal JAX's, bit for bit.  A rank asked for its index of a row that it
does not hold raises."""
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
B, PER, CHUNK, KEY_RANGE = 32, 64, 16, 120
BACKENDS = ("bucket", "probe")
FIELDS = ("keys", "values", "cur", "flushed", "stamp", "table", "bkeys",
          "bids", "skeys", "sids", "stash_n", "n_psync", "n_ops", "size",
          "overflow", "epoch")
PHASES = ("idle", "split", "merge")


def _batch(rng, p=(0.4, 0.4, 0.2), key_range=KEY_RANGE):
    ops = rng.choice(3, B, p=p).astype(np.int32)
    keys = rng.integers(0, key_range, B).astype(np.int32)
    return ops, keys, (keys * 5 + 3).astype(np.int32)


def _fill(seed, n, key_range=KEY_RANGE):
    keys = np.random.default_rng([seed, 41]).choice(
        key_range, n, replace=False).astype(np.int32)
    return [("insert", keys[i:i + B]) for i in range(0, n, B)]


SCENARIOS = {
    "split": [("new", 2)] + _fill(1, 48)
    + [("online", "split", (1, (0.4, 0.4, 0.2))), ("check",),
       ("online", "split", (2, (0.5, 0.3, 0.2))), ("check",)],
    # a merge's traffic inserts nothing, so the merged shard holds both
    # siblings (as tests/test_torch_resize.py's live merge)
    "merges": [("new", 8)] + _fill(4, 40)
    + [("online", "merge", (4, (0.7, 0.0, 0.3))), ("check",),
       ("merge",), ("check",), ("merge",), ("check",),
       ("split",), ("check",)],
    "crashes": [("new", 2)] + _fill(6, 56)
    + [("begin_split",), ("crash", 60), ("check",),
       ("step",), ("step",), ("crash", 61), ("check",),
       ("until_commit",), ("crash", 62), ("check",),
       ("finish",), ("check",),
       ("begin_merge",), ("step",), ("step",), ("step",), ("crash", 63),
       ("check",), ("finish",), ("check",)],
    "capacity": [("new", 2)] + _fill(8, 72)
    + [("begin_merge",), ("check",), ("remove", 8, 24), ("begin_merge",),
       ("step",), ("insert_more", 9, 40), ("until_commit",), ("check",),
       ("remove", 9, 40), ("until_commit",), ("finish",), ("check",)],
    "load": [("snapshot", 4, 10)]
    + [("load", s, el) for s in (2, 8, 16) for el in (True, False)],
}


def _counters(api, m):
    """Every host-side count of an elastic map (collectives on a mesh)."""
    f = m.frontier
    return np.asarray(
        [m.n_shards, m.psyncs, m.ops, len(m), m.overflowed,
         m.migration_psyncs, m.migrated_nodes, m.splits, m.merges,
         m.router_dropped, f.committed, f.units, f.psyncs,
         PHASES.index(f.phase), m.migrating, m.target is not None],
        np.int64)


def run_scenario(api, backend, name, snap_dir):
    """Drive one scenario through either package (``api``: its
    ``ElasticShardedMap``, ``ShardedDurableMap``, ``SetSpec``,
    ``Snapshotter``, ``load_resharded``, ``ResizeCapacityError``).
    Returns the records as int arrays: results, counters, histograms,
    refusals, and at each ``check`` the leaves of ``map`` and ``target``
    (``leaf{i}_map_<field>``) with the rows this process holds of each
    (``rows{i}_map``)."""
    rec, m = {}, None

    def spec(s):
        return api.SetSpec(capacity=PER * s, backend=backend)

    def new_map(s):
        return api.ElasticShardedMap(spec(s), n_shards=s,
                                     migrate_chunk=CHUNK, use_shard_map=True,
                                     **api.map_kw)

    def traffic(tag, seed, p):
        r = np.random.default_rng([seed, 42, int(tag.split(".")[-1])])
        ops, keys, vals = _batch(r, p)
        rec[f"res{tag}"] = np.asarray(m.apply(ops, keys, vals), np.int32)
        rec[f"get{tag}"] = np.asarray(m.get(keys[::-1], default=-9),
                                      np.int32)
        rec[f"has{tag}"] = np.asarray(m.contains(keys + 1), np.int32)

    def check(tag, mm, inner=None):
        maps = {"map": inner} if inner is not None else {"map": mm.map}
        if inner is None and mm.target is not None:
            maps["target"] = mm.target
        for k, x in maps.items():
            rec[f"rows{tag}_{k}"] = np.asarray(api.rows(x), np.int64)
            for f in FIELDS:
                rec[f"leaf{tag}_{k}_{f}"] = api.leaf(x.state, f)

    def step_until(tag, stop):
        j = 0
        while True:
            try:
                done = m.step()
            except api.ResizeCapacityError:
                rec[f"refused{tag}.{j}"] = np.ones((1,), np.int32)
                return
            rec[f"ctr{tag}.{j}"] = _counters(api, m)
            j += 1
            if done or stop():
                return

    for i, st in enumerate(SCENARIOS[name]):
        kind, tag = st[0], str(i)
        if kind == "new":
            m = new_map(st[1])
        elif kind in ("insert", "remove") and len(st) == 2:
            out = getattr(m, kind)(st[1]) if kind == "remove" else \
                m.insert(st[1], st[1] * 7 + 1)
            rec[f"res{tag}"] = np.asarray(out, np.int32)
        elif kind in ("insert_more", "remove"):
            keys = np.random.default_rng([st[1], 43]).choice(
                KEY_RANGE, st[2], replace=False).astype(np.int32)
            for j in range(0, keys.size, B):
                k = keys[j:j + B]
                out = m.insert(k, k * 11) if kind == "insert_more" else \
                    m.remove(k)
                rec[f"res{tag}.{j}"] = np.asarray(out, np.int32)
        elif kind == "online":
            getattr(m, f"begin_{st[1]}")()
            seed, p = st[2]
            j = 0
            while not m.step():
                rec[f"ctr{tag}.{j}"] = _counters(api, m)
                traffic(f"{tag}.{j}", seed, p)
                j += 1
        elif kind in ("begin_split", "begin_merge"):
            try:
                getattr(m, kind)()
            except api.ResizeCapacityError:
                rec[f"refused{tag}"] = np.ones((1,), np.int32)
        elif kind == "step":
            rec[f"done{tag}"] = np.asarray([m.step()], np.int32)
        elif kind == "until_commit":
            f0 = m.frontier.committed
            step_until(tag, lambda: m.frontier.committed != f0)
        elif kind == "finish":
            step_until(tag, lambda: False)
        elif kind in ("split", "merge"):
            getattr(m, kind)()
        elif kind == "crash":
            m.crash_and_recover(seed=st[1])
            rec[f"hist{tag}"] = np.asarray(m.last_recovery_hist, np.int64)
        elif kind == "check":
            check(tag, m)
        elif kind == "snapshot":
            # a probe map cannot snapshot: both backends reload the
            # pool planes of a bucket map's snapshot
            src = api.ShardedDurableMap(
                api.SetSpec(capacity=PER * st[1], backend="bucket"),
                n_shards=st[1], use_shard_map=True, **api.map_kw)
            for op in _fill(st[2], 96):
                src.insert(op[1], op[1] * 13)
            sn = api.Snapshotter(src, snap_dir)
            sn.snapshot()
            sn.wait()
            src.remove(np.arange(B, dtype=np.int32))  # after the snapshot
            sn.close()
        elif kind == "load":
            s, elastic = st[1], st[2]
            lm = api.load_resharded(snap_dir, spec(s), s, elastic=elastic,
                                    use_shard_map=True, **api.map_kw)
            inner = lm.map if elastic else lm
            check(tag, None, inner)
            rec[f"hist{tag}"] = np.asarray(inner.last_recovery_hist_shards,
                                           np.int64)
            rec[f"ctr{tag}"] = np.asarray([len(lm), lm.psyncs,
                                           lm.n_shards], np.int64)
            keys = np.arange(KEY_RANGE, dtype=np.int32)
            rec[f"read{tag}"] = np.concatenate(
                [np.asarray(lm.get(keys[j:j + B], default=-1), np.int32)
                 for j in range(0, keys.size, B)])
        if m is not None and kind not in ("new", "snapshot", "load"):
            rec[f"ctr{tag}"] = _counters(api, m)
    return rec


class _TorchAPI:
    from repro_torch.core.engine import SetSpec
    from repro_torch.core.resize import (ElasticShardedMap,
                                         ResizeCapacityError)
    from repro_torch.core.shard import ShardedDurableMap
    from repro_torch.store.snapshot import Snapshotter, load_resharded
    map_kw = {"device": "cpu"}

    @staticmethod
    def leaf(state, f):
        return getattr(state, f).numpy().copy()

    @staticmethod
    def rows(m):
        return [m.rows.start, m.rows.stop]


def _not_held(rank):
    """A rank of an 8-shard mesh map asked for its index of a row it does
    not hold, and of one it holds."""
    from repro_torch.core.engine import SetSpec
    from repro_torch.core.resize import ElasticShardedMap
    m = ElasticShardedMap(SetSpec(capacity=8 * PER), n_shards=8,
                          use_shard_map=True, device="cpu")
    out = {"held": m.map.local_row(2 * rank + 1)}
    try:
        m.map.local_row((2 * rank + 2) % 8)
    except IndexError as e:
        out["not_held"] = str(e)
    return out


def torch_rank(rank, snap_root):
    """One rank of the port: every scenario on both backends, then the
    row-index probe."""
    out = {(b, n): run_scenario(_TorchAPI, b, n,
                                os.path.join(snap_root, f"{b}_{n}"))
           for b in BACKENDS for n in SCENARIOS}
    out["not_held"] = _not_held(rank)
    return out


def jax_main(out_dir, backend):
    """The JAX side, in a subprocess with 4 fake CPU devices: every
    scenario on one backend, its records saved to
    ``<out_dir>/<backend>_<name>.npz``."""
    import jax
    from repro.core.engine import SetSpec
    from repro.core.resize import ElasticShardedMap, ResizeCapacityError
    from repro.core.shard import ShardedDurableMap
    from repro.store.snapshot import Snapshotter, load_resharded

    class API:
        map_kw = {}

        @staticmethod
        def leaf(state, f):
            return np.asarray(getattr(state, f))

        @staticmethod
        def rows(m):
            return [0, m.n_shards]

    API.SetSpec, API.ElasticShardedMap = SetSpec, ElasticShardedMap
    API.ShardedDurableMap, API.Snapshotter = ShardedDurableMap, Snapshotter
    API.load_resharded = staticmethod(load_resharded)
    API.ResizeCapacityError = ResizeCapacityError
    assert jax.device_count() == RANKS, jax.device_count()
    os.makedirs(out_dir, exist_ok=True)
    for name in SCENARIOS:
        rec = run_scenario(API, backend, name,
                           os.path.join(out_dir, "snap", f"{backend}_{name}"))
        np.savez(os.path.join(out_dir, f"{backend}_{name}.npz"), **rec)


def _rows_of(s, rank):
    """The rows a rank holds of an S-shard mesh map: D = min(S, 4), the
    rank's block of S/D, none past rank D - 1 (every rank holds the one
    row at S = 1)."""
    d = min(s, RANKS)
    if d == 1:
        return (0, s)
    per = s // d
    return (rank * per, (rank + 1) * per) if rank < d else (0, 0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_resize")
    # compiling is most of the JAX side's time: XLA's optimizations, which
    # change no integer result, cost a third of it
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_DISABLE_MOST_OPTIMIZATIONS="1",
               PYTHONPATH=os.pathsep.join([SRC, HERE]),
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") +
                          " --xla_force_host_platform_device_count="
                          f"{RANKS}").strip())
    jax_dir = str(tmp / "jax")
    # the JAX side is bound by compiling a program for each geometry and
    # each committed row: one subprocess per backend
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import test_torch_mesh_resize as t; "
         f"t.jax_main({jax_dir!r}, {b!r})"],
        env=env, cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for b in BACKENDS]
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
    jax = {(b, n): dict(np.load(os.path.join(jax_dir, f"{b}_{n}.npz")))
           for b in BACKENDS for n in SCENARIOS}
    return jax, ranks


CASES = [(b, n) for b in BACKENDS for n in SCENARIOS]


@pytest.mark.parametrize("backend,name", CASES)
def test_mesh_resize_ranks_match_jax_shard_map(runs, backend, name):
    jax, ranks = runs
    want = jax[(backend, name)]
    for rank, out in enumerate(ranks):
        got = out[(backend, name)]
        assert set(got) == set(want), (rank, set(got) ^ set(want))
        for k, w in want.items():
            if k.startswith("rows"):
                continue
            if k.startswith("leaf"):
                tag, which = k[4:].split("_")[:2]
                lo, hi = got[f"rows{tag}_{which}"]
                assert (lo, hi) == _rows_of(w.shape[0], rank), (rank, k)
                w = w[lo:hi]
            g = got[k]
            assert g.dtype == w.dtype and g.shape == w.shape, (
                rank, k, g.dtype, w.dtype, g.shape, w.shape)
            np.testing.assert_array_equal(g, w, err_msg=f"rank {rank} {k}")


def test_mesh_resize_scenarios_reach_what_they_are_for(runs):
    """Rows move between ranks (S crosses 4 both ways), the state at S = 1
    is every rank's, a crash lands mid-copy, the merge refuses at begin
    and at the commit, and each reload holds the snapshot's keys."""
    jax, ranks = runs
    for b in BACKENDS:
        split = jax[(b, "split")]
        shards = {int(v[0]) for k, v in split.items() if k.startswith("ctr")}
        assert shards == {2, 4, 8}, shards
        merges = jax[(b, "merges")]
        sizes = [v.shape[0] for k, v in merges.items()
                 if k.startswith("leaf") and k.endswith("_map_keys")]
        assert sizes == [4, 2, 1, 2], sizes
        at_one = [i for i, st in enumerate(SCENARIOS["merges"])
                  if st[0] == "check"][2]
        assert ranks[3][(b, "merges")][f"rows{at_one}_map"].tolist() == \
            [0, 1]
        cap = jax[(b, "capacity")]
        assert sum(k.startswith("refused") for k in cap) == 2, b
        # the second crash: two chunks into unit 0 (begin + 2 chunk
        # psyncs), nothing committed
        second = [i for i, st in enumerate(SCENARIOS["crashes"])
                  if st[0] == "crash"][1]
        mid = jax[(b, "crashes")][f"ctr{second - 1}"]
        assert (mid[5], mid[10], mid[13]) == (3, 0, 1), mid
        load = jax[(b, "load")]
        for i in range(1, 7):
            n, psyncs, s = load[f"ctr{i}"]
            assert psyncs == 0 and s in (2, 8, 16) and n > 0
            assert (load[f"read{i}"] >= 0).sum() == n


def test_mesh_resize_refuses_a_row_it_does_not_hold(runs):
    _, ranks = runs
    for rank, out in enumerate(ranks):
        got = out["not_held"]
        assert got["held"] == 1, rank
        assert "is not held here" in got.get("not_held", ""), rank
