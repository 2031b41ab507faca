"""The port's online resize against the JAX package's, on the CPU.

The same seeded batches (numpy) go through ``repro.core.resize`` and
``repro_torch.core.resize`` at ``tests/test_resize.py``'s small sizes
(capacity 256 or 512, 2 shards, ``migrate_chunk`` 64, so every unit takes
several chunks): the plane functions; a quiescent split and merge on all
three backends, every state leaf bit-identical to JAX's
``ElasticShardedMap`` and to the offline rebuild; a live split and merge
under traffic with per-batch results, ``psyncs``, ``migration_psyncs``,
the frontier sequence and ``migrated_nodes`` equal step by step; a crash
at every split and merge step, both maps crashed in lockstep; the merge
refusal and the facade's constraints; a strided resize over 2 device
groups, which loses keys in JAX and which the port refuses;
``load_resharded`` at 1 and 4 shards from a snapshot that each package
wrote; the elastic overflow message; and the serve CLI's ``--autosplit``
lines.  The JAX side runs as
its own tests run it (Pallas kernels in interpret mode)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import resize as JR  # noqa: E402
from repro.core import shard as JS  # noqa: E402
from repro.core.engine import SetSpec as JSpec  # noqa: E402
from repro.store import snapshot as JSN  # noqa: E402
from repro_torch.core import engine as TE  # noqa: E402
from repro_torch.core import resize as TR  # noqa: E402
from repro_torch.core import shard as TS  # noqa: E402
from repro_torch.core.convert import state_to_numpy  # noqa: E402
from repro_torch.core.engine import (OP_CONTAINS, OP_INSERT,  # noqa: E402
                                     OP_REMOVE, SetSpec as TSpec)
from repro_torch.core.nvm import FREE, VALID  # noqa: E402
from repro_torch.store import snapshot as TSN  # noqa: E402

BACKENDS = ("probe", "scan", "bucket")
PLANES = ("stage", "keys", "values", "stamp")
B = 32                                  # lanes per traffic batch


def pair(backend="probe", capacity=256, n_shards=2, migrate_chunk=64):
    """The same elastic map in both packages (the port's on the CPU)."""
    jm = JR.ElasticShardedMap(JSpec(capacity=capacity, backend=backend),
                              n_shards=n_shards, migrate_chunk=migrate_chunk)
    tm = TR.ElasticShardedMap(TSpec(capacity=capacity, backend=backend),
                              n_shards=n_shards, migrate_chunk=migrate_chunk,
                              device="cpu")
    return jm, tm


def assert_states_equal(got, want, what=""):
    """Every stacked leaf (shape and dtype too) of the port's state equals
    the JAX one."""
    got = state_to_numpy(got)
    for f, w in zip(want._fields, want):
        w = np.asarray(w)
        assert got[f].dtype == w.dtype and got[f].shape == w.shape, (what, f)
        np.testing.assert_array_equal(got[f], w, err_msg=f"{what} leaf {f}")


def assert_elastic_equal(jm, tm):
    assert_states_equal(tm.map.state, jm.map.state, "map")
    assert (tm.target is None) == (jm.target is None)
    if tm.target is not None:
        assert_states_equal(tm.target.state, jm.target.state, "target")
    f, g = tm.frontier, jm.frontier
    assert (f.phase, f.committed, f.units, f.psyncs) == \
        (g.phase, g.committed, g.units, g.psyncs)
    for k in ("n_shards", "psyncs", "ops", "migration_psyncs",
              "migrated_nodes", "splits", "merges", "overflowed",
              "migrating", "router_dropped"):
        assert getattr(tm, k) == getattr(jm, k), k
    assert len(tm) == len(jm)


def mixed(rng, key_range, p=(0.4, 0.4, 0.2)):
    """A 32-lane mixed batch; keys may repeat inside it."""
    ops = rng.choice(np.array([OP_CONTAINS, OP_INSERT, OP_REMOVE],
                              np.int32), B, p=p)
    keys = rng.integers(0, key_range, B).astype(np.int32)
    return ops, keys, (keys * 2).astype(np.int32)


def content(m, key_range):
    return np.asarray(m.get(np.arange(key_range, dtype=np.int32),
                            default=-1))


def in_batches(m, fn, keys, *more):
    """``fn`` over 32-lane slices of ``keys`` (and ``more``), results
    joined: the JAX side compiles one program for the batch shape."""
    return np.concatenate([
        np.asarray(getattr(m, fn)(keys[i:i + B],
                                  *(x[i:i + B] for x in more)))
        for i in range(0, keys.size, B)])


def both(jm, tm, fn, *args):
    got = in_batches(tm, fn, *args)
    np.testing.assert_array_equal(got, in_batches(jm, fn, *args))
    return got


# ---------------------------------------------------------------------------
# The plane functions
# ---------------------------------------------------------------------------


def _planes(rng, s, n, fill=0.5):
    """Random stacked pool planes whose live keys sit in their own shard."""
    keys = rng.choice(1 << 20, (s, n), replace=False).astype(np.int32)
    sid = TS.np_shard_of(keys.reshape(-1), s).reshape(s, n)
    ok = (rng.random((s, n)) < fill) & (sid == np.arange(s)[:, None])
    stage = np.where(ok, VALID, rng.choice([FREE, 1, 2, 4], (s, n)))
    return {"stage": stage.astype(np.int32),
            "keys": np.where(ok | (rng.random((s, n)) < .3), keys, 0)
            .astype(np.int32),
            "values": (keys * 3).astype(np.int32),
            "stamp": rng.integers(0, 9, (s, n)).astype(np.int32)}


@pytest.mark.parametrize("s,t", [(1, 2), (2, 4), (4, 2), (4, 1), (2, 8),
                                 (8, 8)])
def test_plane_functions_match_jax(s, t):
    rng = np.random.default_rng([s, t])
    planes = _planes(rng, s, 64, fill=0.3 if t < s else 0.5)
    got = TR.reshard_planes(planes, s, t)
    want = JR.reshard_planes(planes, s, t)
    for k in PLANES:
        assert got[k].dtype == np.int32 and got[k].shape == (t, 64)
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    if s < t:
        one = TR.split_planes(planes, s)
        for k, v in JR.split_planes(planes, s).items():
            np.testing.assert_array_equal(one[k], np.asarray(v), err_msg=k)
    if s > 1:
        one = TR.merge_planes(planes, s)
        for k, v in JR.merge_planes(planes, s).items():
            np.testing.assert_array_equal(one[k], np.asarray(v), err_msg=k)


def test_plane_functions_refuse_what_jax_refuses():
    planes = _planes(np.random.default_rng(0), 2, 8)
    for mod in (TR, JR):
        with pytest.raises(ValueError):
            mod.reshard_planes(planes, 2, 3)
        with pytest.raises(KeyError):
            mod.reshard_planes({"stage": planes["stage"]}, 2, 4)
    n = 8
    full = {"stage": np.full(n, VALID, np.int32),
            "keys": np.arange(1, n + 1, dtype=np.int32),
            "values": np.arange(1, n + 1, dtype=np.int32),
            "stamp": np.zeros(n, np.int32)}
    with pytest.raises(TR.ResizeCapacityError, match="does not fit"):
        TR.merge_pair(dict(full), dict(full))
    half = dict(full, stage=np.where(np.arange(n) < 4, VALID, FREE)
                .astype(np.int32))
    got, want = TR.merge_pair(half, half), JR.merge_pair(half, half)
    for k in PLANES:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))


# ---------------------------------------------------------------------------
# Quiescent split and merge: bit-identical to JAX and to the offline rebuild
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_quiescent_split_and_merge_match_jax(backend):
    rng = np.random.default_rng([1, BACKENDS.index(backend)])
    jm, tm = pair(backend, capacity=512)
    keys = rng.choice(4096, 192, replace=False).astype(np.int32)
    both(jm, tm, "insert", keys, keys * 7)
    both(jm, tm, "remove", keys[:32])
    p0 = tm.psyncs
    planes = TE.export_pool(tm.map.state)        # durable pool, pre-split
    for m in (jm, tm):
        m.split()
    assert tm.psyncs == p0 and tm.n_shards == 4 and not tm.migrating
    # 1 + 2 units x (4 chunks + patch + frontier) + 1
    assert tm.migration_psyncs == 14 and tm.migrated_nodes == 160
    assert_elastic_equal(jm, tm)
    split = TR.split_planes(planes, 2)
    off, hist = TS.recover(*(torch.from_numpy(split[k]) for k in PLANES),
                           sspec=tm.sspec)
    got, want = state_to_numpy(tm.map.state), state_to_numpy(off)
    for f in got:
        if f not in ("n_psync", "n_ops"):
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    np.testing.assert_array_equal(
        both(jm, tm, "get", keys),
        np.where(np.isin(keys, keys[:32]), 0, keys * 7))
    for m in (jm, tm):
        m.merge()
    assert tm.n_shards == 2 and tm.merges == 1
    assert_elastic_equal(jm, tm)
    np.testing.assert_array_equal(content(tm, 4096), content(jm, 4096))


# ---------------------------------------------------------------------------
# Live split and merge under traffic
# ---------------------------------------------------------------------------


def test_live_split_and_merge_match_jax():
    rng = np.random.default_rng(2)
    kr = 1024
    jm, tm = pair("probe")
    pre = rng.choice(kr, 64, replace=False).astype(np.int32)
    both(jm, tm, "insert", pre, pre * 2)
    p0 = tm.psyncs
    updates = 0
    frontiers = []
    for m in (jm, tm):
        m.begin_split()
    while True:
        done = tm.step()
        assert jm.step() == done
        frontiers.append(tm.frontier.committed)
        assert_elastic_equal(jm, tm)
        if done:
            break
        ops, ks, vs = mixed(rng, kr)
        res = tm.apply(ops, ks, vs)
        np.testing.assert_array_equal(res, np.asarray(jm.apply(ops, ks, vs)))
        updates += int(res[ops != OP_CONTAINS].sum())
        assert tm.psyncs == jm.psyncs == p0 + updates   # SOFT, exact
    # 2 units of (2 chunks + a commit); the last commit finalizes, and
    # the frontier goes back to idle at 0
    assert frontiers == [0, 0, 1, 1, 1, 0]
    assert tm.n_shards == 4 and tm.splits == 1 and tm.migration_psyncs == 10
    np.testing.assert_array_equal(content(tm, kr), content(jm, kr))

    # merge straight back under read/remove traffic (the merged geometry
    # must hold both siblings, so no new keys mid-merge)
    for m in (jm, tm):
        m.begin_merge()
    p1 = tm.psyncs
    while True:
        done = tm.step()
        assert jm.step() == done
        assert_elastic_equal(jm, tm)
        if done:
            break
        ops, ks, vs = mixed(rng, kr)
        ops = np.where(ops == OP_INSERT, OP_CONTAINS, ops).astype(np.int32)
        res = tm.apply(ops, ks, vs)
        np.testing.assert_array_equal(res, np.asarray(jm.apply(ops, ks, vs)))
        np.testing.assert_array_equal(tm.get(ks, default=-3),
                                      np.asarray(jm.get(ks, default=-3)))
        p1 += int(res[ops == OP_REMOVE].sum())
        assert tm.psyncs == p1
    assert tm.n_shards == 2 and tm.merges == 1 and not tm.overflowed
    np.testing.assert_array_equal(content(tm, kr), content(jm, kr))


# ---------------------------------------------------------------------------
# Crash at every split and merge step, both packages in lockstep
# ---------------------------------------------------------------------------


def _crash_every_step(jm, tm, want, key_range, seed0):
    """``tests/test_resize.py``'s adversary on both maps: a crash at every
    frontier state and once mid-copy inside every unit; each recovery
    pays 0 psyncs, keeps every committed key, and leaves both packages'
    maps equal leaf for leaf."""
    n = 0

    def crash(tag):
        nonlocal n
        for m in (jm, tm):
            m.crash_and_recover(seed=seed0 + n)
        n += 1
        assert tm.psyncs == 0, f"recovery paid psyncs at {tag}"
        np.testing.assert_array_equal(tm.last_recovery_hist,
                                      np.asarray(jm.last_recovery_hist))
        assert_elastic_equal(jm, tm)
        np.testing.assert_array_equal(content(tm, key_range), want,
                                      err_msg=f"lost ops at {tag}")

    def step():
        done = tm.step()
        assert jm.step() == done
        return done

    frontiers = 0
    while True:
        crash(f"frontier={tm.frontier.committed}")
        frontiers += 1
        if step():
            return frontiers
        crash("mid-copy")
        f0 = tm.frontier.committed
        while tm.frontier.committed == f0:
            if step():
                return frontiers


def test_crash_at_every_split_and_merge_step_matches_jax():
    rng = np.random.default_rng(3)
    kr = 1024
    jm, tm = pair("probe")
    keys = rng.choice(kr, 96, replace=False).astype(np.int32)
    both(jm, tm, "insert", keys, keys * 5)
    want = np.full(kr, -1)
    want[keys] = keys * 5
    for m in (jm, tm):
        m.begin_split()
        m.crash_and_recover(seed=99)         # crash before any step
    assert tm.psyncs == 0
    assert _crash_every_step(jm, tm, want, kr, 100) >= 2
    assert tm.n_shards == 4 and not tm.migrating
    for m in (jm, tm):
        m.begin_merge()
    assert _crash_every_step(jm, tm, want, kr, 500) >= 1
    assert tm.n_shards == 2 and not tm.migrating
    assert tm.insert([kr + 1], [7])[0] and tm.contains([kr + 1])[0]


# ---------------------------------------------------------------------------
# The merge refusal and the facade's constraints
# ---------------------------------------------------------------------------


def test_begin_merge_refusal_matches_jax():
    jm, tm = pair("probe")
    keys = np.arange(1, 193, dtype=np.int32)
    both(jm, tm, "insert", keys, keys)      # 192 live > 128 per merged shard
    for m in (jm, tm):
        with pytest.raises(JR.ResizeCapacityError if m is jm
                           else TR.ResizeCapacityError, match="refused"):
            m.begin_merge()
    assert not tm.migrating and tm.n_shards == 2 and len(tm) == 192
    assert tm.migration_psyncs == 0
    assert_elastic_equal(jm, tm)


def test_elastic_facade_constraints():
    spec = TSpec(capacity=256, backend="probe")
    with pytest.raises(ValueError, match="router"):
        TR.ElasticShardedMap(spec, n_shards=2, router="v1", device="cpu")
    with pytest.raises(ValueError, match="pipeline_depth"):
        TR.ElasticShardedMap(spec, n_shards=2, pipeline_depth=2,
                             device="cpu")
    with pytest.raises(ValueError, match="migrate_chunk"):
        TR.ElasticShardedMap(spec, n_shards=2, migrate_chunk=0, device="cpu")
    with pytest.raises(ValueError, match="1-shard"):
        TR.ElasticShardedMap(spec, n_shards=1, device="cpu").begin_merge()
    m = TR.ElasticShardedMap(spec, n_shards=2, device="cpu")
    assert m.step() is True and m.migration_psyncs == 0   # idle: a no-op
    m.begin_split()
    with pytest.raises(RuntimeError, match="already running"):
        m.begin_merge()
    assert m.target.device == m.device == torch.device("cpu")
    assert m.pipeline_flush() is m and m.supports_hybrid is False


def test_strided_resize_loses_keys_in_jax_and_the_port_refuses(tmp_path):
    """Strided placement over 2 stage-1 groups: storage row u is not shard
    u, but the migration moves storage row u as shard u.  The JAX package
    acknowledges 300 keys and finds fewer after ``split()`` while ``len``
    still says 300 (ROADMAP C); the port refuses such a resize and such a
    reload.  One group (the serve CLI's ``--placement strided
    --autosplit``) is unaffected."""
    kw = dict(n_shards=4, migrate_chunk=128, placement="strided")
    keys = np.arange(1, 301, dtype=np.int32)
    jm = JR.ElasticShardedMap(JSpec(capacity=1024, backend="bucket"),
                              n_device_groups=2, **kw)
    for i in range(0, 300, 100):
        jm.insert(keys[i:i + 100])
    jm.split()
    found = sum(int(np.asarray(jm.contains(keys[i:i + 100])).sum())
                for i in range(0, 300, 100))
    assert found < 300 and len(jm) == 300, found
    spec = TSpec(capacity=1024, backend="bucket")
    for extra in (dict(n_device_groups=2), dict(use_shard_map=True)):
        with pytest.raises(ValueError, match="storage row u as shard u"):
            TR.ElasticShardedMap(spec, device="cpu", **kw, **extra)
    src = TS.ShardedDurableMap(spec, n_shards=4, device="cpu")
    src.insert(keys[:B])
    d = str(tmp_path / "snap")
    sn = TSN.Snapshotter(src, d)
    sn.snapshot()
    sn.close()
    for elastic in (True, False):
        with pytest.raises(ValueError, match="storage row u as shard u"):
            TSN.load_resharded(d, TSpec(capacity=2048, backend="bucket"), 8,
                               elastic=elastic, device="cpu",
                               placement="strided", n_device_groups=2)
    one = TR.ElasticShardedMap(spec, device="cpu", **kw)   # one group
    for i in range(0, 300, 100):
        one.insert(keys[i:i + 100])
    one.split()
    assert one.contains(keys).all() and len(one) == 300


def test_open_unit_bumps_a_new_epoch_tensor():
    """The epoch bump of a unit builds a new tensor: a snapshot capture
    holding the old one is not changed under it."""
    m = TR.ElasticShardedMap(TSpec(capacity=256, backend="bucket"),
                             n_shards=2, migrate_chunk=64, device="cpu")
    m.insert(np.arange(B, dtype=np.int32))
    old = m.map.state.epoch
    held = old.clone()
    m.begin_split()
    m.step()
    assert torch.equal(old, held)
    assert m.map.state.epoch.tolist() == [held[0] + 1, held[1]]


def test_migration_buffers_own_their_memory():
    """A chunk read is a copy: traffic after the copy (rows written in
    place) leaves the copied planes as they were."""
    m = TR.ElasticShardedMap(TSpec(capacity=256, backend="probe"),
                             n_shards=2, migrate_chunk=128, device="cpu")
    keys = np.arange(B, dtype=np.int32)
    m.insert(keys, keys)
    m.begin_split()
    m.step()                                     # unit 0's one chunk
    buf = {k: v.copy() for k, v in m._mig["buf"].items()}
    row = m._read_row(0, 0, 128)
    m.remove(keys)
    m.insert(keys + 1000, keys)
    for k in buf:
        np.testing.assert_array_equal(m._mig["buf"][k], buf[k])
    assert (row["stage"] == VALID).sum() == \
        (TS.np_shard_of(keys, 2) == 0).sum()


# ---------------------------------------------------------------------------
# load_resharded from either package's snapshot
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ("jax", "torch"))
@pytest.mark.parametrize("new_s", (1, 4))
def test_load_resharded_matches_jax(tmp_path, new_s, writer):
    rng = np.random.default_rng([6, new_s])
    keys = rng.choice(4096, 160, replace=False).astype(np.int32)
    if writer == "jax":
        src = JS.ShardedDurableMap(JSpec(capacity=512, backend="bucket"),
                                   n_shards=2)
        snapper = JSN.Snapshotter
    else:
        src = TS.ShardedDurableMap(TSpec(capacity=512, backend="bucket"),
                                   n_shards=2, device="cpu")
        snapper = TSN.Snapshotter
    in_batches(src, "insert", keys, keys * 9)
    in_batches(src, "remove", keys[:32])
    d = str(tmp_path / "snap")
    sn = snapper(src, d)
    sn.snapshot()
    sn.wait()
    sn.close()

    tspec = TSpec(capacity=256 * new_s, backend="bucket")
    tm = TSN.load_resharded(d, tspec, new_s, device="cpu")
    jm = JSN.load_resharded(d, JSpec(capacity=256 * new_s,
                                     backend="bucket"), new_s)
    assert isinstance(tm, TR.ElasticShardedMap) and tm.n_shards == new_s
    assert tm.psyncs == 0 and len(tm) == 128
    assert_states_equal(tm.map.state, jm.map.state)
    np.testing.assert_array_equal(tm.last_recovery_hist,
                                  np.asarray(jm.last_recovery_hist))
    np.testing.assert_array_equal(tm.map.last_recovery_hist_shards,
                                  np.asarray(jm.map.last_recovery_hist_shards))
    # the offline comparator: a full recovery of the source's durable
    # planes at 2 shards, resharded by the plane functions and recovered
    # at the new count; the epoch is raised past the stored watermark
    st = src.state
    full, _ = TS.recover(*(torch.from_numpy(np.array(getattr(st, f)))
                           for f in ("flushed", "keys", "values", "stamp")),
                         sspec=TS.ShardSpec(base=TSpec(capacity=512,
                                                       backend="bucket"),
                                            n_shards=2))
    out = TR.reshard_planes({"stage": full.cur.numpy(),
                             "keys": full.keys.numpy(),
                             "values": full.values.numpy(),
                             "stamp": full.stamp.numpy()}, 2, new_s)
    off, _ = TS.recover(*(torch.from_numpy(out[k]) for k in PLANES),
                        sspec=tm.sspec)
    got, want = state_to_numpy(tm.map.state), state_to_numpy(off)
    for f in got:
        if f != "epoch":
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert (got["epoch"] >= int(np.max(np.array(st.epoch)))).all()
    np.testing.assert_array_equal(
        tm.get(keys, default=-1),
        np.where(np.isin(keys, keys[:32]), -1, keys * 9))
    assert tm.insert([4097], [1])[0]
    tm.crash_and_recover(seed=7)
    assert tm.contains([4097])[0]
    plain = TSN.load_resharded(d, tspec, new_s, elastic=False, device="cpu")
    assert isinstance(plain, TS.ShardedDurableMap)
    np.testing.assert_array_equal(content(plain, 4096), content(jm, 4096))


def test_load_resharded_refuses_what_jax_refuses(tmp_path):
    with pytest.raises(FileNotFoundError):
        TSN.load_resharded(str(tmp_path / "none"), TSpec(capacity=256), 2,
                           device="cpu")
    src = TS.ShardedDurableMap(TSpec(capacity=512, backend="bucket"),
                               n_shards=2, device="cpu")
    src.insert(np.arange(B, dtype=np.int32))
    d = str(tmp_path / "snap")
    sn = TSN.Snapshotter(src, d)
    sn.snapshot()
    sn.close()
    with pytest.raises(ValueError, match="per-shard capacity"):
        TSN.load_resharded(d, TSpec(capacity=512, backend="bucket"), 4,
                           device="cpu")


# ---------------------------------------------------------------------------
# The overflow message and the serve CLI
# ---------------------------------------------------------------------------


def test_elastic_overflow_suggests_split():
    jm, tm = pair("probe", capacity=64)
    keys = np.arange(1, 129, dtype=np.int32)
    with pytest.warns(RuntimeWarning, match="begin_split"):
        tm.insert(keys)
    with pytest.warns(RuntimeWarning, match="begin_split"):
        jm.insert(keys)
    assert tm.overflowed and jm.overflowed
    assert tm.fill_factor() == jm.fill_factor()
    assert 0.0 < tm.fill_factor() <= 1.0
    assert_elastic_equal(jm, tm)


def test_serve_autosplit_prints_the_jax_drivers_lines(capsys):
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve
    argv = ["--arch", "qwen3-32b-smoke", "--requests", "4", "--prompt-len",
            "4", "--gen", "2", "--shards", "2", "--autosplit", "0.001",
            "--crash"]
    lines = {}
    for name, main, extra in (("jax", jserve.main, []),
                              ("torch", tserve.main, ["--device", "cpu"])):
        assert main(argv + extra) == 0
        lines[name] = [ln for ln in capsys.readouterr().out.splitlines()
                       if not ln.startswith("served ")]
    assert lines["torch"] == lines["jax"]
    assert any(ln.startswith("elastic registry: n_shards=4 (splits=1)")
               for ln in lines["torch"])


@pytest.mark.parametrize("argv", [
    ["--autosplit", "1.5"], ["--autosplit=-0.5"],
    ["--autosplit", "0.5", "--router", "v1"],
    ["--autosplit", "0.5", "--shards", "2", "--pipeline", "2"]])
def test_serve_autosplit_usage_errors(argv):
    """The JAX driver's usage errors: a watermark outside (0, 1], or
    another router or pipeline depth than the frontier protocol takes."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve as tserve
    with pytest.raises(SystemExit) as e:
        tserve.main(["--device", "cpu", *argv])
    assert e.value.code == 2
    kw = {"--router": "router", "--pipeline": "pipeline",
          "--shards": "shards"}
    opts = {kw[a]: (v if a == "--router" else int(v))
            for a, v in zip(argv[2::2], argv[3::2])}
    frac = float(argv[0].split("=")[1] if "=" in argv[0] else argv[1])
    with pytest.raises(ValueError, match="--autosplit"):
        tserve.run(get_config("qwen3-32b-smoke"), device="cpu",
                   autosplit=frac, **opts)
