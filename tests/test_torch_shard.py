"""The port's sharded map against the JAX package's, on the CPU.

The same seeded batches (numpy) go through ``repro.core.shard`` and
``repro_torch.core.shard``'s facade (``insert`` / ``remove`` /
``contains`` / ``get`` / ``apply`` / ``crash_and_recover`` /
``precompile``) for the three backends and three modes: every stacked
``SetState`` leaf (shape and dtype too), every result, ``last_drop_mask``,
``router_dropped``, ``psyncs``, ``ops`` and ``last_recovery_hist_shards``
must be equal.  Then the runtime's own cases: per-shard memory, the
per-shard executor's write-back, the no-op ``precompile``, v1's drop
latch, the stash overflow, a probe shard whose ``table_claim`` takes
several rounds, and ``use_shard_map`` over several GPUs with no process
group, which raises, as resizing a map partitioned over ranks does.  The
router settings are in ``test_torch_shard_router``, the functional API in
``test_torch_shard_functional``, the map over several ranks in
``test_torch_mesh``.  The JAX side runs as its own tests run
it (Pallas kernels in interpret mode)."""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import shard as JS  # noqa: E402
from repro.core.engine import SetSpec as JSpec  # noqa: E402
from repro_torch.core import durable_set as DS  # noqa: E402
from repro_torch.core import router as TR  # noqa: E402
from repro_torch.core import shard as TS  # noqa: E402
from repro_torch.core.convert import state_to_numpy  # noqa: E402
from repro_torch.core.durable_set import MODES, SetState  # noqa: E402
from repro_torch.core.engine import (OP_INSERT, OP_NOP,  # noqa: E402
                                     SetSpec as TSpec)

BACKENDS = ("probe", "scan", "bucket")


def pair(backend="probe", mode="soft", capacity=256, n_shards=4, **kw):
    """The same sharded map in both packages (the port's on the CPU)."""
    extra = {k: kw.pop(k) for k in ("n_buckets", "bucket_width",
                                    "stash_size", "max_probe") if k in kw}
    jm = JS.ShardedDurableMap(JSpec(capacity=capacity, mode=mode,
                                    backend=backend, **extra),
                              n_shards=n_shards, **kw)
    tm = TS.ShardedDurableMap(TSpec(capacity=capacity, mode=mode,
                                    backend=backend, **extra),
                              n_shards=n_shards, device="cpu", **kw)
    return jm, tm


def assert_states_equal(got, want, skip=()):
    """Every stacked leaf of the port's state (a SetState or a dict of
    planes) equals the JAX one, at the same shape and dtype."""
    got = got if isinstance(got, dict) else state_to_numpy(got)
    for f in SetState._fields:
        if f in skip:
            continue
        w = np.asarray(want[f] if isinstance(want, dict) else
                       getattr(want, f))
        assert got[f].dtype == w.dtype and got[f].shape == w.shape, (
            f, got[f].dtype, w.dtype, got[f].shape, w.shape)
        np.testing.assert_array_equal(got[f], w, err_msg=f"leaf {f}")


def assert_maps_equal(jm, tm):
    assert_states_equal(tm.state, jm.state)
    assert (tm.psyncs, tm.ops, len(tm)) == (jm.psyncs, jm.ops, len(jm))
    assert tm.router_dropped == jm.router_dropped
    assert tm.overflowed == jm.overflowed
    for f in ("last_drop_mask", "last_recovery_hist_shards",
              "last_recovery_hist"):
        a, b = getattr(tm, f), getattr(jm, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=f)


def mixed(rng, b, key_range, p=(0.4, 0.4, 0.2)):
    ops = rng.choice(3, b, p=p).astype(np.int32)
    keys = rng.integers(0, key_range, b).astype(np.int32)
    return ops, keys, (keys * 3 + 1).astype(np.int32)


def drive(jm, tm, rng, n_batches, b, key_range, **kw):
    """Mixed batches through both maps: the same results and drop masks
    batch by batch."""
    for _ in range(n_batches):
        ops, keys, vals = mixed(rng, b, key_range, **kw)
        got, want = tm.apply(ops, keys, vals), jm.apply(ops, keys, vals)
        assert isinstance(got, np.ndarray) and got.dtype == bool
        np.testing.assert_array_equal(got, np.asarray(want))
        np.testing.assert_array_equal(tm.last_drop_mask, jm.last_drop_mask)


# Every batch below has 32 lanes: the JAX side then compiles one program
# per router and entry point, which keeps each case to a few seconds.
B = 32


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("backend", BACKENDS)
def test_sharded_map_matches_jax(backend, mode):
    rng = np.random.default_rng([BACKENDS.index(backend), len(mode)])
    jm, tm = pair(backend, mode)
    for keys in np.arange(0, 2 * B, dtype=np.int32).reshape(2, B):
        np.testing.assert_array_equal(tm.insert(keys, keys * 5),
                                      np.asarray(jm.insert(keys, keys * 5)))
    drive(jm, tm, rng, 3, B, 120)
    for q in np.arange(4 * B, dtype=np.int32).reshape(4, B):
        np.testing.assert_array_equal(tm.get(q, default=-9),
                                      np.asarray(jm.get(q, default=-9)))
    keys = np.arange(0, 3 * B, 3, dtype=np.int32)
    np.testing.assert_array_equal(tm.remove(keys), np.asarray(
        jm.remove(keys)))
    assert_maps_equal(jm, tm)
    jm.crash_and_recover(seed=5)
    tm.crash_and_recover(seed=5)
    assert tm.last_recovery_hist_shards.shape == (4, 5)
    assert_maps_equal(jm, tm)
    drive(jm, tm, rng, 2, B, 120)
    for q in np.arange(4 * B, dtype=np.int32).reshape(4, B):
        np.testing.assert_array_equal(tm.contains(q),
                                      np.asarray(jm.contains(q)))
    assert_maps_equal(jm, tm)


def test_make_state_gives_each_shard_its_own_memory():
    sspec = TS.ShardSpec(base=TSpec(capacity=64, backend="bucket"),
                         n_shards=4)
    st = TS.make_state(sspec, device="cpu")
    per = sspec.shard_spec()
    nb, w = per.bucket_geometry()
    assert st.keys.shape == (4, per.capacity)
    assert st.bkeys.shape == (4, nb, w) and st.n_psync.shape == (4,)
    want = JS.make_state(JS.ShardSpec(base=JSpec(capacity=64,
                                                 backend="bucket"),
                                      n_shards=4))
    assert_states_equal(st, want)
    for leaf in st:
        if leaf.numel():
            assert leaf.stride(0) != 0      # repeat, never an expanded view
    st.keys[0, 3] = 7
    st.epoch[2] = 9
    assert int(st.keys[1, 3]) == 0 and int(st.epoch[1]) == 1


def test_run_shards_writes_back_aliasing_leaves_safely():
    """A body may return a view of another leaf of its own shard (here
    ``flushed`` = the old ``cur``) while replacing that leaf: the write
    back must copy the old values, not the ones written just before."""
    sspec = TS.ShardSpec(base=TSpec(capacity=8, backend="scan"), n_shards=2)
    st = TS.make_state(sspec, device="cpu")
    st.cur.copy_(torch.arange(8, dtype=torch.int32).reshape(2, 4))

    def body(view):
        return (view._replace(cur=view.cur + 100, flushed=view.cur),)

    TS.run_shards(st, body, range(2))
    np.testing.assert_array_equal(st.flushed.numpy(),
                                  np.arange(8).reshape(2, 4))
    np.testing.assert_array_equal(st.cur.numpy(),
                                  np.arange(8).reshape(2, 4) + 100)


def test_precompile_is_a_noop_that_returns_the_jax_budgets():
    """The budgets the JAX package compiles programs for, and no change to
    the map: every leaf equals the JAX map's after its precompile."""
    jm, tm = pair("probe", capacity=1024, n_shards=8)
    keys = np.array([1, 2, 3], np.int32)
    jm.insert(keys)
    tm.insert(keys)
    before = state_to_numpy(tm.state)
    assert tm.precompile(8) == jm.precompile(8) == (8,)
    after = state_to_numpy(tm.state)
    for f in before:
        np.testing.assert_array_equal(after[f], before[f], err_msg=f)
    assert_maps_equal(jm, tm)
    for kw in (dict(n_device_groups=2, pipeline_depth=2),
               dict(max_lane_budget=64), dict(n_shards=1)):
        m = TS.ShardedDurableMap(TSpec(capacity=1024), device="cpu",
                                 **{"n_shards": 8, **kw})
        m.insert(keys)
        before = state_to_numpy(m.state)
        assert m.precompile(256) == TR.budget_candidates(m.sspec, 256)
        after = state_to_numpy(m.state)
        for f in before:
            np.testing.assert_array_equal(after[f], before[f], err_msg=f)
    assert TS.ShardedDurableMap(TSpec(capacity=64), router="v1",
                                device="cpu").precompile(64) == ()


def test_v1_drop_latch_and_warning_match_jax():
    """48 keys of one shard against v1's static budget of 32: the excess is
    dropped, counted and warned once, as in the JAX package."""
    s, keys, k = 8, [], 0
    while len(keys) < 48:
        if int(TS.np_shard_of(np.array([k]), s)[0]) == 3:
            keys.append(k)
        k += 1
    keys = np.array(keys, np.int32)
    jm, tm = pair("probe", capacity=512, n_shards=s, router="v1")
    with pytest.warns(RuntimeWarning, match="dropped 16 lane"):
        ok = tm.insert(keys, keys)
    with pytest.warns(RuntimeWarning):
        jm.insert(keys, keys)
    assert ok[:32].all() and not ok[32:].any()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tm.insert(keys[:1])
    jm.insert(keys[:1])
    assert tm.router_dropped == 16
    assert_maps_equal(jm, tm)


def test_sharded_stash_overflow_surfaces():
    """The bucket stash-overflow latch propagates through the sharded
    facade: ``overflowed`` flips, a one-shot RuntimeWarning fires, and the
    leaves equal the JAX map's."""
    jm, tm = pair("bucket", capacity=64, n_shards=2, n_buckets=1,
                  bucket_width=1, stash_size=1)
    assert not tm.overflowed
    keys = np.arange(1, 8, dtype=np.int32)
    with pytest.warns(RuntimeWarning, match="overflow latched"):
        tm.insert(keys)
    with pytest.warns(RuntimeWarning):
        jm.insert(keys)
    assert tm.overflowed
    assert_maps_equal(jm, tm)
    with warnings.catch_warnings():
        warnings.simplefilter("error")            # one-shot per structure
        tm.insert(keys + 10)
    jm.insert(keys + 10)
    assert_maps_equal(jm, tm)


def test_probe_shard_claim_takes_several_rounds(monkeypatch):
    """Probe shards whose windows overlap (64 slots, max_probe 8): one
    batch's ``table_claim`` needs several rounds, and every leaf still
    equals the JAX package's sequential writer."""
    rounds = []
    real_claim, real_set = DS.table_claim, DS.set_drop
    active = [False]

    def counting_set(*a, **k):
        if active[0]:
            rounds[-1] += 1
        return real_set(*a, **k)

    def counting_claim(*a, **k):
        rounds.append(0)
        active[0] = True
        try:
            return real_claim(*a, **k)
        finally:
            active[0] = False

    monkeypatch.setattr(DS, "set_drop", counting_set)
    monkeypatch.setattr(DS, "table_claim", counting_claim)
    jm, tm = pair("probe", capacity=32, n_shards=2, max_probe=8)
    keys = np.arange(0, 32, 2, dtype=np.int32)
    np.testing.assert_array_equal(tm.insert(keys),
                                  np.asarray(jm.insert(keys)))
    assert max(rounds) > 1
    assert_maps_equal(jm, tm)
    jm.crash_and_recover(seed=2)
    tm.crash_and_recover(seed=2)
    assert_maps_equal(jm, tm)


def test_facade_constructor_forms_agree():
    base = TSpec(capacity=128, backend="bucket")
    kw = dict(device="cpu")
    assert TS.ShardedDurableMap(base, **kw).n_shards == 8
    assert TS.ShardedDurableMap(base, n_shards=4, **kw).n_shards == 4
    assert TS.ShardedDurableMap(capacity=128, n_shards=4,
                                **kw).n_shards == 4
    sspec = TS.ShardSpec(base=base, n_shards=16)
    assert TS.ShardedDurableMap(sspec, **kw).n_shards == 16
    assert TS.ShardedDurableMap(sspec, n_shards=4, **kw).n_shards == 4
    m = TS.ShardedDurableMap(sspec, lane_factor=3, **kw)
    assert m.sspec.lane_factor == 3 and m.n_shards == 16
    assert m.spec == sspec.shard_spec()
    with pytest.raises(KeyError, match="unknown index backend"):
        TS.ShardedDurableMap(capacity=64, backend="nope", **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TS.ShardedDurableMap(base)          # the GPU by default
    r = repr(TS.ShardedDurableMap(base, n_shards=2, **kw))
    assert r.startswith("ShardedDurableMap(size=0, psyncs=0, n_shards=2")


def test_use_shard_map_over_several_gpus_names_item_7b(monkeypatch,
                                                       tmp_path):
    """Several visible CUDA devices and no process group raise, saying how
    to start one process per GPU (ROADMAP item 7b is ported); without
    ``use_shard_map`` the map stays on one device.  On rank 0 of a group of
    4, an elastic map holds its rows and its split target's, and
    ``load_resharded`` restores rank 0's rows of the one-device reload
    (the group's collectives stand in for 4 ranks with equal data; the
    real group is ``tests/test_torch_mesh_resize.py``'s)."""
    from repro_torch.core import resize as TZ
    from repro_torch.launch import mesh as MS
    from repro_torch.store.snapshot import Snapshotter, load_resharded
    base = TSpec(capacity=64)
    m = TS.ShardedDurableMap(base, n_shards=4, device="cpu")   # no mesh
    src = TS.ShardedDurableMap(TSpec(capacity=64, backend="bucket"),
                               n_shards=4, device="cpu")
    src.insert(np.arange(40, dtype=np.int32))
    sn = Snapshotter(src, str(tmp_path))
    sn.snapshot()
    sn.close()
    whole = {el: load_resharded(str(tmp_path), TSpec(capacity=128,
                                                     backend="bucket"), 8,
                                elastic=el, device="cpu")
             for el in (True, False)}
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(RuntimeError, match="one process per GPU") as e:
        TS.ShardedDurableMap(base, n_shards=4, use_shard_map=True,
                             device="cpu")
    assert "torchrun" in str(e.value)
    assert m.insert([1, 2]).all()
    sspec = TS.ShardSpec(base=base, n_shards=4, use_shard_map=True)
    st = m.state
    for fn in (lambda: TS.apply_batch(st, *(torch.zeros(4, dtype=torch.int32)
                                            for _ in range(3)), sspec=sspec),
               lambda: TS.recover(st.cur, st.keys, st.values, sspec=sspec),
               lambda: TR.dispatch_plan(st, TR.host_route(
                   sspec, *(np.zeros(4, np.int32) for _ in range(3))),
                   sspec=sspec)):
        with pytest.raises(RuntimeError, match="one process per GPU"):
            fn()
    # a group of 4 ranks, this process rank 0: the map holds rows 0 and 1
    monkeypatch.setattr(MS, "world_size", lambda: 4)
    monkeypatch.setattr(MS, "current_mesh",
                        lambda: MS.ShardMesh(rank=0, world=4, group=None))
    part = TS.ShardedDurableMap(base, n_shards=8, use_shard_map=True,
                                device="cpu")
    assert part.rows == range(0, 2) and part.state.keys.shape[0] == 2
    el = TZ.ElasticShardedMap(base, n_shards=8, use_shard_map=True,
                              device="cpu")
    assert el.map.rows == range(0, 2)
    el.begin_split()                      # the 16-shard target: 4 a rank
    assert el.target.rows == range(0, 4) and el.migrating
    # rank 0's collectives in a group whose 4 ranks hold equal data
    import torch.distributed as dist
    monkeypatch.setattr(dist, "broadcast", lambda t, src, group: None)
    monkeypatch.setattr(dist, "all_reduce", lambda t, op, group: None)
    monkeypatch.setattr(dist, "all_gather", lambda got, t, group: [
        g.copy_(t) for g in got])
    for elastic in (True, False):
        lm = load_resharded(str(tmp_path), TSpec(capacity=128,
                                                 backend="bucket"), 8,
                            elastic=elastic, device="cpu",
                            use_shard_map=True)
        inner, one = ((lm.map, whole[True].map) if elastic
                      else (lm, whole[False]))
        assert inner.rows == range(0, 2) and lm.psyncs == 0
        got, want = state_to_numpy(inner.state), state_to_numpy(one.state)
        for f in got:
            np.testing.assert_array_equal(got[f], want[f][0:2], err_msg=f)


def test_nop_lanes_not_transported_and_budget_neutral():
    jm, tm = pair("scan", capacity=128)
    codes = np.array([OP_INSERT, OP_NOP, OP_INSERT, OP_NOP], np.int32)
    keys = np.array([1, 2, 3, 4], np.int32)
    res = tm.apply(codes, keys, keys)
    np.testing.assert_array_equal(res, np.asarray(jm.apply(codes, keys,
                                                           keys)))
    assert list(res) == [True, False, True, False]
    plan = tm.last_route
    assert int(plan.occupancy.sum()) == 2
    assert (plan.slot[codes == OP_NOP] == -1).all()
    assert len(tm) == 2 and tm.router_dropped == 0
