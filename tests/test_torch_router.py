"""The port's shard routing against the JAX package's, on the CPU.

Seeded batches (numpy) go through both packages' routers: the v1
single-stage ``route`` / ``gather`` and ``np_v1_drop_mask``, the v2
stage-1 ``host_route`` / ``host_gather`` (with its scratch pool), the
stage-2 ``route_local`` / ``_local_row``, ``shard_of`` / ``np_shard_of``,
the placement rows, ``adaptive_lane_budget`` / ``budget_candidates`` and
the ``ShardSpec`` rules and errors.  Integers must be equal, at the same
dtype."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import router as JR  # noqa: E402
from repro.core import shard as JS  # noqa: E402
from repro.core.engine import SetSpec as JSpec  # noqa: E402
from repro_torch.core import router as TR  # noqa: E402
from repro_torch.core import shard as TS  # noqa: E402
from repro_torch.core.engine import (OP_NOP, SetSpec as TSpec)  # noqa: E402

# the knobs of a ShardSpec other than its base SetSpec
_KNOBS = ("n_shards", "router", "placement", "lane_factor",
          "min_lane_budget", "max_lane_budget", "n_device_groups",
          "pipeline_depth", "use_shard_map")


def _specs(capacity=256, **kw):
    """The same ShardSpec in both packages."""
    return (JS.ShardSpec(base=JSpec(capacity=capacity), **kw),
            TS.ShardSpec(base=TSpec(capacity=capacity), **kw))


def _eq(got, want, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


def _batch(rng, b, key_range=4096, nop=0.0):
    ops = rng.integers(0, 3, b).astype(np.int32)
    ops[rng.random(b) < nop] = OP_NOP
    keys = rng.integers(0, key_range, b).astype(np.int32)
    vals = rng.integers(-(1 << 31), 1 << 31, b, dtype=np.int64).astype(
        np.int32)
    return ops, keys, vals


@pytest.mark.parametrize("s", (1, 2, 4, 8, 32, 1024))
def test_shard_of_matches_jax(s):
    keys = np.random.default_rng(s).integers(
        -(1 << 31), 1 << 31, 4096, dtype=np.int64).astype(np.int32)
    keys[:3] = (0, -1, (1 << 31) - 1)
    want = JS.shard_of(jnp.asarray(keys), s)
    _eq(TS.shard_of(torch.from_numpy(keys), s), want, "shard_of")
    _eq(TS.np_shard_of(keys, s), JS.np_shard_of(keys, s), "np_shard_of")
    _eq(TS.np_shard_of(keys, s), want, "np vs device")


@pytest.mark.parametrize("b,s,l", [(24, 4, 8), (64, 4, 4), (64, 8, 16),
                                   (100, 2, 32), (7, 1, 7), (256, 16, 4)])
def test_route_and_gather_match_jax(b, s, l):
    rng = np.random.default_rng([b, s, l])
    ops, keys, vals = _batch(rng, b, key_range=64)
    got = TS.route(*(torch.from_numpy(x) for x in (ops, keys, vals)),
                   n_shards=s, lane_budget=l)
    want = JS.route(*(jnp.asarray(x) for x in (ops, keys, vals)),
                    n_shards=s, lane_budget=l)
    for name, g, w in zip(("r_ops", "r_keys", "r_vals", "slot", "dropped"),
                          got, want):
        _eq(g, w, name)
    grid = rng.integers(0, 1000, (s, l)).astype(np.int32)
    _eq(TS.gather(torch.from_numpy(grid), got[3], -7),
        JS.gather(jnp.asarray(grid), want[3], jnp.int32(-7)), "gather")
    _eq(TS.np_v1_drop_mask(keys, n_shards=s, lane_budget=l),
        JS.np_v1_drop_mask(keys, n_shards=s, lane_budget=l), "drop mask")
    assert int(got[4]) == int(TS.np_v1_drop_mask(
        keys, n_shards=s, lane_budget=l).sum())


@pytest.mark.parametrize("placement", TR.PLACEMENTS)
@pytest.mark.parametrize("groups", (1, 2, 4))
@pytest.mark.parametrize("lane", (1, 4, 32))
def test_route_local_matches_jax(placement, groups, lane):
    rng = np.random.default_rng([groups, lane])
    js, ts = _specs(n_shards=8, placement=placement)
    ops, keys, vals = _batch(rng, 64, key_range=300, nop=0.25)
    got = TR.route_local(*(torch.from_numpy(x) for x in (ops, keys, vals)),
                         sspec=ts, n_groups=groups, lane_budget=lane)
    want = JR.route_local(*(jnp.asarray(x) for x in (ops, keys, vals)),
                          sspec=js, n_groups=groups, lane_budget=lane)
    for name, g, w in zip(("r_ops", "r_keys", "r_vals", "slot", "dropped"),
                          got, want):
        _eq(g, w, name)
    _eq(TR._local_row(torch.from_numpy(keys), ts, groups),
        JR._local_row(jnp.asarray(keys), js, groups), "local row")
    grid = rng.integers(0, 9, tuple(got[0].shape)).astype(np.int32)
    _eq(TR._grid_gather(torch.from_numpy(grid), got[3], 5),
        JR._grid_gather(jnp.asarray(grid), want[3], jnp.int32(5)), "gather")


@pytest.mark.parametrize("kw", [
    dict(n_shards=8), dict(n_shards=8, n_device_groups=2),
    dict(n_shards=8, n_device_groups=4, placement="strided"),
    dict(n_shards=4, max_lane_budget=2, min_lane_budget=1),
    dict(n_shards=1), dict(n_shards=16, n_device_groups=16)])
@pytest.mark.parametrize("nop", (0.0, 0.3))
def test_host_route_matches_jax(kw, nop):
    rng = np.random.default_rng(len(kw))
    js, ts = _specs(**kw)
    for b in (1, 8, 37, 256):
        ops, keys, vals = _batch(rng, b, nop=nop)
        got = TR.host_route(ts, ops, keys, vals)
        want = JR.host_route(js, ops, keys, vals)
        for f in ("d_ops", "d_keys", "d_vals", "slot", "occupancy"):
            _eq(getattr(got, f), getattr(want, f), f)
        for f in ("groups", "lane_budget", "max_occ"):
            assert getattr(got, f) == getattr(want, f), f
        res = rng.integers(0, 2, got.d_ops.shape).astype(bool)
        _eq(TR.host_gather(res, got.slot, False),
            JR.host_gather(res, want.slot, False), "host_gather")
        TR.release_plan(got)
        JR.release_plan(want)


def test_host_route_scratch_is_recycled():
    _, ts = _specs(n_shards=4, n_device_groups=2)
    rng = np.random.default_rng(3)
    before = TR.scratch_stats()["grid_allocs"]
    for _ in range(5):
        plan = TR.host_route(ts, *_batch(rng, 64))
        TR.release_plan(plan)
    # one geometry per distinct (D, Bd, B): at most two here
    assert TR.scratch_stats()["grid_allocs"] - before <= 2


def test_placement_rows_match_jax():
    for kw in (dict(n_shards=8), dict(n_shards=8, placement="strided"),
               dict(n_shards=16, placement="strided")):
        js, ts = _specs(**kw)
        keys = np.arange(512, dtype=np.int32)
        for d in (1, 2, 4, 8):
            _eq(TR.np_storage_rows(ts, d), JR.np_storage_rows(js, d), "rows")
            _eq(TR._np_row_of(keys, ts, d), JR._np_row_of(keys, js, d),
                "row of")
            assert TR.resolve_groups(dataclasses.replace(
                ts, n_device_groups=d)) == JR.resolve_groups(
                    dataclasses.replace(js, n_device_groups=d))


@pytest.mark.parametrize("kw", [dict(n_shards=8), dict(n_shards=1),
                                dict(n_shards=8, max_lane_budget=64),
                                dict(n_shards=8, max_lane_budget=48),
                                dict(n_shards=4, min_lane_budget=1),
                                dict(n_shards=8, min_lane_budget=100)])
def test_adaptive_budget_and_candidates_match_jax(kw):
    js, ts = _specs(capacity=1024, **kw)
    for b in (1, 5, 16, 32, 100, 1024):
        assert TR.budget_candidates(ts, b) == JR.budget_candidates(js, b)
        for occ in (0, 1, 3, 31, 32, 33, 500, 2000):
            assert TR.adaptive_lane_budget(ts, b, occ) == \
                JR.adaptive_lane_budget(js, b, occ)
        assert ts.lane_budget(b) == js.lane_budget(b)
    assert TR.mesh_devices(ts) == JR.mesh_devices(js) == 1


@pytest.mark.parametrize("cap,s", [(1024, 8), (100, 8), (1000, 2), (8, 8),
                                   (65, 4)])
def test_shard_spec_geometry_matches_jax(cap, s):
    js, ts = _specs(capacity=cap, n_shards=s)
    assert ts.per_shard_capacity == js.per_shard_capacity
    assert ts.effective_capacity == js.effective_capacity
    assert ts.shard_spec().capacity == js.shard_spec().capacity
    for name in ("split_spec", "merge_spec"):
        if name == "merge_spec" and s < 2:
            continue
        got, want = getattr(ts, name)(), getattr(js, name)()
        assert [getattr(got, k) for k in _KNOBS] == \
            [getattr(want, k) for k in _KNOBS]
        assert got.base.capacity == want.base.capacity


_BAD = [dict(n_shards=3), dict(n_shards=0), dict(router="v3"),
        dict(placement="random"), dict(lane_factor=0),
        dict(min_lane_budget=0), dict(max_lane_budget=-1),
        dict(n_device_groups=3), dict(n_shards=4, n_device_groups=8),
        dict(pipeline_depth=0), dict(n_shards=512),
        dict(router="v1", placement="strided"),
        dict(router="v1", max_lane_budget=4),
        dict(router="v1", n_device_groups=2),
        dict(router="v1", pipeline_depth=2)]


@pytest.mark.parametrize("kw", _BAD, ids=[str(k) for k in _BAD])
def test_shard_spec_errors_match_jax(kw):
    with pytest.raises(ValueError) as want:
        JS.ShardSpec(base=JSpec(capacity=256), **kw)
    with pytest.raises(ValueError) as got:
        TS.ShardSpec(base=TSpec(capacity=256), **kw)
    assert str(got.value) == str(want.value).replace(
        "repro.core", "repro_torch.core")
    with pytest.raises(ValueError, match="merge below one shard"):
        TS.ShardSpec(base=TSpec(capacity=8), n_shards=1).merge_spec()


def test_use_shard_map_on_one_device_stays_put():
    """A process with no ``torch.distributed`` group under
    ``use_shard_map`` runs as without it, as the JAX package stays on
    plain vmap: one group, no mesh, every row held here."""
    _, ts = _specs(n_shards=8, use_shard_map=True)
    assert not torch.distributed.is_initialized()
    if torch.cuda.device_count() <= 1:
        assert TR.mesh_devices(ts) == 1 and TR.mesh_groups(ts) == 1
        assert TR.resolve_groups(ts) == 1
        assert TR.shard_mesh(ts) is None
        assert TR.local_rows(ts) == range(8)
        m = TS.ShardedDurableMap(TSpec(capacity=128), n_shards=8,
                                 use_shard_map=True, device="cpu")
        assert m.mesh is None and m.rows == range(8)
        assert m.state.keys.shape[0] == 8
        assert m.insert([1, 2]).all() and len(m) == 2
