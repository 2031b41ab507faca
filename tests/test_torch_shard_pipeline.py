"""The sharded map's dispatch pipeline (``pipeline_depth`` 2 and 3) in the
port, on the CPU, ported from tests/test_pipeline.py: pipelined results,
state and counters equal the synchronous map's and the JAX package's
pipelined map's; a crash abandons only the staged batch (the same
abandoned handle, counters and leaves as in the JAX package); SOFT pays
exactly 1 psync per successful update through the pipeline; the lazy
handle reads like an array; the scratch pool recycles."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch.core import router as TR  # noqa: E402
from repro_torch.core import shard as TS  # noqa: E402
from repro_torch.core.engine import OP_NOP, SetSpec as TSpec  # noqa: E402
from test_torch_shard import (B, BACKENDS, assert_maps_equal,  # noqa: E402
                              assert_states_equal, mixed, pair)


def _sync_pair(backend="probe", mode="soft", depth=2, groups=0,
               capacity=256):
    """(pipelined, synchronous) port maps over the same geometry."""
    base = TSpec(capacity=capacity, mode=mode, backend=backend)
    pipe = TS.ShardedDurableMap(base, n_shards=8, pipeline_depth=depth,
                                n_device_groups=groups, device="cpu")
    sync = TS.ShardedDurableMap(base, n_shards=8, n_device_groups=groups,
                                device="cpu")
    return pipe, sync


@pytest.mark.parametrize("depth", (2, 3))
@pytest.mark.parametrize("backend", BACKENDS)
def test_pipeline_matches_jax_pipeline(backend, depth):
    """Depth 2 and 3 with logical groups and mixed apply + get batches,
    forced only at the end, then a crash: the same per-batch results,
    leaves and counters as the JAX package's pipelined map."""
    rng = np.random.default_rng([depth, BACKENDS.index(backend)])
    jm, tm = pair(backend, n_shards=8, pipeline_depth=depth,
                  n_device_groups=2)
    handles = []
    for i in range(5):
        ops, keys, vals = mixed(rng, B, 90)
        ops[rng.random(B) < 0.2] = OP_NOP
        handles.append((tm.apply(ops, keys, vals), jm.apply(ops, keys,
                                                             vals)))
        if i % 2:
            handles.append((tm.get(keys, default=-3),
                            jm.get(keys, default=-3)))
    assert isinstance(handles[0][0], TS._LazyBatch)
    assert repr(handles[-1][0]).startswith("_LazyBatch(")
    tm.pipeline_flush()
    jm.pipeline_flush()
    for t, j in handles:
        np.testing.assert_array_equal(np.asarray(t), np.asarray(j))
        np.testing.assert_array_equal(t.drop_mask, j.drop_mask)
    assert_maps_equal(jm, tm)
    h_t = tm.insert(np.arange(200, 200 + B, dtype=np.int32))   # staged
    h_j = jm.insert(np.arange(200, 200 + B, dtype=np.int32))
    tm.crash_and_recover(seed=4)
    jm.crash_and_recover(seed=4)
    assert h_t.abandoned and h_j.abandoned
    assert tm.pipeline_abandoned == jm.pipeline_abandoned == 1
    assert_maps_equal(jm, tm)


@pytest.mark.parametrize("mode", ("soft", "linkfree", "logfree"))
def test_pipeline_equals_synchronous_with_recovery(mode):
    rng = np.random.default_rng(3)
    pipe, sync = _sync_pair("bucket", mode, depth=3, groups=4)
    for r in range(6):
        ops, keys, _ = mixed(rng, 16, 96)
        hp = pipe.apply(ops, keys, keys * 2)
        hs = sync.apply(ops, keys, keys * 2)
        np.testing.assert_array_equal(np.asarray(hp), hs)
        if r == 3:
            pipe.crash_and_recover(seed=11)
            sync.crash_and_recover(seed=11)
            assert pipe.pipeline_abandoned == 0   # nothing staged: forced
    probe = np.arange(96)
    np.testing.assert_array_equal(np.asarray(pipe.contains(probe)),
                                  sync.contains(probe))
    pipe.pipeline_flush()
    assert (pipe.psyncs, pipe.ops, len(pipe)) == (sync.psyncs, sync.ops,
                                                  len(sync))
    assert_states_equal(pipe.state, {f: t.numpy() for f, t in
                                     sync.state._asdict().items()})


@pytest.mark.parametrize("crash_at", (1, 2, 4))
def test_crash_abandons_only_staged_batch(crash_at):
    """Crash after ``crash_at`` submits: the dispatched batches are
    committed, the one staged batch is abandoned with zero side effects,
    and recovery equals a synchronous run of the dispatched prefix."""
    rng = np.random.default_rng(crash_at)
    batches = [(rng.integers(0, 3, 12).astype(np.int32),
                rng.integers(0, 64, 12).astype(np.int32))
               for _ in range(crash_at)]
    pipe, ref = _sync_pair("scan")
    handles = [pipe.apply(o, k, k * 5) for o, k in batches]
    for o, k in batches[:-1]:
        ref.apply(o, k, k * 5)
    pipe.crash_and_recover(seed=99)
    ref.crash_and_recover(seed=99)
    assert pipe.pipeline_abandoned == 1 and handles[-1].abandoned
    assert repr(handles[-1]) == "_LazyBatch(abandoned)"
    with pytest.raises(RuntimeError, match="abandoned"):
        handles[-1].value()
    with pytest.raises(RuntimeError, match="abandoned"):
        np.asarray(handles[-1])
    for h in handles[:-1]:
        assert not h.abandoned and h.value() is not None
    assert (pipe.psyncs, pipe.ops, len(pipe)) == (ref.psyncs, ref.ops,
                                                  len(ref))
    probe = np.arange(64)
    np.testing.assert_array_equal(np.asarray(pipe.contains(probe)),
                                  ref.contains(probe))
    pipe.pipeline_flush()
    assert_states_equal(pipe.state, {f: t.numpy() for f, t in
                                     ref.state._asdict().items()})


def test_soft_psync_parity_under_pipeline():
    """Exactly 1 psync per successful update, 0 per read, 0 for the
    abandoned staged batch."""
    m = TS.ShardedDurableMap(TSpec(capacity=512, mode="soft"), n_shards=8,
                             pipeline_depth=2, device="cpu")
    keys = np.arange(100, 164, dtype=np.int32)
    m.insert(keys, keys)                  # 64 fresh inserts
    m.contains(keys)                      # reads: 0 psyncs
    m.insert(keys[:16], keys[:16])        # duplicate inserts: fail, 0
    m.remove(keys[:32])                   # 32 successful removes
    m.pipeline_flush()
    assert m.psyncs == 64 + 32
    h = m.insert(np.arange(500, 516, dtype=np.int32))   # staged only
    m.crash_and_recover(seed=1)
    assert h.abandoned and m.psyncs == 0
    assert not np.asarray(m.contains(np.arange(500, 516))).any()
    assert len(m) == 64 - 32


def test_lazy_handle_is_array_like():
    m = TS.ShardedDurableMap(TSpec(capacity=128), n_shards=4,
                             pipeline_depth=2, device="cpu")
    h = m.insert([1, 2, 3], [10, 20, 30])
    g = m.get([1, 2, 9], default=-1)
    assert repr(g) == "_LazyBatch(get, staged)"
    assert list(h) == [True, True, True]
    assert len(g) == 3 and g[0] == 10
    assert g.dropped == 0 and not g.drop_mask.any()
    np.testing.assert_array_equal(g.present, [True, True, False])
    np.testing.assert_array_equal(np.asarray(g, dtype=np.int64),
                                  [10, 20, -1])
    assert repr(g).startswith("_LazyBatch(get, forced=")


def test_properties_account_for_staged_batch():
    m = TS.ShardedDurableMap(TSpec(capacity=128), n_shards=4,
                             pipeline_depth=2, device="cpu")
    m.insert([1, 2, 3])
    assert m.psyncs == 3 and len(m) == 3 and m.ops == 3


def test_empty_batch_through_pipeline():
    m = TS.ShardedDurableMap(TSpec(capacity=128), n_shards=4,
                             pipeline_depth=2, device="cpu")
    h = m.insert(np.zeros((0,), np.int32))
    assert np.asarray(h).shape == (0,)
    m.pipeline_flush()
    assert len(m) == 0


@pytest.mark.parametrize("depth", (1, 2, 3))
def test_host_route_scratch_steady_state_allocates_nothing(depth):
    """After warm-up at one geometry, routing allocates no scratch grid;
    a flush or a crash leaves no scratch set referenced."""
    m = TS.ShardedDurableMap(TSpec(capacity=2048), n_shards=8,
                             pipeline_depth=depth, device="cpu")
    rng = np.random.default_rng(depth)
    keys = lambda: rng.integers(0, 1000, 64).astype(np.int32)  # noqa: E731
    for _ in range(4):
        m.insert(keys())
    m.pipeline_flush()
    s0 = m.scratch_stats()
    for _ in range(10):
        m.contains(keys())
    m.pipeline_flush()
    s1 = m.scratch_stats()
    assert s1["grid_allocs"] == s0["grid_allocs"]
    assert s1["acquires"] - s1["releases"] == s0["acquires"] - s0[
        "releases"]
    m.insert(keys())
    m.crash_and_recover(seed=0)
    s2 = m.scratch_stats()
    assert s2["acquires"] - s2["releases"] == s0["acquires"] - s0[
        "releases"]
    assert m._metrics_extra()["pipeline_abandoned"] == int(depth > 1)


def test_pipeline_depth_validation():
    base = TSpec(capacity=64)
    with pytest.raises(ValueError, match="pipeline_depth"):
        TS.ShardSpec(base=base, pipeline_depth=0)
    with pytest.raises(ValueError, match="pipeline_depth"):
        TS.ShardSpec(base=base, router="v1", pipeline_depth=2)
    m = TS.ShardedDurableMap(base, n_shards=4, device="cpu")
    assert isinstance(m.insert([1]), np.ndarray)
    assert TR.scratch_stats()["grid_allocs"] >= 1
