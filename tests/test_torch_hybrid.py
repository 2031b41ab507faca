"""Snapshot + delta-log hybrid recovery of the port's DurableMap, on the CPU.

Parity with the JAX package: the same snapshot state and crash planes (made
from a numpy seed) go through JAX's ``hybrid_recover`` and the port's, and
every SetState leaf must be equal, at the same dtype -- bucket and scan
backends, all three modes, zero / few / many / whole-pool deltas, and a
stash that overflows.  The port's own snapshot cases (ported from
tests/test_snapshot.py) then hold ``Snapshotter.recover`` to the port's
full ``crash_and_recover`` under the same adversary.  The JAX side runs as
its own tests run it: SetSpec defaults, the Pallas kernels in interpret
mode."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import engine as JE  # noqa: E402
from repro.core.oracle import OracleSet  # noqa: E402
from repro_torch.core import durable_set as DS  # noqa: E402
from repro_torch.core import engine as TE  # noqa: E402
from repro_torch.core.convert import state_to_numpy  # noqa: E402
from repro_torch.core.durable_set import MODES, SetState  # noqa: E402
from repro_torch.obs import MetricsRegistry  # noqa: E402
from repro_torch.store.snapshot import (SnapshotPolicy,  # noqa: E402
                                        Snapshotter)

def _copy_state(state):
    return SetState(*(t.clone() for t in state))


def _assert_states_equal(got, want, skip=("n_psync", "n_ops")):
    got = got if isinstance(got, dict) else state_to_numpy(got)
    for f in SetState._fields:
        if f in skip:
            continue
        w = want[f] if isinstance(want, dict) else np.asarray(
            getattr(want, f))
        assert got[f].dtype == w.dtype, (f, got[f].dtype, w.dtype)
        np.testing.assert_array_equal(got[f], w, err_msg=f"field {f}")


def _u(rng, n):
    return rng.random(n).astype(np.float32)


# ---------------------------------------------------------------------------
# pad_delta and the device-side delta
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", list(range(71)) + [127, 128, 129, 1024,
                                                   4096, 65536])
def test_pad_delta_matches_jax(size):
    rng = np.random.default_rng(size)
    n = max(size, 1) * 3
    idx = np.sort(rng.choice(n, size, replace=False)).astype(np.int32)
    got, want = TE.pad_delta(idx, n), JE.pad_delta(idx, n)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # the facade finds the delta on the planes' device: the same padding
    stamp = np.zeros(n, np.int32)
    stamp[idx] = 7
    stage = rng.integers(0, 5, n).astype(np.int32)
    d_idx, slots, stages = TE.find_delta(torch.from_numpy(stage),
                                         torch.from_numpy(stamp), 6)
    np.testing.assert_array_equal(d_idx.numpy(), want)
    np.testing.assert_array_equal(slots, idx)
    np.testing.assert_array_equal(stages, stage[idx])


# ---------------------------------------------------------------------------
# hybrid_recover against the JAX package's, leaf for leaf
# ---------------------------------------------------------------------------

# delta kind -> (capacity, pre-snapshot ops?, ops after the capture)
def _few(m, keys):
    m.insert(keys[600:603])
    m.remove(keys[100:102])


def _many(m, keys):
    n = m.spec.capacity
    m.insert(keys[n // 4: n // 2])          # fresh inserts,
    m.remove(keys[n // 8: n // 4])          # removes of snapshotted keys,
    m.insert(keys[: n // 16])               # reuse of pre-snapshot slots


def _whole(m, keys):
    m.insert(keys[: m.spec.capacity], keys[: m.spec.capacity] * 5)


DELTAS = {"zero": (1024, True, lambda m, keys: None),
          "few": (1024, True, _few),
          "many": (1024, True, _many),
          "whole": (256, False, _whole)}


def _pre(m, keys):
    n = m.spec.capacity
    m.insert(keys[: n // 4], keys[: n // 4] * 3)
    m.remove(keys[: n // 16])               # pre-snapshot DELETED slots


def _check_hybrid_parity(spec_kw, pre, after, seed=3):
    """One capture, delta and crash on the port; the snapshot and the
    hybrid recovery on both packages and the port's full recovery."""
    rng = np.random.default_rng(seed)
    n = spec_kw["capacity"]
    m = TE.DurableMap(TE.SetSpec(**spec_kw), device="cpu")
    keys = (rng.permutation(5 * n)[:n] + 1).astype(np.int32)
    if pre:
        _pre(m, keys)
    cap = m.snapshot_capture()
    planes, meta = m.snapshot_build(cap)
    after(m, keys)
    u = _u(rng, n)
    crashed = [t.numpy().copy() for t in DS.crash(m.state,
                                                  torch.from_numpy(u))]
    w = cap["watermark"]
    delta_idx = JE.pad_delta(np.flatnonzero(crashed[3] > w), n)

    jspec = JE.SetSpec(**spec_kw)
    jsnap, jhist = JE.recover(*(jnp.asarray(cap[f]) for f in
                                ("raw_stage", "keys", "values", "stamp")),
                              spec=jspec)
    for f in TE.DurableMap._SNAP_FIELDS:     # the stored snapshot planes
        want = np.asarray(getattr(jsnap, f))
        assert planes[f].dtype == want.dtype, f
        np.testing.assert_array_equal(planes[f], want, err_msg=f)
    assert meta == {"kind": "map", "watermark": w,
                    "hist": np.asarray(jhist).tolist()}
    jout = JE.hybrid_recover(jsnap, *(jnp.asarray(a) for a in crashed),
                             jnp.asarray(delta_idx), spec=jspec)
    tout = TE.hybrid_recover(m._snapshot_state(planes),
                             *(torch.from_numpy(a) for a in crashed),
                             torch.from_numpy(delta_idx), spec=m.spec)
    _assert_states_equal(tout, jout, skip=())

    # the facade: the same state and the full scan's histogram
    full = TE.DurableMap(m.spec, device="cpu")
    full.state = _copy_state(m.state)
    full.crash_and_recover(u)
    _, jfull_hist = JE.recover(*(jnp.asarray(a) for a in crashed),
                               spec=jspec)
    np.testing.assert_array_equal(full.last_recovery_hist, jfull_hist)
    m.hybrid_crash_and_recover(planes, meta, u)
    _assert_states_equal(m.state, tout, skip=())
    _assert_states_equal(m.state, full.state, skip=())
    np.testing.assert_array_equal(m.last_recovery_hist,
                                  full.last_recovery_hist)
    assert m.last_recovery_hist.dtype == np.int32
    assert m.psyncs == 0
    return m, delta_idx


@pytest.mark.parametrize("delta", sorted(DELTAS))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("backend", ("bucket", "scan"))
def test_hybrid_recover_matches_jax(backend, mode, delta):
    n, pre, after = DELTAS[delta]
    m, delta_idx = _check_hybrid_parity(
        dict(capacity=n, backend=backend, mode=mode), pre, after)
    live = int((delta_idx < n).sum())
    assert (live == 0) == (delta == "zero")
    if backend == "bucket":
        nb, w = m.spec.bucket_geometry()
        k = 2 * delta_idx.size * w + m.spec.stash_size + delta_idx.size
        # the candidate bound is below the pool for a few slots and reaches
        # it for the whole pool: both branches of _delta_bucket_patch run
        assert (k < n) == (delta in ("zero", "few"))


@pytest.mark.parametrize("mode", MODES)
def test_hybrid_recover_matches_jax_when_the_stash_overflows(mode):
    """A tiny bucket table and stash: the spill count passes stash_size,
    and the recovered latch fires in both packages."""
    with pytest.warns(RuntimeWarning, match="overflow latched"):
        m, _ = _check_hybrid_parity(
            dict(capacity=256, backend="bucket", mode=mode, n_buckets=8,
                 bucket_width=2, stash_size=4), True, _many)
    assert m.overflowed and int(m.state.stash_n) == 4


def test_probe_backend_refuses_hybrid_recover_as_jax_does():
    spec = TE.SetSpec(capacity=64, backend="probe")
    assert not TE.supports_hybrid_recovery(spec)
    assert not JE.supports_hybrid_recovery(JE.SetSpec(capacity=64))
    st = TE.make_state(spec, device="cpu")
    planes = DS.crash(st, torch.zeros(64))
    with pytest.raises(ValueError) as got:
        TE.hybrid_recover(st, *planes, torch.full((8,), 64,
                                                   dtype=torch.int32),
                          spec=spec)
    jst = JE.make_state(JE.SetSpec(capacity=64))
    with pytest.raises(ValueError) as want:
        JE.hybrid_recover_impl(jst, *(jnp.asarray(p.numpy()) for p in planes),
                               jnp.full((8,), 64, jnp.int32),
                               spec=JE.SetSpec(capacity=64))
    assert str(got.value) == str(want.value)


def test_export_and_restored_planes_own_their_memory(tmp_path):
    """Exported pool planes, a capture and the planes a snapshot restored
    share no memory with the live state, and batches after an export or a
    restore leave them unchanged."""
    rng = np.random.default_rng(1)
    m = TE.DurableMap(TE.SetSpec(capacity=256, backend="bucket"),
                      device="cpu")
    m.insert(np.arange(1, 90, dtype=np.int32))
    pool = TE.export_pool(m.state)
    cap = m.snapshot_capture()
    before = {k: v.copy() for k, v in pool.items()}
    cap_before = {k: np.copy(v) for k, v in cap.items()}
    for k, plane in pool.items():
        for t in m.state:
            assert not np.shares_memory(plane, t.numpy()), k
    st, _ = TE.import_pool(pool, spec=m.spec, device="cpu")
    for t in st:
        assert not any(np.shares_memory(t.numpy(), p) for p in pool.values())

    sn = Snapshotter(m, str(tmp_path / "snap"))
    sn.snapshot()
    sn.wait()
    m.apply(rng.integers(0, 3, 64).astype(np.int32),
            rng.integers(1, 300, 64).astype(np.int32))
    planes = sn.store.restore()
    planes_before = {k: v.copy() for k, v in planes.items()}
    m.hybrid_crash_and_recover(planes, sn.store.extra(), _u(rng, 256))
    for t in m.state:
        assert not any(np.shares_memory(t.numpy(), p)
                       for p in planes.values())
    m.apply(rng.integers(0, 3, 64).astype(np.int32),
            rng.integers(1, 300, 64).astype(np.int32))
    m.insert(np.arange(300, 340, dtype=np.int32))
    for got, want in ((pool, before), (planes, planes_before),
                      (cap, cap_before)):
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    sn.close()


# ---------------------------------------------------------------------------
# the port's Snapshotter against its own full recovery (tests/test_snapshot.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend,mode", [("bucket", "soft"),
                                          ("scan", "soft"),
                                          ("bucket", "linkfree")])
def test_map_hybrid_bit_identical(tmp_path, backend, mode, n=1024):
    rng = np.random.default_rng(3)
    m = TE.DurableMap(TE.SetSpec(capacity=n, backend=backend, mode=mode),
                      device="cpu")
    sn = Snapshotter(m, str(tmp_path / "snap"))
    keys = (rng.permutation(5 * n)[: n // 2] + 1).astype(np.int32)
    m.insert(keys[: n // 4], keys[: n // 4] * 3)
    m.remove(keys[: n // 16])                # pre-snapshot DELETED slots
    sn.snapshot()
    sn.wait()
    m.insert(keys[n // 4:])                  # delta: fresh inserts,
    m.remove(keys[n // 8: n // 4])           # removes of snapshotted keys,
    m.insert(keys[: n // 16])                # reuse of pre-snapshot slots
    ref = TE.DurableMap(m.spec, device="cpu")
    ref.state = _copy_state(m.state)
    u = _u(rng, n)
    ref.crash_and_recover(u)
    sn.recover(u)
    _assert_states_equal(m.state, state_to_numpy(ref.state))
    np.testing.assert_array_equal(m.last_recovery_hist,
                                  ref.last_recovery_hist)
    assert m.psyncs == 0                     # recovery psyncs: exactly 0
    sn.close()


def test_map_hybrid_zero_delta(tmp_path):
    rng = np.random.default_rng(4)
    m = TE.DurableMap(TE.SetSpec(capacity=256, backend="bucket"),
                      metrics=MetricsRegistry(), device="cpu")
    sn = Snapshotter(m, str(tmp_path / "snap"))
    m.insert(np.arange(1, 100, dtype=np.int32))
    sn.snapshot()
    sn.wait()
    ref = TE.DurableMap(m.spec, device="cpu")
    ref.state = _copy_state(m.state)
    u = _u(rng, 256)
    ref.crash_and_recover(u)
    sn.recover(u)                            # nothing stamped past W
    _assert_states_equal(m.state, state_to_numpy(ref.state))
    g = m._m.snapshot()["gauges"]
    assert g["map.last_recovery_from_delta_slots"] == 0
    assert g["map.last_recovery_from_snapshot_slots"] == 256
    sn.close()


def test_recover_with_no_snapshot_falls_back(tmp_path):
    m = TE.DurableMap(TE.SetSpec(capacity=128, backend="bucket"),
                      metrics=MetricsRegistry(), device="cpu")
    sn = Snapshotter(m, str(tmp_path / "snap"))
    m.insert([1, 2, 3])
    sn.recover()
    assert m.contains([1, 2, 3]).tolist() == [True] * 3
    g = m._m.snapshot()["gauges"]
    assert g["map.last_recovery_from_snapshot_slots"] == 0
    assert g["map.last_recovery_from_delta_slots"] == 128
    sn.close()


def test_snapshots_add_zero_hot_path_psyncs(tmp_path):
    """The op stream IS the delta log: the same trace with snapshots
    interleaved pays exactly the same psyncs as without."""
    rng = np.random.default_rng(10)
    a = TE.DurableMap(TE.SetSpec(capacity=512, backend="bucket"),
                      device="cpu")
    b = TE.DurableMap(TE.SetSpec(capacity=512, backend="bucket"),
                      device="cpu")
    sn = Snapshotter(b, str(tmp_path / "snap"),
                     SnapshotPolicy(every_steps=2))
    for step in range(6):
        keys = (rng.integers(1, 400, 32)).astype(np.int32)
        ops = rng.integers(0, 3, 32).astype(np.int32)
        a.apply(ops, keys)
        b.apply(ops, keys)
        sn.maybe_snapshot(step)
    sn.wait()
    assert a.psyncs == b.psyncs
    assert a.ops == b.ops
    sn.close()


def test_oracle_set_conformance_through_snapshot(tmp_path):
    """The JAX package's OracleSet (pure Python; the port's copy waits for
    ROADMAP item 6) through a snapshot boundary mid-trace."""
    rng = np.random.default_rng(11)
    m = TE.DurableMap(TE.SetSpec(capacity=128, backend="bucket"),
                      device="cpu")
    sn = Snapshotter(m, str(tmp_path / "snap"))
    o = OracleSet(64)
    trace = [("insert" if r < 0.6 else "remove", int(k))
             for r, k in zip(rng.random(40), rng.integers(0, 32, 40))]
    for i, (kind, key) in enumerate(trace):
        if kind == "insert":
            o.insert(key, key * 10)
            m.insert([key], [key * 10])
        else:
            o.remove(key)
            m.remove([key])
        if i == len(trace) // 2:
            sn.snapshot()                    # boundary mid-trace
            sn.wait()
    sn.recover(_u(rng, 128))
    got = m.contains(np.arange(32)).numpy()
    ok, msg = o.check_recovery({k: 1 for k in range(32) if got[k]})
    assert ok, msg
    sn.close()


def test_epoch_discipline_without_commits(tmp_path):
    """Back-to-back snapshots with NO intervening commits bump the stored
    watermark past every stamp on NVM; recovery must still raise the epoch
    strictly above it or later commits would stamp below the watermark and
    be invisible to the next delta scan."""
    m = TE.DurableMap(TE.SetSpec(capacity=128, backend="scan"),
                      device="cpu")
    sn = Snapshotter(m, str(tmp_path / "snap"))
    m.insert([1, 2, 3])
    sn.snapshot()
    sn.wait()
    sn.snapshot()
    sn.wait()
    w = sn.store.extra()["watermark"]
    sn.recover()
    assert int(m.state.epoch) > w
    m.insert([9])
    assert int(m.state.stamp.max()) > w
    ref = TE.DurableMap(m.spec, device="cpu")
    ref.state = _copy_state(m.state)
    ref.crash_and_recover()
    sn.recover()                             # the [9] commit is in the delta
    _assert_states_equal(m.state, state_to_numpy(ref.state))
    sn.close()


def test_snapshot_policy_cadence(tmp_path):
    m = TE.DurableMap(TE.SetSpec(capacity=64, backend="bucket"),
                      device="cpu")
    sn = Snapshotter(m, str(tmp_path / "snap"),
                     SnapshotPolicy(every_steps=3))
    m.insert([1])
    assert sn.maybe_snapshot(1) is None
    assert sn.maybe_snapshot(2) is None
    f = sn.maybe_snapshot(3)
    assert f is not None
    sn.wait()
    assert sn.store.latest_step() == 3
    assert sn.maybe_snapshot(4) is None      # cadence restarts at 3
    sn.close()


def test_probe_backend_falls_back_to_full_scan(tmp_path):
    m = TE.DurableMap(TE.SetSpec(capacity=64, backend="probe"),
                      device="cpu")
    sn = Snapshotter(m, str(tmp_path / "snap"))
    assert not sn.supports_hybrid
    assert sn.maybe_snapshot(100) is None    # snapshotter is inert
    with pytest.raises(ValueError):
        sn.snapshot()
    m.insert([4, 5])
    sn.recover()
    assert m.contains([4, 5]).tolist() == [True, True]
    sn.close()


def test_snapshot_metrics_surface(tmp_path):
    m = TE.DurableMap(TE.SetSpec(capacity=256, backend="bucket"),
                      metrics=MetricsRegistry(), device="cpu")
    sn = Snapshotter(m, str(tmp_path / "snap"))
    m.insert(np.arange(1, 100, dtype=np.int32))
    sn.snapshot()
    sn.wait()
    m.insert(np.arange(100, 130, dtype=np.int32))
    sn.recover()
    snap = m._m.snapshot()
    assert snap["counters"]["map.snapshots"] == 1
    assert snap["counters"]["map.snapshot_bytes_written"] > 0
    assert snap["counters"]["map.recovery_psyncs"] == 0
    assert snap["histograms"]["span.map.snapshot"]["count"] == 1
    assert snap["gauges"]["map.snapshot_age_seconds"] > 0
    assert snap["gauges"]["map.last_recovery_from_delta_slots"] == 30
    assert snap["gauges"]["map.last_recovery_from_snapshot_slots"] == 226
    c = snap["collected"]["map.snapshotter"]
    assert c["snapshots"] == 1 and c["latest_step"] == 1
    sn.close()
