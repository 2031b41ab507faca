"""Snapshots of the port's sharded map, on the CPU: the sharded snapshot
hooks (an (S,) watermark vector, planes that keep the shard axis) through
``Snapshotter``, ported from tests/test_snapshot.py.

Hybrid recovery (the snapshot plus each shard's stamp delta) must equal
the full ``crash_and_recover`` of a copy of the same pre-crash state under
the same adversary, leaf for leaf and per-shard histogram; a ``dirs``
snapshot written by either package's ``Snapshotter`` must recover through
the other's to the same state; both packages must write the same files;
and the functional ``hybrid_recover`` must equal the JAX package's on the
same planes."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import shard as JS  # noqa: E402
from repro.store.snapshot import Snapshotter as JSnapshotter  # noqa: E402
from repro_torch.core import shard as TS  # noqa: E402
from repro_torch.core.durable_set import SetState  # noqa: E402
from repro_torch.core.engine import SetSpec as TSpec  # noqa: E402
from repro_torch.obs import MetricsRegistry  # noqa: E402
from repro_torch.store.snapshot import Snapshotter  # noqa: E402
from test_torch_shard import (assert_maps_equal,  # noqa: E402
                              assert_states_equal, pair)


def _copy(state):
    return SetState(*(t.clone() for t in state))


def _both(maps, name, *args):
    for m in maps:
        getattr(m, name)(*args)


@pytest.mark.parametrize("backend", ("bucket", "scan", "probe"))
def test_sharded_hybrid_equals_full(tmp_path, backend):
    """Snapshot after 250 inserts, more inserts and removes, a crash:
    recovery through the snapshot equals the full rebuild, every leaf and
    per-shard histogram, at zero psyncs (probe falls back to the full
    scan: the Snapshotter never snapshots it)."""
    rng = np.random.default_rng(6)
    spec = TSpec(capacity=1024, backend=backend)
    reg = MetricsRegistry()
    m = TS.ShardedDurableMap(spec, n_shards=4, device="cpu", metrics=reg)
    sn = Snapshotter(m, str(tmp_path / "snap"))
    keys = (rng.permutation(8192)[:400] + 1).astype(np.int32)
    m.insert(keys[:250], keys[:250] * 7)
    if m.supports_hybrid:
        sn.snapshot()                    # pipeline_flush + per-shard W
        sn.wait()
        w = sn.store.extra()["watermark"]
        assert isinstance(w, list) and len(w) == 4
        assert sn.store.extra()["kind"] == "sharded_map"
    m.insert(keys[250:])
    m.remove(keys[:100])
    ref = TS.ShardedDurableMap(spec, n_shards=4, device="cpu")
    ref.state = _copy(m.state)
    u = np.random.default_rng(1).random(
        tuple(m.state.cur.shape)).astype(np.float32)
    ref.crash_and_recover(u)
    sn.recover(u)
    for f in SetState._fields:
        assert torch.equal(getattr(m.state, f), getattr(ref.state, f)), f
    np.testing.assert_array_equal(m.last_recovery_hist_shards,
                                  ref.last_recovery_hist_shards)
    assert m.psyncs == 0
    g = reg.snapshot()["gauges"]
    delta = int(g["sharded_map.last_recovery_from_delta_slots"])
    restored = int(g["sharded_map.last_recovery_from_snapshot_slots"])
    if m.supports_hybrid:
        assert 0 < delta < 1024 and delta + restored == 1024
    else:
        assert (delta, restored) == (1024, 0)
    assert m.contains(keys[100:]).all() and not m.contains(keys[:100]).any()
    sn.close()


def test_sharded_snapshot_with_a_pipelined_map(tmp_path):
    """The capture flushes the pipeline first; a batch staged at the crash
    is abandoned by the hybrid recovery as by the full one."""
    rng = np.random.default_rng(8)
    spec = TSpec(capacity=512, backend="bucket")
    m = TS.ShardedDurableMap(spec, n_shards=4, pipeline_depth=2,
                             device="cpu")
    ref = TS.ShardedDurableMap(spec, n_shards=4, pipeline_depth=2,
                               device="cpu")
    keys = (rng.permutation(4096)[:200] + 1).astype(np.int32)
    sn = Snapshotter(m, str(tmp_path / "snap"))
    for x in (m, ref):
        x.insert(keys[:100])
    sn.snapshot()
    sn.wait()
    ref.snapshot_capture()                     # the same stamp generation
    for x in (m, ref):
        x.insert(keys[100:150])
        x.remove(keys[:20])
        x.insert(keys[150:])                   # staged at the crash
    sn.recover()
    ref.crash_and_recover()
    assert m.pipeline_abandoned == ref.pipeline_abandoned == 1
    for f in SetState._fields:
        assert torch.equal(getattr(m.state, f), getattr(ref.state, f)), f
    sn.close()


@pytest.mark.parametrize("backend", ("bucket", "scan"))
@pytest.mark.parametrize("writer", ("jax", "torch"))
def test_sharded_snapshot_restores_across_packages(tmp_path, writer,
                                                   backend):
    """A sharded snapshot written by one package's Snapshotter recovers
    through the other's to the state the writer's own recovery reaches,
    leaf for leaf, with the same per-shard histogram."""
    rng = np.random.default_rng(21)
    jm, tm = maps = pair(backend, capacity=512)
    keys = (rng.permutation(2048)[:256] + 1).astype(np.int32)
    _both(maps, "insert", keys[:128], keys[:128] * 3)
    _both(maps, "remove", keys[:32])
    d = str(tmp_path / "snap")
    if writer == "jax":
        w = JSnapshotter(jm, d)
        w.snapshot()
        w.wait()
        tm.snapshot_capture()                # the same stamp generation
    else:
        w = Snapshotter(tm, d)
        w.snapshot()
        w.wait()
        jm.snapshot_capture()
    w.close()
    _both(maps, "insert", keys[128:])
    _both(maps, "remove", keys[64:96])
    assert_maps_equal(jm, tm)
    u = rng.random(tuple(tm.state.cur.shape)).astype(np.float32)
    jsn, tsn = JSnapshotter(jm, d), Snapshotter(tm, d)
    jsn.recover(jnp.asarray(u))
    tsn.recover(u)
    assert_maps_equal(jm, tm)
    jsn.close()
    tsn.close()


def test_both_packages_write_the_same_sharded_snapshot_files(tmp_path):
    rng = np.random.default_rng(22)
    maps = pair("bucket", capacity=256)
    keys = (rng.permutation(1024)[:96] + 1).astype(np.int32)
    _both(maps, "insert", keys, keys * 7)
    _both(maps, "remove", keys[:25])
    dirs = {}
    for name, cls, m in (("jax", JSnapshotter, maps[0]),
                         ("torch", Snapshotter, maps[1])):
        dirs[name] = str(tmp_path / name)
        sn = cls(m, dirs[name])
        sn.snapshot()
        sn.wait()
        sn.close()
    step = "step_000000000001"
    files = [sorted(os.listdir(os.path.join(d, step)))
             for d in dirs.values()]
    assert files[0] == files[1]
    mans = []
    for d in dirs.values():
        with open(os.path.join(d, step, "manifest.json")) as f:
            mans.append(json.load(f))
    assert mans[0] == mans[1]
    for fn in files[0]:
        if fn.endswith(".npy"):
            a, b = (np.load(os.path.join(d, step, fn))
                    for d in dirs.values())
            assert a.dtype == b.dtype and a.shape == b.shape, fn
            assert a.shape[0] == 4, fn         # the shard axis is kept
            np.testing.assert_array_equal(a, b, err_msg=fn)


@pytest.mark.parametrize("backend", ("bucket", "scan"))
def test_hybrid_recover_matches_jax(backend):
    """The functional per-shard ``hybrid_recover`` on the same snapshot
    state, crash planes and (S, D) delta grid as the JAX package's."""
    rng = np.random.default_rng(9)
    jm, tm = pair(backend, capacity=256)
    keys = (rng.permutation(1024)[:100] + 1).astype(np.int32)
    _both((jm, tm), "insert", keys[:60])
    jcap, tcap = jm.snapshot_capture(), tm.snapshot_capture()
    jplanes, jmeta = jm.snapshot_build(jcap)
    tplanes, tmeta = tm.snapshot_build(tcap)
    assert tmeta == {**jmeta, "watermark": list(jmeta["watermark"])}
    for f in jplanes:
        np.testing.assert_array_equal(tplanes[f], np.asarray(jplanes[f]))
    _both((jm, tm), "insert", keys[60:])
    _both((jm, tm), "remove", keys[:15])
    u = rng.random(tuple(tm.state.cur.shape)).astype(np.float32)
    crashed = [np.asarray(x) for x in JS.crash(jm.state, jnp.asarray(u))]
    w = np.asarray(jmeta["watermark"]).reshape(-1, 1)
    mask = crashed[3] > w
    d = max(8, 1 << max(0, int(mask.sum(1).max()) - 1).bit_length())
    delta = np.full((4, d), tm.spec.capacity, np.int32)
    for s in range(4):
        idx = np.flatnonzero(mask[s])
        delta[s, :idx.size] = idx
    want = JS.hybrid_recover(jm._snapshot_state(jplanes),
                             *(jnp.asarray(x) for x in crashed),
                             jnp.asarray(delta), sspec=jm.sspec)
    got = TS.hybrid_recover(tm._snapshot_state(tplanes),
                            *(torch.from_numpy(x) for x in crashed),
                            torch.from_numpy(delta), sspec=tm.sspec)
    assert_states_equal(got, want)
    full, _ = JS.crash_and_recover(jm.state, jnp.asarray(u), sspec=jm.sspec)
    assert_states_equal(got, full, skip=("n_psync", "n_ops"))
