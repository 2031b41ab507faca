"""Snapshot + delta-log hybrid recovery of the port's durable queue, on
the CPU.

The port's ``hybrid_recover`` against the JAX package's on the same
snapshot and crash planes, leaf for leaf; the queue cases of
tests/test_snapshot.py, where ``Snapshotter.recover`` must equal the full
``crash_and_recover`` of a copy of the same state, and the JAX queue driven
beside it must reach the same leaves; and a ``dirs`` snapshot of a queue
written by either package and restored by the other.  Batches are at most
32 lanes, so the JAX side compiles few shapes.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import queue as JQ  # noqa: E402
from repro.core.engine import pad_delta as j_pad_delta  # noqa: E402
from repro.store.snapshot import Snapshotter as JSnapshotter  # noqa: E402
from repro_torch.core import (MODES, DurableQueue, OracleQueue,  # noqa: E402
                              QueueSpec, QueueState)
from repro_torch.core import queue as Q  # noqa: E402
from repro_torch.core.engine import find_delta  # noqa: E402
from repro_torch.obs import MetricsRegistry  # noqa: E402
from repro_torch.store.snapshot import Snapshotter  # noqa: E402
from test_torch_queue import Pair, assert_states_equal  # noqa: E402

B = 32


def _copy(state):
    return QueueState(*(t.clone() for t in state))


def _assert_same(got, want, skip=("n_psync", "n_ops")):
    for f in QueueState._fields:
        if f in skip:
            continue
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f"leaf {f}"


def _u(rng, n):
    return rng.random(n).astype(np.float32)


def _enqueue(q, start, count):
    """``count`` consecutive values from ``start`` in batches of B."""
    for s in range(start, start + count, B):
        q.enqueue(np.arange(s, min(s + B, start + count), dtype=np.int32))


def _dequeue(q, count):
    for s in range(0, count, B):
        q.dequeue(min(B, count - s))


# ---------------------------------------------------------------------------
# hybrid_recover against the JAX package's, leaf for leaf
# ---------------------------------------------------------------------------

# traffic before the capture, traffic after it (capacity 64, values
# counted from 1)
DELTAS = {
    "zero": ((40, 10), (0, 0)),
    "few": ((40, 10), (3, 2)),
    "drained": ((5, 0), (0, 5)),
    "wrapped": ((60, 50), (45, 30)),        # tickets pass N after the capture
    "empty_snapshot": ((0, 0), (20, 7)),
    "empty_at_capture": ((20, 20), (0, 0)),   # head from the snapshot's
    "refilled_drained": ((20, 20), (3, 3)),   # head, or from the delta
}


@pytest.mark.parametrize("delta", sorted(DELTAS))
@pytest.mark.parametrize("mode", MODES)
def test_hybrid_recover_matches_jax(mode, delta):
    """One snapshot state and one set of crash planes through both
    packages' ``hybrid_recover``: every leaf equal, and equal to the full
    ``recover`` of the same planes."""
    (pre_e, pre_d), (post_e, post_d) = DELTAS[delta]
    rng = np.random.default_rng([MODES.index(mode), len(delta)])
    n = 64
    q = Pair(n, mode)
    _enqueue(q, 1, pre_e)
    _dequeue(q, pre_d)
    cap_t, cap_j = q.t.snapshot_capture(), q.j.snapshot_capture()
    planes_t, meta_t = q.t.snapshot_build(cap_t)
    planes_j, meta_j = q.j.snapshot_build(cap_j)
    assert meta_t == meta_j and sorted(planes_t) == sorted(planes_j)
    for f in planes_t:
        assert planes_t[f].dtype == planes_j[f].dtype, f
        np.testing.assert_array_equal(planes_t[f], planes_j[f], err_msg=f)
    _enqueue(q, 1000, post_e)
    _dequeue(q, post_d)
    q.check()
    u = _u(rng, n)
    crashed_t = Q.crash(q.t.state, torch.from_numpy(u))
    crashed_j = JQ.crash(q.j.state, jnp.asarray(u))
    w = meta_t["watermark"]
    delta_idx, slots, stages = find_delta(crashed_t[0], crashed_t[3], w)
    j_idx = j_pad_delta(np.flatnonzero(np.asarray(crashed_j[3]) > w), n)
    np.testing.assert_array_equal(delta_idx.numpy(), j_idx)
    got = Q.hybrid_recover(q.t._snapshot_state(planes_t), *crashed_t,
                           delta_idx, spec=q.t.spec)
    want = JQ.hybrid_recover(q.j._snapshot_state(planes_j), *crashed_j,
                             jnp.asarray(j_idx), spec=q.j.spec)
    assert_states_equal(got, want)
    full, _ = Q.recover(*crashed_t, spec=q.t.spec)
    _assert_same(got, full, skip=())


# ---------------------------------------------------------------------------
# The queue cases of tests/test_snapshot.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_queue_hybrid_bit_identical(tmp_path, mode):
    """Snapshot, dequeue past the watermark's head, enqueue past N: the
    recovery through the Snapshotter equals the full recovery of a copy of
    the same state (leaves and histogram), at zero psyncs, and the JAX
    queue beside it recovers through its Snapshotter to the same leaves."""
    rng = np.random.default_rng(5)
    n = 512
    q = Pair(n, mode)
    sn = Snapshotter(q.t, str(tmp_path / "t"))
    jsn = JSnapshotter(q.j, str(tmp_path / "j"))
    _enqueue(q, 1, 192)
    for s in (sn, jsn):
        s.snapshot()
        s.wait()
    _dequeue(q, 160)                         # delta: head moves past W
    _enqueue(q, 300, 384)                    # and tickets pass N
    q.check()
    ref = DurableQueue(q.t.spec, device="cpu")
    ref.state = _copy(q.t.state)
    u = _u(rng, n)
    ref.crash_and_recover(u)
    sn.recover(u)
    jsn.recover(jnp.asarray(u))
    _assert_same(q.t.state, ref.state)
    np.testing.assert_array_equal(q.t.last_recovery_hist,
                                  ref.last_recovery_hist)
    assert q.t.last_recovery_hist.dtype == np.int32
    q.check()
    np.testing.assert_array_equal(q.t.last_recovery_hist,
                                  q.j.last_recovery_hist)
    assert q.t.psyncs == 0
    sn.close()
    jsn.close()


def test_queue_hybrid_drained_to_empty(tmp_path):
    """head/tail reconstruction when every live snapshot ticket was
    dequeued in the delta: head == tail == one past the last dequeue."""
    q = DurableQueue(QueueSpec(capacity=64), device="cpu")
    sn = Snapshotter(q, str(tmp_path / "snap"))
    q.enqueue([1, 2, 3, 4, 5])
    sn.snapshot()
    sn.wait()
    q.dequeue(5)
    ref = DurableQueue(q.spec, device="cpu")
    ref.state = _copy(q.state)
    ref.crash_and_recover()
    sn.recover()
    _assert_same(q.state, ref.state)
    assert int(q.state.head) == int(q.state.tail) == 5
    sn.close()


def test_oracle_queue_conformance_through_snapshot(tmp_path):
    rng = np.random.default_rng(12)
    q = DurableQueue(QueueSpec(capacity=32), device="cpu")
    sn = Snapshotter(q, str(tmp_path / "snap"))
    o = OracleQueue(32)
    for i in range(60):
        if rng.random() < 0.6:
            v = int(rng.integers(1, 99))
            o.enqueue(v)
            q.enqueue([v])
        else:
            o.dequeue()
            q.dequeue(1)
        if i == 30:
            sn.snapshot()
            sn.wait()
    sn.recover(_u(rng, 32))
    contents, head, tail = OracleQueue.recover(o.crash([0] * 32))
    assert (int(q.state.head), int(q.state.tail)) == (head, tail)
    vals, ok = q.dequeue(len(contents))
    np.testing.assert_array_equal(vals[ok], contents)
    sn.close()


def test_snapshot_metrics_and_zero_hot_path_psyncs(tmp_path):
    """Snapshots add no psync to the queue's ops; the recovery gauges say
    how many slots came from the delta and how many from the snapshot."""
    m = MetricsRegistry()
    q = DurableQueue(QueueSpec(capacity=64), device="cpu", metrics=m,
                     metrics_name="rq")
    sn = Snapshotter(q, str(tmp_path / "snap"))
    q.enqueue(np.arange(20))
    sn.snapshot()
    sn.wait()
    q.enqueue(np.arange(3))
    q.dequeue(2)
    assert q.psyncs == 25                     # 23 enqueues + 2 dequeues
    sn.recover()
    g = m.snapshot()["gauges"]
    assert g["rq.last_recovery_from_delta_slots"] == 5
    assert g["rq.last_recovery_from_snapshot_slots"] == 59
    assert m.snapshot()["collected"]["rq.snapshotter"]["snapshots"] == 1
    sn.close()


# ---------------------------------------------------------------------------
# A dirs snapshot of a queue between the packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ("jax", "torch"))
def test_dirs_snapshot_restores_across_packages(tmp_path, writer):
    """A queue snapshot written by one package's Snapshotter recovers
    through the other's to the state the writer's own recovery reaches,
    leaf for leaf, with the same histogram."""
    rng = np.random.default_rng(31)
    n = 256
    q = Pair(n, "soft")
    _enqueue(q, 1, 150)
    _dequeue(q, 60)
    d = str(tmp_path / "snap")
    if writer == "jax":
        w = JSnapshotter(q.j, d)
        w.snapshot()
        w.wait()
        q.t.snapshot_capture()                # the same stamp generation
    else:
        w = Snapshotter(q.t, d)
        w.snapshot()
        w.wait()
        q.j.snapshot_capture()
    w.close()
    _enqueue(q, 500, 160)                     # wraps past N
    _dequeue(q, 100)
    q.check()
    u = _u(rng, n)
    jsn, tsn = JSnapshotter(q.j, d), Snapshotter(q.t, d)
    jsn.recover(jnp.asarray(u))
    tsn.recover(u)
    q.check()
    np.testing.assert_array_equal(q.t.last_recovery_hist,
                                  q.j.last_recovery_hist)
    jsn.close()
    tsn.close()


def test_both_packages_write_the_same_queue_snapshot_files(tmp_path):
    """One queue state, snapshotted by each package: the same files, leaf
    names, manifest and ``.npy`` dtypes, shapes and values."""
    q = Pair(128, "logfree")
    _enqueue(q, 7, 100)
    _dequeue(q, 33)
    dirs = {}
    for name, cls, x in (("jax", JSnapshotter, q.j),
                         ("torch", Snapshotter, q.t)):
        dirs[name] = str(tmp_path / name)
        sn = cls(x, dirs[name])
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
    assert mans[0]["extra"]["kind"] == "queue"
    for fn in files[0]:
        if fn.endswith(".npy"):
            a, b = (np.load(os.path.join(d, step, fn))
                    for d in dirs.values())
            assert a.dtype == b.dtype and a.shape == b.shape, fn
            np.testing.assert_array_equal(a, b, err_msg=fn)
