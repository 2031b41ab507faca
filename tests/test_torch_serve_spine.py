"""End-to-end crash adversary for the port's durable request/completion
spine, held against the JAX package's spine on the same inputs.

The spine (``repro_torch.launch.serve --queue``) composes three durable
structures -- request ``DurableQueue``, response ``DurableQueue``,
completion registry -- in the order

  1. durable ack       req_q.enqueue(ids)          (psync per request)
  2. volatile peek     req_q.peek(b)               (zero psync)
  3. process           pure compute
  4. response enqueue  resp_q.enqueue(ids)
  5. registry insert   registry.insert(ids, vals)
  6. dequeue COMMIT    req_q.dequeue(b)

The cases of tests/test_serve_spine.py run once on the JAX package's
structures and once on the port's (``device="cpu"``) under the same seeds:
a crash at every step boundary, multi-wave traffic with interleaved
crashes on each registry backend, the 4-psync bound, and the pipelined
spine with and without a crash before the flush.  Each run must keep its
invariants (no acknowledged request lost, no completion duplicated), and
the two runs must agree on every psync count, every survivor and every
queue leaf.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.core as J  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.core.queue import QueueState  # noqa: E402

STEPS = ("after_ack", "after_peek", "after_resp_enqueue",
         "after_registry_insert", "after_dequeue_commit")
PKGS = {"jax": (J, {}), "torch": (T, {"device": "cpu"})}


def _process(ids):
    """Stand-in for generation: the recorded completion value."""
    return (ids * 2 + 1).astype(np.int32)


def _make_spine(pkg, capacity=16, backend="probe"):
    mod, kw = PKGS[pkg]
    qspec = mod.QueueSpec(capacity=capacity)
    return (mod.DurableQueue(qspec, **kw), mod.DurableQueue(qspec, **kw),
            mod.DurableMap(mod.SetSpec(capacity=4 * capacity,
                                       backend=backend), **kw))


def _make_pipelined(pkg, capacity):
    mod, kw = PKGS[pkg]
    qspec = mod.QueueSpec(capacity=capacity)
    return (mod.DurableQueue(qspec, **kw), mod.DurableQueue(qspec, **kw),
            mod.ShardedDurableMap(mod.SetSpec(capacity=128), n_shards=4,
                                  pipeline_depth=2, **kw))


def _run_until(req_q, resp_q, registry, ids, crash_after):
    """Drive one batch through the spine, stopping after ``crash_after``."""
    acked = np.asarray(req_q.enqueue(ids))
    assert acked.all(), "admission queue full"
    if crash_after == "after_ack":
        return
    served, ok = req_q.peek(len(ids))
    np.testing.assert_array_equal(served[ok], ids)
    if crash_after == "after_peek":
        return
    resp_q.enqueue(served[ok])
    if crash_after == "after_resp_enqueue":
        return
    registry.insert(ids, _process(ids))
    if crash_after == "after_registry_insert":
        return
    _, committed = req_q.dequeue(len(ids))
    assert committed.all()
    assert crash_after == "after_dequeue_commit"


def _crash_all(req_q, resp_q, registry, rng):
    n = req_q.spec.capacity
    req_q.crash_and_recover(u=rng.random(n).astype(np.float32))
    resp_q.crash_and_recover(u=rng.random(n).astype(np.float32))
    registry.crash_and_recover()
    assert req_q.psyncs == 0 and resp_q.psyncs == 0, \
        "recovery must issue no psync"


def _drain(req_q, resp_q, registry):
    """Redelivery loop a recovered server runs: re-serve every request
    still live in the request queue, skipping (deduping) the ones the
    registry already shows completed, then commit their dequeues.
    Returns the number of requests re-served."""
    fresh_total = 0
    while len(req_q) > 0:
        live, ok = req_q.peek(req_q.spec.capacity)
        live = live[np.asarray(ok)]
        fresh = live[~np.array(registry.contains(live), bool)]
        if fresh.size:
            resp_q.enqueue(fresh)
            registry.insert(fresh, _process(fresh))
            fresh_total += fresh.size
        _, committed = req_q.dequeue(len(live))
        assert np.asarray(committed).all()
    return fresh_total


def _leaves(q):
    """The queue's state as numpy leaves (either package)."""
    return {f: np.asarray(getattr(q.state, f)) for f in QueueState._fields}


def _record(req_q, resp_q, registry, **extra):
    """What the two packages' runs must agree on."""
    resp, ok = resp_q.peek(resp_q.spec.capacity)
    return dict(psyncs=(req_q.psyncs, resp_q.psyncs, registry.psyncs),
                ops=(req_q.ops, resp_q.ops, registry.ops),
                sizes=(len(req_q), len(resp_q), len(registry)),
                responses=resp[np.asarray(ok)].tolist(),
                req_leaves=_leaves(req_q), resp_leaves=_leaves(resp_q),
                **extra)


def _assert_records_equal(rec):
    got, want = rec["torch"], rec["jax"]
    assert got.keys() == want.keys()
    for k in got:
        if k.endswith("_leaves"):
            for f in got[k]:
                assert got[k][f].dtype == want[k][f].dtype, (k, f)
                np.testing.assert_array_equal(got[k][f], want[k][f],
                                              err_msg=f"{k}.{f}")
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("crash_after", STEPS)
def test_no_acked_request_lost_no_completion_duplicated(crash_after):
    """Crash at every spine step boundary under the per-slot eviction
    adversary: after recovery + drain, every acknowledged request is
    registered EXACTLY once and the request queue is empty -- in both
    packages, with the same psyncs, survivors and queue leaves."""
    rec = {}
    for pkg in PKGS:
        rng = np.random.default_rng(STEPS.index(crash_after))
        req_q, resp_q, registry = _make_spine(pkg)
        ids = np.arange(100, 108, dtype=np.int32)
        _run_until(req_q, resp_q, registry, ids, crash_after)
        pre = (req_q.psyncs, resp_q.psyncs, registry.psyncs)
        _crash_all(req_q, resp_q, registry, rng)
        survivors = len(req_q)
        fresh = _drain(req_q, resp_q, registry)
        done = np.array(registry.contains(ids))
        assert done.all(), f"lost acked requests {ids[~done]} ({crash_after})"
        assert len(registry) == len(ids), "completion duplicated in registry"
        assert len(req_q) == 0 and not req_q.overflowed
        resp, ok = resp_q.peek(resp_q.spec.capacity)
        assert set(ids.tolist()) <= set(resp[np.asarray(ok)].tolist())
        rec[pkg] = _record(req_q, resp_q, registry, pre_crash=pre,
                           survivors=survivors, fresh=fresh)
    _assert_records_equal(rec)


@pytest.mark.parametrize("backend", ("probe", "scan", "bucket"))
def test_multi_wave_spine_with_interleaved_crashes(backend):
    """Several waves through a small ring (ticket wraparound) with a
    crash at a random step boundary each wave: the registry ends with
    every acked id exactly once, and both packages agree wave by wave."""
    rec = {}
    for pkg in PKGS:
        rng = np.random.default_rng(42)
        req_q, resp_q, registry = _make_spine(pkg, capacity=8,
                                              backend=backend)
        all_ids, per_wave = [], []
        for wave in range(6):
            ids = np.arange(200 + 8 * wave, 200 + 8 * wave + 4,
                            dtype=np.int32)
            all_ids += ids.tolist()
            step = STEPS[rng.integers(0, len(STEPS))]
            _run_until(req_q, resp_q, registry, ids, step)
            _crash_all(req_q, resp_q, registry, rng)
            survivors = len(req_q)
            _drain(req_q, resp_q, registry)
            done = np.array(registry.contains(np.asarray(all_ids,
                                                         np.int32)))
            assert done.all(), f"wave {wave} lost {np.asarray(all_ids)[~done]}"
            assert len(registry) == len(all_ids)
            got, ok = resp_q.dequeue(8)
            got = got[np.asarray(ok)].tolist()
            assert set(ids.tolist()) <= set(got)
            while len(resp_q):
                resp_q.dequeue(8)
            per_wave.append((step, survivors, got, req_q.psyncs,
                             resp_q.psyncs, registry.psyncs))
        assert not req_q.overflowed and not resp_q.overflowed
        assert int(np.asarray(req_q.state.tail)) > 8    # the ring wrapped
        rec[pkg] = _record(req_q, resp_q, registry, waves=per_wave)
    _assert_records_equal(rec)


def test_spine_psync_bound():
    """Crash-free spine pass costs exactly 4 psyncs per request (ack +
    response + registry insert + dequeue commit), in both packages."""
    rec = {}
    for pkg in PKGS:
        req_q, resp_q, registry = _make_spine(pkg)
        ids = np.arange(8, dtype=np.int32)
        _run_until(req_q, resp_q, registry, ids, "after_dequeue_commit")
        total = req_q.psyncs + resp_q.psyncs + registry.psyncs
        assert total == 4 * len(ids), (req_q.psyncs, resp_q.psyncs,
                                       registry.psyncs)
        rec[pkg] = _record(req_q, resp_q, registry)
    _assert_records_equal(rec)


def test_pipelined_spine_exactly_once_and_psync_bound():
    """The ``serve --pipeline`` wave loop: wave k+1's durable ack
    enqueues while wave k "generates", and each wave's pipelined registry
    insert is flushed durable BEFORE that wave's dequeue commit.
    Exactly-once completion and the exact 4 psyncs/request bill survive
    pipelining, in both packages."""
    rec = {}
    for pkg in PKGS:
        req_q, resp_q, registry = _make_pipelined(pkg, 32)
        ids = np.arange(300, 316, dtype=np.int32)
        waves = np.array_split(ids, 4)
        assert np.asarray(req_q.enqueue(waves[0])).all()
        for k, wave in enumerate(waves):
            served, ok = req_q.peek(len(wave))      # volatile, zero psync
            np.testing.assert_array_equal(served[np.asarray(ok)], wave)
            if k + 1 < len(waves):   # ack wave k+1 during wave k
                assert np.asarray(req_q.enqueue(waves[k + 1])).all()
            resp_q.enqueue(wave)
            registry.insert(wave, _process(wave))   # staged, lazy
            registry.pipeline_flush()   # durable BEFORE the dequeue commit
            _, committed = req_q.dequeue(len(wave))
            assert np.asarray(committed).all()
        total = req_q.psyncs + resp_q.psyncs + registry.psyncs
        assert total == 4 * len(ids), (req_q.psyncs, resp_q.psyncs,
                                       registry.psyncs)
        assert len(registry) == len(ids) and len(req_q) == 0
        assert np.array(registry.contains(ids)).all()
        rec[pkg] = _record(req_q, resp_q, registry)
    _assert_records_equal(rec)


def test_pipelined_spine_crash_before_flush_loses_nothing():
    """Crash with a wave's registry insert still STAGED (after response
    enqueue, before flush + dequeue commit): the staged insert is
    abandoned psync-free, the wave is still live in the recovered request
    queue, and the redelivery drain completes it exactly once -- the same
    in both packages."""
    rec = {}
    for pkg in PKGS:
        rng = np.random.default_rng(7)
        req_q, resp_q, registry = _make_pipelined(pkg, 16)
        done = np.arange(400, 404, dtype=np.int32)   # wave 0 completes
        assert np.asarray(req_q.enqueue(done)).all()
        resp_q.enqueue(done)
        registry.insert(done, _process(done))
        registry.pipeline_flush()
        _, committed = req_q.dequeue(len(done))
        assert np.asarray(committed).all()
        live = np.arange(404, 408, dtype=np.int32)   # wave 1 crashes
        assert np.asarray(req_q.enqueue(live)).all()
        resp_q.enqueue(live)
        h = registry.insert(live, _process(live))    # staged, not durable
        n = req_q.spec.capacity
        req_q.crash_and_recover(u=rng.random(n).astype(np.float32))
        resp_q.crash_and_recover(u=rng.random(n).astype(np.float32))
        registry.crash_and_recover()
        assert h.abandoned and registry.pipeline_abandoned == 1
        assert len(req_q) == len(live), "uncommitted wave must stay live"
        fresh = _drain(req_q, resp_q, registry)
        all_ids = np.concatenate([done, live])
        assert np.array(registry.contains(all_ids)).all()
        assert len(registry) == len(all_ids) and len(req_q) == 0
        rec[pkg] = _record(req_q, resp_q, registry, fresh=fresh)
    _assert_records_equal(rec)
