"""The port's copy of the sequential oracle against the JAX package's, trace
for trace: the same seeded op sequences, event budgets (crashes inside an
operation) and eviction biases go through ``repro.core.oracle`` and
``repro_torch.core.oracle``; every result, every node (stages, history,
payload), the volatile index, the op records, the counters, the crash
image, the recovered contents and ``check_recovery``'s verdict must be
equal."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import oracle as JO  # noqa: E402
from repro_torch.core import oracle as TO  # noqa: E402

MODES = ("linkfree", "soft", "logfree")


def _nodes(o):
    return [dataclasses.astuple(n) for n in o.nodes]


def _records(o):
    return [dataclasses.astuple(r) for r in o.ops]


def _assert_same(j, t):
    assert _nodes(t) == _nodes(j)
    assert _records(t) == _records(j)
    assert (t.psyncs, t.events, t.crashed) == (j.psyncs, j.events, j.crashed)


def _set_trace(rng, n_ops, key_range):
    kinds = ("insert", "remove", "contains")
    return [(kinds[int(rng.integers(3))], int(rng.integers(key_range)))
            for _ in range(n_ops)]


def _drive_set(o, trace, budget):
    """Run ``trace`` until the event budget lands inside an operation;
    returns the per-op results."""
    out, left = [], budget
    for kind, key in trace:
        before = o.events
        args = (key, key * 10) if kind == "insert" else (key,)
        res = getattr(o, kind)(*args, budget=None if left is None
                               else max(left, 0))
        out.append(res)
        if left is not None:
            left -= o.events - before + (1 if res is None else 0)
        if res is None:
            break
    return out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", range(6))
def test_oracle_set_traces_match(mode, seed):
    rng = np.random.default_rng([seed, MODES.index(mode)])
    cap = 12
    trace = _set_trace(rng, 40, 10)
    budget = None if seed == 0 else int(rng.integers(0, 150))
    j, t = JO.OracleSet(cap, mode=mode), TO.OracleSet(cap, mode=mode)
    assert _drive_set(t, trace, budget) == _drive_set(j, trace, budget)
    assert t.index == j.index
    _assert_same(j, t)
    ev = [int(x) for x in rng.integers(0, 6, cap)]
    img_t, img_j = t.crash(ev), j.crash(ev)
    assert img_t == img_j
    _assert_same(j, t)
    rec_t, rec_j = TO.OracleSet.recover(img_t), JO.OracleSet.recover(img_j)
    assert rec_t == rec_j
    assert t.check_recovery(rec_t) == j.check_recovery(rec_j)
    assert t.check_recovery(rec_t)[0]
    # a recovered set that lost or gained a key: the same verdict too
    for bad in ({**rec_t, 99: 1}, dict(list(rec_t.items())[1:])):
        assert t.check_recovery(bad) == j.check_recovery(bad)


def test_oracle_set_capacity_exhausted_matches():
    for mod in (JO, TO):
        o = mod.OracleSet(2, mode="soft")
        assert o.insert(1, 1) and o.insert(2, 2)
        with pytest.raises(RuntimeError, match="capacity exhausted"):
            o.insert(3, 3)
    with pytest.raises(AssertionError):
        TO.OracleSet(4, mode="bogus")


def _drive_queue(o, trace, budget):
    out, left = [], budget
    for kind, v in trace:
        before = o.events
        b = None if left is None else max(left, 0)
        res = o.enqueue(v, budget=b) if kind == "enqueue" \
            else o.dequeue(budget=b)
        out.append(res)
        if left is not None:
            left -= o.events - before + (1 if res is None else 0)
        if res is None:
            break
    return out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", range(6))
def test_oracle_queue_traces_match(mode, seed):
    rng = np.random.default_rng([seed, 7, MODES.index(mode)])
    cap = 6
    trace = [("enqueue" if rng.random() < 0.6 else "dequeue",
              int(rng.integers(100))) for _ in range(30)]
    budget = None if seed == 0 else int(rng.integers(0, 120))
    j, t = JO.OracleQueue(cap, mode=mode), TO.OracleQueue(cap, mode=mode)
    assert _drive_queue(t, trace, budget) == _drive_queue(j, trace, budget)
    assert (t.head, t.tail) == (j.head, j.tail)
    _assert_same(j, t)
    ev = [int(x) for x in rng.integers(0, 6, cap)]
    img_t, img_j = t.crash(ev), j.crash(ev)
    assert img_t == img_j
    rec_t, rec_j = TO.OracleQueue.recover(img_t), JO.OracleQueue.recover(
        img_j)
    assert rec_t == rec_j
    assert t.check_recovery(rec_t[0]) == j.check_recovery(rec_j[0])
    assert t.check_recovery(rec_t[0])[0]
    bad = rec_t[0] + [12345]
    assert t.check_recovery(bad) == j.check_recovery(bad)
    assert not t.check_recovery(bad)[0]


def test_oracle_budget_counts_down_the_same():
    for budget in (None, 0, 1, 3):
        tb, jb = TO._Budget(budget), JO._Budget(budget)
        rec = TO.OpRecord("insert", 1, None)
        assert [tb.spend(None, rec) for _ in range(5)] == \
            [jb.spend(None, rec) for _ in range(5)]
