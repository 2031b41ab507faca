"""Parity of the repro_torch engine with repro's, bucket backend, all modes.

Both packages run the same calls on the same inputs (numpy, from a seed);
every result and every SetState leaf must be equal, at the same dtype,
after every call.  The JAX side runs as its own tests run it: SetSpec
defaults, so the Pallas kernels in interpret mode.  The port runs on the
CPU, where its kernel wrappers take their plain versions."""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import engine as JE  # noqa: E402
from repro.core.durable_set import COUNTER_MAX as J_COUNTER_MAX  # noqa
from repro.core.nvm import np_hash32  # noqa: E402
from repro.obs import MetricsRegistry as JRegistry  # noqa: E402
from repro_torch.core import engine as TE  # noqa: E402
from repro_torch.core.convert import (state_from_numpy,  # noqa: E402
                                      state_to_numpy)
from repro_torch.core.durable_set import (COUNTER_MAX, MODES,  # noqa: E402
                                          SetState)
from repro_torch.obs import MetricsRegistry  # noqa: E402

OPS = (JE.OP_CONTAINS, JE.OP_INSERT, JE.OP_REMOVE)


def _jleaves(state):
    return {f: np.asarray(v) for f, v in state._asdict().items()}


def _assert_states_equal(tstate, jstate):
    got, want = state_to_numpy(tstate), _jleaves(jstate)
    assert set(got) == set(want) == set(SetState._fields)
    for f in SetState._fields:
        assert got[f].dtype == want[f].dtype, (f, got[f].dtype, want[f].dtype)
        assert got[f].shape == want[f].shape, f
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


class Pair:
    """One JAX DurableMap and one port DurableMap built from one spec;
    ``call`` runs a method on both and checks results and every leaf."""

    def __init__(self, **spec):
        self.j = JE.DurableMap(JE.SetSpec(**spec))
        self.t = TE.DurableMap(TE.SetSpec(**spec), device="cpu")
        self.check()

    def call(self, name, *args, **kw):
        rj = getattr(self.j, name)(*args, **kw)
        rt = getattr(self.t, name)(*args, **kw)
        if name == "crash_and_recover":
            np.testing.assert_array_equal(self.t.last_recovery_hist,
                                          self.j.last_recovery_hist)
            assert self.t.last_recovery_hist.dtype == np.int32
            out = None
        else:
            out = rt.numpy()
            assert out.dtype == np.asarray(rj).dtype
            np.testing.assert_array_equal(out, np.asarray(rj))
        self.check()
        return out

    def check(self):
        _assert_states_equal(self.t.state, self.j.state)
        assert (self.t.psyncs, self.t.ops, len(self.t), self.t.overflowed) \
            == (self.j.psyncs, self.j.ops, len(self.j), self.j.overflowed)


@pytest.mark.parametrize("mode", MODES)
def test_conformance_battery(mode):
    """tests/test_engine.py's backend battery, on both packages at once."""
    p = Pair(capacity=128, mode=mode, backend="bucket")
    assert list(p.call("insert", [5, 6, 7, 6], [50, 60, 70, 61])) == \
        [True, True, True, False]
    assert list(p.call("contains", [5, 6, 7, 8])) == [True, True, True, False]
    assert list(p.call("remove", [6, 8, 6])) == [True, False, False]
    assert list(p.call("get", [5, 6, 7, 9], default=-1)) == [50, -1, 70, -1]
    p.call("crash_and_recover", np.full(128, 0.99, np.float32))
    assert list(p.call("contains", [5, 6, 7])) == [True, False, True]
    assert len(p.t) == 2 and int(p.t.last_recovery_hist[3]) == 2
    assert p.t.psyncs == 0


# The tests below reuse the battery's spec (capacity 128) and batch widths
# (4 and 3 lanes, 11 for apply), so the JAX side compiles each shape once.


@pytest.mark.parametrize("mode", MODES)
def test_apply_batch_equals_sequential_phases(mode):
    rng = np.random.default_rng(3)
    p = Pair(capacity=128, mode=mode, backend="bucket")
    seed = np.array([1, 3, 5, 7], np.int32)
    p.call("insert", seed, seed)
    ops = np.array([JE.OP_CONTAINS] * 4 + [JE.OP_INSERT] * 4
                   + [JE.OP_REMOVE] * 3, np.int32)
    keys = rng.integers(0, 9, ops.size).astype(np.int32)
    res = p.call("apply", ops, keys, keys * 2)
    seq = Pair(capacity=128, mode=mode, backend="bucket")
    seq.call("insert", seed, seed)
    exp = np.concatenate([seq.call("contains", keys[:4]),
                          seq.call("insert", keys[4:8], keys[4:8] * 2),
                          seq.call("remove", keys[8:])])
    np.testing.assert_array_equal(res, exp)
    assert (p.t.psyncs, p.t.ops, len(p.t)) == \
        (seq.t.psyncs, seq.t.ops, len(seq.t))


@pytest.mark.parametrize("mode", MODES)
def test_apply_batch_phase_linearization(mode):
    p = Pair(capacity=128, mode=mode, backend="bucket")
    # contains sees the pre-batch state; a remove lane sees the insert of
    # the same batch; duplicate lanes lose; OP_NOP is a no-op
    res = p.call("apply", [0, 1, 2, 1, 2, 3, 0, 3, 3, 3, 3],
                 [7, 7, 7, 7, 7, 9, 9, 0, 0, 0, 0])
    assert list(res) == [False, True, True, False, False, False, False,
                         False, False, False, False]
    assert len(p.t) == 0 and p.t.ops == 6


def test_counters_saturate_from_converted_state():
    spec = dict(capacity=128, mode="logfree", backend="bucket")
    assert COUNTER_MAX == int(J_COUNTER_MAX)
    near = COUNTER_MAX - 5
    p = Pair(**spec)
    planes = _jleaves(p.j.state)
    planes["n_psync"] = np.asarray(near, np.int32)
    planes["n_ops"] = np.asarray(near, np.int32)
    p.j.state = p.j.state._replace(n_psync=jnp.asarray(near, jnp.int32),
                                   n_ops=jnp.asarray(near, jnp.int32))
    p.t.state = state_from_numpy(planes, device="cpu")
    p.check()
    p.call("insert", np.arange(4))            # 8 psyncs > headroom
    assert p.t.psyncs == COUNTER_MAX and p.t.ops == COUNTER_MAX - 1
    p.call("contains", np.arange(4))
    assert p.t.ops == COUNTER_MAX


def _warnings_of(fn):
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("default")
        fn()
    return [str(w.message) for w in rec
            if issubclass(w.category, RuntimeWarning)]


def test_overflow_warning_rearmed_after_recovery():
    """Pool exhaustion latches and warns once; recovery recomputes the
    latch from the rebuilt index and re-arms the warning; both packages."""
    p = Pair(capacity=4, mode="soft", backend="bucket")
    for m in (p.j, p.t):
        assert len(_warnings_of(lambda: m.insert(np.arange(10)))) == 1
        assert m.overflowed
        assert _warnings_of(lambda: m.insert([99])) == []   # one shot
    p.check()
    p.call("crash_and_recover")
    assert not p.t.overflowed
    p.call("remove", [0])
    for m in (p.j, p.t):
        assert _warnings_of(lambda: m.insert([50])) == []   # room again
        assert len(_warnings_of(lambda: m.insert([60]))) == 1
    p.check()


SPECS = [
    dict(capacity=32, backend="bucket"),
    dict(capacity=32, backend="bucket", n_buckets=512),
    dict(capacity=100, backend="bucket", bucket_width=3, stash_size=1),
    dict(capacity=(1 << 24) - 1, backend="bucket"),
    dict(capacity=1 << 24, backend="bucket"),
    dict(capacity=0, backend="bucket"),
    dict(capacity=8, backend="bucket", mode="nope"),
    dict(capacity=8, backend="bucket", n_buckets=3),
    dict(capacity=8, backend="bucket", n_buckets=-8),
    dict(capacity=8, backend="bucket", stash_size=0),
    dict(capacity=8, backend="bucket", bucket_width=0),
    dict(capacity=8, backend="bucket", table_factor=0),
    dict(capacity=8, backend="bucket", max_probe=0),
    dict(capacity=8, backend="probe", n_buckets=520),
    dict(capacity=-1, backend="scan"),
    dict(capacity=8, backend="btree"),
]


@pytest.mark.parametrize("kw", SPECS, ids=lambda kw: repr(sorted(kw.items())))
def test_setspec_accepts_and_refuses_the_same_specs(kw):
    try:
        js = JE.SetSpec(**kw)
    except ValueError:
        with pytest.raises(ValueError):
            TE.SetSpec(**kw)
        return
    ts = TE.SetSpec(**kw)
    if kw["backend"] in TE.BACKENDS:
        assert ts.bucket_geometry() == js.bucket_geometry()
    else:
        with pytest.raises(KeyError, match="unknown index backend"):
            TE.DurableMap(ts, device="cpu")


def test_every_jax_backend_is_registered_in_the_port():
    """Every backend of the JAX package is registered in the port, and a
    spec naming it constructs without raising."""
    assert set(JE.BACKENDS) - set(TE.BACKENDS) == set()
    for backend in sorted(JE.BACKENDS):
        TE.SetSpec(capacity=8, backend=backend)


def test_every_jax_backend_constructs_in_the_port():
    """Every backend of the JAX package is registered in the port and a map
    on it constructs; the default is the probe backend, as in JAX."""
    assert set(TE.BACKENDS) == set(JE.BACKENDS)
    for backend in sorted(JE.BACKENDS):
        TE.DurableMap(TE.SetSpec(capacity=8, backend=backend), device="cpu")
    assert TE.SetSpec(capacity=8).backend == JE.SetSpec(capacity=8).backend


def test_use_kernels_false_matches_true():
    keys = np.arange(40, dtype=np.int32)
    out = {}
    for flag in (True, False):
        m = TE.DurableMap(TE.SetSpec(capacity=96, backend="bucket",
                                     use_kernels=flag), device="cpu")
        m.insert(keys, keys * 3)
        m.remove(keys[::3])
        m.crash_and_recover()
        out[flag] = (m.contains(keys).numpy(), state_to_numpy(m.state))
    np.testing.assert_array_equal(out[True][0], out[False][0])
    for f in SetState._fields:
        np.testing.assert_array_equal(out[True][1][f], out[False][1][f])


def test_state_conversion_round_trip_and_dtype_check():
    m = TE.DurableMap(TE.SetSpec(capacity=16, backend="bucket"),
                      device="cpu")
    m.insert([3, 4, 5])
    planes = state_to_numpy(m.state)
    back = state_from_numpy(planes, device="cpu")
    for f in SetState._fields:
        assert torch.equal(getattr(back, f), getattr(m.state, f))
    bad = dict(planes, n_psync=planes["n_psync"].astype(np.int64))
    with pytest.raises(ValueError, match="n_psync"):
        state_from_numpy(bad, device="cpu")
    with pytest.raises(ValueError, match="missing"):
        state_from_numpy({k: v for k, v in planes.items() if k != "epoch"},
                         device="cpu")


def test_metrics_snapshot_matches():
    """The attach_metrics path: both facades report the same collected
    counters across a recovery (timings aside)."""
    jm = JE.DurableMap(JE.SetSpec(capacity=128, backend="bucket",
                                  mode="linkfree"), metrics=JRegistry())
    tm = TE.DurableMap(TE.SetSpec(capacity=128, backend="bucket",
                                  mode="linkfree"), metrics=MetricsRegistry(),
                       device="cpu")
    snaps = []
    for m, reg in ((jm, jm._m), (tm, tm._m)):
        m.insert([1, 2, 3, 3])
        m.contains([1, 9, 2, 8])
        m.crash_and_recover()
        m.remove([2, 5, 2])
        snap = reg.snapshot()
        c = dict(snap["collected"]["map"])
        c.pop("last_recovery_seconds")
        snaps.append((c, snap["counters"]))
    assert snaps[0] == snaps[1]
    # 3 inserts + 1 duplicate-lane flush, then 1 remove + 1 duplicate
    assert snaps[1][0]["psync_total"] == 6 and snaps[1][0]["size"] == 2


def test_bucket_overflow_spills_to_the_stash():
    """Three keys of one bucket in a two-way table: the third lands in the
    stash, and all three are found."""
    nb, found, k = 8, [], 1
    while len(found) < 3:
        if int(np_hash32(np.array([k]))[0] % nb) == 0:
            found.append(k)
        k += 1
    m = TE.DurableMap(TE.SetSpec(capacity=16, backend="bucket", n_buckets=nb,
                                 bucket_width=2), device="cpu")
    assert m.insert(found).all()
    assert int(m.state.stash_n) == 1
    assert m.contains(found).all()
