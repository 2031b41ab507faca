"""The port's durable queue against the JAX package's, on the CPU.

The cases of tests/test_queue.py, each driving a JAX ``DurableQueue`` and
the port's (``device="cpu"``) through the same trace, made from a numpy
seed, in all three modes.  After every step the ``ok`` lanes, the
tickets, the values, the histograms and every ``QueueState`` leaf (the
counters and the overflow latch among them) must be equal, at the same
dtype.  The JAX side runs as its own tests run it (``recovery_scan``'s
Pallas kernel in interpret mode).  The hypothesis properties run against
the port's ``OracleQueue``, with few examples.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import DurableQueue as JQueue  # noqa: E402
from repro.core import QueueSpec as JSpec  # noqa: E402
from repro.core import queue as JQ  # noqa: E402
from repro_torch.core import (DELETED, MODES, VALID, DurableMap,  # noqa: E402
                              DurableQueue, OracleQueue, QueueSpec,
                              QueueState, SetSpec)
from repro_torch.core import queue as Q  # noqa: E402


def assert_states_equal(t_state, j_state, skip=()):
    """Every leaf of the port's QueueState equals the JAX one, at the same
    dtype."""
    assert t_state._fields == j_state._fields
    for f in QueueState._fields:
        if f in skip:
            continue
        got = getattr(t_state, f).numpy()
        want = np.asarray(getattr(j_state, f))
        assert got.dtype == want.dtype, (f, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=f"leaf {f}")


class Pair:
    """A JAX queue and the port's, driven in lockstep: every call returns
    the port's result after checking it, and every leaf, against JAX's."""

    def __init__(self, capacity, mode="soft", metrics=None):
        self.j = JQueue(JSpec(capacity=capacity, mode=mode))
        self.t = DurableQueue(QueueSpec(capacity=capacity, mode=mode),
                              device="cpu", metrics=metrics)
        self.check()

    @property
    def spec(self):
        return self.t.spec

    def check(self):
        assert_states_equal(self.t.state, self.j.state)

    def enqueue(self, vals):
        vals = np.asarray(vals, np.int32)
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            ok_j = np.asarray(self.j.enqueue(vals))
        n_j = sum(issubclass(w.category, RuntimeWarning) for w in rec)
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            ok_t = self.t.enqueue(vals)
        n_t = sum(issubclass(w.category, RuntimeWarning) for w in rec)
        assert isinstance(ok_t, torch.Tensor) and ok_t.dtype == torch.bool
        np.testing.assert_array_equal(ok_t.numpy(), ok_j)
        np.testing.assert_array_equal(self.t.last_tickets,
                                      self.j.last_tickets)
        assert self.t.last_tickets.dtype == self.j.last_tickets.dtype
        assert n_t == n_j                    # the same one-shot warnings
        self.check()
        return ok_t.numpy()

    def _read(self, name, n, default):
        got = getattr(self.t, name)(n, default=default)
        want = getattr(self.j, name)(n, default=default)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        self.check()
        return got

    def dequeue(self, n, default=0):
        return self._read("dequeue", n, default)

    def peek(self, n, default=0):
        return self._read("peek", n, default)

    def crash_and_recover(self, u=None):
        self.j.crash_and_recover(None if u is None else jnp.asarray(u))
        self.t.crash_and_recover(u)
        np.testing.assert_array_equal(self.t.last_recovery_hist,
                                      np.asarray(self.j.last_recovery_hist))
        self.check()

    def __len__(self):
        assert len(self.t) == len(self.j)
        return len(self.t)

    @property
    def psyncs(self):
        assert self.t.psyncs == self.j.psyncs
        return self.t.psyncs

    @property
    def ops(self):
        assert self.t.ops == self.j.ops
        return self.t.ops

    @property
    def overflowed(self):
        assert self.t.overflowed == self.j.overflowed
        return self.t.overflowed


def _u(rng, n):
    return rng.random(n).astype(np.float32)


# ---------------------------------------------------------------------------
# Spec + basics
# ---------------------------------------------------------------------------


def test_spec_validation():
    for bad in (dict(capacity=12), dict(capacity=0),
                dict(capacity=8, mode="nope")):
        with pytest.raises(ValueError):
            JSpec(**bad)
        with pytest.raises(ValueError):
            QueueSpec(**bad)
    for mode in MODES:
        assert QueueSpec(capacity=8, mode=mode).psync_per_success() == \
            JSpec(capacity=8, mode=mode).psync_per_success()
    assert QueueSpec(capacity=8, mode="logfree").psync_per_success() == 2


def test_make_state_matches_jax():
    spec = QueueSpec(capacity=16)
    assert_states_equal(Q.make_state(spec, device="cpu"),
                        JQ.make_state(JSpec(capacity=16)))
    if not torch.cuda.is_available():          # the GPU is the default
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Q.make_state(spec)


@pytest.mark.parametrize("mode", MODES)
def test_fifo_basic(mode):
    q = Pair(8, mode)
    assert q.enqueue([10, 20, 30]).all()
    assert len(q) == 3
    vals, ok = q.dequeue(2)
    np.testing.assert_array_equal(vals, [10, 20])
    assert ok.all() and len(q) == 1
    vals, ok = q.dequeue(3, default=-1)
    np.testing.assert_array_equal(vals, [30, -1, -1])
    np.testing.assert_array_equal(ok, [True, False, False])
    assert len(q) == 0


@pytest.mark.parametrize("mode", MODES)
def test_full_enqueue_fails_and_empty_dequeue_fails(mode):
    q = Pair(4, mode)
    ok = q.enqueue(np.arange(6, dtype=np.int32))
    np.testing.assert_array_equal(ok, [True] * 4 + [False] * 2)
    assert len(q) == 4 and q.overflowed
    q2 = Pair(4, mode)
    _, ok = q2.dequeue(2)
    assert not ok.any() and not q2.overflowed     # empty != overflow


@pytest.mark.parametrize("mode", MODES)
def test_wraparound_recycles_slots(mode):
    """Ticket t lives in slot t & (N-1); many rounds through a tiny ring
    keep FIFO order and the stage machine equal to JAX's."""
    q = Pair(4, mode)
    expect, nxt = [], 0
    rng = np.random.default_rng(3)
    for _ in range(40):
        k = int(rng.integers(1, 4))
        if rng.random() < 0.5 and len(expect) + k <= 4:
            vs = list(range(nxt, nxt + k))
            nxt += k
            assert q.enqueue(vs).all()
            expect += vs
        else:
            vals, ok = q.dequeue(k)
            got = [int(v) for v, o in zip(vals, ok) if o]
            assert got == expect[:len(got)]
            expect = expect[len(got):]
        assert len(q) == len(expect)
    assert not q.overflowed
    assert int(q.t.state.tail) > 4                # the ring wrapped


@pytest.mark.parametrize("mode", MODES)
def test_active_mask_lanes_are_exact_noops(mode):
    jspec, spec = JSpec(capacity=8, mode=mode), QueueSpec(capacity=8,
                                                          mode=mode)
    per = spec.psync_per_success()
    active = np.array([True, False, True, False])
    vals = np.arange(4, dtype=np.int32)
    js, jok, jtk = JQ.enqueue_impl(JQ.make_state(jspec), jnp.asarray(vals),
                                   spec=jspec, active=jnp.asarray(active))
    ts, tok, ttk = Q.enqueue_impl(Q.make_state(spec, device="cpu"),
                                  torch.from_numpy(vals), spec=spec,
                                  active=torch.from_numpy(active))
    assert_states_equal(ts, js)
    np.testing.assert_array_equal(tok.numpy(), [True, False, True, False])
    np.testing.assert_array_equal(ttk.numpy(), [0, -1, 1, -1])
    np.testing.assert_array_equal(ttk.numpy(), np.asarray(jtk))
    assert ttk.dtype == torch.int32
    assert int(Q.size(ts)) == 2
    assert int(ts.n_psync) == 2 * per         # inactive lanes pay nothing
    assert int(ts.n_ops) == 2
    want = np.array([False, True, True, True])
    js, jv, jok, jtk = JQ.dequeue_impl(js, jnp.asarray(want), spec=jspec)
    ts, tv, tok, ttk = Q.dequeue_impl(ts, torch.from_numpy(want), spec=spec)
    assert_states_equal(ts, js)
    np.testing.assert_array_equal(tv.numpy(), [0, 0, 2, 0])
    np.testing.assert_array_equal(tok.numpy(), [False, True, True, False])
    for a, b in ((tv, jv), (tok, jok), (ttk, jtk)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("mode", MODES)
def test_peek_is_pure(mode):
    q = Pair(8, mode)
    q.enqueue([5, 6])
    p0, o0 = q.psyncs, q.ops
    state0 = tuple(t.clone() for t in q.t.state)
    vals, ok = q.peek(4)
    np.testing.assert_array_equal(vals[:2], [5, 6])
    np.testing.assert_array_equal(ok, [True, True, False, False])
    assert (q.psyncs, q.ops) == (p0, o0)
    assert all(torch.equal(a, b) for a, b in zip(q.t.state, state0))
    assert len(q) == 2                        # nothing consumed
    # the functional peek: values, ok and tickets equal JAX's
    want = np.array([True, False, True, True, True])
    got = Q.peek(q.t.state, torch.from_numpy(want), spec=q.spec, default=-7)
    exp = JQ.peek(q.j.state, jnp.asarray(want), spec=q.j.spec, default=-7)
    for a, b in zip(got, exp):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# Exact psync accounting
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_psync_exact_per_successful_op(mode):
    """Exactly psync_per_success per successful enqueue/dequeue, 0 for
    full-enqueue/empty-dequeue, 0 during recovery."""
    q = Pair(8, mode)
    per = q.spec.psync_per_success()
    ok = q.enqueue(np.arange(12, dtype=np.int32))
    succ = int(ok.sum())
    assert succ == 8 and q.psyncs == per * succ
    _, dok = q.dequeue(12)                    # 8 succeed, 4 empty-fail
    succ += int(dok.sum())
    assert q.psyncs == per * succ
    _, dok = q.dequeue(3)                     # all empty: zero psync
    assert not dok.any() and q.psyncs == per * succ
    assert q.ops == 12 + 12 + 3


@pytest.mark.parametrize("mode", MODES)
def test_recovery_issues_zero_psyncs_and_psyncs_stay_flat(mode):
    """The cumulative psync count across crash/recover cycles equals the
    per-success bound exactly: recovery itself contributes ZERO."""
    q = Pair(16, mode)
    per = q.spec.psync_per_success()
    rng = np.random.default_rng(11)
    total_psyncs = total_succ = live = 0
    for _ in range(6):
        ok = q.enqueue(rng.integers(0, 100, 5).astype(np.int32))
        total_succ += int(ok.sum())
        live += int(ok.sum())
        _, dok = q.dequeue(int(rng.integers(1, 5)))
        total_succ += int(dok.sum())
        live -= int(dok.sum())
        total_psyncs += q.psyncs              # counter resets at recovery
        q.crash_and_recover(_u(rng, 16))
        assert q.psyncs == 0, "recovery must issue no psync"
        assert len(q) == live
    assert total_psyncs == per * total_succ


# ---------------------------------------------------------------------------
# Oracle trace conformance
# ---------------------------------------------------------------------------


def _drive_pair(q, o, trace):
    """Run a trace through the batched queues and the port's sequential
    oracle, element by element in lane order."""
    for kind, arg in trace:
        if kind == "enqueue":
            vs = np.asarray(arg, np.int32)
            got = q.enqueue(vs)
            exp = np.array([o.enqueue(int(v)) for v in vs], bool)
            np.testing.assert_array_equal(got, exp, err_msg=str((kind, arg)))
        else:
            vals, ok = q.dequeue(arg, default=-1)
            exp = [o.dequeue() for _ in range(arg)]
            np.testing.assert_array_equal(ok, [e[0] for e in exp])
            np.testing.assert_array_equal(
                vals, [(-1 if e[1] is None else e[1]) for e in exp])


@pytest.mark.parametrize("mode", MODES)
def test_oracle_trace_conformance(mode):
    """Random mixed traces: per-lane results AND the psync counter match
    the sequential OracleQueue exactly, in every mode."""
    rng = np.random.default_rng(7)
    for seed in range(3):
        q = Pair(16, mode)
        o = OracleQueue(16, mode=mode)
        trace = []
        for _ in range(12):
            if rng.random() < 0.55:
                trace.append(("enqueue",
                              rng.integers(0, 99, rng.integers(1, 6))))
            else:
                trace.append(("dequeue", int(rng.integers(1, 6))))
        _drive_pair(q, o, trace)
        assert q.psyncs == o.psyncs, (mode, seed)
        assert len(q) == o.tail - o.head


# ---------------------------------------------------------------------------
# Crash adversary + recovery
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_recovery_rebuilds_head_tail_from_stages_alone(mode):
    q = Pair(8, mode)
    q.enqueue([1, 2, 3, 4, 5])
    q.dequeue(2)
    h, t = int(q.t.state.head), int(q.t.state.tail)
    q.crash_and_recover()
    assert (int(q.t.state.head), int(q.t.state.tail)) == (h, t)
    vals, ok = q.dequeue(3)
    np.testing.assert_array_equal(vals[ok], [3, 4, 5])


@pytest.mark.parametrize("mode", MODES)
def test_per_lane_crash_adversary(mode):
    """The per-slot eviction adversary can never lose an acknowledged
    enqueue nor resurrect a committed dequeue; the port recovers what JAX
    recovers, leaf for leaf, through wraparound."""
    rng = np.random.default_rng(23)
    for trial in range(4):
        q = Pair(16, mode)
        expect, nxt = [], 0
        for _ in range(int(rng.integers(3, 10))):
            if rng.random() < 0.6:
                k = int(rng.integers(1, 6))
                vs = np.arange(nxt, nxt + k, dtype=np.int32)
                nxt += k
                ok = q.enqueue(vs)
                expect += [int(v) for v, o in zip(vs, ok) if o]
            else:
                _, ok = q.dequeue(int(rng.integers(1, 6)))
                expect = expect[int(ok.sum()):]
        q.crash_and_recover(_u(rng, 16))
        assert not q.overflowed, "recovery found a FIFO hole"
        assert len(q) == len(expect)
        vals, ok = q.dequeue(16)
        assert [int(v) for v, o in zip(vals, ok) if o] == expect, \
            (mode, trial)


def _recover_both(persisted, tickets, vals, stamp=None, use_kernels=True):
    spec, jspec = QueueSpec(capacity=persisted.size,
                            use_kernels=use_kernels), \
        JSpec(capacity=persisted.size)
    t_args = [torch.from_numpy(a) for a in (persisted, tickets, vals)]
    j_args = [jnp.asarray(a) for a in (persisted, tickets, vals)]
    if stamp is not None:
        t_args.append(torch.from_numpy(stamp))
        j_args.append(jnp.asarray(stamp))
    ts, th = Q.recover(*t_args, spec=spec)
    js, jh = JQ.recover(*j_args, spec=jspec)
    assert_states_equal(ts, js)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    return ts


def test_recovery_latches_fifo_hole():
    """A persisted image with a hole in the live ticket range latches
    ``overflow``, in both packages, and a clean one does not."""
    persisted = np.zeros(8, np.int32)
    tickets = np.arange(8, dtype=np.int32)
    persisted[5], persisted[7], persisted[6] = VALID, VALID, DELETED
    state = _recover_both(persisted, tickets, tickets * 10)
    assert bool(state.overflow)
    clean = persisted.copy()
    clean[6] = VALID
    state = _recover_both(clean, tickets, tickets * 10)
    assert not bool(state.overflow)
    assert (int(state.head), int(state.tail)) == (5, 8)


@pytest.mark.parametrize("stamped", (False, True))
@pytest.mark.parametrize("seed", range(4))
def test_recover_matches_jax_on_arbitrary_planes(seed, stamped):
    """Random stage, ticket, value and stamp planes (holes, no live
    element, only DELETED slots): the same cursors, latch, epoch and
    histogram as JAX's ``recover``."""
    rng = np.random.default_rng(seed)
    n = 64
    persisted = rng.integers(0, 5, n).astype(np.int32)
    if seed == 1:
        persisted[persisted == VALID] = DELETED    # nothing live
    tickets = rng.permutation(4 * n)[:n].astype(np.int32)
    vals = rng.integers(-1000, 1000, n).astype(np.int32)
    stamp = rng.integers(0, 9, n).astype(np.int32) if stamped else None
    _recover_both(persisted, tickets, vals, stamp)
    _recover_both(persisted, tickets, vals, stamp, use_kernels=False)


def test_recovery_kernel_route_matches_plain():
    """``use_kernels`` on and off give the same state (on the CPU both run
    the plain scan; the card tests hold the CUDA kernel to it)."""
    q = Pair(128)
    q.enqueue(np.arange(100, dtype=np.int32))
    q.dequeue(37)
    img = Q.crash(q.t.state, torch.zeros(128))
    sp, hp = Q.recover(*img, spec=QueueSpec(capacity=128))
    sr, hr = Q.recover(*img, spec=QueueSpec(capacity=128,
                                            use_kernels=False))
    assert torch.equal(hp, hr)
    assert all(torch.equal(a, b) for a, b in zip(sp, sr))
    jimg = JQ.crash(q.j.state, jnp.zeros(128, jnp.float32))
    js, _ = JQ.recover(*jimg, spec=q.j.spec)
    assert_states_equal(sp, js)


# ---------------------------------------------------------------------------
# Hypothesis properties (instruction-granularity adversary on the port's
# oracle, batch-boundary adversary on the port's queue)
# ---------------------------------------------------------------------------

ops_strategy = st.lists(
    st.tuples(st.sampled_from(["enqueue", "dequeue"]), st.integers(0, 99)),
    min_size=1, max_size=24)


@settings(max_examples=30, deadline=None)
@given(mode=st.sampled_from(MODES), ops=ops_strategy,
       crash_budget=st.integers(0, 120),
       evictions=st.lists(st.integers(0, 6), min_size=8, max_size=8))
def test_oracle_durable_linearizability(mode, ops, crash_budget, evictions):
    """The adversary picks the trace, an event budget landing the crash
    inside an op, and the per-slot eviction bias; the port's oracle
    recovers a crash-consistent cut (the single pending op ambiguous)."""
    o = OracleQueue(8, mode=mode)
    left = crash_budget
    for kind, val in ops:
        before = o.events
        res = (o.enqueue(val, budget=max(left, 0)) if kind == "enqueue"
               else o.dequeue(budget=max(left, 0)))
        left -= (o.events - before) + (1 if res is None else 0)
        if res is None:
            break
    contents, head, tail = OracleQueue.recover(o.crash(list(evictions)))
    ok, msg = o.check_recovery(contents)
    assert ok, msg
    assert tail - head == len(contents)


@settings(max_examples=15, deadline=None)
@given(mode=st.sampled_from(MODES), ops=ops_strategy,
       u=st.lists(st.floats(0.0, 0.999), min_size=16, max_size=16))
def test_port_queue_matches_oracle_through_crash(mode, ops, u):
    """Batched one-lane trace + batch-boundary crash: the port's queue and
    its oracle agree on results, psyncs and the recovered FIFO."""
    q = DurableQueue(QueueSpec(capacity=16, mode=mode), device="cpu")
    o = OracleQueue(16, mode=mode)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for kind, val in ops:
            if kind == "enqueue":
                assert bool(q.enqueue([val])[0]) == o.enqueue(val)
            else:
                vals, okk = q.dequeue(1, default=-1)
                eok, ev = o.dequeue()
                assert bool(okk[0]) == eok
                assert int(vals[0]) == (-1 if ev is None else ev)
    assert q.psyncs == o.psyncs
    q.crash_and_recover(np.asarray(u, np.float32))
    contents, head, tail = OracleQueue.recover(o.crash([10] * 16))
    assert q.psyncs == 0
    assert (int(q.state.head), int(q.state.tail)) == (head, tail)
    vals, okk = q.dequeue(16)
    assert [int(v) for v, k in zip(vals, okk) if k] == contents


# ---------------------------------------------------------------------------
# Per-structure overflow warnings
# ---------------------------------------------------------------------------


def test_overflow_warning_fires_per_structure_same_spec():
    """Two same-spec queues overflowing in one process both warn (the
    default filter's module-global dedup must not swallow the second),
    and each warns once."""
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("default")
        a, b = (DurableQueue(QueueSpec(capacity=2), device="cpu")
                for _ in range(2))
        a.enqueue(np.arange(4))
        b.enqueue(np.arange(4))
        a.enqueue(np.arange(4))               # latched: no second warning
    msgs = [w for w in rec if issubclass(w.category, RuntimeWarning)
            and "DurableQueue full" in str(w.message)]
    assert len(msgs) == 2, [str(w.message) for w in rec]


def test_queue_full_and_map_overflow_both_warn():
    """A queue-full warning and a map-overflow warning in the same
    process both fire exactly once per structure."""
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("default")
        m = DurableMap(SetSpec(capacity=2, backend="probe"), device="cpu")
        m.insert(np.arange(4, dtype=np.int32))
        q = DurableQueue(QueueSpec(capacity=2), device="cpu")
        q.enqueue(np.arange(4, dtype=np.int32))
        q.enqueue(np.arange(4, dtype=np.int32))   # latched: no second warn
    runtime = [str(w.message) for w in rec
               if issubclass(w.category, RuntimeWarning)]
    assert len(runtime) == 2, runtime
    assert any("overflow" in m_ for m_ in runtime)
    assert any("DurableQueue full" in m_ for m_ in runtime)


def test_overflow_warning_rearmed_after_recovery():
    """A full ring warns once; recovery recomputes the latch (a clean
    ring has none) and re-arms the warning, as in the JAX package."""
    q = Pair(4)
    q.enqueue(np.arange(6))
    assert q.overflowed
    q.dequeue(2)
    q.crash_and_recover()
    assert not q.overflowed
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        q.t.enqueue(np.arange(3))
    assert sum("DurableQueue full" in str(w.message) for w in rec) == 1


# ---------------------------------------------------------------------------
# Metrics (tests/test_obs.py's queue case)
# ---------------------------------------------------------------------------


def test_queue_counters_durable_across_recovery():
    from repro.obs.metrics import MetricsRegistry as JRegistry
    from repro_torch.obs import MetricsRegistry
    m, jm = MetricsRegistry(), JRegistry()
    q = DurableQueue(QueueSpec(capacity=64), metrics=m, device="cpu")
    jq = JQueue(JSpec(capacity=64), metrics=jm)
    for x in (q, jq):
        x.enqueue(np.arange(8))
        x.dequeue(3)
        x.crash_and_recover()
    post = m.snapshot()["collected"]["queue"]
    assert post["psyncs"] == 0 and post["ops"] == 0
    assert post["psync_total"] == 11 and post["ops_total"] == 11
    assert post["recoveries"] == 1 and post["recovery_psyncs"] == 0
    assert post["size"] == 5                   # live elements survived
    for x in (q, jq):
        x.enqueue([100])
        x.crash_and_recover()
    post2 = m.snapshot()["collected"]["queue"]
    assert post2["psync_total"] == 12 and post2["recoveries"] == 2
    want = jm.snapshot()["collected"]["queue"]
    for k in ("psyncs", "ops", "psync_total", "ops_total", "size",
              "overflowed", "recoveries", "recovery_psyncs",
              "last_recovery_hist"):
        assert post2[k] == want[k], k
    assert m.snapshot()["gauges"]["queue.last_recovery_scanned_slots"] == 64
