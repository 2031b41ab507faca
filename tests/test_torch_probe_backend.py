"""Parity of the port's linear-probe table and its probe and scan backends
with the JAX package's.

Both packages run the same calls on the same numpy inputs (from a seed);
tables, overflow latches, found ids, every SetState leaf, per-lane results
and stage histograms must be equal bit for bit.  The JAX side runs as its
own tests run it: the lax window lookup by default, and ``table_lookup``
through the Pallas kernel in interpret mode.  The port runs on the CPU,
where its kernel wrappers take their plain versions.  The cases are
tests/test_plan_commit.py's, test_engine.py's and test_durable_set.py's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

import repro.kernels.hash_probe.ops as JHP  # noqa: E402
from repro.core import durable_set as JDS  # noqa: E402
from repro.core import engine as JE  # noqa: E402
from repro.core.nvm import np_hash32  # noqa: E402
from repro_torch.core import durable_set as TDS  # noqa: E402
from repro_torch.core import engine as TE  # noqa: E402
from repro_torch.core.convert import state_from_numpy  # noqa: E402
from repro_torch.core.durable_set import MODES  # noqa: E402
from repro_torch.core.nvm import EMPTY, TOMB, VALID  # noqa: E402
from repro_torch.kernels.hash_probe.kernel import table_probe_cuda  # noqa
from repro_torch.kernels.hash_probe.ref import table_lookup_ref  # noqa
from test_torch_engine import OPS, Pair, _assert_states_equal  # noqa: E402
from test_torch_engine_workload import _torn_planes  # noqa: E402

BACKENDS = ("probe", "scan")


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _eq(got, want, what=""):
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port while this module runs: its
    operations are tiny, and with several test workers on one host each
    op spread over every core spends its time waiting on the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_probe_constants_match():
    assert TDS.MAX_PROBE == JDS.MAX_PROBE


# ---------------------------------------------------------------------------
# The table's writers: claim / release against JAX's vectorized kernels and
# its sequential references, on arbitrary tables and lane mixes.
# ---------------------------------------------------------------------------

def _scenario(seed, t=64, b=24, key_range=12, fill=0.0, max_probe=8,
              tomb=0.3):
    """test_plan_commit.py's (table, keys, ids, do, max_probe): small
    ``key_range`` => contended chains within the batch; ``fill``
    pre-occupies slots, a ``tomb`` share of them TOMBs."""
    rng = np.random.default_rng(seed)
    table = np.full(t, EMPTY, np.int32)
    n_fill = int(t * fill)
    slots = rng.choice(t, n_fill, replace=False)
    table[slots] = rng.integers(1000, 2000, n_fill)
    table[slots[rng.random(n_fill) < tomb]] = TOMB
    keys = rng.integers(0, key_range, b).astype(np.int32)
    ids = np.arange(b, dtype=np.int32)
    do = rng.random(b) < 0.7
    return table, keys, ids, do, max_probe


def _wrapping_scenario(seed, t=64, b=16, max_probe=32):
    """Every key's home slot in the last 8 slots, so windows wrap past
    T - 1, over a half-full table."""
    table, _, ids, do, _ = _scenario(seed, t=t, b=b, fill=0.5)
    cand = np.arange(20000, dtype=np.int32)
    home = np_hash32(cand) & np.uint32(t - 1)
    keys = np.random.default_rng(seed).choice(cand[home >= t - 8], b)
    return table, keys.astype(np.int32), ids, do, max_probe


CLAIM_CASES = (
    [("fill%.2f-keys%d" % (f, k), _scenario(10 * i + j, fill=f,
                                             key_range=k))
     for i, f in enumerate((0.0, 0.5, 0.9, 0.97))
     for j, k in enumerate((3, 12, 1000))]
    + [("full-table", _scenario(7, fill=1.0, key_range=40)),
       ("tomb-heavy", _scenario(8, fill=0.8, tomb=0.9, key_range=40,
                                max_probe=32)),
       ("wrapping", _wrapping_scenario(9)),
       ("one-chain", (np.full(64, EMPTY, np.int32), np.full(16, 7, np.int32),
                      np.arange(16, dtype=np.int32), np.ones(16, bool), 32)),
       ("max-probe-128", _scenario(11, t=256, b=32, fill=0.6, key_range=5,
                                   max_probe=128))])


@pytest.mark.parametrize("case", CLAIM_CASES, ids=lambda c: c[0])
def test_table_claim_matches_jax(case):
    """The port's claim equals JAX's claim and JAX's sequential writer; the
    port's sequential writer equals JAX's too."""
    table, keys, ids, do, mp = case[1]
    args_j = [_j(a) for a in (table, keys, ids, do)]
    args_t = [_t(a) for a in (table, keys, ids, do)]
    jt, jovf = JDS.table_claim(*args_j, mp)
    rt, rovf = JDS._table_write_ref(*args_j, mp)
    np.testing.assert_array_equal(np.asarray(jt), np.asarray(rt))
    tt, tovf = TDS.table_claim(*args_t, mp)
    _eq(tt, jt, "table_claim")
    _eq(tovf, jovf, "claim overflow")
    st, sovf = TDS._table_write_ref(*args_t, mp)
    _eq(st, rt, "_table_write_ref")
    _eq(sovf, rovf, "_table_write_ref overflow")
    if case[0] == "full-table":
        assert bool(tovf), "a full table must latch the overflow"


@pytest.mark.parametrize("case", CLAIM_CASES[:12:3] + CLAIM_CASES[12:],
                         ids=lambda c: c[0])
def test_table_release_matches_jax(case):
    table, keys, ids, do, mp = case[1]
    # place some lanes' ids for real so deletes have live targets
    placed, _ = JDS._table_write_ref(_j(table), _j(keys), _j(ids), _j(do),
                                     mp)
    dele = np.random.default_rng(len(case[0])).random(len(keys)) < 0.6
    args_j = [placed] + [_j(a) for a in (keys, ids, dele)]
    args_t = [_t(np.asarray(placed))] + [_t(a) for a in (keys, ids, dele)]
    want = JDS.table_release(*args_j, mp)
    _eq(TDS.table_release(*args_t, mp), want, "table_release")
    _eq(TDS._table_delete_ref(*args_t, mp),
        JDS._table_delete_ref(*args_j, mp), "_table_delete_ref")


# ---------------------------------------------------------------------------
# Lookups: the windowed probe, the scan, and table_lookup's plain version
# against JAX's table_lookup through the Pallas kernel (interpret mode).
# ---------------------------------------------------------------------------

def _lookup_case(seed, t, n, b, fill, tomb, present=0.5, wrap=False,
                 dense=False):
    """An arbitrary table over a pool of n keys (ids past the pool too),
    and queries half drawn from the pool keys.  ``dense`` fills a run of
    3 x 128 slots with no EMPTY, so chains reach max_probe."""
    rng = np.random.default_rng(seed)
    pool = rng.choice(10 ** 6, n, replace=False).astype(np.int32)
    table = np.full(t, EMPTY, np.int32)
    slots = rng.choice(t, int(t * fill), replace=False)
    table[slots] = rng.integers(0, n + 4, slots.size)
    if dense:
        table[: 3 * 128] = rng.integers(0, n, 3 * 128)
    table[rng.random(t) < tomb] = TOMB
    q = np.where(rng.random(b) < present, rng.choice(pool, b),
                 rng.integers(2 * 10 ** 6, 3 * 10 ** 6, b)).astype(np.int32)
    if wrap:
        cand = rng.choice(pool, 4 * b)
        home = np_hash32(cand) & np.uint32(t - 1)
        late = cand[home >= t - 16]
        q[: min(b // 2, late.size)] = late[: b // 2]
    return table, pool, q


LOOKUP_CASES = [
    ("sparse", _lookup_case(1, 256, 64, 24, 0.2, 0.05)),
    ("tomb-heavy", _lookup_case(2, 256, 64, 16, 0.7, 0.5)),
    ("wrapping", _lookup_case(3, 256, 64, 16, 0.6, 0.1, wrap=True)),
    ("full-chains", _lookup_case(4, 512, 128, 24, 0.3, 0.0, dense=True)),
    ("b1", _lookup_case(5, 256, 64, 1, 0.5, 0.1, present=1.0)),
    ("b7", _lookup_case(6, 256, 64, 7, 0.5, 0.1)),
    ("b8-registry", _lookup_case(7, 4096, 1024, 8, 0.25, 0.02)),
    # tables shorter than the window, which wraps over them many times
    ("t4", _lookup_case(8, 4, 16, 8, 0.75, 0.25)),
    ("t8", _lookup_case(9, 8, 16, 8, 0.5, 0.25)),
]


@pytest.mark.parametrize("case", LOOKUP_CASES, ids=lambda c: c[0])
@pytest.mark.parametrize("max_probe", (5, 128, 129, 200))
def test_table_lookup_ref_matches_jax_kernel(case, max_probe):
    table, pool, q = case[1]
    want = JHP.table_lookup(_j(table), _j(pool), _j(q), max_probe=max_probe,
                            interpret=True)
    got = table_lookup_ref(_t(table), _t(pool), _t(q), max_probe)
    _eq(got, want, "table_lookup_ref")
    _eq(table_probe_cuda(_t(table), _t(pool), _t(q), max_probe), want,
        "table_probe_cuda on CPU tensors")


def _states(table, keys, cur=None):
    n = keys.shape[0]
    cur = np.full(n, VALID, np.int32) if cur is None else cur
    js = JDS.make_state(n)._replace(table=_j(table), keys=_j(keys),
                                    cur=_j(cur))
    ts = TDS.make_state(n, device="cpu")._replace(
        table=_t(table), keys=_t(keys), cur=_t(cur))
    return js, ts


@pytest.mark.parametrize("case", LOOKUP_CASES, ids=lambda c: c[0])
def test_lookup_probe_and_scan_match_jax(case):
    table, pool, q = case[1]
    table = np.where(table >= pool.size, EMPTY, table).astype(np.int32)
    cur = np.random.default_rng(0).integers(0, 5, pool.size).astype(np.int32)
    js, ts = _states(table, pool, cur)
    for mp in (5, 128):
        _eq(TDS._lookup_probe(ts, _t(q), mp),
            JDS._lookup_probe(js, _j(q), mp), f"_lookup_probe {mp}")
    _eq(TDS._lookup_scan(ts, _t(q)), JDS._lookup_scan(js, _j(q)),
        "_lookup_scan")


@pytest.mark.parametrize("mode", MODES)
def test_table_lookup_ref_equals_lookup_probe_on_built_tables(mode):
    """On the tables the ops build (claims, releases, TOMB reuse, a
    recovery), the any-match window lookup equals the first match before an
    EMPTY slot, for every key of the range."""
    rng = np.random.default_rng(5)
    m = TE.DurableMap(TE.SetSpec(capacity=64, mode=mode, backend="probe",
                                 table_factor=2, max_probe=16), device="cpu")
    keys = torch.arange(200, dtype=torch.int32)
    tombs = 0
    for step in range(10):
        ops = rng.choice(OPS, 32, p=[0.2, 0.5, 0.3]).astype(np.int32)
        m.apply(ops, rng.integers(0, 60, 32).astype(np.int32))
        if step == 5:
            m.crash_and_recover(rng.random(64, dtype=np.float32))
        st = m.state
        tombs = max(tombs, int((st.table == TOMB).sum()))
        np.testing.assert_array_equal(
            table_lookup_ref(st.table, st.keys, keys, 16).numpy(),
            TDS._lookup_probe(st, keys, 16).numpy())
    assert tombs > 0 and not m.overflowed


# ---------------------------------------------------------------------------
# Recovery's bulk build of the probe table.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,table_factor,max_probe,chunk",
                         [(128, 4, 128, 16), (128, 4, 8, 24),
                          (64, 1, 4, 16)])
def test_table_build_matches_sequential_writer(n, table_factor, max_probe,
                                               chunk):
    """Member ids in id order through claims of ``chunk`` lanes (at least
    three chunks) equal JAX's sequential writer over every node id, the
    overflow latch included (the last case overflows)."""
    rng = np.random.default_rng(n + chunk)
    keys = rng.integers(0, 10 ** 5, n).astype(np.int32)
    member = rng.random(n) < 0.8
    assert member.sum() >= 3 * chunk
    t = JDS.make_state(n, table_factor).table.shape[0]
    empty = np.full(t, EMPTY, np.int32)
    want, wovf = JDS._table_write_ref(_j(empty), _j(keys),
                                      jnp.arange(n, dtype=jnp.int32),
                                      _j(member), max_probe)
    got, govf = TDS.table_build(_t(empty), _t(keys), _t(member), max_probe,
                                chunk)
    _eq(got, want, "table_build")
    _eq(govf, wovf, "table_build overflow")
    if table_factor == 1:
        assert bool(govf)


@pytest.mark.parametrize("mode", MODES)
def test_probe_recovery_in_chunks_matches_jax(mode, monkeypatch):
    """The engine's recovery rebuilds the table in several claim chunks and
    matches JAX's one sequential rebuild leaf for leaf."""
    monkeypatch.setattr(TDS, "REBUILD_CHUNK", 16)
    spec = dict(capacity=256, mode=mode, backend="probe")
    rng = np.random.default_rng(4)
    planes = _torn_planes(spec, rng)
    u = rng.random(256, dtype=np.float32)
    jst, jh = JE.crash_and_recover(
        JE.make_state(JE.SetSpec(**spec))._replace(
            **{f: jnp.asarray(a) for f, a in planes.items()}),
        jnp.asarray(u), spec=JE.SetSpec(**spec))
    assert int(np.asarray(jh)[VALID]) > 3 * 16
    tst, th = TE.crash_and_recover(state_from_numpy(planes, device="cpu"),
                                   torch.from_numpy(u),
                                   spec=TE.SetSpec(**spec))
    _assert_states_equal(tst, jst)
    _eq(th, jh, "stage histogram")


# ---------------------------------------------------------------------------
# DurableMap on the probe and scan backends, all modes, against JAX's.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("backend", BACKENDS)
def test_conformance_battery(backend, mode):
    """tests/test_engine.py's backend battery, on both packages at once."""
    p = Pair(capacity=128, mode=mode, backend=backend)
    assert list(p.call("insert", [5, 6, 7, 6], [50, 60, 70, 61])) == \
        [True, True, True, False]
    assert list(p.call("contains", [5, 6, 7, 8])) == [True, True, True, False]
    assert list(p.call("remove", [6, 8, 6])) == [True, False, False]
    assert list(p.call("get", [5, 6, 7, 9], default=-1)) == [50, -1, 70, -1]
    p.call("crash_and_recover", np.full(128, 0.99, np.float32))
    assert list(p.call("contains", [5, 6, 7])) == [True, False, True]
    assert len(p.t) == 2 and int(p.t.last_recovery_hist[3]) == 2
    assert p.t.psyncs == 0


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("backend", BACKENDS)
def test_random_workload_and_crash(backend, mode):
    """Mixed apply batches with duplicates, slot reuse and a crash under a
    random adversary half way; a small table so chains form."""
    rng = np.random.default_rng(17)
    p = Pair(capacity=64, mode=mode, backend=backend, table_factor=1,
             max_probe=16)
    for step in range(10):
        p_ins = 0.6 if step < 4 else 0.3
        ops = rng.choice(OPS, 16, p=[0.2, p_ins, 0.8 - p_ins])
        keys = rng.integers(0, 48, 16).astype(np.int32)
        vals = rng.integers(-10 ** 6, 10 ** 6, 16).astype(np.int32)
        p.call("apply", ops.astype(np.int32), keys, vals)
        if step == 5:
            p.call("crash_and_recover", rng.random(64, dtype=np.float32))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("backend", BACKENDS)
def test_torn_state_crash_and_recover(backend, mode):
    """Functional crash_and_recover from one torn state: the adversary's
    stage choice, the histogram, the rebuilt table and the epoch match."""
    spec = dict(capacity=256, mode=mode, backend=backend)
    rng = np.random.default_rng(3)
    planes = _torn_planes(spec, rng)
    u = rng.random(256, dtype=np.float32)
    jst, jh = JE.crash_and_recover(
        JE.make_state(JE.SetSpec(**spec))._replace(
            **{f: jnp.asarray(a) for f, a in planes.items()}),
        jnp.asarray(u), spec=JE.SetSpec(**spec))
    tst, th = TE.crash_and_recover(state_from_numpy(planes, device="cpu"),
                                   torch.from_numpy(u),
                                   spec=TE.SetSpec(**spec))
    _assert_states_equal(tst, jst)
    _eq(th, jh, "stage histogram")


@pytest.mark.parametrize("mode", MODES)
def test_probe_map_matches_jax_kernel_route(mode):
    """The port's probe map (on the CPU: the windowed lookup, the route
    ``table_probe_cuda``'s plain version equals on the tables the ops
    build) against JAX's with probe_pallas_lookup=True (its table_lookup
    through the Pallas kernel): the same results and leaves."""
    rng = np.random.default_rng(9)
    p = Pair.__new__(Pair)
    p.j = JE.DurableMap(JE.SetSpec(capacity=128, mode=mode, backend="probe",
                                   probe_pallas_lookup=True))
    p.t = TE.DurableMap(TE.SetSpec(capacity=128, mode=mode, backend="probe"),
                        device="cpu")
    keys = np.arange(64, dtype=np.int32)
    p.call("insert", keys, keys * 3)
    p.call("remove", keys[::4])
    p.call("contains", rng.integers(0, 80, 32).astype(np.int32))
    p.call("get", keys, default=-1)
    p.call("apply", rng.choice(OPS, 16).astype(np.int32),
           rng.integers(0, 80, 16).astype(np.int32))


@pytest.mark.parametrize("mode", MODES)
def test_apply_batch_equals_sequential_phases(mode):
    rng = np.random.default_rng(3)
    seed = np.array([1, 3, 5, 7], np.int32)
    ops = np.array([JE.OP_CONTAINS] * 4 + [JE.OP_INSERT] * 4
                   + [JE.OP_REMOVE] * 3, np.int32)
    keys = rng.integers(0, 9, ops.size).astype(np.int32)
    for backend in BACKENDS:
        p = Pair(capacity=128, mode=mode, backend=backend)
        p.call("insert", seed, seed)
        res = p.call("apply", ops, keys, keys * 2)
        seq = Pair(capacity=128, mode=mode, backend=backend)
        seq.call("insert", seed, seed)
        exp = np.concatenate([seq.call("contains", keys[:4]),
                              seq.call("insert", keys[4:8], keys[4:8] * 2),
                              seq.call("remove", keys[8:])])
        np.testing.assert_array_equal(res, exp)


def test_insert_reuses_tomb_slot_after_remove():
    """test_engine.py's TOMB-reuse case: remove -> insert of a colliding key
    reuses the tombstoned slot instead of growing the chain."""
    t, chain, k = 64, {}, 1
    while True:
        h = int(np_hash32(np.array([k]))[0] & (t - 1))
        chain.setdefault(h, []).append(k)
        if len(chain[h]) == 3:
            a, b, c = chain[h]
            break
        k += 1
    p = Pair(capacity=16, mode="soft", backend="probe")
    p.call("insert", [a, b])
    p.call("remove", [a])
    assert int(p.t.state.table[h]) == TOMB
    p.call("insert", [c])
    table = p.t.state.table.numpy()
    assert table[h] >= 0 and table[(h + 2) % t] == EMPTY
    assert list(p.call("contains", [a, b, c])) == [False, True, True]


@pytest.mark.parametrize("backend", BACKENDS)
def test_soft_pays_one_psync_per_update_and_none_per_read(backend):
    """test_plan_commit.py's SOFT bound, on the port: exactly 1 psync per
    successful update and 0 per read."""
    rng = np.random.default_rng(2)
    m = TE.DurableMap(TE.SetSpec(capacity=128, mode="soft",
                                 backend=backend), device="cpu")
    upd = reads = 0
    for _ in range(6):
        ops = rng.integers(0, 3, 16).astype(np.int32)
        keys = rng.integers(0, 24, 16).astype(np.int32)
        res = m.apply(ops, keys).numpy()
        upd += int(res[ops != JE.OP_CONTAINS].sum())
        reads += int((ops == JE.OP_CONTAINS).sum())
    assert m.psyncs == upd and m.ops == 96


def test_pool_overflow_latches_and_recovers():
    """Pool exhaustion on the probe backend latches, and the latch is
    recomputed at recovery, on both packages."""
    p = Pair(capacity=8, mode="soft", backend="probe")
    p.call("insert", np.arange(16, dtype=np.int32))
    assert p.t.overflowed
    p.call("crash_and_recover")
    assert not p.t.overflowed and len(p.t) == 8
