"""Durable linearizability of the port's sharded map, against the port's
own sequential oracle (``repro_torch.core.oracle.OracleSet``), on the CPU.

Ported from tests/test_durability_property.py: a mixed-op trace routed
through router v2 (any placement, any logical group count, optionally a
drop-forcing lane cap), then an INDEPENDENT per-shard crash, must match S
oracles each fed its shard's KEPT sub-trace -- dropped lanes have no side
effect.  SOFT pays exactly 1 psync per successful update, 0 per read, 0
for dropped lanes and 0 during recovery.

After recovery the membership is read ONE KEY PER BATCH.  The JAX test of
this property reads all eight keys in one batch through the same capped
router, which drops some of those reads (result False for a key that is
durably present); that is ROADMAP C2, the one red JAX test, and not a
fault of the engine.  A one-key batch never exceeds a budget of 1, so
this reading sees the recovered set itself.  The drop rule itself is held
to the host rule batch by batch on the way.  This file imports nothing of
JAX."""
import numpy as np
import pytest

pytest.importorskip("torch")

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:                                   # pragma: no cover
    HAVE_HYPOTHESIS = False

from repro_torch.core import (MODES, PLACEMENTS, OP_CONTAINS,  # noqa: E402
                              OP_INSERT, OP_NOP, OP_REMOVE, OracleSet,
                              SetSpec, ShardedDurableMap, np_shard_of)
from repro_torch.core import router as RT  # noqa: E402

_OP_CODE = {"contains": OP_CONTAINS, "insert": OP_INSERT,
            "remove": OP_REMOVE}
_N_SHARDS = 4
_BATCH = 8


def _one_key_reads(m, keys):
    """Membership read one key per batch: a batch of one lane is never
    shed by the router, whatever its cap."""
    return np.array([bool(m.contains(np.array([k], np.int32))[0])
                     for k in keys])


def run_router_v2_adversary_property(mode, ops, placement, groups, cap, u):
    kw = dict(max_lane_budget=cap, min_lane_budget=1) if cap else {}
    m = ShardedDurableMap(SetSpec(capacity=64, mode=mode),
                          n_shards=_N_SHARDS, use_shard_map=True,
                          placement=placement, n_device_groups=groups,
                          device="cpu", **kw)
    oracles = [OracleSet(64, mode=mode) for _ in range(_N_SHARDS)]
    d = RT.resolve_groups(m.sspec)

    def rows_of(k):
        return RT._np_row_of(np.asarray(k, np.int32), m.sspec, d)

    def oracle_for(key):
        return oracles[int(np_shard_of(np.array([key]), _N_SHARDS)[0])]

    n_success = 0
    for i in range(0, len(ops), _BATCH):
        chunk = ops[i:i + _BATCH]
        codes = np.full(_BATCH, OP_NOP, np.int32)
        keys = np.zeros(_BATCH, np.int32)
        for j, (kind, key) in enumerate(chunk):
            codes[j], keys[j] = _OP_CODE[kind], key
        # the drop rule: per shard ROW, the first-L real lanes in batch
        # order are kept (L == the realized adaptive budget)
        kept = np.ones(_BATCH, bool)
        if cap:
            budget = RT.adaptive_lane_budget(
                m.sspec, _BATCH,
                int(np.bincount(rows_of(keys)[codes != OP_NOP],
                                minlength=_N_SHARDS).max()))
            taken = {}
            for j, r in enumerate(rows_of(keys)):
                if codes[j] == OP_NOP:
                    continue
                taken[r] = taken.get(r, 0) + 1
                kept[j] = taken[r] <= budget
        got = m.apply(codes, keys, keys * 10)
        np.testing.assert_array_equal(m.last_drop_mask, ~kept)
        exp = np.zeros(_BATCH, bool)
        for phase in ("contains", "insert", "remove"):
            for j, (kind, key) in enumerate(chunk):
                if kind != phase or not kept[j]:
                    continue
                o = oracle_for(key)
                exp[j] = (o.insert(key, key * 10) if kind == "insert"
                          else getattr(o, kind)(key))
                if kind != "contains" and exp[j]:
                    n_success += 1
        np.testing.assert_array_equal(got, exp, err_msg=str(chunk))

    if mode == "soft":
        assert m.psyncs == n_success == sum(o.psyncs for o in oracles)

    uarr = np.repeat(np.asarray(u, np.float32)[:, None],
                     m.state.cur.shape[1], axis=1)
    m.crash_and_recover(u=uarr)
    assert m.psyncs == 0, "recovery must issue no psync"
    got = _one_key_reads(m, range(8))
    for key in range(8):
        assert got[key] == (key in oracle_for(key).index), (key, mode)
    # an uncapped map over the same recovered state reads the same
    free = ShardedDurableMap(SetSpec(capacity=64, mode=mode),
                             n_shards=_N_SHARDS, placement=placement,
                             n_device_groups=groups, device="cpu")
    free.state = type(m.state)(*(t.clone() for t in m.state))
    np.testing.assert_array_equal(free.contains(np.arange(8)), got)


def run_sharded_trace_property(mode, ops, u):
    """Every batched op completes before the crash, so the recovered
    membership is exact (uncapped router: nothing is dropped)."""
    m = ShardedDurableMap(SetSpec(capacity=64, mode=mode),
                          n_shards=_N_SHARDS, device="cpu")
    oracles = [OracleSet(64, mode=mode) for _ in range(_N_SHARDS)]

    def oracle_for(key):
        return oracles[int(np_shard_of(np.array([key]), _N_SHARDS)[0])]

    for i in range(0, len(ops), _BATCH):
        chunk = ops[i:i + _BATCH]
        codes = np.full(_BATCH, OP_NOP, np.int32)
        keys = np.zeros(_BATCH, np.int32)
        for j, (kind, key) in enumerate(chunk):
            codes[j], keys[j] = _OP_CODE[kind], key
        got = m.apply(codes, keys, keys * 10)
        exp = np.zeros(_BATCH, bool)
        for phase in ("contains", "insert", "remove"):
            for j, (kind, key) in enumerate(chunk):
                if kind == phase:
                    o = oracle_for(key)
                    exp[j] = (o.insert(key, key * 10) if kind == "insert"
                              else getattr(o, kind)(key))
        np.testing.assert_array_equal(got, exp, err_msg=str(chunk))
        assert not got[len(chunk):].any()               # NOP lanes inert
    if mode == "soft":
        assert m.psyncs == sum(o.psyncs for o in oracles)
    uarr = np.repeat(np.asarray(u, np.float32)[:, None],
                     m.state.cur.shape[1], axis=1)
    m.crash_and_recover(u=uarr)
    got = m.contains(np.arange(8))
    for key in range(8):
        assert got[key] == (key in oracle_for(key).index), (key, mode)


def _seeded_ops(rng, n=24):
    kinds = ("insert", "remove", "contains")
    return [(kinds[int(c)], int(k)) for c, k in
            zip(rng.integers(0, 3, n), rng.integers(0, 8, n))]


@pytest.mark.parametrize("groups", (0, 2, 4))
@pytest.mark.parametrize("cap", (0, 1))
@pytest.mark.parametrize("placement", PLACEMENTS)
@pytest.mark.parametrize("mode", MODES)
def test_router_v2_adversary_recovery_deterministic(mode, placement, cap,
                                                    groups):
    rng = np.random.default_rng([17 + cap, groups, len(mode)])
    u = [float(x) for x in rng.random(_N_SHARDS)]
    run_router_v2_adversary_property(mode, _seeded_ops(rng), placement,
                                     groups, cap, u)


def test_c2_reading_of_the_red_jax_case():
    """ROADMAP C2's reproducer: ``insert 3`` through a budget-1 router,
    then a crash.  Key 3 is durably present; one-key reads see it, while
    an eight-key read through the same capped router drops its lane."""
    m = ShardedDurableMap(SetSpec(capacity=64, mode="soft"),
                          n_shards=_N_SHARDS, max_lane_budget=1,
                          min_lane_budget=1, device="cpu")
    codes = np.full(_BATCH, OP_NOP, np.int32)
    keys = np.zeros(_BATCH, np.int32)
    codes[0], keys[0] = OP_INSERT, 3
    assert m.apply(codes, keys, keys * 10)[0]
    m.crash_and_recover(u=np.zeros(tuple(m.state.cur.shape), np.float32))
    assert _one_key_reads(m, [3])[0]
    wide = m.contains(np.arange(8))
    assert m.last_drop_mask[3] and not wide[3]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("mode", MODES)
def test_sharded_trace_matches_independent_oracles_deterministic(mode, seed):
    rng = np.random.default_rng([seed, len(mode)])
    run_sharded_trace_property(mode, _seeded_ops(rng, 20),
                               [float(x) for x in rng.random(_N_SHARDS)])


if HAVE_HYPOTHESIS:
    ops_strategy = st.lists(
        st.tuples(st.sampled_from(["insert", "remove", "contains"]),
                  st.integers(0, 7)),
        min_size=1, max_size=24)
    u_strategy = st.lists(st.floats(0.0, 0.999), min_size=_N_SHARDS,
                          max_size=_N_SHARDS)

    @settings(max_examples=20, deadline=None)
    @given(mode=st.sampled_from(MODES), ops=ops_strategy,
           placement=st.sampled_from(PLACEMENTS),
           groups=st.sampled_from((0, 2, 4)), cap=st.sampled_from((0, 1)),
           u=u_strategy)
    def test_router_v2_adversary_recovery_and_psync_parity(
            mode, ops, placement, groups, cap, u):
        run_router_v2_adversary_property(mode, ops, placement, groups, cap,
                                         u)

    @settings(max_examples=20, deadline=None)
    @given(mode=st.sampled_from(MODES), ops=ops_strategy, u=u_strategy)
    def test_sharded_trace_matches_independent_oracles(mode, ops, u):
        run_sharded_trace_property(mode, ops, u)
