"""Parity of repro_torch's bucket index with repro's, bit for bit.

The JAX side runs ``probe_pallas`` in interpret mode, as
tests/test_kernels.py runs it; the port's wrapper runs its plain version
on CPU tensors."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

import repro.kernels.hash_probe.ops as J  # noqa: E402
from repro.core.nvm import VALID, np_hash32  # noqa: E402
from repro.kernels.hash_probe.kernel import probe_pallas  # noqa: E402
import repro_torch.kernels.hash_probe.ops as T  # noqa: E402
from repro_torch.kernels.hash_probe.kernel import probe_cuda  # noqa: E402
from repro_torch.kernels.hash_probe.ref import probe_ref  # noqa: E402
from test_torch_cuda import _hashed_table  # noqa: E402


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nb,w,b", [(64, 8, 8), (256, 8, 128),
                                    (512, 16, 256), (1024, 8, 64)])
def test_build_and_lookup_match_probe_pallas(nb, w, b):
    rng = np.random.default_rng(nb + b)
    n = nb * w // 2
    keys = rng.choice(10 ** 6, n, replace=False).astype(np.int32)
    cur = rng.integers(0, 5, n).astype(np.int32)
    q = np.concatenate([keys[: b // 2],
                        rng.integers(2 * 10 ** 6, 3 * 10 ** 6, b - b // 2)]
                       ).astype(np.int32)
    jk, ji, jo = J.build_buckets(jnp.asarray(keys), jnp.asarray(cur),
                                 nb=nb, w=w)
    tk, ti, to = T.build_buckets(_t(keys), _t(cur), nb=nb, w=w)
    _eq(tk, jk)
    _eq(ti, ji)
    _eq(to, jo)
    want = J.lookup(jk, ji, jnp.asarray(q), use_pallas=True)
    for use_kernels in (True, False):
        _eq(T.lookup(tk, ti, _t(q), use_kernels=use_kernels), want)


def test_probe_takes_max_over_matching_ways():
    """Rows holding the query key in several ways (and in empty ways) give
    the largest live id, as probe_pallas and probe_ref do."""
    rng = np.random.default_rng(5)
    nb, w, b = 16, 8, 64
    bkeys = rng.integers(0, 4, (nb, w)).astype(np.int32)
    bids = rng.integers(-1, 50, (nb, w)).astype(np.int32)
    qb = rng.integers(0, nb, b).astype(np.int32)
    qk = rng.integers(0, 5, b).astype(np.int32)
    want = probe_pallas(jnp.asarray(bkeys), jnp.asarray(bids),
                        jnp.asarray(qb), jnp.asarray(qk), bq=8, nbt=nb)
    _eq(probe_ref(_t(bkeys), _t(bids), _t(qb), _t(qk)), want)
    before = probe_cuda.launches
    _eq(probe_cuda(_t(bkeys), _t(bids), _t(qb), _t(qk)), want)
    assert probe_cuda.launches == before


def _colliding_keys(nb, count, start=1):
    out, k = [], start
    while len(out) < count:
        if int(np_hash32(np.array([k]))[0] % nb) == 0:
            out.append(k)
        k += 1
    return np.array(out, np.int32)


@pytest.mark.parametrize("s", (2, 32))
def test_bucket_init_stash_spill_and_overflow(s):
    nb, w, n = 8, 2, 64
    rng = np.random.default_rng(s)
    keys = np.zeros(n, np.int32)
    cur = np.zeros(n, np.int32)
    coll = _colliding_keys(nb, 7)
    slots = rng.choice(n, 20, replace=False)
    keys[slots[:7]] = coll                       # 5 spill from bucket 0
    keys[slots[7:]] = rng.integers(100, 10 ** 5, 13)
    cur[slots] = VALID
    cur[slots[-3:]] = 4                          # dead nodes are skipped
    want = J.bucket_init(jnp.asarray(keys), jnp.asarray(cur), nb=nb, w=w, s=s)
    got = T.bucket_init(_t(keys), _t(cur), nb=nb, w=w, s=s)
    for g, x in zip(got, want):
        _eq(g, x)
    assert int(got[4]) == min(s, int(want[4]))
    assert bool(got[5]) == (s == 2)


def test_nth_free_matches():
    rng = np.random.default_rng(3)
    free = rng.random((32, 12)) < 0.4
    rank = rng.integers(0, 6, 32).astype(np.int32)
    jc, jok = J._nth_free(jnp.asarray(free), jnp.asarray(rank))
    tc, tok = T._nth_free(_t(free), _t(rank))
    _eq(tok, jok)
    ok = np.asarray(jok)
    np.testing.assert_array_equal(tc.numpy()[ok], np.asarray(jc)[ok])


@pytest.mark.parametrize("stash", (3, 16))
def test_bucket_insert_remove_sequence_matches(stash):
    """Random insert/remove rounds on a tiny table whose keys collide, so
    ways fill, lanes spill to the stash and the stash (at least the small
    one) overflows.
    Every output of every call matches."""
    nb, w, n, b = 4, 2, 48, 8
    rng = np.random.default_rng(stash)
    universe = np.concatenate([_colliding_keys(nb, 12),
                               rng.choice(np.arange(10 ** 3, 10 ** 4), 20,
                                          replace=False)]).astype(np.int32)
    jst = (jnp.zeros((nb, w), jnp.int32), jnp.full((nb, w), -1, jnp.int32),
           jnp.zeros((stash,), jnp.int32), jnp.full((stash,), -1, jnp.int32),
           jnp.zeros((), jnp.int32))
    tst = tuple(_t(np.asarray(a)) for a in jst)
    live = {}                                    # node id -> key
    overflowed, spilled = False, 0
    for _ in range(12):
        # insert: distinct free node ids, distinct keys not yet live
        free_ids = [i for i in range(n) if i not in live]
        cand = [k for k in universe if k not in live.values()]
        m = min(b, len(free_ids), len(cand))
        ids = rng.choice(free_ids, m, replace=False).astype(np.int32)
        keys = rng.choice(cand, m, replace=False).astype(np.int32)
        do = rng.random(m) < 0.8
        jout = J.bucket_insert(*jst, jnp.asarray(keys), jnp.asarray(ids),
                               jnp.asarray(do))
        tout = T.bucket_insert(*tst, _t(keys), _t(ids), _t(do))
        for g, x in zip(tout, jout):
            _eq(g, x)
        overflowed |= bool(jout[5])
        spilled = max(spilled, int(jout[4]))
        jst, tst = jout[:5], tout[:5]
        live.update({int(i): int(k) for i, k, d in zip(ids, keys, do) if d})
        # remove: distinct live node ids with their keys
        if live:
            r = rng.choice(sorted(live), min(b, len(live)), replace=False)
            rids = r.astype(np.int32)
            rkeys = np.array([live[int(i)] for i in r], np.int32)
            rdo = rng.random(r.size) < 0.5
            jout = J.bucket_remove(*jst, jnp.asarray(rkeys),
                                   jnp.asarray(rids), jnp.asarray(rdo))
            tout = T.bucket_remove(*tst, _t(rkeys), _t(rids), _t(rdo))
            for g, x in zip(tout, jout):
                _eq(g, x)
            jst, tst = jout[:5], tout[:5]
            for i, d in zip(rids, rdo):
                if d:
                    del live[int(i)]
    assert spilled > 0
    assert overflowed or stash > 3


@pytest.fixture(scope="module")
def _one_torch_thread():
    """One intra-op thread for the port while the hashed-lookup cases run:
    their operations are tiny, and with several test workers on one host
    each op spread over every core spends its time waiting on the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("b", (1, 7, 257))
@pytest.mark.parametrize("w", (1, 3, 8, 16))
@pytest.mark.parametrize("nb", (24, 64, 1000))
def test_hashed_lookup_matches_jax_lookup(_one_torch_thread, nb, w, b):
    """``probe_cuda`` given no bucket operand (each key hashed to
    hash32(q) % NB, NB a power of two or not) and ``ops.lookup`` on CPU
    tensors equal the JAX package's ``ops.lookup`` (``probe_pallas`` in
    interpret mode), bit for bit, and count no launch."""
    rng = np.random.default_rng([nb, w, b])
    bkeys, bids, q = _hashed_table(rng, nb, w, b)
    want = J.lookup(jnp.asarray(bkeys), jnp.asarray(bids), jnp.asarray(q),
                    use_pallas=True)
    assert int((np.asarray(want) >= 0).sum()) > 0 or b == 1
    before = probe_cuda.launches
    _eq(probe_cuda(_t(bkeys), _t(bids), None, _t(q)), want)
    assert probe_cuda.launches == before
    for use_kernels in (True, False):
        _eq(T.lookup(_t(bkeys), _t(bids), _t(q), use_kernels=use_kernels),
            want)
    _eq(T.bucket_of(_t(q), nb), (np_hash32(q) % np.uint32(nb)).astype(
        np.int32))
