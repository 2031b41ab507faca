"""The port's functional sharded API against the JAX package's, on the
CPU: states built by the same calls go through the v1 ``apply_batch``,
``insert``, ``contains``, ``remove`` and ``get``, ``dispatch_batch`` /
``dispatch_get`` under both routers, ``recover`` (with and without the
stamp plane) and ``crash_and_recover``; every result, drop count and
stacked leaf must be equal (helpers in ``test_torch_shard``)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import shard as JS  # noqa: E402
from repro_torch.core import shard as TS  # noqa: E402
from test_torch_shard import (BACKENDS, assert_states_equal,  # noqa: E402
                              mixed, pair)


def _planes(rng, jm):
    """A crash of ``jm``'s state under a seeded per-shard adversary, as
    numpy planes: (persisted, keys, values, stamp)."""
    u = rng.random(tuple(jm.state.cur.shape)).astype(np.float32)
    return [np.asarray(x) for x in JS.crash(jm.state, jnp.asarray(u))]


@pytest.mark.parametrize("backend", BACKENDS)
def test_functional_api_matches_jax(backend):
    """The functional entry points on states built from the same numpy
    planes: the v1 ``apply_batch`` family, ``dispatch_batch`` /
    ``dispatch_get`` under both routers, ``recover`` (with and without
    the stamp plane) and ``crash_and_recover``.  ``hybrid_recover`` is
    held to the JAX package's in ``test_torch_shard_snapshot``."""
    rng = np.random.default_rng(BACKENDS.index(backend))
    jm, tm = pair(backend, capacity=128)
    jsp, tsp = jm.sspec, tm.sspec
    jst, tst = jm.state, tm.state
    ops, keys, vals = mixed(rng, 32, 60)
    t = [torch.from_numpy(x) for x in (ops, keys, vals)]
    j = [jnp.asarray(x) for x in (ops, keys, vals)]
    for name, targs, jargs in (
            ("insert", (t[1], t[2]), (j[1], j[2])),
            ("apply_batch", t, j), ("contains", t[1:2], j[1:2]),
            ("remove", t[1:2], j[1:2])):
        jst, jres, jd = getattr(JS, name)(jst, *jargs, sspec=jsp)
        tst, tres, td = getattr(TS, name)(tst, *targs, sspec=tsp)
        np.testing.assert_array_equal(tres.numpy(), np.asarray(jres))
        assert int(td) == int(jd) and td.dtype == torch.int32, name
        assert_states_equal(tst, jst)
    jst, jv, jp, jd = JS.get(jst, j[1], sspec=jsp, default=-4)
    tst, tv, tp, td = TS.get(tst, t[1], sspec=tsp, default=-4)
    assert tv.dtype == torch.int32 and tp.dtype == torch.bool
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    for router in ("v1", "v2"):
        jsp2 = dataclasses.replace(jsp, router=router)
        tsp2 = dataclasses.replace(tsp, router=router)
        jst, jr, jd, jmask, jplan = JS.dispatch_batch(jst, ops, keys, vals,
                                                      sspec=jsp2)
        tst, tr_, td, tmask, tplan = TS.dispatch_batch(tst, ops, keys, vals,
                                                       sspec=tsp2)
        np.testing.assert_array_equal(tr_, np.asarray(jr))
        np.testing.assert_array_equal(tmask, jmask)
        assert td == jd and (tplan is None) == (jplan is None)
        jout = JS.dispatch_get(jst, keys, sspec=jsp2, default=7)
        tout = TS.dispatch_get(tst, keys, sspec=tsp2, default=7)
        for a, b in zip(tout[1:5], jout[1:5]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        jst, tst = jout[0], tout[0]
        assert_states_equal(tst, jst)
    jm.state = jst
    planes = _planes(rng, jm)
    for with_stamp in (False, True):
        n = 4 if with_stamp else 3
        js_, jh = JS.recover(*(jnp.asarray(p) for p in planes[:n]),
                             sspec=jsp)
        ts_, th = TS.recover(*(torch.from_numpy(p) for p in planes[:n]),
                             sspec=tsp)
        assert th.shape == (4, 5) and th.dtype == torch.int32
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        assert_states_equal(ts_, js_)
    u = rng.random(tuple(tst.cur.shape)).astype(np.float32)
    js_, jh = JS.crash_and_recover(jst, jnp.asarray(u), sspec=jsp)
    ts_, th = TS.crash_and_recover(tst, torch.from_numpy(u), sspec=tsp)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    assert_states_equal(ts_, js_)
