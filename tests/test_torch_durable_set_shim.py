"""The port's legacy surface against the JAX package's, on the CPU.

``insert_batch`` / ``remove_batch`` / ``contains_batch`` / ``recover`` /
``crash_and_recover`` of ``repro_torch.core.durable_set`` (the string
``index="probe"|"scan"`` interface) and the deprecated ``DurableSet``
facade: the same seeded batches (numpy) through both packages, every
``SetState`` leaf and every result equal, in all three modes, and the
crash under the same float32 adversary.  Also: ``repro_torch.core``
exports every name ``repro.core`` does."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

import repro.core as JC  # noqa: E402
from repro.core import durable_set as JD  # noqa: E402
import repro_torch.core as TC  # noqa: E402
from repro_torch.core import durable_set as TD  # noqa: E402
from repro_torch.core.convert import state_to_numpy  # noqa: E402

CAP = 64
B = 16


def assert_leaves_equal(got, want):
    got = state_to_numpy(got)
    for f, w in zip(want._fields, want):
        w = np.asarray(w)
        assert got[f].dtype == w.dtype and got[f].shape == w.shape, f
        np.testing.assert_array_equal(got[f], w, err_msg=f"leaf {f}")


def t(a):
    return torch.from_numpy(np.asarray(a, np.int32))


@pytest.mark.parametrize("index", ("probe", "scan"))
@pytest.mark.parametrize("mode", TD.MODES)
def test_legacy_wrappers_match_jax(mode, index):
    """Batches with repeated keys (lane priority decides), reads, removes,
    a crash and recovery under the same adversary, and more batches after
    it: every result and leaf equal at every step."""
    rng = np.random.default_rng([len(mode), len(index)])
    js, ts = JD.make_state(CAP), TD.make_state(CAP, device="cpu")
    assert_leaves_equal(ts, js)

    def step(fn, keys, *extra):
        nonlocal js, ts
        js, want = getattr(JD, fn)(js, jnp.asarray(keys),
                                   *(jnp.asarray(x) for x in extra),
                                   mode=mode, index=index)
        ts, got = getattr(TD, fn)(ts, t(keys), *(t(x) for x in extra),
                                  mode=mode, index=index)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert_leaves_equal(ts, js)

    for r in range(4):
        keys = rng.integers(0, 40, B).astype(np.int32)
        step("insert_batch", keys, keys * 3 + r)
        step("contains_batch", rng.integers(0, 48, B).astype(np.int32))
        step("remove_batch", rng.integers(0, 40, B).astype(np.int32))
    u = rng.random(CAP, dtype=np.float32)
    js = JD.crash_and_recover(js, jnp.asarray(u))
    ts = TD.crash_and_recover(ts, torch.from_numpy(u))
    assert_leaves_equal(ts, js)
    assert int(ts.n_psync) == 0
    keys = rng.integers(0, 48, B).astype(np.int32)
    step("contains_batch", keys)
    step("insert_batch", keys, keys)


def test_legacy_recover_without_stamp_matches_jax():
    keys = np.arange(B, dtype=np.int32)
    js, _ = JD.insert_batch(JD.make_state(CAP), jnp.asarray(keys),
                            jnp.asarray(keys))
    ts, _ = TD.insert_batch(TD.make_state(CAP, device="cpu"), t(keys),
                            t(keys))
    u = np.zeros(CAP, np.float32)
    p, k, v, _ = JD.crash(js, jnp.asarray(u))
    want = JD.recover(p, k, v, table_factor=2)
    p, k, v, _ = TD.crash(ts, torch.from_numpy(u))
    got = TD.recover(p, k, v, table_factor=2)
    assert_leaves_equal(got, want)
    assert int(got.size) == B and got.table.shape == (128,)


def test_functional_core_stability():
    """``tests/test_durable_set.py``'s functional case on the port."""
    st = TC.make_state(CAP, device="cpu")
    keys = torch.arange(8, dtype=torch.int32)
    st, ok = TC.insert_batch(st, keys, keys, mode="soft")
    assert bool(ok.all())
    st, c = TC.contains_batch(st, keys, mode="soft")
    assert bool(c.all())
    st, r = TC.remove_batch(st, keys[:4], mode="soft")
    assert bool(r.all()) and int(st.size) == 4


@pytest.mark.parametrize("index", ("probe", "scan", "bucket"))
def test_durable_set_shim_warns_and_matches_jax(index):
    """``tests/test_durable_set.py`` and ``tests/test_engine.py``'s shim
    cases: the DeprecationWarning naming DurableMap, ``index=`` mapped
    1:1 onto a backend, and the same leaves as the JAX shim."""
    with pytest.warns(DeprecationWarning, match="DurableMap"):
        s = TC.DurableSet(CAP, mode="soft", index=index, device="cpu")
    with pytest.warns(DeprecationWarning, match="DurableMap"):
        j = JC.DurableSet(CAP, mode="soft", index=index)
    assert (s.mode, s.index, s.spec.backend) == ("soft", index, index)
    assert isinstance(s, TC.DurableMap)
    for m in (s, j):
        m.insert([1, 2, 3, 4], [10, 20, 30, 40])
    assert list(np.asarray(s.contains([1, 3, 5]))) == [True, True, False]
    u = np.zeros(CAP, np.float32)
    s.crash_and_recover(torch.from_numpy(u))
    j.crash_and_recover(jnp.asarray(u))
    assert len(s) == 4 and s.psyncs == 0     # recovery never psyncs
    assert_leaves_equal(s.state, j.state)


def test_core_exports_every_name_of_the_jax_core():
    names = [n for n in dir(JC) if not n.startswith("_")
             and not isinstance(getattr(JC, n), type(JC))]
    assert [n for n in names if not hasattr(TC, n)] == []
