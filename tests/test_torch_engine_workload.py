"""Parity of the repro_torch engine with repro's under random traffic and
torn-state recovery, bucket backend, all modes.

Same method as tests/test_torch_engine.py: both packages run the same
calls on the same numpy inputs and must agree on every result and every
SetState leaf after every call."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import engine as JE  # noqa: E402
from repro_torch.core import engine as TE  # noqa: E402
from repro_torch.core.convert import state_from_numpy  # noqa: E402
from repro_torch.core.durable_set import MODES  # noqa: E402
from test_torch_engine import (OPS, Pair, _assert_states_equal,  # noqa
                               _jleaves)


@pytest.mark.parametrize("mode", MODES)
def test_random_workload_with_stash_and_recovery(mode):
    """Mixed apply batches on a table small enough that buckets overflow
    into the stash and node slots are reused; a crash under a random
    adversary half way."""
    rng = np.random.default_rng(11)
    p = Pair(capacity=64, mode=mode, backend="bucket", n_buckets=8,
             bucket_width=2, stash_size=32)
    b, stashed = 16, 0
    for step in range(12):
        # insert-heavy early batches fill buckets and the stash; later
        # ones mix in removes, so freed slots are reused
        p_ins = 0.7 if step < 4 else 0.3
        ops = rng.choice(OPS, b, p=[0.2, p_ins, 0.8 - p_ins])
        keys = rng.integers(0, 48, b).astype(np.int32)
        vals = rng.integers(-10 ** 6, 10 ** 6, b).astype(np.int32)
        p.call("apply", ops.astype(np.int32), keys, vals)
        stashed = max(stashed, int(p.t.state.stash_n))
        if step == 6:
            p.call("crash_and_recover", rng.random(64, dtype=np.float32))
    assert stashed > 0


def _torn_planes(spec, rng):
    """A JAX state whose nodes sit between flushed and cur (a crash in the
    middle of operations) and whose stamps differ per slot."""
    st = _jleaves(JE.make_state(JE.SetSpec(**spec)))
    n = spec["capacity"]
    st["keys"] = rng.choice(10 ** 5, n, replace=False).astype(np.int32)
    st["values"] = rng.integers(0, 10 ** 6, n).astype(np.int32)
    st["flushed"] = rng.integers(0, 5, n).astype(np.int32)
    st["cur"] = np.minimum(st["flushed"] + rng.integers(0, 4, n),
                           4).astype(np.int32)
    st["stamp"] = rng.integers(0, 9, n).astype(np.int32)
    return st


@pytest.mark.parametrize("mode", MODES)
def test_torn_state_crash_and_recover(mode):
    """Functional crash_and_recover from one torn state: the adversary's
    stage choice, the histogram, the rebuilt index (with stash spill) and
    the re-derived epoch match."""
    spec = dict(capacity=256, mode=mode, backend="bucket", n_buckets=16,
                bucket_width=4, stash_size=64)
    rng = np.random.default_rng(3)
    planes = _torn_planes(spec, rng)
    u = rng.random(256, dtype=np.float32)
    u[:4] = [0.0, np.nextafter(np.float32(1), np.float32(0)), 0.5, 0.25]
    jst, jh = JE.crash_and_recover(
        JE.DurableMap(JE.SetSpec(**spec)).state._replace(
            **{f: jnp.asarray(a) for f, a in planes.items()}),
        jnp.asarray(u), spec=JE.SetSpec(**spec))
    tst, th = TE.crash_and_recover(state_from_numpy(planes, device="cpu"),
                                   torch.from_numpy(u),
                                   spec=TE.SetSpec(**spec))
    _assert_states_equal(tst, jst)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    assert int(tst.stash_n) > 0
