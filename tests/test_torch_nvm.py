"""Parity of repro_torch.core.nvm with repro.core.nvm, bit for bit."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import nvm as J  # noqa: E402
from repro_torch.core import nvm as T  # noqa: E402

I32 = np.iinfo(np.int32)


def test_constants_match():
    for name in ("FREE", "INVALID", "PAYLOAD", "VALID", "DELETED", "EMPTY",
                 "TOMB"):
        assert getattr(T, name) == getattr(J, name)


@pytest.mark.parametrize("seed", (0, 1))
def test_hash32_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    x = np.concatenate([
        rng.integers(I32.min, I32.max, 100_000, dtype=np.int64,
                     endpoint=True),
        [I32.min, I32.min + 1, -1, 0, 1, I32.max - 1, I32.max]
    ]).astype(np.int32)
    want = np.asarray(J.hash32(jnp.asarray(x)))
    got = T.hash32(torch.from_numpy(x)).numpy()
    assert got.dtype == np.int64 and got.min() >= 0 and got.max() < 2 ** 32
    np.testing.assert_array_equal(got.astype(np.uint32), want)
    np.testing.assert_array_equal(T.np_hash32(x), want)


def test_crash_persisted_stage_bit_for_bit():
    rng = np.random.default_rng(7)
    n = 20_000
    flushed = rng.integers(0, 5, n).astype(np.int32)
    cur = np.minimum(flushed + rng.integers(0, 5, n), 4).astype(np.int32)
    just_below_1 = np.nextafter(np.float32(1), np.float32(0))
    u = rng.random(n, dtype=np.float32)
    # edges: u = 0, u just below 1, and u on the tile edges k / span
    u[:5] = [0.0, just_below_1, 0.5, 1 / 3, 2 / 3]
    u[5:10] = just_below_1
    want = np.asarray(J.crash_persisted_stage(
        jnp.asarray(cur), jnp.asarray(flushed), jnp.asarray(u)))
    got = T.crash_persisted_stage(torch.from_numpy(cur),
                                  torch.from_numpy(flushed),
                                  torch.from_numpy(u)).numpy()
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert ((got >= flushed) & (got <= cur)).all()


def test_crash_persisted_stage_extreme_stages():
    """Stages far outside 0..4, including INT32 extremes with a span that
    fits in int32."""
    cur = np.array([I32.max, 0, 5, -3, 100], np.int32)
    flushed = np.array([I32.max - 7, I32.min + 1 + I32.max, -2, -3, 1],
                       np.int32)
    flushed = np.minimum(flushed, cur)
    u = np.array([0.999, 0.5, np.nextafter(np.float32(1), np.float32(0)),
                  0.0, 0.25], np.float32)
    want = np.asarray(J.crash_persisted_stage(
        jnp.asarray(cur), jnp.asarray(flushed), jnp.asarray(u)))
    got = T.crash_persisted_stage(torch.from_numpy(cur),
                                  torch.from_numpy(flushed),
                                  torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(got, want)
