"""The port's sharded map against the JAX package's under each router
setting, on the CPU: router v1 (with and without drops), v2 with both
placements, logical device groups and a lane cap, for the three backends.
The same seeded 32-lane batches go through both packages; every result,
drop mask, drop count and stacked leaf must be equal, and again after a
crash under an explicit per-shard adversary (helpers in
``test_torch_shard``)."""
import warnings

import numpy as np
import pytest

pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from test_torch_shard import (B, BACKENDS, assert_maps_equal,  # noqa: E402
                              drive, pair)

_VARIANTS = {
    "v1": dict(router="v1"),
    "v1-drops": dict(router="v1", min_lane_budget=1, lane_factor=1),
    "strided-groups": dict(placement="strided", n_device_groups=2),
    "contiguous-groups-cap": dict(n_device_groups=2, max_lane_budget=4,
                                  min_lane_budget=1),
    "strided-cap": dict(placement="strided", max_lane_budget=2,
                        min_lane_budget=1),
}


@pytest.mark.parametrize("variant", sorted(_VARIANTS))
@pytest.mark.parametrize("backend", BACKENDS)
def test_router_variants_match_jax(backend, variant):
    """Both routers, both placements, logical groups and a lane cap: the
    same drop masks and drop counts (the capped and v1-drops variants do
    drop lanes), then a crash under an explicit per-shard adversary."""
    rng = np.random.default_rng([len(variant), BACKENDS.index(backend)])
    kw = dict(_VARIANTS[variant])
    jm, tm = pair(backend, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        drive(jm, tm, rng, 4, B, 100)
        q = rng.integers(0, 100, B).astype(np.int32)
        np.testing.assert_array_equal(tm.get(q, default=-1),
                                      np.asarray(jm.get(q, default=-1)))
    if "cap" in variant or variant == "v1-drops":
        assert tm.router_dropped > 0
    assert_maps_equal(jm, tm)
    u = rng.random(tuple(tm.state.cur.shape)).astype(np.float32)
    u[1] = 0.999                                  # shards differ
    jm.crash_and_recover(u=jnp.asarray(u))
    tm.crash_and_recover(u=u)
    assert_maps_equal(jm, tm)
