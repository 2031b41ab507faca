"""Parity of repro_torch's ``moe_ffn`` with repro's at mixtral-8x22b-smoke
and arctic-480b-smoke (the latter with its dense residual FFN), in f32.

The same numpy-seeded weights and inputs go through both.  Compared: the
output and the load-balancing aux loss (atol 1e-5; the two packages sum
the expert products in other orders), in prefill (B 2, S 12) and in both
decode branches (B 2 is one group of the batch's tokens, B 1 a row of
one); with a capacity factor low enough that tokens are dropped, the same
tokens dropped; and with a zero router, where every gate ties and the
lower expert index must win, as ``lax.top_k`` orders ties.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.models.moe import moe_ffn as jax_moe_ffn  # noqa: E402
from repro.models.sharding import CPU_CTX  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models.moe import capacity, moe_ffn  # noqa: E402

ATOL = 1e-5
ARCHS = ("mixtral-8x22b-smoke", "arctic-480b-smoke")


def _weights(cfg, seed, zero_router=False):
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(
            np.float32)
    p = {"router": w(d, e), "wi": w(e, d, f), "wg": w(e, d, f),
         "wo": w(e, f, d)}
    if zero_router:
        p["router"][:] = 0
    if cfg.moe_dense_ff:
        g = cfg.moe_dense_ff
        p["dense"] = {"wi": w(d, g), "wg": w(d, g), "wo": w(g, d)}
    return p


def _both(arch, shape, seed=0, zero_router=False, **variant):
    jcfg = jax_get_config(arch).replace(**variant)
    cfg = get_config(arch).replace(**variant)
    p = _weights(cfg, seed, zero_router)
    x = np.random.default_rng(seed + 1).standard_normal(
        (*shape, cfg.d_model)).astype(np.float32)
    jout, jaux = jax.jit(jax_moe_ffn, static_argnums=(2, 3))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg, CPU_CTX)
    tp = {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()}
              if isinstance(v, dict) else torch.from_numpy(v))
          for k, v in p.items()}
    tout, taux = moe_ffn(tp, torch.from_numpy(x), cfg)
    return (np.asarray(jout), float(jaux)), (tout.numpy(), float(taux))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", [(2, 12), (2, 1), (1, 1)],
                         ids=["prefill", "decode-b2", "decode-b1"])
def test_moe_ffn_matches_jax(arch, shape):
    (jout, jaux), (tout, taux) = _both(arch, shape)
    assert tout.shape == jout.shape
    np.testing.assert_allclose(tout, jout, atol=ATOL, rtol=0)
    np.testing.assert_allclose(taux, jaux, atol=ATOL, rtol=0)
    assert taux > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_drops_the_same_tokens(arch):
    """At capacity factor 0.5 a row of 32 tokens holds 8 slots per expert
    for 64 / E assignments on average, so tokens are dropped.  A dropped
    assignment adds nothing: the tokens whose output moves against a run
    at a capacity that drops none are the same in both packages."""
    shape = (2, 32)
    low = _both(arch, shape, capacity_factor=0.5)
    high = _both(arch, shape, capacity_factor=64.0)
    cfg = get_config(arch)
    assert capacity(32, cfg.replace(capacity_factor=0.5)) == 8
    moved = []
    for (jl, _), (jh, _) in zip(low, high):
        moved.append(np.abs(jl - jh).max(-1) > 1e-3)
    np.testing.assert_array_equal(moved[1], moved[0])
    assert 0 < moved[0].sum() < moved[0].size
    np.testing.assert_allclose(low[1][0], low[0][0], atol=ATOL, rtol=0)
    np.testing.assert_allclose(low[1][1], low[0][1], atol=ATOL, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", [(2, 12), (2, 1)])
def test_moe_ffn_all_tie_router_takes_the_lower_experts(arch, shape):
    """A zero router gives every expert the gate 1/E: both packages route
    every token to experts 0 and 1 with weight 1/2 each."""
    (jout, jaux), (tout, taux) = _both(arch, shape, zero_router=True)
    np.testing.assert_allclose(tout, jout, atol=ATOL, rtol=0)
    np.testing.assert_allclose(taux, jaux, atol=ATOL, rtol=0)
    # the same output from the two lowest experts alone, by hand
    cfg = get_config(arch)
    p = _weights(cfg, 0, True)
    x = np.random.default_rng(1).standard_normal(
        (*shape, cfg.d_model)).astype(np.float32)

    def expert(j):
        g = x @ p["wg"][j]
        return ((g / (1 + np.exp(-g))) * (x @ p["wi"][j])) @ p["wo"][j]
    want = 0.5 * expert(0) + 0.5 * expert(1)
    if cfg.moe_dense_ff:
        dp = p["dense"]
        g = x @ dp["wg"]
        want = want + ((g / (1 + np.exp(-g))) * (x @ dp["wi"])) @ dp["wo"]
    np.testing.assert_allclose(tout, want, atol=1e-4, rtol=0)
