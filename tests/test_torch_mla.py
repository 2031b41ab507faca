"""Parity of repro_torch's MLA block (minicpm3) with repro's, at
minicpm3-4b-smoke in f32: prefill (per-head keys materialized from the
latent, attention through the port's ``flash_prefill`` op with the values
padded to the query head dim) and the absorbed decode (f32 einsums in the
latent space), with the ``lat`` and ``kr`` caches compared.

The block weights are layer 0 of the JAX ``init_params(PRNGKey(0))``,
converted by ``params_from_jax``; the inputs are numpy-seeded.  Tolerance:
f32, atol 1e-4 on block outputs and caches, as in
``tests/test_torch_model.py``.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro.models.params import init_params as jax_init_params  # noqa: E402
from repro.models.sharding import CPU_CTX  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models import blocks as B  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.convert import (cache_from_jax,  # noqa: E402
                                        params_from_jax)

ATOL = 1e-4
CPU = torch.device("cpu")
ARCH = "minicpm3-4b-smoke"


def _close(got, want, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0, err_msg=what)


def _block():
    jcfg = jax_get_config(ARCH)
    stack = jax.jit(jax_init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))["stack_0"]
    jp = jax.tree.map(lambda a: a[0], stack["b0_attn"])
    return jcfg, jp, get_config(ARCH), params_from_jax(
        jax.tree.map(np.asarray, jp), CPU)


def test_mla_prefill_and_absorbed_decode_match_jax(monkeypatch):
    jcfg, jp, cfg, p = _block()
    b, s, steps = 2, 12, 3
    x = np.random.default_rng(0).standard_normal(
        (b, s + steps, cfg.d_model)).astype(np.float32)
    jcache = JB.init_block_cache("attn", jcfg, b, s + steps, jnp.float32)
    tcache = cache_from_jax(jax.tree.map(np.asarray, jcache), CPU)
    assert sorted(tcache) == ["kr", "lat"]

    seen = []
    kernel_op = L.flash_prefill

    def spy(q, k, v, **kw):
        seen.append((q.shape[-1], k.shape[-1], v.shape[-1]))
        return kernel_op(q, k, v, **kw)
    monkeypatch.setattr(L, "flash_prefill", spy)

    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    jpre = jax.jit(functools.partial(JB.apply_block, "attn", cfg=jcfg,
                                     ctx=CPU_CTX, mode="prefill"))
    jout, jcache, _ = jpre(jp, jnp.asarray(x[:, :s]),
                           positions=jnp.asarray(pos), cache=jcache)
    tout, tcache, _ = B.apply_block("attn", p, torch.from_numpy(x[:, :s]),
                                    cfg=cfg, mode="prefill",
                                    positions=torch.from_numpy(pos.copy()),
                                    cache=tcache)
    _close(tout, jout, "prefill output")
    # one launch, with V padded from head_dim to head_dim + rope_dim
    qk = cfg.head_dim + cfg.rope_dim
    assert seen == [(qk, qk, qk)]
    for key in ("lat", "kr"):
        _close(tcache[key], jcache[key], f"prefill cache {key}")

    jdec = jax.jit(functools.partial(JB.apply_block, "attn", cfg=jcfg,
                                     ctx=CPU_CTX, mode="decode"))
    for t in range(s, s + steps):
        posv = np.full((b,), t, np.int32)
        jout, jcache, _ = jdec(jp, jnp.asarray(x[:, t:t + 1]),
                               cache=jcache, pos=jnp.asarray(posv))
        tout, tcache, _ = B.apply_block("attn", p,
                                        torch.from_numpy(x[:, t:t + 1]),
                                        cfg=cfg, mode="decode", cache=tcache,
                                        pos=torch.from_numpy(posv))
        _close(tout, jout, f"decode output at {t}")
        for key in ("lat", "kr"):
            _close(tcache[key], jcache[key], f"decode cache {key} at {t}")
    assert len(seen) == 1        # the absorbed decode calls no kernel


def test_attention_prefill_pads_a_narrower_v():
    """``attention_prefill`` with Dv < D equals dense attention scaled by
    1/sqrt(D), the scale the JAX ``attention_dense`` takes from q."""
    rng = np.random.default_rng(1)
    b, s, h, d, dv = 2, 9, 4, 24, 16
    q, k = (torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(
        np.float32)) for _ in range(2))
    v = torch.from_numpy(rng.standard_normal((b, s, h, dv)).astype(
        np.float32))
    got = L.attention_prefill(q, k, v, None)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / d ** 0.5
    mask = torch.ones(s, s, dtype=torch.bool).tril()
    pr = torch.softmax(logits.masked_fill(~mask, -1e30), -1)
    want = torch.einsum("bhqk,bkhd->bqhd", pr, v)
    assert got.shape == (b, s, h, dv)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
