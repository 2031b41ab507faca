"""Parity of repro_torch's vlm family (qwen2-vl-2b: M-RoPE, patch
embeddings in place of tokens) with repro's model, at its smoke config in
f32.

Both packages run the same weights (``params_from_jax`` of the JAX
``init_params(PRNGKey(0))``) and the same numpy-seeded prompts; the JAX
serve steps are jitted.  The JAX side masks prefill attention in
``attention_dense`` by the positions' temporal row; the port's
``flash_prefill`` op takes the same row through its positions operand when
the batch gives positions, and masks by index at the default ones.

Tolerances, f32: atol 1e-4 on logits and every cache leaf (as
``tests/test_torch_model.py``), 1e-5 on rotary alone; greedy tokens and
``pos`` equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.params import param_count as jax_param_count  # noqa: E402
from repro_torch.configs.all import ASSIGNED  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import cache_from_jax  # noqa: E402
from repro_torch.models.params import (NOT_PORTED, param_count,  # noqa: E402
                                       tree_leaves)
from repro_torch.train import steps as TS  # noqa: E402

from test_torch_model_families import (CPU, _check_caches,  # noqa: E402
                                       _close, _jax_params, _jax_steps)

ARCH = "qwen2-vl-2b-smoke"
ROPE_ATOL = 1e-5


def mrope_positions(b, text0, grid, text1):
    """Qwen2-VL's M-RoPE positions (arXiv:2409.12191 section 2.1) of rows
    holding ``text0`` text tokens, one image of grid x grid patches at
    t = text0, h = text0 + row, w = text0 + col, then ``text1`` text
    tokens from text0 + grid: (3, B, S) int32."""
    t = np.arange(text0)
    rows, cols = np.divmod(np.arange(grid * grid), grid)
    img = np.stack([np.full(grid * grid, text0), text0 + rows,
                    text0 + cols])
    post = text0 + grid + np.arange(text1)
    pos = np.concatenate([np.stack([t] * 3), img, np.stack([post] * 3)], 1)
    return np.ascontiguousarray(
        np.broadcast_to(pos[:, None], (3, b, pos.shape[1])), np.int32)


def test_configs_and_param_counts_match_the_jax_package():
    """Every config of the JAX package is registered in the port, and the
    vlm's match it field for field and in parameter count."""
    from repro.configs.all import ASSIGNED as JAX_ASSIGNED
    assert ASSIGNED == JAX_ASSIGNED
    for arch in ASSIGNED:
        assert get_config(arch).name == arch
    for arch in ("qwen2-vl-2b", ARCH):
        assert vars(get_config(arch)) == vars(jax_get_config(arch))
        assert param_count(get_config(arch)) == \
            jax_param_count(jax_get_config(arch))
    assert param_count(get_config("qwen2-vl-2b")) == 1_777_030_656
    assert NOT_PORTED == {}


def test_init_params_layout_matches_jax():
    params = M.init_params(get_config(ARCH), seed=0, device=CPU)
    jshapes = jax.eval_shape(lambda: JM.init_params(
        jax_get_config(ARCH), jax.random.PRNGKey(0)))
    want = {k: (v.shape, str(v.dtype)) for k, v in tree_leaves(jshapes)}
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in tree_leaves(params)}
    assert got == want


@pytest.mark.parametrize("d,secs,span", [(16, (2, 3, 3), 40),
                                         (128, (16, 24, 24), 300)])
def test_mrope_matches_jax(d, secs, span):
    """apply_rope with M-RoPE sections == the JAX one on random (3, B, S)
    positions; 2-d positions fall back to plain rotary in both."""
    rng = np.random.default_rng(d)
    x = rng.standard_normal((2, 12, 3, d)).astype(np.float32)
    pos = rng.integers(0, span, (3, 2, 12)).astype(np.int32)
    for p in (pos, pos[0]):
        want = JL.apply_rope(jnp.asarray(x), jnp.asarray(p), 1e6, secs)
        got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(p), 1e6,
                           secs)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ROPE_ATOL, rtol=0)
    # equal sections give plain rotary at that position (M-RoPE decode)
    same = np.broadcast_to(pos[:1], pos.shape)
    np.testing.assert_allclose(
        L.apply_rope(torch.from_numpy(x), torch.from_numpy(same.copy()), 1e6,
                     secs).numpy(),
        L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[0]), 1e6
                     ).numpy(), atol=ROPE_ATOL, rtol=0)


def _prompt(cfg, kind, b, rng):
    """A batch of the given kind, as numpy: token prompts at the default
    positions; or N(0, 0.02^2) embedding rows at the M-RoPE positions of 3
    text tokens, a 4 x 4 image and 5 text tokens."""
    if kind == "tokens":
        return {"tokens": rng.integers(0, cfg.vocab, (b, 12)).astype(
            np.int32)}
    pos = mrope_positions(b, 3, 4, 5)
    s = pos.shape[-1]
    embeds = (0.02 * rng.standard_normal((b, s, cfg.d_model))).astype(
        np.float32)
    return {"embeds": embeds, "positions": pos}


@pytest.mark.parametrize("kind", ["tokens", "embeds_mrope"])
def test_prefill_and_greedy_decode_match_jax(kind):
    """Prefill and 4 greedy decode steps: the logits, the greedy tokens and
    every cache leaf against the JAX model, token prompts at the default
    positions and patch embeddings at given M-RoPE positions (the
    positions path of flash_prefill's plain version)."""
    jcfg, jparams, params = _jax_params(ARCH)
    cfg = get_config(ARCH)
    b, gen = 2, 4
    batch = _prompt(cfg, kind, b, np.random.default_rng(7))
    s = batch["tokens" if kind == "tokens" else "embeds"].shape[1]
    jpre, jdec = _jax_steps(jcfg)
    jc = JM.init_cache(jcfg, b, s + gen)
    tc = cache_from_jax(jax.tree.map(np.asarray, jc), CPU)
    jc, jlogits = jpre(jparams, {k: jnp.asarray(a) for k, a in batch.items()},
                       jc)
    tpre, tdec = TS.make_serve_steps(cfg)
    tc, tlogits = tpre(params, {k: torch.from_numpy(a)
                                for k, a in batch.items()}, tc)
    _close(tlogits, jlogits, "prefill logits")
    _check_caches(tc, jc)
    jnxt = jnp.argmax(jlogits, -1).astype(jnp.int32)[:, None]
    tnxt = torch.argmax(tlogits, -1).to(torch.int32)[:, None]
    for step in range(gen):
        np.testing.assert_array_equal(tnxt.numpy(), np.asarray(jnxt))
        jc, jnxt, jlogits = jdec(jparams, jc, jnxt)
        tc, tnxt, tlogits = tdec(params, tc, tnxt)
        _close(tlogits, jlogits, f"decode step {step} logits")
    np.testing.assert_array_equal(tnxt.numpy(), np.asarray(jnxt))
    _check_caches(tc, jc)


def test_decode_matches_prefill():
    """One decode step at position S (the cache counter in all three
    M-RoPE sections) gives the last-position logits of a prefill over
    S + 1 tokens at the default positions, f32 within 1e-4."""
    cfg = get_config(ARCH)
    params = M.init_params(cfg, seed=0, device=CPU)
    b, s = 2, 16
    tok = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (b, s + 1)).astype(np.int32))
    cache = M.init_cache(cfg, b, 32, device=CPU)
    cache, _ = M.prefill(params, {"tokens": tok[:, :s]}, cache, cfg)
    _, lg_dec = M.decode_step(params, cache, tok[:, s:], cfg)
    _, lg_ref = M.prefill(params, {"tokens": tok},
                          M.init_cache(cfg, b, 32, device=CPU), cfg)
    np.testing.assert_allclose(lg_dec.numpy(), lg_ref.numpy(), atol=1e-4,
                               rtol=0)


def test_given_default_positions_equal_the_index_mask():
    """The positions path at the default (3, B, S) aranges gives the index
    path's logits and caches, within f32 rounding."""
    cfg = get_config(ARCH)
    params = M.init_params(cfg, seed=1, device=CPU)
    tok = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (2, 10)).astype(np.int32))
    pos = torch.arange(10, dtype=torch.int32)[None, None].expand(3, 2, 10)
    out = []
    for batch in ({"tokens": tok}, {"tokens": tok, "positions": pos}):
        cache = M.init_cache(cfg, 2, 10, device=CPU)
        out.append(M.prefill(params, batch, cache, cfg))
    np.testing.assert_allclose(out[0][1].numpy(), out[1][1].numpy(),
                               atol=1e-5, rtol=0)
    for (key, a), (_, c) in zip(tree_leaves(out[0][0]),
                                tree_leaves(out[1][0])):
        np.testing.assert_allclose(a.numpy(), c.numpy(), atol=1e-5, rtol=0,
                                   err_msg=key)


def test_serve_run_matches_jax_generation():
    """The port's serve.run serves the vlm's token prompts at the default
    M-RoPE positions, as ``repro.launch.serve`` does: the JAX model's
    greedy tokens on the same weights and prompts, every completion
    registered at one psync and still registered after crash and
    recovery."""
    jcfg, jparams, params = _jax_params(ARCH)
    cfg = get_config(ARCH)
    requests, prompt_len, gen = 4, 8, 5
    res = serve.run(cfg, requests=requests, prompt_len=prompt_len, gen=gen,
                    crash=True, device="cpu", params=params)
    assert res["registered"] == requests and res["psyncs"] == requests
    assert res["registered_after_recovery"] == requests
    assert res["recovery_psyncs"] == 0

    toks = np.random.default_rng(0).integers(0, cfg.vocab,
                                             (requests, prompt_len))
    jpre, jdec = _jax_steps(jcfg)
    jc = JM.init_cache(jcfg, requests, prompt_len + gen)
    jc, logits = jpre(jparams, {"tokens": jnp.asarray(toks, jnp.int32)}, jc)
    nxt = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    out = [nxt]
    for _ in range(gen - 1):
        jc, nxt, logits = jdec(jparams, jc, nxt)
        out.append(nxt)
    np.testing.assert_array_equal(res["tokens"].numpy(),
                                  np.asarray(jnp.concatenate(out, 1)))
    _close(res["logits"], logits, "last decode logits")
