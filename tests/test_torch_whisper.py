"""Parity of repro_torch's audio family (whisper-base: a bidirectional
encoder over frame embeddings, a decoder with learned positions and
cross-attention) with repro's model, at its smoke config in f32.

Both packages run the same weights (``params_from_jax`` of the JAX
``init_params(PRNGKey(0))``, the encoder stack and learned position tables
included) and the same numpy-seeded frames and prompts; the JAX serve
steps are jitted.  The JAX side runs the encoder's and the cross
attention's non-causal ``attention_dense``; the port runs ``flash_prefill``
at all-zero positions for both, and ``gqa_decode`` over the whole cross
cache in decode.

Tolerances, f32: atol 1e-4 on logits and every cache leaf, ``xk`` and
``xv`` included (as ``tests/test_torch_model.py``); greedy tokens and
``pos`` equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.launch import serve as jax_serve  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.params import param_count as jax_param_count  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.blocks import (attention_layers,  # noqa: E402
                                       decode_attention_layers)
from repro_torch.models.convert import cache_from_jax  # noqa: E402
from repro_torch.models.params import param_count, tree_leaves  # noqa: E402
from repro_torch.train import steps as TS  # noqa: E402

from test_torch_model_families import (CPU, _check_caches,  # noqa: E402
                                       _close, _jax_params, _jax_steps)

ARCH = "whisper-base-smoke"


def test_configs_and_param_counts_match_the_jax_package():
    for arch in ("whisper-base", ARCH):
        assert vars(get_config(arch)) == vars(jax_get_config(arch))
        assert param_count(get_config(arch)) == \
            jax_param_count(jax_get_config(arch))
    assert param_count(get_config("whisper-base")) == 112_630_784
    cfg = get_config("whisper-base")
    # 6 encoder layers, 6 decoder layers of self + cross attention
    assert attention_layers(cfg) == 18 and decode_attention_layers(cfg) == 12


def test_init_params_layout_matches_jax():
    """The port's own initialization has the JAX tree's keys, shapes and
    dtypes: the encoder stack, the learned position tables, the decoder's
    cross-attention projections."""
    params = M.init_params(get_config(ARCH), seed=0, device=CPU)
    jshapes = jax.eval_shape(lambda: JM.init_params(
        jax_get_config(ARCH), jax.random.PRNGKey(0)))
    want = {k: (v.shape, str(v.dtype)) for k, v in tree_leaves(jshapes)}
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in tree_leaves(params)}
    assert got == want
    assert {"pos_dec/w", "pos_enc/w", "enc_final_norm/bias",
            "stack_0/b0_dec/xattn/wq"} <= set(got)


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return {"embeds": rng.standard_normal((b, cfg.enc_seq, cfg.d_model)
                                          ).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}


@pytest.mark.parametrize("prompt_len", [5, 12])
def test_prefill_and_greedy_decode_match_jax(prompt_len):
    """Prefill (the encoder over the frames, the decoder's prompt) and 4
    greedy decode steps against the JAX model: the logits, the greedy
    tokens and every cache leaf, the cross caches ``xk`` and ``xv`` that
    prefill fills and decode reads included.  ``params_from_jax`` and
    ``cache_from_jax`` carry the encoder stack and the cross caches by a
    plain leaf-by-leaf copy."""
    jcfg, jparams, params = _jax_params(ARCH)
    cfg = get_config(ARCH)
    assert {k for k, _ in tree_leaves(params)} == \
        {k for k, _ in tree_leaves(jax.tree.map(np.asarray, jparams))}
    b, gen = 2, 4
    batch = _batch(cfg, b, prompt_len, prompt_len)
    jpre, jdec = _jax_steps(jcfg)
    jc = JM.init_cache(jcfg, b, prompt_len + gen)
    tc = cache_from_jax(jax.tree.map(np.asarray, jc), CPU)
    assert tuple(tc["stack_0"]["b0_dec"]["xk"].shape) == \
        (cfg.n_layers, b, cfg.enc_seq, cfg.n_kv_heads, cfg.head_dim)
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
    """One decode step at position S (self-attention over S + 1 slots,
    cross-attention over every frame) gives the last-position logits of a
    prefill over S + 1 tokens on the same frames, f32 within 1e-4."""
    cfg = get_config(ARCH)
    params = M.init_params(cfg, seed=0, device=CPU)
    b, s = 2, 16
    batch = {k: torch.from_numpy(a) for k, a in _batch(cfg, b, s + 1,
                                                        3).items()}
    cache = M.init_cache(cfg, b, 32, device=CPU)
    cache, _ = M.prefill(params, {"embeds": batch["embeds"],
                                  "tokens": batch["tokens"][:, :s]}, cache,
                         cfg)
    _, lg_dec = M.decode_step(params, cache, batch["tokens"][:, s:], cfg)
    _, lg_ref = M.prefill(params, batch, M.init_cache(cfg, b, 32, device=CPU),
                          cfg)
    np.testing.assert_allclose(lg_dec.numpy(), lg_ref.numpy(), atol=1e-4,
                               rtol=0)


SERVE_ARGS = ["--arch", ARCH, "--requests", "2", "--prompt-len", "4",
              "--gen", "2"]


def test_both_serves_refuse_whisper():
    """Neither package's serve can serve the audio family: it passes token
    prompts only, and the prefill also needs the encoder's frames.  The
    JAX serve fails on the missing ``embeds``; the port refuses with a
    ValueError that says why, from ``run`` and from the command line."""
    with pytest.raises(KeyError, match="embeds"):
        jax_serve.main(list(SERVE_ARGS))
    with pytest.raises(ValueError, match="frame embeddings"):
        serve.main(list(SERVE_ARGS))
    with pytest.raises(ValueError, match="frame embeddings"):
        serve.run(get_config(ARCH), requests=2, prompt_len=4, gen=2,
                  device="cpu")
