"""Parity of repro_torch's serving path with repro's model, for the dense
GQA smoke configs in f32.

The JAX package's ``init_params(PRNGKey(0))`` is converted by
``params_from_jax``, so both packages run the same weights.  The JAX side
runs prefill attention through ``attention_dense`` and decode attention
through ``gqa_decode_ref``; the port runs its ``flash_prefill`` and
``gqa_decode`` ops, which take their plain versions on CPU tensors.

Tolerance: f32, atol 1e-4 on logits and cache leaves.  The two packages
sum in other orders (XLA's dot against torch's matmul, the chunked dense
attention against the reference einsum), so f32 agreement is to rounding,
not bit for bit; greedy tokens must be equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.sharding import CPU_CTX  # noqa: E402
from repro.train import steps as JTS  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import (cache_from_jax,  # noqa: E402
                                        params_from_jax)
from repro_torch.models.params import param_count, tree_leaves  # noqa: E402
from repro_torch.train import steps as TS  # noqa: E402

ATOL = 1e-4
CPU = torch.device("cpu")
ARCHS = ("qwen3-32b-smoke", "h2o-danube-3-4b-smoke")


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


def _close(got, want, what):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=ATOL, rtol=0, err_msg=what)


def _jax_params(arch, **variant):
    cfg = jax_get_config(arch).replace(**variant)
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, params, params_from_jax(jax.tree.map(np.asarray, params), CPU)


def _check_caches(tc, jc):
    """Every cache leaf of the port equals the JAX one."""
    jflat = dict(tree_leaves(jax.tree.map(np.asarray, jc)))
    tflat = dict(tree_leaves(tc))
    assert sorted(jflat) == sorted(tflat)
    for key, want in jflat.items():
        got = tflat[key]
        assert tuple(got.shape) == want.shape, key
        if key == "pos":
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            _close(got, want, key)


def test_configs_match_the_jax_package():
    for arch in ARCHS + ("qwen3-32b", "h2o-danube-3-4b"):
        assert vars(get_config(arch)) == vars(jax_get_config(arch))
    assert param_count(get_config("qwen3-32b")) == 32_762_123_264


@pytest.mark.parametrize("arch,prompt_len,variant", [
    ("qwen3-32b-smoke", 12, {}), ("h2o-danube-3-4b-smoke", 12, {}),
    # longer than h2o's window of 16: prefill drives the ring write
    ("h2o-danube-3-4b-smoke", 23, {}),
    # the ported config fields the two configs leave at their defaults
    ("h2o-danube-3-4b-smoke", 12,
     {"norm": "layernorm", "qkv_bias": True, "tie_embeddings": True})])
def test_prefill_and_greedy_decode_match_jax(arch, prompt_len, variant):
    jcfg, jparams, params = _jax_params(arch, **variant)
    cfg = get_config(arch).replace(**variant)
    b, gen = 2, 4
    max_seq = prompt_len + gen
    toks = np.random.default_rng(prompt_len).integers(
        0, cfg.vocab, (b, prompt_len)).astype(np.int32)

    jpre, jdec = JTS.make_serve_steps(jcfg, CPU_CTX)
    jc = JM.init_cache(jcfg, b, max_seq)
    jc, jlogits = jpre(jparams, {"tokens": jnp.asarray(toks)}, jc)
    tpre, tdec = TS.make_serve_steps(cfg)
    tc = cache_from_jax(jax.tree.map(np.asarray,
                                     JM.init_cache(jcfg, b, max_seq)), CPU)
    tc, tlogits = tpre(params, {"tokens": torch.from_numpy(toks)}, tc)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill(arch):
    """tests/test_arch_smoke.py's check on the port: one decode step at
    position S gives the last-position logits of a prefill over S + 1
    tokens."""
    _, _, params = _jax_params(arch)
    cfg = get_config(arch)
    b, s = 2, 20
    tok = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (b, s + 1)).astype(np.int32))
    cache = M.init_cache(cfg, b, 64, device=CPU)
    cache, _ = M.prefill(params, {"tokens": tok[:, :s]}, cache, cfg)
    _, lg_dec = M.decode_step(params, cache, tok[:, s:s + 1], cfg)
    c2 = M.init_cache(cfg, b, 64, device=CPU)
    _, lg_ref = M.prefill(params, {"tokens": tok}, c2, cfg)
    np.testing.assert_allclose(lg_dec.numpy(), lg_ref.numpy(), atol=ATOL,
                               rtol=0)


def test_serve_run_matches_jax_generation():
    """The port's serve.run on the CPU: the same greedy tokens as the JAX
    model on the same weights and prompts, every completion registered at
    one psync each, and all still registered after crash and recovery at
    zero recovery psyncs."""
    arch = "qwen3-32b-smoke"
    jcfg, jparams, params = _jax_params(arch)
    cfg = get_config(arch)
    requests, prompt_len, gen = 4, 8, 8
    res = serve.run(cfg, requests=requests, prompt_len=prompt_len, gen=gen,
                    crash=True, device="cpu", params=params)
    assert res["registered"] == requests and res["psyncs"] == requests
    assert res["registered_after_recovery"] == requests
    assert res["recovery_psyncs"] == 0 and res["psyncs_after_recovery"] == 0

    toks = np.random.default_rng(0).integers(0, cfg.vocab,
                                             (requests, prompt_len))
    jpre, jdec = JTS.make_serve_steps(jcfg, CPU_CTX)
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


def test_init_params_layout_and_scale():
    """The port's own initialization: the JAX tree's keys, shapes and
    dtypes, ones for the norms, and weights drawn at 1/sqrt(fan-in)."""
    cfg = get_config("qwen3-32b-smoke")
    params = M.init_params(cfg, seed=0, device=CPU)
    jshapes = jax.eval_shape(lambda: JM.init_params(
        jax_get_config("qwen3-32b-smoke"), jax.random.PRNGKey(0)))
    want = {k: (v.shape, str(v.dtype))
            for k, v in tree_leaves(jax.tree.map(lambda a: a, jshapes))}
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in tree_leaves(params)}
    assert got == want
    assert bool((params["stack_0"]["b0_attn"]["ln1"]["scale"] == 1).all())
    wi = params["stack_0"]["b0_attn"]["mlp"]["wi"]
    assert abs(float(wi.std()) * cfg.d_model ** 0.5 - 1) < 0.05
    assert not torch.equal(wi[0], wi[1])
