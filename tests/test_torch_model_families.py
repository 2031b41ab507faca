"""Parity of repro_torch's serving path with repro's model for the
decoder-only families beyond dense GQA: MoE (mixtral-8x22b, arctic-480b),
QKV bias at qwen1.5-110b, MLA (minicpm3-4b), xLSTM (xlstm-350m) and the
hybrid RG-LRU + local attention (recurrentgemma-2b), at their smoke
configs in f32.

Both packages run the same weights (``params_from_jax`` of the JAX
``init_params(PRNGKey(0))``) and the same numpy-seeded prompts.  The JAX
side runs prefill attention through ``attention_dense`` and decode
attention through ``gqa_decode_ref``; the port runs its ``flash_prefill``
and ``gqa_decode`` ops, which take their plain versions on CPU tensors.

Tolerances, f32: atol 1e-4 on logits and attention caches, as in
``tests/test_torch_model.py``; the recurrent state leaves (``c``, ``n``,
``h``, ``conv``) atol 1e-4 and rtol 1e-4, because the mLSTM input gate
reaches e^8 and its states grow with it.  Greedy tokens and ``pos`` must be
equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.params import param_count as jax_param_count  # noqa: E402
from repro.models.sharding import CPU_CTX  # noqa: E402
from repro.train import steps as JTS  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import (cache_from_jax,  # noqa: E402
                                        params_from_jax)
from repro_torch.models.params import (NOT_PORTED, param_count,  # noqa: E402
                                       tree_leaves)
from repro_torch.train import steps as TS  # noqa: E402

ATOL = 1e-4
STATE_RTOL = 1e-4
STATE_LEAVES = ("c", "n", "h", "conv")
CPU = torch.device("cpu")
FAMILIES = ("mixtral-8x22b", "arctic-480b", "qwen1.5-110b", "minicpm3-4b",
            "xlstm-350m", "recurrentgemma-2b")
SMOKE = tuple(a + "-smoke" for a in FAMILIES)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


def _close(got, want, what, rtol=0.0):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=ATOL, rtol=rtol, err_msg=what)


def _jax_params(arch, **variant):
    cfg = jax_get_config(arch).replace(**variant)
    params = jax.jit(JM.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0))
    return cfg, params, params_from_jax(jax.tree.map(np.asarray, params), CPU)


def _jax_steps(cfg):
    """The JAX serve steps, jitted: one compile of each is a fraction of
    the op-by-op dispatch's compiles at these sizes."""
    jpre, jdec = JTS.make_serve_steps(cfg, CPU_CTX)
    return jax.jit(jpre), jax.jit(jdec)


def _check_caches(tc, jc):
    """Every cache leaf of the port equals the JAX one, in its dtype."""
    jflat = dict(tree_leaves(jax.tree.map(np.asarray, jc)))
    tflat = dict(tree_leaves(tc))
    assert sorted(jflat) == sorted(tflat)
    for key, want in jflat.items():
        got = tflat[key]
        assert tuple(got.shape) == want.shape, key
        assert str(got.dtype).replace("torch.", "") == str(want.dtype), key
        if key == "pos":
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            leaf = key.rsplit("/", 1)[-1]
            _close(got, want, key,
                   STATE_RTOL if leaf in STATE_LEAVES else 0.0)


def test_configs_and_param_counts_match_the_jax_package():
    for arch in FAMILIES + SMOKE:
        assert vars(get_config(arch)) == vars(jax_get_config(arch))
        assert param_count(get_config(arch)) == \
            jax_param_count(jax_get_config(arch))
    assert param_count(get_config("mixtral-8x22b")) == 140_630_071_296
    assert NOT_PORTED == {}


@pytest.mark.parametrize("arch,prompt_len,variant", [
    *((a, 12, {}) for a in SMOKE),
    # longer than recurrentgemma-smoke's window of 16: the local
    # attention's ring takes the prompt's last 16 keys
    ("recurrentgemma-2b-smoke", 23, {}),
    # one (rglru, rglru, attn) period and a tail stack of two rglru
    # layers, as recurrentgemma-2b's 26 = 8 x 3 + 2
    ("recurrentgemma-2b-smoke", 12, {"n_layers": 5})])
def test_prefill_and_greedy_decode_match_jax(arch, prompt_len, variant):
    jcfg, jparams, params = _jax_params(arch, **variant)
    cfg = get_config(arch).replace(**variant)
    assert len(cfg.stacks()) == (2 if variant else 1)
    b, gen = 2, 4
    max_seq = prompt_len + gen
    toks = np.random.default_rng(prompt_len).integers(
        0, cfg.vocab, (b, prompt_len)).astype(np.int32)

    jpre, jdec = _jax_steps(jcfg)
    jc = JM.init_cache(jcfg, b, max_seq)
    tc = cache_from_jax(jax.tree.map(np.asarray, jc), CPU)
    jc, jlogits = jpre(jparams, {"tokens": jnp.asarray(toks)}, jc)
    tpre, tdec = TS.make_serve_steps(cfg)
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


@pytest.mark.parametrize("arch", SMOKE)
def test_decode_matches_prefill(arch):
    """tests/test_arch_smoke.py's check on the port: one decode step at
    position S gives the last-position logits of a prefill over S + 1
    tokens.  MoE keeps that test's 5e-2, as decode groups the batch's
    tokens together and prefill groups each row's, so their capacity
    drops may differ; the other families are held to f32's 1e-4."""
    cfg = get_config(arch)
    params = M.init_params(cfg, seed=0, device=CPU)
    b, s = 2, 16
    tok = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (b, s + 1)).astype(np.int32))
    cache = M.init_cache(cfg, b, 64, device=CPU)
    cache, _ = M.prefill(params, {"tokens": tok[:, :s]}, cache, cfg)
    _, lg_dec = M.decode_step(params, cache, tok[:, s:s + 1], cfg)
    c2 = M.init_cache(cfg, b, 64, device=CPU)
    _, lg_ref = M.prefill(params, {"tokens": tok}, c2, cfg)
    np.testing.assert_allclose(lg_dec.numpy(), lg_ref.numpy(),
                               atol=5e-2 if cfg.n_experts else 1e-4, rtol=0)


def test_serve_run_matches_jax_generation():
    """The port's serve.run at mixtral-8x22b-smoke on the CPU: the same
    greedy tokens as the JAX model on the same weights and prompts, every
    completion registered at one psync each and still registered after
    crash and recovery at zero recovery psyncs."""
    arch = "mixtral-8x22b-smoke"
    jcfg, jparams, params = _jax_params(arch)
    cfg = get_config(arch)
    requests, prompt_len, gen = 4, 8, 6
    res = serve.run(cfg, requests=requests, prompt_len=prompt_len, gen=gen,
                    crash=True, device="cpu", params=params)
    assert res["registered"] == requests and res["psyncs"] == requests
    assert res["registered_after_recovery"] == requests
    assert res["recovery_psyncs"] == 0 and res["psyncs_after_recovery"] == 0

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


@pytest.mark.parametrize("arch", SMOKE)
def test_every_family_serves_on_the_cpu(arch):
    """Each family through the port's serve entry point, with a crash of
    the registry: tokens in range, finite logits, one psync per request and
    none in recovery."""
    cfg = get_config(arch)
    res = serve.run(cfg, requests=2, prompt_len=8, gen=3, crash=True,
                    device="cpu")
    tokens = res["tokens"]
    assert tuple(tokens.shape) == (2, 3)
    assert bool(((tokens >= 0) & (tokens < cfg.vocab)).all())
    assert bool(torch.isfinite(res["logits"]).all())
    assert res["psyncs"] == 2 and res["recovery_psyncs"] == 0
    assert res["registered_after_recovery"] == 2


def test_init_params_layout_matches_jax():
    """The port's own initialization: the JAX tree's keys, shapes and
    dtypes for every new family (expert stacks, MLA projections, the
    recurrent mixers' leaves)."""
    for arch in SMOKE:
        params = M.init_params(get_config(arch), seed=0, device=CPU)
        jshapes = jax.eval_shape(lambda a=arch: JM.init_params(
            jax_get_config(a), jax.random.PRNGKey(0)))
        want = {k: (v.shape, str(v.dtype)) for k, v in tree_leaves(jshapes)}
        got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
               for k, v in tree_leaves(params)}
        assert got == want, arch
