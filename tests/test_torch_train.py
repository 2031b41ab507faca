"""Parity of the port's training path (``repro_torch.models.model``'s
``forward_train``, ``ce_loss_chunked`` and ``loss_fn``, ``optim.adamw``
and ``train.steps``) with the JAX package, on the same state.

Every case starts both packages from one state: the JAX ``TrainState``
of ``init_params(PRNGKey(0))`` and ``adamw.init``, as numpy, converted by
``train_state_from_jax``.  The batches are ``tests/test_arch_smoke.py``'s
(B 2, S 16; the vlm's patch embeddings at M-RoPE positions, whisper's
frames and decoder tokens).  The smoke configs are f32.  The JAX side is
jitted: one compile per config computes the forward, the loss, the
gradients and one train step.

Tolerances, f32: the final hidden state and aux within 1e-5 absolute;
the loss, ce and aux within 1e-5 relative; every gradient leaf within
1e-4 of that leaf's largest magnitude; after one step ``step`` equal, m
and v within lr x 1e-3 absolute, the params within lr x 1e-3 of JAX's
update of the port's gradients (``_check_step`` says why), the grad norm
within 1e-5 relative.  Inside the port, remat "full" and "dots" give the
same numbers as "none".
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs.all import ASSIGNED  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.sharding import CPU_CTX  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import steps as JTS  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import train_state_from_jax  # noqa: E402
from repro_torch.models.params import (tree_leaves, tree_map,  # noqa: E402
                                       tree_unflatten)
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import steps as TS  # noqa: E402

CPU = torch.device("cpu")
B, S = 2, 16
LR = 1e-3
HIDDEN_ATOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4            # of each leaf's largest magnitude
STEP_ATOL = LR * 1e-3
GNORM_RTOL = 1e-5
OPT = dict(lr=LR, warmup=1, total_steps=10)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port while this module runs: its
    operations are tiny, and with several test workers on one host each
    op spread over every core spends its time waiting on the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_batch(cfg, rng=0):
    """``tests/test_arch_smoke.py``'s batch, as numpy arrays."""
    key = jax.random.PRNGKey(rng)
    tok = jax.random.randint(key, (B, S + 1), 0, cfg.vocab)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    if cfg.family == "vlm":
        batch = {
            "embeds": jax.random.normal(key, (B, S, cfg.d_model)) * 0.02,
            "labels": tok[:, 1:],
            "positions": jnp.broadcast_to(
                jnp.arange(S, dtype=jnp.int32)[None, None], (3, B, S)),
        }
    if cfg.family == "audio":
        batch = {
            "embeds": jax.random.normal(key, (B, cfg.enc_seq, cfg.d_model))
            * 0.02,
            "tokens": tok[:, :-1], "labels": tok[:, 1:],
        }
    return {k: np.asarray(v) for k, v in batch.items()}


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_state(jcfg, opt_cfg):
    params = jax.jit(JM.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))
    return JTS.TrainState(params, jadamw.init(params, opt_cfg))


@functools.lru_cache(maxsize=None)
def _jax_reference(arch, grad_accum=1):
    """The JAX package on its smoke state and batch, jitted once: the
    forward, the loss with its metrics and gradients, and one train step.
    Returns (state, batch, outputs) as numpy."""
    jcfg = jax_get_config(arch)
    opt_cfg = jadamw.AdamWConfig(**OPT, state_dtype=jcfg.opt_dtype)
    state = _jax_state(jcfg, opt_cfg)
    batch = make_batch(jcfg)
    step = JTS.make_train_step(jcfg, CPU_CTX, opt_cfg, grad_accum=grad_accum)

    def run(state, batch):
        x, aux = JM.forward_train(state.params, batch, jcfg, CPU_CTX)
        (loss, metrics), grads = jax.value_and_grad(
            JM.loss_fn, has_aux=True)(state.params, batch, jcfg, CPU_CTX)
        new_state, step_metrics = step(state, batch)
        return dict(x=x, aux=aux, loss=loss, metrics=metrics, grads=grads,
                    state=new_state, step_metrics=step_metrics)

    out = jax.jit(run)(state, {k: jnp.asarray(v) for k, v in batch.items()})
    return _np(state), batch, _np(out)


def _port_state(jstate):
    return train_state_from_jax(jstate, CPU)


def _flat(tree):
    return {k: np.asarray(v.float() if isinstance(v, torch.Tensor) else v,
                          np.float32)
            for k, v in tree_leaves(tree)}


def _jflat(tree):
    return {k: np.asarray(v, np.float32) for k, v in tree_leaves(tree)}


def _close_rel(got, want, rtol, what):
    got, want = float(got), float(want)
    assert abs(got - want) <= rtol * max(abs(want), 1e-30), \
        f"{what}: {got} vs {want}"


def _port_grads(cfg, params, tb, grad_accum):
    """The gradients the port's train step applies: each microbatch's,
    summed, then divided (numpy, nested as the params)."""
    total = None
    for i in range(grad_accum):
        _, _, g = TS.loss_and_grads(cfg, params,
                                    TS.microbatch(tb, i, grad_accum))
        total = g if total is None else jax.tree.map(torch.add, total, g)
    return tree_map(lambda a: (a / grad_accum).numpy(), total)


def _check_step(cfg, jstate, tb, grad_accum, ref):
    """One train step from JAX's state against JAX's: ``step`` equal, the
    grad norm within GNORM_RTOL, the loss within LOSS_RTOL, m and v within
    STEP_ATOL.  The params within STEP_ATOL of JAX's ``adamw.update``
    applied to the port's own gradients (held against JAX's above): on the
    first step AdamW divides each gradient by its magnitude + eps (1e-8),
    so at the elements whose gradient is itself about 1e-8 the f32
    rounding of the two gradients (about 1e-6 of a leaf's largest) moves
    the update by up to 0.12 lr."""
    opt_cfg = adamw.AdamWConfig(**OPT, state_dtype=cfg.opt_dtype)
    state = _port_state(jstate)
    grads = _port_grads(cfg, state.params, tb, grad_accum)
    state, tm = TS.make_train_step(cfg, opt_cfg, grad_accum)(state, tb)
    jstep, jm = ref["state"], ref["step_metrics"]
    assert int(state.opt.step) == int(jstep.opt.step) == 1
    _close_rel(tm["grad_norm"], jm["grad_norm"], GNORM_RTOL, "grad_norm")
    _close_rel(tm["loss"], jm["loss"], LOSS_RTOL, "loss")
    jopt = jadamw.AdamWConfig(**OPT, state_dtype=cfg.opt_dtype)
    jparams = _np(jax.jit(functools.partial(jadamw.update, cfg=jopt))(
        grads, jstate.opt, jstate.params)[0])
    for name, got, want in (("params", state.params, jparams),
                            ("m", state.opt.m, jstep.opt.m),
                            ("v", state.opt.v, jstep.opt.v)):
        g, w = _flat(got), _jflat(want)
        assert sorted(g) == sorted(w)
        for key in w:
            np.testing.assert_allclose(g[key], w[key], atol=STEP_ATOL,
                                       rtol=0, err_msg=f"{name}/{key}")


@pytest.mark.parametrize("arch", ASSIGNED)
def test_train_path_matches_jax(arch):
    """forward_train, loss_fn and its gradients, and one train step, at
    each of the ten smoke configs."""
    jstate, batch, ref = _jax_reference(arch + "-smoke")
    cfg = get_config(arch + "-smoke")
    state = _port_state(jstate)
    tb = _torch_batch(batch)

    x, aux = M.forward_train(state.params, tb, cfg)
    assert x.shape == ref["x"].shape and aux.dtype == torch.float32
    np.testing.assert_allclose(x.numpy(), ref["x"], atol=HIDDEN_ATOL,
                               rtol=0, err_msg="hidden")
    np.testing.assert_allclose(float(aux), float(ref["aux"]),
                               atol=HIDDEN_ATOL, rtol=0, err_msg="aux")

    loss, metrics, grads = TS.loss_and_grads(cfg, state.params, tb)
    _close_rel(loss, ref["loss"], LOSS_RTOL, "loss")
    for key in ("ce", "aux"):
        _close_rel(metrics[key], ref["metrics"][key], LOSS_RTOL, key)
    g, w = _flat(grads), _jflat(ref["grads"])
    assert sorted(g) == sorted(w)
    for key in w:
        scale = float(np.abs(w[key]).max())
        np.testing.assert_allclose(g[key], w[key], atol=GRAD_RTOL * scale,
                                   rtol=0, err_msg=f"grad {key}")

    _check_step(cfg, jstate, tb, 1, ref)


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "qwen2-vl-2b"])
def test_grad_accum_matches_jax(arch):
    """grad_accum=2 against JAX's: the microbatches cut by JAX's rule (the
    vlm's (3, B, S) M-RoPE positions on dim 1)."""
    jstate, batch, ref = _jax_reference(arch + "-smoke", grad_accum=2)
    _check_step(get_config(arch + "-smoke"), jstate, _torch_batch(batch), 2,
                ref)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_remat_changes_no_number(arch):
    """remat "full" and "dots" give the loss and every gradient of remat
    "none", bit for bit, inside the port (the layers' param slices are
    the checkpointed bodies' inputs, so their gradients arrive)."""
    base = get_config(arch + "-smoke")
    jstate, batch, _ = _jax_reference(arch + "-smoke")
    params = _port_state(jstate).params
    tb = _torch_batch(batch)
    out = {}
    for remat in ("none", "full", "dots"):
        loss, metrics, grads = TS.loss_and_grads(
            base.replace(remat=remat), params, tb)
        out[remat] = (loss, metrics["aux"], dict(tree_leaves(grads)))
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0]), remat
        assert torch.equal(out[remat][1], out["none"][1]), remat
        for key, g in out["none"][2].items():
            assert torch.equal(out[remat][2][key], g), (remat, key)


def test_remat_dots_recomputes_no_weight_product():
    """What each policy recomputes in backward, counted at the dispatcher:
    "dots" runs the weight products (``aten.mm``) of "none" and recomputes
    the attention's batched products and softmax; "full" recomputes weight
    products too."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n[func] = self.n.get(func, 0) + 1
            return func(*args, **(kwargs or {}))

    base = get_config("h2o-danube-3-4b-smoke")
    jstate, batch, _ = _jax_reference("h2o-danube-3-4b-smoke")
    params = _port_state(jstate).params
    aten = torch.ops.aten
    counts = {}
    for remat in ("none", "dots", "full"):
        cfg = base.replace(remat=remat)
        leaves = [a.detach().requires_grad_()
                  for _, a in tree_leaves(params)]
        loss, _ = M.loss_fn(tree_unflatten(params, leaves),
                            _torch_batch(batch), cfg)
        with Count() as c:
            torch.autograd.grad(loss, leaves)
        counts[remat] = {op: c.n.get(op, 0) for op in (
            aten.mm.default, aten.bmm.default, aten._softmax.default)}
    none, dots, full = counts["none"], counts["dots"], counts["full"]
    assert none[aten._softmax.default] == 0
    assert dots[aten.mm.default] == none[aten.mm.default]
    assert dots[aten.bmm.default] > none[aten.bmm.default]
    assert dots[aten._softmax.default] == base.n_layers
    assert full[aten.mm.default] > none[aten.mm.default]


def test_ce_loss_chunked_matches_jax():
    """Several chunks (tokens_per_chunk 64 over B 4 x S 48: c = 16, three
    chunks, each recomputed in backward), masked labels: the loss and its
    gradients in x and the unembedding against JAX."""
    rng = np.random.default_rng(3)
    b, s, d, v = 4, 48, 32, 100
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    w = (rng.standard_normal((d, v)) / np.sqrt(d)).astype(np.float32)
    labels = rng.integers(-1, v, (b, s)).astype(np.int32)

    def jloss(x, w):
        return JM.ce_loss_chunked(x, w, jnp.asarray(labels), CPU_CTX,
                                  tokens_per_chunk=64)
    jl, (jgx, jgw) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tl = M.ce_loss_chunked(tx, tw, torch.from_numpy(labels),
                           tokens_per_chunk=64)
    gx, gw = torch.autograd.grad(tl, (tx, tw))
    _close_rel(tl.detach(), jl, LOSS_RTOL, "loss")
    for got, want in ((gx, jgx), (gw, jgw)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=GRAD_RTOL * np.abs(want).max(),
                                   rtol=0)


@pytest.mark.parametrize("sq,sk,h,kv,d,dv,window,causal", [
    (1024, 1024, 4, 2, 16, 16, 100, True),    # two chunks of 512, window
    (1500, 1500, 2, 2, 8, 8, None, False),    # whisper's 1500 -> 500
    (12, 20, 4, 4, 24, 16, None, False),      # cross, Dv < D (MLA)
])
def test_attention_dense_matches_jax(sq, sk, h, kv, d, dv, window, causal):
    """``attention_dense`` and its gradients in q, k and v against JAX's,
    at random positions with repeats."""
    rng = np.random.default_rng(sq + sk)
    q = rng.standard_normal((2, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((2, sk, kv, d)).astype(np.float32)
    v = rng.standard_normal((2, sk, kv, dv)).astype(np.float32)
    qp = np.sort(rng.integers(0, sq, (2, sq)), 1).astype(np.int32)
    kp = np.sort(rng.integers(0, sk, (2, sk)), 1).astype(np.int32)
    ct = rng.standard_normal((2, sq, h, dv)).astype(np.float32)

    def jf(q, k, v):
        out = JL.attention_dense(CPU_CTX, q, k, v, jnp.asarray(qp),
                                 jnp.asarray(kp), window, causal=causal)
        return jnp.sum(out * ct), out
    (_, jout), jg = jax.jit(jax.value_and_grad(jf, argnums=(0, 1, 2),
                                               has_aux=True))(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = L.attention_dense(tq, tk, tv, torch.from_numpy(qp),
                            torch.from_numpy(kp), window, causal=causal)
    tg = torch.autograd.grad((out * torch.from_numpy(ct)).sum(),
                             (tq, tk, tv))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=HIDDEN_ATOL, rtol=0)
    for got, want in zip(tg, jg):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=GRAD_RTOL * np.abs(want).max(),
                                   rtol=0)


def test_adamw_schedule_matches_jax():
    """The lr at step 0, 1, the end of warmup and total_steps (and past
    it), from an int32 step tensor."""
    cfg = adamw.AdamWConfig(lr=3e-4, warmup=7, total_steps=50)
    jcfg = jadamw.AdamWConfig(lr=3e-4, warmup=7, total_steps=50)
    for step in (0, 1, 7, 8, 30, 50, 60):
        got = adamw.schedule(torch.tensor(step, dtype=torch.int32), cfg)
        want = jadamw.schedule(jnp.asarray(step, jnp.int32), jcfg)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   atol=1e-12, err_msg=f"step {step}")


def test_adamw_update_bf16_state_matches_jax():
    """Three updates with bf16 m and v and clipping on (grads past
    clip_norm), over a stacked leaf (updated one slice at a time), a 2-D
    and a 1-D leaf: params, m and v (bf16, equal bits or one ulp), step
    and the grad norm against JAX."""
    rng = np.random.default_rng(5)
    shapes = {"stack": {"w": (3, 8, 6)}, "emb": (10, 4), "scale": (5,)}
    params = jax.tree.map(lambda s: rng.standard_normal(s).astype(
        np.float32), shapes, is_leaf=lambda s: isinstance(s, tuple))
    cfg = adamw.AdamWConfig(lr=1e-2, warmup=2, total_steps=10,
                            state_dtype="bfloat16")
    jcfg = jadamw.AdamWConfig(lr=1e-2, warmup=2, total_steps=10,
                              state_dtype="bfloat16")
    jp, jst = params, jadamw.init(params, jcfg)
    # copies: the port updates its params in place, and JAX may read
    # the numpy arrays it was given without copying them
    tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()), params)
    tst = adamw.init(tp, cfg)
    assert tst.m["emb"].dtype == torch.bfloat16
    jupd = jax.jit(functools.partial(jadamw.update, cfg=jcfg))
    for i in range(3):
        grads = jax.tree.map(lambda a: (3 * rng.standard_normal(
            a.shape)).astype(np.float32), params)
        jp, jst, jn = jupd(grads, jst, jp)
        tp, tst, tn = adamw.update(jax.tree.map(torch.from_numpy, grads),
                                   tst, tp, cfg)
        assert int(tst.step) == int(jst.step) == i + 1
        _close_rel(tn, jn, GNORM_RTOL, "grad norm")
        for name, got, want in (("params", tp, jp), ("m", tst.m, jst.m),
                                ("v", tst.v, jst.v)):
            for (key, g), (_, w) in zip(tree_leaves(got),
                                        tree_leaves(_np(want))):
                w = np.asarray(w, np.float32)
                tol = 1e-6 if name == "params" else \
                    2 ** -7 * np.abs(w).max()        # one bf16 ulp
                np.testing.assert_allclose(g.float().numpy(), w, atol=tol,
                                           rtol=0, err_msg=f"{name}/{key}")
