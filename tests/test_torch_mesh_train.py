"""The port's sharded train step on a (data, model) grid of 4 ``gloo``
ranks against the JAX package's ``make_train_step(cfg, ctx, opt_cfg)``
under ``make_shard_ctx`` on a 2 x 2 mesh of 4 fake CPU devices (part 2
of ``tests/test_multidevice.py``'s script), with the layout pieces
(``param_pspecs``, ``batch_pspecs``, ``input_specs``) and the port's own
one-process step.

One JAX subprocess (``XLA_FLAGS=--xla_force_host_platform_device_count=4``,
``JAX_DISABLE_MOST_OPTIMIZATIONS=1``) and one 4-rank spawn of the port
(``repro_torch.launch.mesh.spawn``, one intra-op thread a rank, on the
CPU) run at the same time, and every case of the file reads them.  The
JAX side: qwen3-32b-smoke, ``ShapeConfig("t", 32, 8, "train")``,
``init_train_state(PRNGKey(0))`` placed by ``param_pspecs`` (m and v
too), a numpy-seeded batch placed by ``batch_pspecs``, the loss and
gradients of step 1 under the mesh, two train steps, and one step with
``grad_accum=2``; then the same first two for each of ``TP_RUNS`` (the
moe kind, MLA, and the recurrent kinds: xlstm-350m-smoke, also at
``d_model=52``, and recurrentgemma-2b-smoke).  The port: the same state
through ``train_state_from_jax`` cut to each rank's blocks, each rank's
``batch_pspecs`` rows.

Tolerances are ``tests/test_torch_train.py``'s (f32 smoke configs): the
loss, its metrics and the grad norm within 1e-5 relative; each gradient
leaf within 1e-4 of its largest magnitude; after each step the params, m
and v within lr x 1e-3 of JAX's ``adamw.update`` applied to the port's
own gathered gradients and state before the step (the rule of ROADMAP C1:
AdamW's first steps divide each gradient by its magnitude + 1e-8, so the
rounding of two gradients of about 1e-8 moves an update by up to a tenth
of lr), and the same against the port's one-process ``adamw.update`` for
the runs held to one process.  The sums run in other orders (XLA's
collectives and dots against ``gloo`` and torch's), so agreement is to
rounding, not bit for bit; the specs are compared exactly.
"""
import contextlib
import dataclasses
import functools
import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.all import ASSIGNED  # noqa: E402
from repro_torch.configs.base import (SHAPES, ShapeConfig,  # noqa: E402
                                      get_config)
from repro_torch.launch.mesh import ModelMesh, make_model_mesh  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.launch.meshctx import mesh_context  # noqa: E402
from repro_torch.launch.specs import (batch_pspecs, gather,  # noqa: E402
                                      input_specs, local_shape,
                                      make_shard_ctx, put)
from repro_torch.models.convert import train_state_from_jax  # noqa: E402
from repro_torch.models.params import (param_defs,  # noqa: E402
                                       param_pspecs, tree_leaves, tree_map)
from repro_torch.models.sharding import CPU_CTX  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import steps as TS  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
RANKS = 4
ARCH = "qwen3-32b-smoke"
SHAPE = ("t", 32, 8, "train")              # tests/test_multidevice.py's
GRID = (2, 2)
ACCUM = 2
LR = 1e-3
OPT = dict(lr=LR, warmup=1, total_steps=10, state_dtype="float32")
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4            # of each leaf's largest magnitude
STEP_ATOL = LR * 1e-3
GNORM_RTOL = 1e-5
SPEC_GRIDS = ((2, 2), (4, 2), (1, 4))
# the port's (2, 2) step against its own one process: the other dense
# archs (sliding window, QKV bias, M-RoPE positions) and qwen3-32b-smoke
# with tied embeddings (no registered config ties them: the unembedding is
# the transpose of the rank's vocabulary rows); B 8, S 16
SELF_ARCHS = ("h2o-danube-3-4b-smoke", "qwen1.5-110b-smoke",
              "qwen2-vl-2b-smoke", "qwen3-32b-smoke+tied",
              "arctic-480b-smoke")
# MLA's 4 heads over 4 model ranks, one a rank, against one process
MLA_GRID = (1, 4)
SELF_SHAPE = (8, 16)
FSDP_GRID = (4, 1)
# the moe kind, MLA and the recurrent kinds on (2, 2) against JAX's step:
# (name, arch, config fields replaced in both packages).  mixtral's 4
# experts split their width over model; arctic with 16 experts takes JAX's
# EP route (params.py's ``n_experts % 16 == 0``: whole experts over
# model), its dense residual column- and row-parallel; minicpm3's MLA
# splits its 4 heads; xlstm's mLSTM its 2 heads, its sLSTM running whole
# from its gathered weights (widths 64, split; at d_model 52 the widths are
# 69, whole on model as the published 1365 is); recurrentgemma's RG-LRU
# its 64 channels and its one KV head mid-head
TP_RUNS = (("mixtral", "mixtral-8x22b-smoke", {}),
           ("arctic16", "arctic-480b-smoke", {"n_experts": 16}),
           ("minicpm", "minicpm3-4b-smoke", {}),
           ("xlstm", "xlstm-350m-smoke", {}),
           ("xlstm_whole", "xlstm-350m-smoke", {"d_model": 52}),
           ("rglru", "recurrentgemma-2b-smoke", {}))
TP_NAMES = [r[0] for r in TP_RUNS]
# the leaf of each whose blocks differ on every rank (a quarter each)
TP_LEAF = {"mixtral": "stack_0/b0_moe/moe/wi",
           "arctic16": "stack_0/b0_moe/moe/wi",
           "minicpm": "stack_0/b0_attn/attn/wo",
           "xlstm": "stack_0/b0_mlstm/mix/wq",
           "xlstm_whole": "stack_0/b0_mlstm/mix/wq",
           "rglru": "stack_0/b0_rglru/mix/w_x"}
W_UP = "stack_0/b0_mlstm/mix/w_up"
# the leaves JAX keeps whole on model at d_model 52 (width 69)
WHOLE_69 = ("stack_0/b1_slstm/mix/w_up", "stack_0/b1_slstm/mix/w_gate",
            "stack_0/b1_slstm/mix/w_down", "stack_0/b1_slstm/mlp/wi",
            "stack_0/b1_slstm/mlp/wg", "stack_0/b1_slstm/mlp/wo")
# the port's (1, 4) steps against its own one process: RG-LRU's 64
# channels and one KV head over 4 ranks (a quarter of the head a rank),
# qwen3-32b-smoke's 2 KV heads over 4 (half a head a rank)
QUARTER_ARCHS = ("recurrentgemma-2b-smoke", ARCH)
# where the model line lacks tensor-parallel compute (ROADMAP 12.5e):
# (name, arch, config fields replaced, grid)
REFUSALS = (("whisper", "whisper-base-smoke", {}, GRID),
            ("pod", ARCH, {}, (2, 1, 2)),
            ("xlstm", "xlstm-350m-smoke", {}, (1, 4)),
            ("heads", "recurrentgemma-2b-smoke", {"n_heads": 10}, (1, 4)),
            ("lru", "recurrentgemma-2b-smoke", {"lru_dim": 66}, (1, 4)))


def _opt():
    return adamw.AdamWConfig(**OPT)


def _cfg(name):
    """A registered config; "+tied" ties its embeddings."""
    arch, _, tied = name.partition("+")
    cfg = get_config(arch)
    return cfg.replace(tie_embeddings=True) if tied else cfg


def _tp_cfg(name):
    """The port's config of a ``TP_RUNS`` entry."""
    _, arch, kw = next(r for r in TP_RUNS if r[0] == name)
    return get_config(arch).replace(**kw)


def _batch(cfg, b, s, seed=37):
    """A numpy-seeded batch of ``tests/test_arch_smoke.py``'s layout: the
    vlm's patch embeddings at M-RoPE positions, whisper's frames and
    decoder tokens, else tokens.  The first two rows' first labels are
    masked (-1): the ranks hold other counts of labelled tokens, where a
    mean of the ranks' own means would not be the loss."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:].copy()}
    batch["labels"][:2, :s // 2 + 1] = -1
    if cfg.family == "vlm":
        batch = {"embeds": (0.02 * rng.standard_normal(
                     (b, s, cfg.d_model))).astype(np.float32),
                 "labels": batch["labels"],
                 "positions": np.broadcast_to(
                     np.arange(s, dtype=np.int32), (3, b, s))}
    if cfg.family == "audio":
        batch["embeds"] = (0.02 * rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_model))).astype(np.float32)
    return {k: np.ascontiguousarray(v) for k, v in batch.items()}


def _np(tree):
    return tree_map(lambda a: a.detach().cpu().numpy().copy(), tree)


def _state_np(state):
    return {"params": _np(state.params), "m": _np(state.opt.m),
            "v": _np(state.opt.v), "step": int(state.opt.step)}


# ---------------------------------------------------------------------------
# The JAX side (a subprocess with 4 fake CPU devices)
# ---------------------------------------------------------------------------


def _jnp_tree(tree, prefix):
    out = {}
    for key, a in tree_leaves(tree):
        out[f"{prefix}/{key}"] = np.asarray(a)
    return out


def jax_main(out_dir):
    import jax
    from repro.configs.base import ShapeConfig as JShape
    from repro.configs.base import get_config as jget
    from repro.launch.mesh import compat_make_mesh
    from repro.launch.meshctx import mesh_context as jmesh_context
    from repro.launch.specs import batch_pspecs as jbatch_pspecs
    from repro.launch.specs import make_shard_ctx as jmake_ctx
    from repro.launch.specs import to_shardings
    from repro.models import model as JM
    from repro.models.params import param_pspecs as jparam_pspecs
    from repro.optim import adamw as jadamw
    from repro.train import steps as JTS

    assert jax.device_count() == RANKS, jax.device_count()
    os.makedirs(out_dir, exist_ok=True)
    mesh = compat_make_mesh(GRID, ("data", "model"))
    cfg = jget(ARCH)
    shape = JShape(*SHAPE)
    ctx = jmake_ctx(cfg, shape, mesh)
    opt_cfg = jadamw.AdamWConfig(**OPT)
    state = JTS.init_train_state(cfg, jax.random.PRNGKey(0), opt_cfg)
    psh = to_shardings(mesh, jparam_pspecs(cfg, ctx, mesh=mesh))
    state = JTS.TrainState(
        params=jax.device_put(state.params, psh),
        opt=state.opt._replace(m=jax.device_put(state.opt.m, psh),
                               v=jax.device_put(state.opt.v, psh)))
    bsh = to_shardings(mesh, jbatch_pspecs(cfg, shape, ctx))
    batch = _batch(get_config(ARCH), SHAPE[2], SHAPE[1])
    rec = {}
    with jmesh_context(mesh):
        grad = jax.jit(jax.value_and_grad(
            lambda p, b: JM.loss_fn(p, b, cfg, ctx), has_aux=True))
        (loss, met), grads = grad(state.params, jax.device_put(batch, bsh))
        rec.update(loss0=np.asarray(loss), ce0=np.asarray(met["ce"]),
                   aux0=np.asarray(met["aux"]), **_jnp_tree(grads, "grad0"))
        step = jax.jit(JTS.make_train_step(cfg, ctx, opt_cfg))
        st = state
        for k in range(2):
            st, m = step(st, jax.device_put(batch, bsh))
            for name in ("loss", "grad_norm", "ce", "aux"):
                rec[f"{name}_{k}"] = np.asarray(m[name])
        # a param is held in parts (the multidevice script's check)
        wq = st.params["stack_0"]["b0_attn"]["attn"]["wq"]
        rec["wq_devices"] = np.asarray(len(wq.sharding.device_set))
        acc = jax.jit(JTS.make_train_step(cfg, ctx, opt_cfg,
                                          grad_accum=ACCUM))
        st, m = acc(state, jax.device_put(batch, bsh))
        for name in ("loss", "grad_norm", "ce", "aux"):
            rec[f"accum_{name}"] = np.asarray(m[name])
    for name, arch, kw in TP_RUNS:
        rec.update(_jax_tp_run(name, jget(arch).replace(**kw), mesh, opt_cfg))
    np.savez(os.path.join(out_dir, "jax.npz"), **rec)


def _jax_tap_routing(taps):
    """``repro.models.moe``'s ``lax.top_k`` and its one ``jnp.where`` (the
    kept mask choosing each lane's slot) through stand-ins that hand their
    top-k experts and kept mask to the host while a program runs (the
    JAX package itself unchanged); returns the undo."""
    import jax
    from repro.models import moe as JMOE
    real_lax, real_jnp = JMOE.lax, JMOE.jnp

    def record(kind):
        return lambda a: taps[kind].append(np.asarray(a))

    class Lax:
        def __getattr__(self, name):
            return getattr(real_lax, name)

        @staticmethod
        def top_k(x, k):
            v, i = real_lax.top_k(x, k)
            jax.debug.callback(record("topi"), i)
            return v, i

    class Jnp:
        def __getattr__(self, name):
            return getattr(real_jnp, name)

        @staticmethod
        def where(keep, *a):
            jax.debug.callback(record("keep"), keep)
            return real_jnp.where(keep, *a)

    JMOE.lax, JMOE.jnp = Lax(), Jnp()

    def undo():
        JMOE.lax, JMOE.jnp = real_lax, real_jnp
    return undo


def _jax_tp_run(name, cfg, mesh, opt_cfg):
    """One ``TP_RUNS`` config on the 2 x 2 mesh: the loss, metrics and
    gradients of step 1 with each MoE layer's top-k experts and kept mask
    (the forward's, in layer order), then two train steps' metrics."""
    import jax
    from repro.launch.meshctx import mesh_context as jmesh_context
    from repro.launch.specs import batch_pspecs as jbatch_pspecs
    from repro.launch.specs import make_shard_ctx as jmake_ctx
    from repro.launch.specs import to_shardings
    from repro.models import model as JM
    from repro.models.params import param_pspecs as jparam_pspecs
    from repro.configs.base import ShapeConfig as JShape
    from repro.train import steps as JTS
    shape = JShape(*SHAPE)
    ctx = jmake_ctx(cfg, shape, mesh)
    state = JTS.init_train_state(cfg, jax.random.PRNGKey(0), opt_cfg)
    psh = to_shardings(mesh, jparam_pspecs(cfg, ctx, mesh=mesh))
    state = JTS.TrainState(
        params=jax.device_put(state.params, psh),
        opt=state.opt._replace(m=jax.device_put(state.opt.m, psh),
                               v=jax.device_put(state.opt.v, psh)))
    bsh = to_shardings(mesh, jbatch_pspecs(cfg, shape, ctx))
    batch = jax.device_put(_batch(_tp_cfg(name), SHAPE[2], SHAPE[1]), bsh)
    rec, taps = {}, {"topi": [], "keep": []}
    with jmesh_context(mesh):
        undo = _jax_tap_routing(taps)
        try:
            grad = jax.jit(jax.value_and_grad(
                lambda p, b: JM.loss_fn(p, b, cfg, ctx), has_aux=True))
            (loss, met), grads = grad(state.params, batch)
            jax.effects_barrier()
        finally:
            undo()
        rec.update(loss0=np.asarray(loss), ce0=np.asarray(met["ce"]),
                   aux0=np.asarray(met["aux"]), **_jnp_tree(grads, "grad0"))
        layers = cfg.n_layers if cfg.n_experts else 0
        for kind in ("topi", "keep"):
            assert len(taps[kind]) >= layers, (name, kind, len(taps[kind]))
            for i, a in enumerate(taps[kind][:layers]):
                rec[f"{kind}/{i}"] = a
        step = jax.jit(JTS.make_train_step(cfg, ctx, opt_cfg))
        st = state
        for k in range(2):
            st, m = step(st, batch)
            for key in ("loss", "grad_norm", "ce", "aux"):
                rec[f"{key}_{k}"] = np.asarray(m[key])
    return {f"{name}/{k}": v for k, v in rec.items()}


# ---------------------------------------------------------------------------
# The port's side (4 spawned ranks)
# ---------------------------------------------------------------------------


def _step_grads(cfg, state, batch, ctx, accum):
    """The gradients a sharded train step applies (this rank's blocks),
    by the step's own rule: each microbatch's unreduced gradients summed,
    reduced once after the last, then divided."""
    from repro_torch.models import tp as TP
    if accum == 1:
        return TS.loss_and_grads(cfg, state.params, batch, ctx)[2]
    sink = TP.GradSink()
    for i, mb in enumerate(TS.microbatches(batch, accum, ctx)):
        with TP.accumulate(sink, final=i == accum - 1):
            _, _, g = TS.loss_and_grads(cfg, state.params, mb, ctx)
    return tree_map(lambda a: a / accum, g)


def _sharded_run(cfg, mesh, state, batch, steps, accum=1):
    """``steps`` sharded train steps on this rank of ``mesh`` from its
    blocks of a state and the whole batch (numpy): per step, the whole
    state before it, the whole gradients it applies and the metrics, then
    the whole state after the last; the rank's block shapes, their specs
    and its ``wq`` block's bytes."""
    b, s = batch["labels"].shape
    ctx = make_shard_ctx(cfg, ShapeConfig("t", s, b, "train"), mesh)
    specs = param_pspecs(cfg, ctx, mesh=mesh)
    rows = put({k: torch.from_numpy(v) for k, v in batch.items()},
               batch_pspecs(cfg, ShapeConfig("t", s, b, "train"), ctx), mesh)
    rec = {"steps": []}
    with mesh_context(mesh):
        step = TS.make_train_step(cfg, _opt(), accum, ctx)
        for _ in range(steps):
            grads = _step_grads(cfg, state, rows, ctx, accum)
            whole = _state_np(TS.TrainState(
                gather(state.params, specs, mesh), adamw.AdamWState(
                    state.opt.step, gather(state.opt.m, specs, mesh),
                    gather(state.opt.v, specs, mesh))))
            state, m = step(state, rows)
            rec["steps"].append(dict(
                before=whole, grads=_np(gather(grads, specs, mesh)),
                metrics={k: float(v) for k, v in m.items()}))
        rec["after"] = _state_np(TS.TrainState(
            gather(state.params, specs, mesh), adamw.AdamWState(
                state.opt.step, gather(state.opt.m, specs, mesh),
                gather(state.opt.v, specs, mesh))))
    opt_specs = param_pspecs(cfg, ctx, opt=True, mesh=mesh)
    rec["blocks"] = {part: {k: tuple(a.shape) for k, a in tree_leaves(t)}
                     for part, t in (("params", state.params),
                                     ("m", state.opt.m), ("v", state.opt.v))}
    rec["specs"] = {"params": dict(tree_leaves(specs)),
                    "opt": dict(tree_leaves(opt_specs))}
    rec["rows"] = tuple(rows["labels"].shape)
    attn = state.params["stack_0"].get("b0_attn", {}).get("attn", {})
    if "wq" in attn:
        rec["wq"] = attn["wq"].numpy().tobytes()
    return rec


def _port_state(cfg, mesh):
    """The port's init_train_state(seed 0) cut to this rank's blocks."""
    ctx = make_shard_ctx(cfg, ShapeConfig("t", 16, 8, "train"), mesh)
    return TS.shard_train_state(TS.init_train_state(cfg, 0, _opt(), "cpu"),
                                cfg, ctx, mesh)


def _remat_bits(cfg, mesh, state, batch):
    """The sharded loss and gradients under remat "full" and "dots",
    each bit for bit against remat "none"."""
    b, s = batch["labels"].shape
    ctx = make_shard_ctx(cfg, ShapeConfig("t", s, b, "train"), mesh)
    rows = put({k: torch.from_numpy(v) for k, v in batch.items()},
               batch_pspecs(cfg, ShapeConfig("t", s, b, "train"), ctx), mesh)
    out = {}
    with mesh_context(mesh):
        for remat in ("none", "full", "dots"):
            loss, _, g = TS.loss_and_grads(cfg.replace(remat=remat),
                                           state.params, rows, ctx)
            out[remat] = (loss, [a for _, a in tree_leaves(g)])
    return {r: bool(torch.equal(out[r][0], out["none"][0]) and all(
        torch.equal(a, b) for a, b in zip(out[r][1], out["none"][1])))
        for r in ("full", "dots")}


def _refusal(arch, kw, mesh):
    """The sharded step where the model line lacks tensor-parallel
    compute: the exception, and the model mesh's collectives run before
    it (none)."""
    from repro_torch.launch import mesh as mesh_mod
    cfg = get_config(arch).replace(**kw)
    b, s = 8, 16
    ctx = make_shard_ctx(cfg, ShapeConfig("t", s, b, "train"), mesh)
    whole = TS.init_train_state(cfg, 0, _opt(), "cpu")
    calls = []
    real = {n: getattr(mesh_mod.ModelMesh, n)
            for n in ("all_reduce", "all_gather", "reduce_scatter")}
    for n, f in real.items():
        def counted(self, *a, _f=f, _n=n, **k):
            calls.append(_n)
            return _f(self, *a, **k)
        setattr(mesh_mod.ModelMesh, n, counted)
    try:
        with mesh_context(mesh):
            state = TS.TrainState(whole.params, whole.opt)
            rows = {k: torch.from_numpy(v) for k, v in
                    _batch(cfg, b, s).items()}
            TS.make_train_step(cfg, _opt(), 1, ctx)(state, rows)
        return None, calls
    except NotImplementedError as e:
        return str(e), calls
    finally:
        for n, f in real.items():
            setattr(mesh_mod.ModelMesh, n, f)


@contextlib.contextmanager
def _port_routing():
    """Each MoE layer's (top-k experts, kept mask) as ``moe.plan`` gets
    them while the block runs (this rank's rows), in call order."""
    from repro_torch.models import moe as MOE
    real, taps = MOE.plan, []

    def plan(topi, topv, cfg):
        pl = real(topi, topv, cfg)
        taps.append((topi.numpy().copy(), pl.keep.numpy().copy()))
        return pl
    MOE.plan = plan
    try:
        yield taps
    finally:
        MOE.plan = real


def _tp_run(name, mesh, jstate):
    """A ``TP_RUNS`` config's two sharded steps on (2, 2) from JAX's state
    cut to this rank's blocks (``train_state_from_jax``), with the first
    forward's routing and this rank's initial block of its ``TP_LEAF``."""
    cfg = _tp_cfg(name)
    ctx = make_shard_ctx(cfg, ShapeConfig(*SHAPE), mesh)
    state = train_state_from_jax(jstate, "cpu",
                                 param_pspecs(cfg, ctx, mesh=mesh), mesh)
    blocks = dict(tree_leaves(state.params))
    leaf = blocks[TP_LEAF[name]].numpy().copy()
    w_up = blocks[W_UP].numpy().copy() if W_UP in blocks else None
    with _port_routing() as taps:
        rec = _sharded_run(cfg, mesh, state,
                           _batch(cfg, SHAPE[2], SHAPE[1]), 2)
    rec["routing"] = taps[:cfg.n_layers if cfg.n_experts else 0]
    rec["leaf"], rec["w_up"] = leaf, w_up
    return rec


def torch_rank(rank, jstate, tp_states):
    meshes = {grid: make_model_mesh(grid) for grid in
              (GRID, FSDP_GRID, (1, 4), (2, 1, 2))}
    mesh = meshes[GRID]
    cfg = get_config(ARCH)
    ctx = make_shard_ctx(cfg, ShapeConfig(*SHAPE), mesh)
    specs = param_pspecs(cfg, ctx, mesh=mesh)

    def jax_state():
        return train_state_from_jax(jstate, "cpu", specs, mesh)

    batch = _batch(cfg, SHAPE[2], SHAPE[1])
    out = {"jax_parity": _sharded_run(cfg, mesh, jax_state(), batch, 2),
           "accum": _sharded_run(cfg, mesh, jax_state(), batch, 1, ACCUM)}
    with mesh_context(mesh):
        rows = put({k: torch.from_numpy(v) for k, v in batch.items()},
                   batch_pspecs(cfg, ShapeConfig(*SHAPE), ctx), mesh)
        _, met, g = TS.loss_and_grads(cfg, jax_state().params, rows, ctx)
    out["grad0"] = {"metrics": {k: float(v) for k, v in met.items()},
                    "grads": _np(gather(g, specs, mesh))}
    out["remat"] = _remat_bits(cfg, mesh, jax_state(), batch)
    for name in TP_NAMES:
        out[("tp", name)] = _tp_run(name, mesh, tp_states[name])
    runs = [("self", a, GRID, 2, 1) for a in SELF_ARCHS] + \
        [("fsdp", a + "-smoke", FSDP_GRID, 1, 1) for a in ASSIGNED] + \
        [("fsdp_accum", "mixtral-8x22b-smoke", FSDP_GRID, 1, ACCUM),
         ("tp_accum", "mixtral-8x22b-smoke", GRID, 1, ACCUM),
         ("mla", "minicpm3-4b-smoke", MLA_GRID, 2, 1)] + \
        [("quarter", a, MLA_GRID, 2, 1) for a in QUARTER_ARCHS]
    for kind, arch, grid, steps, accum in runs:
        c = _cfg(arch)
        out[(kind, arch)] = _sharded_run(
            c, meshes[grid], _port_state(c, meshes[grid]),
            _batch(c, *SELF_SHAPE), steps, accum)
    out["refusals"] = {name: _refusal(arch, kw, meshes[grid])
                       for name, arch, kw, grid in REFUSALS}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jax = pytest.importorskip("jax")
    from repro.configs.base import get_config as jget
    from repro.optim import adamw as jadamw
    from repro.train import steps as JTS
    tmp = tmp_path_factory.mktemp("mesh_train")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_DISABLE_MOST_OPTIMIZATIONS="1",
               PYTHONPATH=os.pathsep.join([SRC, HERE]),
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") +
                          " --xla_force_host_platform_device_count="
                          f"{RANKS}").strip())
    jax_dir = str(tmp / "jax")
    proc = subprocess.Popen(
        [sys.executable, "-c", "import test_torch_mesh_train as t; "
         f"t.jax_main({jax_dir!r})"],
        env=env, cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        def init(cfg):
            return jax.tree.map(np.asarray, JTS.init_train_state(
                cfg, jax.random.PRNGKey(0), jadamw.AdamWConfig(**OPT)))
        jstate = init(jget(ARCH))
        tp_states = {name: init(jget(arch).replace(**kw))
                     for name, arch, kw in TP_RUNS}
        ranks = spawn(torch_rank, RANKS, jstate, tp_states)
    except BaseException:
        proc.kill()
        proc.communicate()
        raise
    log, _ = proc.communicate(timeout=900)
    assert proc.returncode == 0, log[-4000:]
    return dict(jax=dict(np.load(os.path.join(jax_dir, "jax.npz"))),
                jstate=jstate, tp_states=tp_states, ranks=ranks)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the one-process references (tiny ops; with
    several test workers on one host each op spread over every core
    waits on the others)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Checks shared by the runs
# ---------------------------------------------------------------------------


def _close_rel(got, want, rtol, what):
    got, want = float(got), float(want)
    assert abs(got - want) <= rtol * max(abs(want), 1e-30), \
        f"{what}: {got} vs {want}"


def _flat(tree):
    return {k: np.asarray(v, np.float32) for k, v in tree_leaves(tree)}


def _check_grads(got, want, what):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w), what
    for key in w:
        np.testing.assert_allclose(
            g[key], w[key], atol=GRAD_RTOL * float(np.abs(w[key]).max()),
            rtol=0, err_msg=f"{what} grad {key}")


def _check_update(update, before, grads, after, what):
    """The state after a step against ``update`` (JAX's or the port's
    one-process ``adamw.update``) applied to the state before it and the
    gradients the step applied, all three within STEP_ATOL."""
    params, m, v = update(grads, before)
    assert after["step"] == before["step"] + 1, what
    for name, want in (("params", params), ("m", m), ("v", v)):
        g, w = _flat(after[name]), _flat(want)
        assert sorted(g) == sorted(w)
        for key in w:
            np.testing.assert_allclose(g[key], w[key], atol=STEP_ATOL,
                                       rtol=0,
                                       err_msg=f"{what} {name}/{key}")


def _jax_update(grads, before):
    import jax
    from repro.optim import adamw as jadamw
    step = jax.jit(functools.partial(jadamw.update,
                                     cfg=jadamw.AdamWConfig(**OPT)))
    params, opt, _ = step(grads, jadamw.AdamWState(
        np.int32(before["step"]), before["m"], before["v"]), before["params"])
    return tuple(jax.tree.map(np.asarray, t)
                 for t in (params, opt.m, opt.v))


def _port_update(grads, before):
    t = functools.partial(tree_map, torch.from_numpy)
    params, m, v = (t(tree_map(np.copy, before[k]))
                    for k in ("params", "m", "v"))
    state = adamw.AdamWState(torch.tensor(before["step"], dtype=torch.int32),
                             m, v)
    params, opt, _ = adamw.update(t(tree_map(np.copy, grads)), state,
                                  params, _opt())
    return _np(params), _np(opt.m), _np(opt.v)


def _same_on_ranks(ranks, key):
    """Every rank's record of a run; each rank gathered the same wholes."""
    got = [r[key] for r in ranks]
    for r in got[1:]:
        for a, b in zip(r["steps"], got[0]["steps"]):
            assert a["metrics"] == b["metrics"]
        for name in ("params", "m", "v"):
            for (k, x), (_, y) in zip(tree_leaves(r["after"][name]),
                                      tree_leaves(got[0]["after"][name])):
                assert np.array_equal(x, y), (key, name, k)
    return got


def _add(a, b):
    """Leafwise a + b of two nested dicts of tensors."""
    if isinstance(a, dict):
        return {k: _add(a[k], b[k]) for k in a}
    return a + b


def _one_process(cfg, batch, steps, accum=1):
    """The port's one-process steps from init_train_state(seed 0): per
    step the metrics and the gradients it applies (numpy)."""
    state = TS.init_train_state(cfg, 0, _opt(), "cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    step = TS.make_train_step(cfg, _opt(), accum)
    out = []
    for _ in range(steps):
        total = None
        for i in range(accum):
            _, _, g = TS.loss_and_grads(cfg, state.params,
                                        TS.microbatch(tb, i, accum))
            total = g if total is None else _add(total, g)
        grads = _np(tree_map(lambda a: a / accum, total))
        state, m = step(state, tb)
        out.append(dict(grads=grads,
                        metrics={k: float(v) for k, v in m.items()}))
    return out


def _check_against_one_process(got, ref, what):
    for k, (g, w) in enumerate(zip(got["steps"], ref)):
        for name in ("loss", "grad_norm", "ce"):
            _close_rel(g["metrics"][name], w["metrics"][name],
                       GNORM_RTOL if name == "grad_norm" else LOSS_RTOL,
                       f"{what} step {k} {name}")
        np.testing.assert_allclose(g["metrics"]["aux"], w["metrics"]["aux"],
                                   rtol=LOSS_RTOL, atol=0,
                                   err_msg=f"{what} step {k} aux")
        if k == 0:
            _check_grads(g["grads"], w["grads"], what)
        after = got["steps"][k + 1]["before"] if k + 1 < len(got["steps"]) \
            else got["after"]
        _check_update(_port_update, g["before"], g["grads"], after,
                      f"{what} step {k}")


# ---------------------------------------------------------------------------
# (a) the layout against JAX's, for every config
# ---------------------------------------------------------------------------


def _jspec(p):
    return tuple(p)


@pytest.mark.parametrize("grid", SPEC_GRIDS, ids=str)
def test_param_and_batch_specs_match_jax_for_every_config(grid):
    """``param_pspecs`` (plain and ``opt``), ``make_shard_ctx``,
    ``batch_pspecs`` and ``input_specs`` against JAX's for every
    registered config and shape, as a grid of ranks with no group
    describes them (a 4 x 2 grid too: no process is needed)."""
    jax = pytest.importorskip("jax")
    from jax.sharding import PartitionSpec as P
    from repro.configs.base import SHAPES as JSHAPES
    from repro.configs.base import get_config as jget
    from repro.launch.specs import batch_pspecs as jbatch_pspecs
    from repro.launch.specs import input_specs as jinput_specs
    from repro.launch.specs import make_shard_ctx as jmake_ctx
    from repro.models.params import param_pspecs as jparam_pspecs
    axes = ("data", "model")
    jmesh = types.SimpleNamespace(axis_names=axes,
                                  shape=dict(zip(axes, grid)))
    mesh = ModelMesh(axes, grid)
    for arch in ASSIGNED + [a + "-smoke" for a in ASSIGNED]:
        for sname in SHAPES:
            jctx = jmake_ctx(jget(arch), JSHAPES[sname], jmesh)
            ctx = make_shard_ctx(get_config(arch), SHAPES[sname], mesh)
            assert dataclasses.asdict(ctx) == dataclasses.asdict(jctx)
            want = {k: _jspec(v) for k, v in jbatch_pspecs(
                jget(arch), JSHAPES[sname], jctx).items()}
            assert batch_pspecs(get_config(arch), SHAPES[sname],
                                ctx) == want, (arch, sname)
            want = {k: (tuple(v.shape), str(v.dtype)) for k, v in
                    jinput_specs(jget(arch), JSHAPES[sname]).items()}
            assert input_specs(get_config(arch), SHAPES[sname]) == want
        ctx = make_shard_ctx(get_config(arch), SHAPES["train_4k"], mesh)
        for opt in (False, True):
            got = dict(tree_leaves(param_pspecs(get_config(arch), ctx, opt,
                                                mesh)))
            flat = jax.tree_util.tree_flatten_with_path(
                jparam_pspecs(jget(arch), jctx, opt, jmesh),
                is_leaf=lambda x: isinstance(x, P))[0]
            want = {"/".join(str(getattr(k, "key", k)) for k in path):
                    _jspec(p) for path, p in flat}
            assert got == want, (arch, opt)


def test_specs_drop_an_axis_that_does_not_divide():
    """h2o-danube-3-4b-smoke on a (3, 4) grid: d_model 64 does not split
    over data 3, so every fsdp dim stays whole, while the 512 vocabulary
    rows and the KV projections' 32 columns split over model 4; without a
    mesh nothing is dropped."""
    mesh = ModelMesh(("data", "model"), (3, 4))
    cfg = get_config("h2o-danube-3-4b-smoke")
    ctx = make_shard_ctx(cfg, ShapeConfig("t", 16, 6, "train"), mesh)
    specs = param_pspecs(cfg, ctx, mesh=mesh)
    assert specs["embed"]["w"] == ("model", None)
    assert specs["stack_0"]["b0_attn"]["attn"]["wk"] == (None, None,
                                                         "model")
    assert param_pspecs(cfg, ctx)["embed"]["w"] == ("model", "data")


# ---------------------------------------------------------------------------
# (b) qwen3-32b-smoke on (2, 2) against JAX's make_train_step on 2 x 2
# ---------------------------------------------------------------------------


def test_step_one_loss_and_gradients_match_jax(runs):
    want = runs["jax"]
    for rank, out in enumerate(runs["ranks"]):
        got = out["grad0"]
        _close_rel(got["metrics"]["ce"], want["ce0"], LOSS_RTOL, "ce")
        _close_rel(got["metrics"]["aux"] + got["metrics"]["ce"],
                   want["loss0"], LOSS_RTOL, "loss")
        wg = {k[len("grad0/"):]: v for k, v in want.items()
              if k.startswith("grad0/")}
        g = _flat(got["grads"])
        assert sorted(g) == sorted(wg)
        for key, w in wg.items():
            np.testing.assert_allclose(
                g[key], w, atol=GRAD_RTOL * float(np.abs(w).max()), rtol=0,
                err_msg=f"rank {rank} grad {key}")


@pytest.mark.parametrize("k", (0, 1))
def test_two_sharded_steps_match_jax(runs, k):
    """Each step's loss, ce and grad norm against JAX's; the state after
    it against JAX's update of the port's gathered gradients (step 0
    starts from JAX's own state, so this is also JAX's trajectory)."""
    want = runs["jax"]
    got = _same_on_ranks(runs["ranks"], "jax_parity")[0]
    g = got["steps"][k]
    for name, rtol in (("loss", LOSS_RTOL), ("ce", LOSS_RTOL),
                       ("grad_norm", GNORM_RTOL)):
        _close_rel(g["metrics"][name], want[f"{name}_{k}"], rtol,
                   f"step {k} {name}")
    after = got["steps"][1]["before"] if k == 0 else got["after"]
    _check_update(_jax_update, g["before"], g["grads"], after, f"step {k}")
    if k == 0:
        _check_grads(g["grads"], {key[len("grad0/"):]: v for key, v in
                                  want.items() if key.startswith("grad0/")},
                     "step 0")
        for part in ("params", "m", "v"):
            for key, a in tree_leaves(got["steps"][0]["before"][part]):
                assert np.array_equal(a, np.asarray(
                    _jleaf(runs["jstate"], part, key), np.float32)), key


def _jleaf(jstate, part, key):
    tree = jstate.params if part == "params" else getattr(jstate.opt, part)
    for k in key.split("/"):
        tree = tree[k]
    return tree


def test_grad_accum_two_matches_jax(runs):
    """grad_accum=2 on (2, 2): microbatch i is the global batch's, split
    over the ranks, and the gradients are reduced once after the last
    microbatch; against JAX's grad_accum=2 step on the same batch (its
    two microbatches hold other counts of labelled tokens), the loss, the
    last microbatch's ce and the grad norm, then the state against JAX's
    update of the port's gradients."""
    want = runs["jax"]
    got = _same_on_ranks(runs["ranks"], "accum")[0]
    g = got["steps"][0]
    for name, rtol in (("loss", LOSS_RTOL), ("ce", LOSS_RTOL),
                       ("grad_norm", GNORM_RTOL)):
        _close_rel(g["metrics"][name], want[f"accum_{name}"], rtol, name)
    _check_update(_jax_update, g["before"], g["grads"], got["after"],
                  "accum")


def test_every_leaf_is_held_as_the_ranks_block(runs):
    """Params by ``param_pspecs(cfg, ctx, mesh=mesh)``, m and v by its
    ``opt`` specs; ``wq``, ``wo``, ``wi`` and ``embed`` never whole on a
    rank between steps; ``wq`` a quarter of the leaf on each rank, a
    different block each (JAX's multidevice check: held on more than one
    device)."""
    assert int(runs["jax"]["wq_devices"]) == RANKS
    whole = {k: pd.shape for k, pd in tree_leaves(
        param_defs(get_config(ARCH)))}
    seen = set()
    for rank, out in enumerate(runs["ranks"]):
        got = out["jax_parity"]
        grid = ModelMesh(("data", "model"), GRID, rank)
        for part, key in (("params", "params"), ("m", "opt"), ("v", "opt")):
            for name, shp in got["blocks"][part].items():
                assert shp == local_shape(whole[name],
                                          got["specs"][key][name], grid)
        blocks = got["blocks"]["params"]
        for name in ("stack_0/b0_attn/attn/wq", "stack_0/b0_attn/attn/wo",
                     "stack_0/b0_attn/mlp/wi", "embed/w"):
            assert np.prod(blocks[name]) * RANKS == np.prod(whole[name]), \
                name
        seen.add(got["wq"])
    assert len(seen) == RANKS


def test_remat_full_and_dots_change_no_number_on_the_grid(runs):
    """The collectives rerun in the recomputation: every rank gets the
    loss and gradients of remat "none" bit for bit."""
    for out in runs["ranks"]:
        assert out["remat"] == {"full": True, "dots": True}


# ---------------------------------------------------------------------------
# (b2) the moe kind, MLA and the recurrent kinds on (2, 2) against JAX's
# make_train_step on 2 x 2
# ---------------------------------------------------------------------------


def _jax_of(runs, name):
    """JAX's record of a ``TP_RUNS`` config, its prefix taken off."""
    return {k[len(name) + 1:]: v for k, v in runs["jax"].items()
            if k.startswith(name + "/")}


@pytest.mark.parametrize("name", TP_NAMES)
def test_moe_and_mla_step_one_loss_and_gradients_match_jax(runs, name):
    """Step 1's loss, ce and aux and the gradients of every leaf, gathered
    on each rank, against JAX's on the same state and batch: the width
    route (mixtral), the EP route with arctic's dense residual (16
    experts), MLA's heads (minicpm3), mLSTM's heads and sLSTM whole from
    its gathered weights, with its widths split or whole (xlstm, at
    d_model 48 and 52), RG-LRU's channels and a KV head split mid-head
    (recurrentgemma)."""
    want = _jax_of(runs, name)
    wg = {k[len("grad0/"):]: v for k, v in want.items()
          if k.startswith("grad0/")}
    for rank, out in enumerate(runs["ranks"]):
        got = out[("tp", name)]["steps"][0]
        _close_rel(got["metrics"]["ce"], want["ce0"], LOSS_RTOL,
                   f"{name} rank {rank} ce")
        _close_rel(got["metrics"]["loss"], want["loss0"], LOSS_RTOL,
                   f"{name} rank {rank} loss")
        np.testing.assert_allclose(got["metrics"]["aux"], want["aux0"],
                                   rtol=LOSS_RTOL, atol=0,
                                   err_msg=f"{name} rank {rank} aux")
        _check_grads(got["grads"], wg, f"{name} rank {rank}")
    if _tp_cfg(name).n_experts:
        assert float(want["aux0"]) > 0


@pytest.mark.parametrize("k", (0, 1))
@pytest.mark.parametrize("name", TP_NAMES)
def test_moe_and_mla_two_sharded_steps_match_jax(runs, name, k):
    """Each step's loss, ce, aux and grad norm against JAX's step; the
    state after it against JAX's update of the port's gathered gradients;
    step 0 starts from JAX's own state."""
    want = _jax_of(runs, name)
    got = _same_on_ranks(runs["ranks"], ("tp", name))[0]
    g = got["steps"][k]
    for key, rtol in (("loss", LOSS_RTOL), ("ce", LOSS_RTOL),
                      ("grad_norm", GNORM_RTOL)):
        _close_rel(g["metrics"][key], want[f"{key}_{k}"], rtol,
                   f"{name} step {k} {key}")
    np.testing.assert_allclose(g["metrics"]["aux"], want[f"aux_{k}"],
                               rtol=LOSS_RTOL, atol=0)
    after = got["steps"][1]["before"] if k == 0 else got["after"]
    _check_update(_jax_update, g["before"], g["grads"], after,
                  f"{name} step {k}")
    if k == 0:
        for part in ("params", "m", "v"):
            for key, a in tree_leaves(g["before"][part]):
                assert np.array_equal(a, np.asarray(_jleaf(
                    runs["tp_states"][name], part, key), np.float32)), key


@pytest.mark.parametrize("name", [n for n in TP_NAMES
                                  if _tp_cfg(n).n_experts])
def test_moe_routing_matches_jax_bit_for_bit(runs, name):
    """Each MoE layer's top-k experts and kept mask in step 1's forward,
    the ranks' rows put together, equal to JAX's bit for bit (a flip
    would change an assignment, not a rounding); the two model ranks of a
    data row route alike."""
    want = _jax_of(runs, name)
    cfg = _tp_cfg(name)
    ranks = runs["ranks"]
    for i in range(cfg.n_layers):
        for j, kind in enumerate(("topi", "keep")):
            rows = []
            for d in range(GRID[0]):
                mine = [r[("tp", name)]["routing"][i][j] for rank, r in
                        enumerate(ranks) if rank // GRID[1] == d]
                assert all(np.array_equal(m, mine[0]) for m in mine)
                rows.append(mine[0])
            np.testing.assert_array_equal(
                np.concatenate(rows), want[f"{kind}/{i}"],
                err_msg=f"{name} layer {i} {kind}")


@pytest.mark.parametrize("name", TP_NAMES)
def test_moe_and_mla_leaves_are_held_as_the_ranks_blocks(runs, name):
    """Params by ``param_pspecs``, m and v by its ``opt`` specs; the
    experts' ``wi`` (split on d over data and, on the EP route, on E over
    model, else on the width), MLA's ``wo``, mLSTM's ``wq`` and RG-LRU's
    ``w_x`` a quarter on each rank, a different one each, equal to JAX's
    state's block as ``train_state_from_jax`` cuts it (``local_slices`` of
    the spec)."""
    from repro_torch.launch.specs import local_slices
    cfg = _tp_cfg(name)
    whole = {k: pd.shape for k, pd in tree_leaves(param_defs(cfg))}
    jleaf = np.asarray(_jleaf(runs["tp_states"][name], "params",
                              TP_LEAF[name]))
    seen = set()
    for rank, out in enumerate(runs["ranks"]):
        got = out[("tp", name)]
        grid = ModelMesh(("data", "model"), GRID, rank)
        for part, key in (("params", "params"), ("m", "opt"), ("v", "opt")):
            for leaf, shp in got["blocks"][part].items():
                assert shp == local_shape(whole[leaf],
                                          got["specs"][key][leaf], grid)
        spec = got["specs"]["params"][TP_LEAF[name]]
        assert "model" in spec and "data" in spec, spec
        if name == "arctic16":
            assert spec[1] == "model", spec        # whole experts
        np.testing.assert_array_equal(
            got["leaf"], jleaf[local_slices(jleaf.shape, spec, grid)])
        assert got["leaf"].size * RANKS == jleaf.size
        seen.add(got["leaf"].tobytes())
    assert len(seen) == RANKS


# ---------------------------------------------------------------------------
# (c) the port's (2, 2) and (4, 1) steps against its own one process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", SELF_ARCHS)
def test_tensor_parallel_step_matches_one_process(runs, arch):
    cfg = _cfg(arch)
    got = _same_on_ranks(runs["ranks"], ("self", arch))[0]
    assert got["rows"][0] == SELF_SHAPE[0] // GRID[0]
    _check_against_one_process(got, _one_process(
        cfg, _batch(cfg, *SELF_SHAPE), 2), arch)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_fsdp_step_matches_one_process_for_every_family(runs, arch):
    """The (4, 1) grid: FSDP over 4 ranks, each with 2 of the 8 rows;
    mixtral's and arctic's auxiliary loss over the whole batch."""
    cfg = get_config(arch + "-smoke")
    got = _same_on_ranks(runs["ranks"], ("fsdp", arch + "-smoke"))[0]
    assert got["rows"][0] == SELF_SHAPE[0] // FSDP_GRID[0]
    ref = _one_process(cfg, _batch(cfg, *SELF_SHAPE), 1)
    if cfg.n_experts:
        assert ref[0]["metrics"]["aux"] > 0
    _check_against_one_process(got, ref, arch)


def test_mla_heads_over_four_model_ranks_match_one_process(runs):
    """minicpm3-4b-smoke on (1, 4): one MLA head a rank, every rank all 8
    rows, against one process."""
    cfg = get_config("minicpm3-4b-smoke")
    got = _same_on_ranks(runs["ranks"], ("mla", "minicpm3-4b-smoke"))[0]
    assert got["rows"][0] == SELF_SHAPE[0]
    assert got["specs"]["params"]["stack_0/b0_attn/attn/wk_b"] == \
        (None, None, "model")
    _check_against_one_process(got, _one_process(
        cfg, _batch(cfg, *SELF_SHAPE), 2), "minicpm3 (1, 4)")


@pytest.mark.parametrize("arch", QUARTER_ARCHS)
def test_kv_head_split_mid_head_over_four_model_ranks_matches_one_process(
        runs, arch):
    """(1, 4): recurrentgemma-2b-smoke (one KV head of 16 columns, 4 a
    rank; RG-LRU's 64 channels, 16 a rank) and qwen3-32b-smoke (2 KV
    heads, half a head a rank; qk-norm's k scale applied to the whole K)
    against one process, every rank all 8 rows."""
    cfg = get_config(arch)
    got = _same_on_ranks(runs["ranks"], ("quarter", arch))[0]
    assert got["rows"][0] == SELF_SHAPE[0]
    assert cfg.n_kv_heads % MLA_GRID[1] and not cfg.kv_dim % MLA_GRID[1]
    split = [spec[-1] == "model" for key, spec in
             got["specs"]["params"].items()
             if key.endswith(("/attn/wk", "/attn/wv", "/mix/w_x"))]
    assert split and all(split)
    _check_against_one_process(got, _one_process(
        cfg, _batch(cfg, *SELF_SHAPE), 2), f"{arch} (1, 4)")


def test_mlstm_w_up_block_is_half_major_and_jax_keeps_widths_whole(runs):
    """The traps of the layout, held to JAX's: each rank's block of
    mLSTM's ``w_up`` (d, 2 x inner) is its data rows of one half of
    [z | skip_in], so rank 1 (model coordinate 1) holds skip_in's columns,
    never a head's; and at d_model 52 the sLSTM widths (69) are whole on
    model in both packages' specs, split at 48 (64)."""
    import jax
    from jax.sharding import PartitionSpec as P
    from repro.configs.base import get_config as jget
    from repro.configs.base import ShapeConfig as JShape
    from repro.launch.specs import make_shard_ctx as jmake_ctx
    from repro.models.params import param_pspecs as jparam_pspecs
    w_up = np.asarray(_jleaf(runs["tp_states"]["xlstm"], "params", W_UP))
    inner = w_up.shape[-1] // 2
    rows = w_up.shape[1] // GRID[0]
    for rank, out in enumerate(runs["ranks"]):
        d, m = divmod(rank, GRID[1])
        got = out[("tp", "xlstm")]["w_up"]
        want = np.split(w_up, 2, -1)[m][:, d * rows:(d + 1) * rows]
        np.testing.assert_array_equal(got, want, err_msg=f"rank {rank}")
        if m == 1:
            np.testing.assert_array_equal(
                got, w_up[:, d * rows:(d + 1) * rows, inner:])
    axes = ("data", "model")
    jmesh = types.SimpleNamespace(axis_names=axes,
                                  shape=dict(zip(axes, GRID)))
    for name, whole in (("xlstm", False), ("xlstm_whole", True)):
        _, arch, kw = next(r for r in TP_RUNS if r[0] == name)
        jcfg = jget(arch).replace(**kw)
        flat = jax.tree_util.tree_flatten_with_path(
            jparam_pspecs(jcfg, jmake_ctx(jcfg, JShape(*SHAPE), jmesh),
                          mesh=jmesh), is_leaf=lambda x: isinstance(x, P))[0]
        want = {"/".join(str(getattr(k, "key", k)) for k in path): tuple(p)
                for path, p in flat}
        got = runs["ranks"][0][("tp", name)]["specs"]["params"]
        assert got == want, name
        for leaf in WHOLE_69:
            assert ("model" not in got[leaf]) == whole, (name, leaf)


def test_tensor_parallel_grad_accum_with_moe_matches_one_process(runs):
    """mixtral-8x22b-smoke, grad_accum=2 on (2, 2): the experts' width
    over model, each microbatch's aux loss over the whole microbatch,
    against one process on the same batch."""
    cfg = get_config("mixtral-8x22b-smoke")
    got = _same_on_ranks(runs["ranks"],
                         ("tp_accum", "mixtral-8x22b-smoke"))[0]
    ref = _one_process(cfg, _batch(cfg, *SELF_SHAPE), 1, ACCUM)
    _check_against_one_process(got, ref, "mixtral (2, 2) accum")


def test_fsdp_grad_accum_with_moe_matches_one_process(runs):
    """mixtral-8x22b-smoke, grad_accum=2 on (4, 1): each microbatch's aux
    loss over the whole microbatch, against one process on the same
    batch."""
    cfg = get_config("mixtral-8x22b-smoke")
    got = _same_on_ranks(runs["ranks"],
                         ("fsdp_accum", "mixtral-8x22b-smoke"))[0]
    ref = _one_process(cfg, _batch(cfg, *SELF_SHAPE), 1, ACCUM)
    _check_against_one_process(got, ref, "mixtral accum")


# ---------------------------------------------------------------------------
# (d) what the model line lacks, and the one-card path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", [r[0] for r in REFUSALS])
def test_refusals_name_12_5c_on_every_rank_before_any_collective(runs,
                                                                 name):
    """What the model line still lacks raises on every rank before any
    collective, naming ROADMAP item 12.5e (the part of item 12.5c left
    after the moe kind, MLA and the recurrent kinds): whisper's
    encoder-decoder, a pod axis, 2 mLSTM heads over 4 ranks, 10 query
    heads over 4 (a query head split mid-head), an RG-LRU width of 66 over
    4."""
    want = {"whisper": "'dec', 'enc'", "pod": "a pod axis",
            "xlstm": "2 mLSTM heads over 4", "heads": "10 query heads over 4",
            "lru": "66 RG-LRU width over 4"}[name]
    for rank, out in enumerate(runs["ranks"]):
        err, calls = out["refusals"][name]
        assert err is not None and "ROADMAP item 12.5e" in err, (rank, err)
        assert want in err, (rank, err)
        assert calls == [], (rank, calls)


def test_disabled_ctx_is_the_one_card_step_bit_for_bit():
    cfg = get_config(ARCH)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 2, 16).items()}
    outs = []
    for ctx in (None, CPU_CTX):
        state = TS.init_train_state(cfg, 0, _opt(), "cpu")
        loss, _, g = TS.loss_and_grads(cfg, state.params, batch, ctx)
        state, m = TS.make_train_step(cfg, _opt(), 2, ctx)(state, batch)
        outs.append([loss, m["loss"], m["grad_norm"]] +
                    [a for _, a in tree_leaves(g)] +
                    [a for _, a in tree_leaves(state.params)])
    assert all(torch.equal(a, b) for a, b in zip(*outs))
