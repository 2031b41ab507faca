"""The port's decode over a sequence-sharded KV cache on a (data, model)
grid of 4 ``gloo`` ranks against the JAX package's ``decode_step(...,
ctx)`` under ``make_shard_ctx`` on 4 fake CPU devices, with the layout
pieces (``ShardCtx``, ``make_shard_ctx``, ``cache_specs``,
``constrain_spec``) and the int8 compressed all-reduce.  The recurrent
kinds run there too: recurrentgemma-2b-smoke (RG-LRU's state split over
its width, its local attention on the sequence split) and
xlstm-350m-smoke (sLSTM's ``h`` split over its width), each rank's
state blocks held to JAX's cache cut by the specs.

One JAX subprocess (``XLA_FLAGS=--xla_force_host_platform_device_count=4``,
``JAX_DISABLE_MOST_OPTIMIZATIONS=1``) and one 4-rank spawn of the port
(``repro_torch.launch.mesh.spawn``, one intra-op thread a rank, on the
CPU) run at the same time, and every case of the file reads them.  Inputs
come from numpy seeds; the weights are the JAX package's
``init_params(PRNGKey(0))``, converted by ``params_from_jax``.

Tolerances: f32 throughout.  The model's logits and cache parts within
1e-4 (the model parity tests' ``ATOL``, ``tests/test_torch_model.py``);
``_sharded_flash_decode`` within 2e-5 (the JAX kernel tests' f32
``gqa_decode`` tolerance): both packages sum in other orders (XLA's dots
and collectives against torch's einsums and ``gloo``), so agreement is to
rounding, not bit for bit.  Integers bit for bit: ``pos``, greedy tokens,
the specs, the int8 planes and the scales of ``compressed_psum``; its
mean and residuals bit for bit as well: both packages round each f32
product and quotient once, in JAX's order, and the port takes the scale
as XLA compiles it (the product with the f32 reciprocal of 127, not the
quotient JAX writes; with the quotient, 1 leaf-step in 16 here differs by
an ulp of the scale, and its mean and residuals with it).
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.configs.base import (SHAPES, ShapeConfig,  # noqa: E402
                                      get_config)
from repro_torch.kernels.gqa_decode.ref import gqa_decode_ref  # noqa: E402
from repro_torch.launch.mesh import (ModelMesh,  # noqa: E402
                                     make_model_mesh, spawn)
from repro_torch.launch.meshctx import mesh_context  # noqa: E402
from repro_torch.launch.specs import (cache_specs, local_rows,  # noqa: E402
                                      local_shape, local_slices,
                                      make_shard_ctx)
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import (cache_part_from_jax,  # noqa: E402
                                        params_from_jax)
from repro_torch.models.params import tree_leaves  # noqa: E402
from repro_torch.models.sharding import CPU_CTX, ShardCtx  # noqa: E402
from repro_torch.optim.compress import (compressed_psum,  # noqa: E402
                                        dequantize, quantize)
from repro_torch.train import steps as TS  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
RANKS = 4
MESHES = ((1, 4), (2, 2))
# the layout's grids: the two meshes, and one with a pod axis, whose dp
# role is ("pod", "data")
GRIDS = {(1, 4): ("data", "model"), (2, 2): ("data", "model"),
         (2, 1, 2): ("pod", "data", "model")}
ATOL = 1e-4                    # tests/test_torch_model.py's f32 tolerance
DECODE_ATOL = 2e-5             # the JAX kernel tests' f32 gqa_decode one
ARCHS = ("qwen3-32b-smoke", "h2o-danube-3-4b-smoke",
         "recurrentgemma-2b-smoke", "xlstm-350m-smoke")
# the registered shapes, and one whose batch (3) dp 2 does not divide
# and whose sequence (32766) tp 4 does not (tp 2 does)
SPEC_SHAPES = ("decode_32k", "prefill_32k", "train_4k", "odd_decode")
ODD = ("odd_decode", 32766, 3, "decode")
# (arch, mesh, batch, max_seq, prompt, decode steps).  qwen3: 4 slots a
# rank on (1, 4), so 12 steps from position 3 cross every shard boundary
# while later shards are empty; h2o-danube: a 16-slot window ring (4 a
# rank) under a 21-token prompt (the prefill writes the last 16), then 16
# steps that wrap it.  B 3 on (2, 2): dp does not divide it.  The
# recurrent kinds on both meshes at B 4: recurrentgemma's RG-LRU state
# (h, conv) split over its 64 channels and its local attention's 16-slot
# window on the sequence split under the same 21-token prompt and 16
# steps; xlstm's sLSTM h split over its 48 units, its mLSTM state whole
RUNS = [(arch, mesh, b, seq, prompt, gen)
        for arch, seq, prompt, gen in (("qwen3-32b-smoke", 16, 3, 12),
                                       ("h2o-danube-3-4b-smoke", 32, 21, 16))
        for mesh, b in (((1, 4), 4), ((2, 2), 4), ((2, 2), 3))] + \
    [(arch, mesh, 4, 32, 21, 16)
     for arch in ("recurrentgemma-2b-smoke", "xlstm-350m-smoke")
     for mesh in MESHES]
# _sharded_flash_decode alone: W 32 (8 slots a rank on (1, 4), 16 on
# (2, 2)); lengths 0, 1, one inside shard 0 (shards 1 to 3 empty), one in
# each later shard, W and past W
FD = dict(b=8, h=4, kv=2, d=16, w=32)
FD_LENGTHS = (0, 1, 5, 11, 18, 29, 32, 40)
CP_STEPS, CP_SHAPES = 8, {"a": (512,), "b": (16, 8)}
# constrain's call sites in the JAX model: (name, roles, dims of a shape)
CONSTRAIN = (("x", ("dp", "sp", None), lambda c, s: (s.global_batch,
                                                      s.seq_len, 1)),
             ("q", ("dp", None, "tp", None),
              lambda c, s: (s.global_batch, 1, c.n_heads, 1)),
             ("decode_x", ("dp", None, None),
              lambda c, s: (s.global_batch, 1, 1)),
             ("logits", ("dp", None, "tp"),
              lambda c, s: (s.global_batch, 1, c.vocab)))


def _tokens(arch, b, prompt):
    vocab = get_config(arch).vocab
    return np.random.default_rng([b, prompt, 36]).integers(
        0, vocab, (b, prompt)).astype(np.int32)


def _fd_inputs():
    rng = np.random.default_rng(361)
    q = rng.standard_normal((FD["b"], 1, FD["h"], FD["d"])).astype(np.float32)
    k, v = (rng.standard_normal((FD["b"], FD["w"], FD["kv"], FD["d"])
                                ).astype(np.float32) for _ in range(2))
    return q, k, v, np.asarray(FD_LENGTHS, np.int32)


def _cp_grads(step):
    rng = np.random.default_rng([step, 362])
    return {k: (rng.standard_normal((RANKS * s[0],) + s[1:]) *
                (10.0 ** rng.integers(-3, 2))).astype(np.float32)
            for k, s in CP_SHAPES.items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _shape(name, shape_cls, shapes):
    return shape_cls(*ODD) if name == ODD[0] else shapes[name]


def _spec_cases():
    """(arch, shape name, mesh) of case (a): every registered config."""
    from repro_torch.configs.all import ASSIGNED
    return [(a, s, m) for a in ASSIGNED for s in SPEC_SHAPES for m in GRIDS]


def _effective(spec, grid):
    """A spec with the axes of one rank taken out (a tuple of axes left
    with one becomes that axis, with none None)."""
    out = []
    for a in spec:
        axes = [x for x in ((a,) if isinstance(a, str) else (a or ()))
                if grid.shape[x] > 1]
        out.append(None if not axes else axes[0] if len(axes) == 1
                   else axes)
    return out


def _norm_spec(spec):
    return [list(a) if isinstance(a, tuple) else a for a in spec]


# ---------------------------------------------------------------------------
# The JAX side (a subprocess with 4 fake CPU devices)
# ---------------------------------------------------------------------------


def jax_main(out_dir):
    import functools

    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.configs.base import SHAPES as JSHAPES
    from repro.configs.base import ShapeConfig as JShape
    from repro.configs.base import get_config as jget
    from repro.launch.mesh import compat_make_mesh, compat_shard_map
    from repro.launch.meshctx import mesh_context as jmesh_context
    from repro.launch.specs import cache_pspecs
    from repro.launch.specs import make_shard_ctx as jmake_ctx
    from repro.models import layers as JL
    from repro.models import model as JM
    from repro.models.sharding import ShardCtx as JCtx
    from repro.optim.compress import compressed_psum as jpsum
    from repro.optim.compress import quantize as jquantize
    from repro.train import steps as JTS

    assert jax.device_count() == RANKS, jax.device_count()
    os.makedirs(out_dir, exist_ok=True)
    meshes = {m: compat_make_mesh(m, axes) for m, axes in GRIDS.items()}

    # (a) the layout: ctx, cache specs, constrain's spec
    specs, seen = {}, {}
    for arch, sname, m in _spec_cases():
        cfg, mesh = jget(arch), meshes[m]
        shape = _shape(sname, JShape, JSHAPES)
        ctx = jmake_ctx(cfg, shape, mesh)
        cache = cache_pspecs(cfg, shape, ctx, mesh)
        cache = {"/".join(str(getattr(k, "key", k)) for k in path):
                 _norm_spec(tuple(p))
                 for path, p in jax.tree_util.tree_flatten_with_path(
                     cache, is_leaf=lambda x: isinstance(x, P))[0]}
        cons = {}
        with jmesh_context(mesh):
            for name, roles, dims in CONSTRAIN:
                shp = dims(cfg, shape)
                key = (m, shp, roles, ctx)
                if key not in seen:
                    f = jax.jit(lambda a, r=roles, c=ctx:
                                JL.constrain(c, a, *r))
                    got = f(jnp.zeros(shp, jnp.int8)).sharding.spec
                    seen[key] = _norm_spec(tuple(got) + (None,) * (
                        len(roles) - len(tuple(got))))
                cons[name] = seen[key]
        specs[f"{arch}|{sname}|{m}"] = dict(
            ctx=dataclasses.asdict(ctx), cache=cache, constrain=cons)
    with open(os.path.join(out_dir, "specs.json"), "w") as f:
        json.dump(specs, f)

    # (b) _sharded_flash_decode alone
    q, k, v, ln = _fd_inputs()
    out = {}
    for m in MESHES:
        ctx = JCtx(enabled=True, seq_shard_cache=True,
                   batch_shardable=FD["b"] % m[0] == 0)
        with jmesh_context(meshes[m]):
            f = jax.jit(functools.partial(JL._sharded_flash_decode, ctx))
            out[f"fd_{m}"] = np.asarray(f(q, k, v, ln))
    np.savez(os.path.join(out_dir, "fd.npz"), **out)

    # (c) prefill and greedy decode steps under make_shard_ctx
    for arch, m, b, seq, prompt, gen in RUNS:
        cfg = jget(arch)
        mesh = meshes[m]
        ctx = jmake_ctx(cfg, JShape("decode", seq, b, "decode"), mesh)
        params = JM.init_params(cfg, jax.random.PRNGKey(0))
        rec = {"seq_shard": np.asarray(ctx.seq_shard_cache),
               "batch_shardable": np.asarray(ctx.batch_shardable)}
        with jmesh_context(mesh):
            pre, dec = JTS.make_serve_steps(cfg, ctx)
            pre, dec = jax.jit(pre), jax.jit(dec)
            cache = JM.init_cache(cfg, b, seq)
            cache, logits = pre(params,
                                {"tokens": jnp.asarray(_tokens(arch, b,
                                                               prompt))},
                                cache)
            nxt = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
            for step in range(gen + 1):
                rec[f"logits_{step}"] = np.asarray(logits)
                rec[f"next_{step}"] = np.asarray(nxt)
                for key, a in _flat(jax.tree.map(np.asarray, cache)).items():
                    rec[f"cache_{step}_{key}"] = a
                if step < gen:
                    cache, nxt, logits = dec(params, cache, nxt)
        np.savez(os.path.join(out_dir, f"run_{arch}_{m}_{b}.npz"), **rec)

    # (d) compressed_psum over a 4-device mesh, P("d") inputs
    mesh = compat_make_mesh((RANKS,), ("d",))
    spec = {k: P("d") for k in CP_SHAPES}
    psum = jax.jit(compat_shard_map(
        lambda g, r: jpsum(g, r, "d"), mesh, in_specs=(spec, spec),
        out_specs=(spec, spec)))

    def planes(g, r):
        out = {}
        for key in g:
            qq, s = jquantize(g[key].astype(jnp.float32) + r[key])
            out[key] = (qq, s[None])
        return out
    quant = jax.jit(compat_shard_map(
        planes, mesh, in_specs=(spec, spec),
        out_specs={k: (P("d"), P("d")) for k in CP_SHAPES}))
    res = {k: jnp.zeros((RANKS * s[0],) + s[1:], jnp.float32)
           for k, s in CP_SHAPES.items()}
    rec = {}
    for step in range(CP_STEPS):
        g = {k: jnp.asarray(a) for k, a in _cp_grads(step).items()}
        qs = quant(g, res)
        mean, res = psum(g, res)
        for key in CP_SHAPES:
            rec[f"q_{step}_{key}"] = np.asarray(qs[key][0])
            rec[f"scale_{step}_{key}"] = np.asarray(qs[key][1])
            rec[f"mean_{step}_{key}"] = np.asarray(mean[key])
            rec[f"res_{step}_{key}"] = np.asarray(res[key])
    np.savez(os.path.join(out_dir, "compress.npz"), **rec)


# ---------------------------------------------------------------------------
# The port's side (4 spawned ranks)
# ---------------------------------------------------------------------------


def _rank_flash_decode(rank):
    q, k, v, ln = _fd_inputs()
    out = {}
    for m in MESHES:
        mesh = make_model_mesh(m)
        ctx = ShardCtx(enabled=True, seq_shard_cache=True,
                       batch_shardable=FD["b"] % m[0] == 0)
        with mesh_context(mesh):
            rows = local_rows(ctx, FD["b"])
            kv_spec = (ctx.dp() if ctx.batch_shardable else None, "model")
            cut = local_slices(k.shape, kv_spec, mesh)
            got = L._sharded_flash_decode(
                ctx, torch.from_numpy(q[rows]), torch.from_numpy(k[cut]),
                torch.from_numpy(v[cut]), torch.from_numpy(ln[rows]))
        out[m] = (rows, cut[1], got.numpy())
    return out


def _rank_run(rank, arch, m, b, seq, prompt, gen, params_np):
    cfg = get_config(arch)
    mesh = make_model_mesh(m)
    ctx = make_shard_ctx(cfg, ShapeConfig("decode", seq, b, "decode"), mesh)
    params = params_from_jax(params_np, "cpu")
    rec = {"ctx": dataclasses.asdict(ctx)}
    with mesh_context(mesh):
        rows = local_rows(ctx, b)
        pre, dec = TS.make_serve_steps(cfg, ctx)
        cache = M.init_cache(cfg, b, seq, device="cpu", ctx=ctx)
        rec["shapes"] = {k: tuple(a.shape) for k, a in tree_leaves(cache)}
        rec["specs"] = cache_specs(cfg, ShapeConfig("decode", seq, b,
                                                    "decode"), ctx, mesh)
        cache, logits = pre(params, {"tokens": torch.from_numpy(
            _tokens(arch, b, prompt)[rows])}, cache)
        nxt = torch.argmax(logits, -1).to(torch.int32)[:, None]
        for step in range(gen + 1):
            rec[f"logits_{step}"] = logits.numpy().copy()
            rec[f"next_{step}"] = nxt.numpy().copy()
            rec[f"cache_{step}"] = {k: a.numpy().copy()
                                    for k, a in tree_leaves(cache)}
            if step < gen:
                cache, nxt, logits = dec(params, cache, nxt)
    rec["rows"] = rows
    return rec


def _rank_compress(rank):
    """Case (d) on the default group: each rank's block of every leaf,
    its planes and scales, the mean and the residuals after each step;
    then the 1-rank form of the JAX runtime tests on a group of one."""
    res = {k: torch.zeros(s, dtype=torch.float32)
           for k, s in CP_SHAPES.items()}
    rec = {}
    for step in range(CP_STEPS):
        g = {k: torch.from_numpy(np.ascontiguousarray(
                 a[rank * s[0]:(rank + 1) * s[0]]))
             for (k, a), s in zip(_cp_grads(step).items(),
                                  CP_SHAPES.values())}
        for key in CP_SHAPES:
            qq, s = quantize(g[key].float() + res[key])
            rec[f"q_{step}_{key}"] = qq.numpy().copy()
            rec[f"scale_{step}_{key}"] = s.numpy().copy()
        mean, res = compressed_psum(g, res)
        for key in CP_SHAPES:
            rec[f"mean_{step}_{key}"] = mean[key].numpy().copy()
            rec[f"res_{step}_{key}"] = res[key].numpy().copy()
    # every rank makes every group of one, in one order
    own = [dist.new_group([r], backend="gloo") for r in range(RANKS)][rank]
    rng = np.random.default_rng(1)
    g = torch.from_numpy(rng.standard_normal(512).astype(np.float32))
    r = torch.zeros(512)
    true, approx = np.zeros(512), np.zeros(512)
    for _ in range(8):
        out, r = compressed_psum(g, r, own)
        true += g.numpy()
        approx += out.numpy()
    rec["feedback_rel"] = float(np.abs(approx - true).max() /
                                np.abs(true).max())
    return rec


def _rank_refusals(rank):
    """Case (e) on a rank: a mesh of another group or rank, a mesh of
    other axes, a ctx asking the sequence split of MLA, a window the
    model axis does not divide."""
    out = {}
    for name, fn in (
            ("grid_of_8", lambda: make_model_mesh((2, 4))),
            ("other_rank", lambda: _decode_under(
                ModelMesh(("data", "model"), (1, 4), (rank + 1) % RANKS),
                "qwen3-32b-smoke")),
            ("pod_ctx", lambda: _decode_under(
                make_model_mesh((1, 4)), "qwen3-32b-smoke",
                ShardCtx(enabled=True, pod_axis="pod",
                         seq_shard_cache=True))),
            ("mla_seq", lambda: _decode_under(
                make_model_mesh((1, 4)), "minicpm3-4b-smoke",
                ShardCtx(enabled=True, seq_shard_cache=True))),
            ("window_6", lambda: _decode_under(
                make_model_mesh((1, 4)), "qwen3-32b-smoke",
                ShardCtx(enabled=True, seq_shard_cache=True), seq=6))):
        try:
            fn()
            out[name] = None
        except (ValueError, RuntimeError, NotImplementedError) as e:
            out[name] = (type(e).__name__, str(e))
    return out


def _decode_under(mesh, arch, ctx=None, seq=16, b=4):
    cfg = get_config(arch)
    ctx = ctx or make_shard_ctx(cfg, ShapeConfig("d", seq, b, "decode"),
                                mesh)
    with mesh_context(mesh):
        cache = M.init_cache(cfg, b, seq, device="cpu", ctx=ctx)
        params = M.init_params(cfg, 0, "cpu")
        tok = torch.zeros((b, 1), dtype=torch.int32)
        return M.decode_step(params, cache, tok, cfg, ctx)


def torch_rank(rank, params):
    out = {"flash_decode": _rank_flash_decode(rank)}
    for run in RUNS:
        out[run] = _rank_run(rank, *run, params[run[0]])
    out["compress"] = _rank_compress(rank)
    out["refusals"] = _rank_refusals(rank)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jax = pytest.importorskip("jax")
    from repro.configs.base import get_config as jget
    from repro.models import model as JM
    tmp = tmp_path_factory.mktemp("mesh_decode")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_DISABLE_MOST_OPTIMIZATIONS="1",
               PYTHONPATH=os.pathsep.join([SRC, HERE]),
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") +
                          " --xla_force_host_platform_device_count="
                          f"{RANKS}").strip())
    jax_dir = str(tmp / "jax")
    proc = subprocess.Popen(
        [sys.executable, "-c", "import test_torch_mesh_decode as t; "
         f"t.jax_main({jax_dir!r})"],
        env=env, cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        params = {a: jax.tree.map(np.asarray, JM.init_params(
            jget(a), jax.random.PRNGKey(0))) for a in ARCHS}
        ranks = spawn(torch_rank, RANKS, params)
    except BaseException:
        proc.kill()
        proc.communicate()
        raise
    log, _ = proc.communicate(timeout=900)
    assert proc.returncode == 0, log[-4000:]
    with open(os.path.join(jax_dir, "specs.json")) as f:
        specs = json.load(f)
    jax_runs = {run: dict(np.load(os.path.join(
        jax_dir, f"run_{run[0]}_{run[1]}_{run[2]}.npz"))) for run in RUNS}
    return dict(specs=specs, runs=jax_runs,
                fd=dict(np.load(os.path.join(jax_dir, "fd.npz"))),
                compress=dict(np.load(os.path.join(jax_dir,
                                                   "compress.npz"))),
                ranks=ranks)


# ---------------------------------------------------------------------------
# (a) the layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", list(GRIDS), ids=str)
@pytest.mark.parametrize("shape", SPEC_SHAPES)
def test_layout_matches_jax_for_every_config(runs, shape, mesh):
    """make_shard_ctx, cache_specs and constrain_spec against JAX's, for
    every registered config, as a grid of ranks with no group describes
    them."""
    from repro_torch.configs.all import ASSIGNED
    grid = ModelMesh(GRIDS[mesh], mesh)
    seen = set()
    for arch in ASSIGNED:
        want = runs["specs"][f"{arch}|{shape}|{mesh}"]
        cfg, shp = get_config(arch), _shape(shape, ShapeConfig, SHAPES)
        ctx = make_shard_ctx(cfg, shp, grid)
        assert dataclasses.asdict(ctx) == want["ctx"], arch
        got = {k: _norm_spec(v) for k, v in tree_leaves(
            cache_specs(cfg, shp, ctx, grid))}
        assert got == want["cache"], arch
        with mesh_context(grid):
            for name, roles, dims in CONSTRAIN:
                got = L.constrain_spec(ctx, dims(cfg, shp), *roles)
                # JAX's output sharding drops an axis of one device (it
                # partitions nothing), which constrain itself passes on:
                # compare the partitions, exactly on (2, 2)
                assert _effective(got, grid) == _effective(
                    want["constrain"][name], grid), (arch, name)
        seen.add((ctx.seq_shard_cache, ctx.batch_shardable))
    # the sequence split on for decode, off for MLA and the ssm family;
    # at the odd shape dp 2 drops the batch, and tp 4 the full-attention
    # sequence (the windowed configs' 4096 and 2048 still split)
    dp1 = int(np.prod(mesh[:-1])) == 1
    want_seen = {"decode_32k": {(True, True), (False, True)},
                 "odd_decode": {(True, dp1), (False, dp1)}
                 }.get(shape, {(False, True)})
    assert seen == want_seen


def test_model_mesh_lays_ranks_out_row_major():
    """Rank r sits where JAX's device r does; a tuple of axes indexes its
    line row-major; the groups' lines cover every rank once per axis."""
    from repro_torch.launch.mesh import _lines
    grid = ModelMesh(("pod", "data", "model"), (2, 3, 2), rank=9)
    assert grid.coords == (1, 1, 1)
    assert grid.coord(("pod", "data")) == 4 and grid.coord("model") == 1
    assert grid.axis_size(("pod", "data")) == 6 and grid.axis_size(None) == 1
    assert _lines((2, 3, 2), (2,)) == [[0, 1], [2, 3], [4, 5], [6, 7],
                                       [8, 9], [10, 11]]
    assert _lines((2, 3, 2), (0, 1)) == [[0, 2, 4, 6, 8, 10],
                                         [1, 3, 5, 7, 9, 11]]
    with pytest.raises(ValueError):
        ModelMesh(("data", "model"), (2, 2), rank=4)


def test_layout_drops_axes_that_do_not_divide():
    """The spec rule's other side, at shapes no registered cell has: a
    batch of 3 over dp 2 keeps every row on every rank, and a window of 6
    splits over tp 2 but not over tp 4."""
    cfg = get_config("qwen3-32b-smoke")
    shape = ShapeConfig("d", 6, 3, "decode")
    grid = ModelMesh(("data", "model"), (2, 2))
    ctx = make_shard_ctx(cfg, shape, grid)
    assert not ctx.batch_shardable and ctx.seq_shard_cache
    spec = cache_specs(cfg, shape, ctx, grid)
    assert spec["pos"] == (None,)
    assert spec["stack_0"]["b0_attn"]["k"] == (None, None, "model", None,
                                               None)
    grid4 = ModelMesh(("data", "model"), (1, 4))
    ctx4 = make_shard_ctx(cfg, shape, grid4)
    assert ctx4.batch_shardable and not ctx4.seq_shard_cache
    assert cache_specs(cfg, shape, ctx4, grid4)["stack_0"]["b0_attn"][
        "k"] == (None, "data", None, None, None)
    with mesh_context(grid):
        assert L.constrain_spec(ctx, (3, 7, 4), "dp", "sp", "tp") == (
            None, None, "model")
        assert local_rows(ctx, 3) == slice(0, 3)
    assert L.constrain_spec(CPU_CTX, (3,), "dp") is None


# ---------------------------------------------------------------------------
# (b) the sharded flash decode alone
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_sharded_flash_decode_matches_jax_and_one_device(runs, mesh):
    q, k, v, ln = _fd_inputs()
    one = gqa_decode_ref(torch.from_numpy(q[:, 0]), torch.from_numpy(k),
                         torch.from_numpy(v), torch.from_numpy(ln)).numpy()
    want = runs["fd"][f"fd_{mesh}"]
    np.testing.assert_allclose(want[:, 0], one, atol=DECODE_ATOL, rtol=0)
    covered = set()
    for rank, out in enumerate(runs["ranks"]):
        rows, slots, got = out["flash_decode"][mesh]
        np.testing.assert_allclose(got, want[rows], atol=DECODE_ATOL,
                                   rtol=0, err_msg=f"rank {rank}")
        np.testing.assert_allclose(got[:, 0], one[rows], atol=DECODE_ATOL,
                                   rtol=0, err_msg=f"rank {rank}")
        covered.add((rows.start, slots.start))
    assert len(covered) == RANKS
    # length 0: the uniform mean over all W slots
    np.testing.assert_allclose(
        one[0], v[0].mean(0).repeat(FD["h"] // FD["kv"], 0), atol=1e-5)


# ---------------------------------------------------------------------------
# (c) the model: prefill and greedy decode on the grid
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("run", RUNS, ids=lambda r: f"{r[0]}-{r[1]}-B{r[2]}")
def test_sharded_decode_matches_jax_decode_step_with_ctx(runs, run):
    arch, mesh, b, seq, prompt, gen = run
    want = runs["runs"][run]
    grid = ModelMesh(("data", "model"), mesh)
    cfg = get_config(arch)
    shape = ShapeConfig("decode", seq, b, "decode")
    ctx = make_shard_ctx(cfg, shape, grid)
    assert ctx.seq_shard_cache == bool(want["seq_shard"])
    assert ctx.batch_shardable == bool(want["batch_shardable"])
    # every family but ssm takes the sequence split (the hybrid's window)
    assert ctx.seq_shard_cache == (cfg.family != "ssm")
    assert ctx.batch_shardable == (b % mesh[0] == 0)
    whole = {k: tuple(a.shape) for k, a in tree_leaves(
        M.init_cache(cfg, b, seq, device="meta"))}
    blocks = set()
    for rank, out in enumerate(runs["ranks"]):
        got = out[run]
        assert got["ctx"] == dataclasses.asdict(ctx)
        rows = got["rows"]
        rank_grid = ModelMesh(("data", "model"), mesh, rank)
        assert rows == local_rows_on(ctx, b, rank_grid)
        specs = dict(tree_leaves(got["specs"]))
        for key, shp in got["shapes"].items():
            # the KV caches on the sequence, the recurrent states h and
            # conv on their width (the smoke widths all divide)
            n = mesh[1] if key.endswith(("/k", "/v", "/h", "/conv")) else 1
            m = (mesh[0] if b % mesh[0] == 0 else 1)
            assert np.prod(shp) * n * m == np.prod(whole[key]), key
            assert shp == local_shape(whole[key], specs[key], rank_grid)
        for step in range(gen + 1):
            what = f"rank {rank} step {step}"
            np.testing.assert_allclose(got[f"logits_{step}"],
                                       want[f"logits_{step}"][rows],
                                       atol=ATOL, rtol=0, err_msg=what)
            np.testing.assert_array_equal(got[f"next_{step}"],
                                          want[f"next_{step}"][rows],
                                          err_msg=what)
            jcache = {k[len(f"cache_{step}_"):]: a for k, a in want.items()
                      if k.startswith(f"cache_{step}_")}
            part = {k: a.numpy() for k, a in tree_leaves(cache_part_from_jax(
                _unflat(jcache), got["specs"], rank_grid, "cpu"))}
            assert sorted(part) == sorted(got[f"cache_{step}"])
            for key, a in got[f"cache_{step}"].items():
                if key == "pos":
                    np.testing.assert_array_equal(a, part[key], what)
                else:
                    np.testing.assert_allclose(a, part[key], atol=ATOL,
                                               rtol=0,
                                               err_msg=f"{what} {key}")
        blocks.add((rows.start,) + tuple(
            s.start for key, spec in specs.items()
            for s in local_slices(whole[key], spec, rank_grid)))
    # each rank its own block; where dp does not divide B, the two ranks
    # of a model coordinate hold the same (every row)
    assert len(blocks) == (RANKS if b % mesh[0] == 0 else mesh[1])


def local_rows_on(ctx, b, grid):
    with mesh_context(grid):
        return local_rows(ctx, b)


def _unflat(flat):
    out = {}
    for key, a in flat.items():
        *path, leaf = key.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = a
    return out


def test_one_card_paths_are_unchanged_with_ctx_none_or_cpu_ctx():
    """ctx=None and CPU_CTX give the one-card results, and no mesh is
    needed."""
    cfg = get_config("h2o-danube-3-4b-smoke")
    params = M.init_params(cfg, 0, "cpu")
    tok = torch.from_numpy(_tokens(cfg.name, 2, 20))
    outs = []
    for ctx in (None, CPU_CTX):
        pre, dec = TS.make_serve_steps(cfg, ctx)
        c = M.init_cache(cfg, 2, 24, device="cpu", ctx=ctx)
        c, lg = pre(params, {"tokens": tok}, c)
        c, nxt, lg2 = dec(params, c, torch.argmax(lg, -1).to(
            torch.int32)[:, None])
        outs.append((lg, lg2, c["stack_0"]["b0_attn"]["k"].clone()))
    pre, dec = TS.make_serve_steps(cfg)
    c = M.init_cache(cfg, 2, 24, device="cpu")
    c, lg = pre(params, {"tokens": tok}, c)
    c, _, lg2 = dec(params, c, torch.argmax(lg, -1).to(torch.int32)[:, None])
    for got in outs:
        for a, b in zip(got, (lg, lg2, c["stack_0"]["b0_attn"]["k"])):
            assert torch.equal(a, b)


@pytest.mark.parametrize("slots", [(0, 8), (4, 8), (0, 16), (12, 16)])
@pytest.mark.parametrize("s,pos0", [(1, 0), (1, 5), (1, 13), (3, 0),
                                    (7, 0), (11, 0), (20, 0)])
def test_cache_write_on_a_block_equals_the_whole_ring_cut(slots, s, pos0):
    """A block's write equals the same slots of the whole ring's write: a
    decode step's position on another rank's slots leaves the block as it
    was, a prefill writes its positions, a prompt longer than W the last
    W."""
    lo, w = slots
    wl = 4
    rng = np.random.default_rng([lo, w, s, pos0])
    ck0 = torch.from_numpy(rng.standard_normal((3, w, 2, 4)).astype(
        np.float32))
    cv0 = ck0 * 2
    k = torch.from_numpy(rng.standard_normal((3, s, 2, 4)).astype(
        np.float32))
    v = k - 1
    p0 = torch.tensor([pos0, pos0 + 1, pos0 + 2], dtype=torch.int32) \
        if s == 1 else torch.zeros(3, dtype=torch.int32)
    ck, cv = ck0.clone(), cv0.clone()
    L.cache_write(ck, cv, k, v, p0)
    bk, bv = ck0[:, lo:lo + wl].clone(), cv0[:, lo:lo + wl].clone()
    L.cache_write(bk, bv, k, v, p0, (lo, w))
    assert torch.equal(bk, ck[:, lo:lo + wl])
    assert torch.equal(bv, cv[:, lo:lo + wl])


# ---------------------------------------------------------------------------
# (d) the int8 compressed all-reduce
# ---------------------------------------------------------------------------


def test_compressed_psum_matches_jax_at_four_ranks(runs):
    want = runs["compress"]
    for rank, out in enumerate(runs["ranks"]):
        got = out["compress"]
        for step in range(CP_STEPS):
            for key, s in CP_SHAPES.items():
                blk = slice(rank * s[0], (rank + 1) * s[0])
                what = f"rank {rank} step {step} {key}"
                w_q = want[f"q_{step}_{key}"][blk]
                assert got[f"q_{step}_{key}"].dtype == np.int8
                np.testing.assert_array_equal(got[f"q_{step}_{key}"], w_q,
                                              what)
                np.testing.assert_array_equal(
                    got[f"scale_{step}_{key}"].reshape(1),
                    want[f"scale_{step}_{key}"][rank:rank + 1], what)
                # each product and quotient rounds once in both packages,
                # in JAX's order: bit for bit
                for part in ("mean", "res"):
                    np.testing.assert_array_equal(
                        got[f"{part}_{step}_{key}"],
                        want[f"{part}_{step}_{key}"][blk],
                        f"{what} {part}")


def test_compressed_psum_error_feedback_on_a_group_of_one(runs):
    """tests/test_runtime.py's error-feedback test on the port: each rank
    on a group of its own."""
    for out in runs["ranks"]:
        assert out["compress"]["feedback_rel"] < 0.02


def test_quantize_roundtrip():
    """tests/test_runtime.py's roundtrip on the port; round half to even."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        1000).astype(np.float32))
    q, s = quantize(x)
    err = float((dequantize(q, s) - x).abs().max())
    assert err <= float(s) * 0.51 + 1e-6
    q, _ = quantize(torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5]))
    assert q.tolist() == [127, 0, 2, 2, 0, -2]


# ---------------------------------------------------------------------------
# (e) no fallback
# ---------------------------------------------------------------------------


def test_enabled_ctx_without_a_matching_mesh_raises():
    cfg = get_config("qwen3-32b-smoke")
    ctx = ShardCtx(enabled=True, seq_shard_cache=True)
    params = M.init_params(cfg, 0, "cpu")
    cache = M.init_cache(cfg, 2, 8, device="cpu")
    tok = torch.zeros((2, 1), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="current ModelMesh"):
        M.decode_step(params, cache, tok, cfg, ctx)
    with pytest.raises(RuntimeError, match="current ModelMesh"):
        M.init_cache(cfg, 2, 8, device="cpu", ctx=ctx)
    with pytest.raises(RuntimeError, match="current ModelMesh"):
        L.constrain_spec(ctx, (2,), "dp")
    with mesh_context(ModelMesh(("data", "tensor"), (1, 1))):
        with pytest.raises(ValueError, match="axes"):
            M.decode_step(params, cache, tok, cfg, ctx)
    # a grid of 4 with no group: the decode's combine refuses to run on
    # one rank's slots alone
    with mesh_context(ModelMesh(("data", "model"), (1, 4))):
        part = M.init_cache(cfg, 2, 8, device="cpu", ctx=ctx)
        assert part["stack_0"]["b0_attn"]["k"].shape[2] == 2
        with pytest.raises(RuntimeError, match="no process group"):
            M.decode_step(params, part, tok, cfg, ctx)
    with pytest.raises(RuntimeError, match="initialized"):
        make_model_mesh((1, 4))


def test_refusals_on_the_ranks(runs):
    for rank, out in enumerate(runs["ranks"]):
        got = out["refusals"]
        assert got["grid_of_8"][0] == "ValueError", got
        assert got["other_rank"][0] == "ValueError", got
        assert got["pod_ctx"][0] == "ValueError", got
        assert got["mla_seq"][0] == "ValueError", got
        assert got["window_6"][0] == "ValueError", got
