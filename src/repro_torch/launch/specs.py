"""The sharded layout of a cell (a port of ``repro.launch.specs``):
``make_shard_ctx`` decides the activation layout (batch shardability,
sequence-sharded decode caches), ``input_specs`` gives a step's inputs'
shapes and dtypes, and ``batch_pspecs`` and ``cache_specs`` give every
batch and cache leaf its partition spec, a tuple with one entry a dim (an
axis name, a tuple of names, or None).  ``local_slices`` cuts a rank's
block of a tensor by a spec, as ``NamedSharding`` places block i of a
split dim on the devices whose coordinate on its axes is i.

There is no ``NamedSharding``: JAX's ``to_shardings`` + ``device_put`` is
``put`` (each rank keeps its block of each leaf), and ``np.asarray`` of a
sharded array is ``gather`` (every rank rebuilds the whole leaf, a
collective).  Each rank of a ``ModelMesh`` allocates and computes on its
blocks alone: the caches of ``models/model.py::init_cache(..., ctx=)``,
the params and AdamW state of ``train/steps.py::shard_train_state`` under
``models/params.py::param_pspecs``.  The dry run's
``cell_abstract_and_shardings`` waits for ROADMAP item 13.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.params import tree_leaves, tree_unflatten
from repro_torch.models.sharding import ShardCtx


def make_shard_ctx(cfg: ModelConfig, shape: ShapeConfig, mesh,
                   opt: bool = False) -> ShardCtx:
    """``repro.launch.specs.make_shard_ctx`` on a ``ModelMesh`` (or any
    mesh with ``axis_names`` and a ``shape`` dict)."""
    multi_pod = "pod" in mesh.axis_names
    dp_size = mesh.shape["data"] * (mesh.shape["pod"] if multi_pod else 1)
    tp = mesh.shape["model"]
    batch_ok = shape.global_batch % dp_size == 0
    # sequence-sharded decode cache: standard-attention archs with a
    # TP-divisible cache window
    w = cfg.window if cfg.attn_kind == "swa" or cfg.family == "hybrid" \
        else shape.seq_len
    seq_shard = (shape.kind == "decode" and not cfg.mla
                 and cfg.family != "ssm"
                 and w % tp == 0)
    fsdp = True
    if opt and shape.kind == "decode":
        # the serving layout: params TP-sharded, replicated over data, when
        # the TP shard fits
        from repro_torch.models.params import param_count
        per_dev = param_count(cfg) * 2 / tp            # bf16
        if per_dev < 11 * 2 ** 30:
            fsdp = False
    return ShardCtx(enabled=True,
                    pod_axis="pod" if multi_pod else None,
                    batch_shardable=batch_ok,
                    seq_shard_cache=seq_shard,
                    sp_activations=shape.kind in ("train", "prefill"),
                    fsdp_params=fsdp)


def input_specs(cfg: ModelConfig, shape: ShapeConfig
                ) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """(shape, dtype name) of each input of a step of ``shape``'s kind (the
    batch part only), JAX's ``ShapeDtypeStruct`` stand-ins as plain
    tuples."""
    b, s = shape.global_batch, shape.seq_len
    i32, cdt = "int32", cfg.compute_dtype
    if shape.kind == "decode":      # one new token against a seq_len cache
        return {"tokens": ((b, 1), i32)}
    batch: Dict[str, Tuple[Tuple[int, ...], str]] = {}
    if shape.kind == "train":
        batch["labels"] = ((b, s), i32)
    if cfg.family == "vlm":
        batch["embeds"] = ((b, s, cfg.d_model), cdt)
        batch["positions"] = ((3, b, s), i32)
    elif cfg.family == "audio":
        batch["embeds"] = ((b, cfg.enc_seq, cfg.d_model), cdt)
        batch["tokens"] = ((b, s), i32)
    else:
        batch["tokens"] = ((b, s), i32)
    return batch


def batch_pspecs(cfg: ModelConfig, shape: ShapeConfig, ctx: ShardCtx
                 ) -> Dict[str, tuple]:
    """The spec of each input: its rows over ``dp`` (M-RoPE's (3, B, S)
    positions on dim 1)."""
    dp = ctx.dp()
    out = {}
    for k in input_specs(cfg, shape):
        if k == "positions":
            out[k] = (None, dp, None)
        elif k == "embeds":
            out[k] = (dp, None, None)
        else:
            out[k] = (dp, None)
    return out


def cache_specs(cfg: ModelConfig, shape: ShapeConfig, ctx: ShardCtx,
                mesh) -> Any:
    """A spec tree matching ``init_cache``'s structure (the JAX package's
    ``cache_pspecs``): the batch dim over ``dp`` where ``dp`` divides it;
    ``k``/``v`` on the sequence over ``model`` with ``seq_shard_cache``
    where ``model`` divides the window; a recurrent state's width (``h``
    of (stack, B, width), ``conv``) over ``model`` where it divides."""
    from repro_torch.models import model as M
    dp = ctx.dp()
    tp = ctx.tp()
    tps = mesh.shape["model"]
    abstract = M.init_cache(cfg, shape.global_batch, shape.seq_len,
                            device="meta")

    def spec(name, shp):
        d = [None] * len(shp)
        # leading dims: (stack, batch, ...) except top-level "pos" (batch,)
        bdim = 0 if name == "pos" else 1
        if dp is not None and shp[bdim] % mesh.axis_size(dp) == 0:
            d[bdim] = dp
        if name in ("k", "v") and ctx.seq_shard_cache and \
                shp[bdim + 1] % tps == 0:
            d[bdim + 1] = tp                      # sequence-sharded cache
        elif state_split(name, shp[1:], tps):
            d[-1] = tp                            # recurrent state width
        return tuple(d)

    def walk(tree, name=None):
        if isinstance(tree, dict):
            return {key: walk(val, key) for key, val in tree.items()}
        return spec(name, tuple(tree.shape))

    return walk(abstract)


def state_split(name: str, shape: Tuple[int, ...], n: int) -> bool:
    """Whether ``cache_specs`` splits a recurrent state leaf of one layer
    (``shape`` without the stack dim) over a ``model`` axis of ``n``
    ranks: RG-LRU's and sLSTM's ``h`` (B, width) and RG-LRU's ``conv``
    (B, K - 1, width) on their width, where n divides it.  sLSTM's ``c``
    and ``n`` and mLSTM's state stay whole, as in JAX's ``cache_pspecs``."""
    return ((name == "h" and len(shape) == 2) or name == "conv") and \
        shape[-1] % n == 0


def local_slices(shape: Tuple[int, ...], spec: Tuple, mesh
                 ) -> Tuple[slice, ...]:
    """This rank's block of a tensor of ``shape`` split by ``spec``: on a
    dim split over axes of n ranks, block ``mesh.coord(axes)`` of n."""
    out = []
    for i, dim in enumerate(shape):
        axes = spec[i] if i < len(spec) else None
        n = mesh.axis_size(axes)
        if dim % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                             f"over {axes} ({n} ranks)")
        blk = dim // n
        at = mesh.coord(axes)
        out.append(slice(at * blk, (at + 1) * blk))
    return tuple(out)


def local_shape(shape: Tuple[int, ...], spec: Tuple, mesh
                ) -> Tuple[int, ...]:
    return tuple(s.stop - s.start for s in local_slices(shape, spec, mesh))


def local_rows(ctx: Optional[ShardCtx], n: int) -> slice:
    """This rank's rows of a batch of ``n``: its ``dp`` block where the
    ``dp`` axes divide ``n`` (``constrain``'s rule), else every row.  The
    caller hands a sharded ``prefill`` / ``decode_step`` these rows of the
    tokens; the cache's rows (``pos`` included) split the same way."""
    from repro_torch.launch.meshctx import require_mesh
    from repro_torch.models.layers import constrain_spec
    if ctx is None or not ctx.enabled:
        return slice(0, n)
    return local_slices((n,), constrain_spec(ctx, (n,), "dp"),
                        require_mesh(ctx))[0]


def put(tree, spec_tree, mesh):
    """JAX's ``device_put(tree, to_shardings(mesh, spec_tree))`` on this
    rank: each leaf (a tensor or an array) cut to its block by its spec,
    as a tensor or array of its own (a copy, so the whole can be freed)."""
    def cut(leaf, spec):
        blk = leaf[local_slices(tuple(leaf.shape), spec, mesh)]
        if isinstance(blk, torch.Tensor):
            return blk.clone(memory_format=torch.contiguous_format)
        return np.ascontiguousarray(blk)

    return _zip_map(cut, tree, spec_tree)


def _zip_map(fn, tree, spec_tree):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, tree[k], spec_tree[k]) for k in tree}
    return fn(tree, spec_tree)


def split_axes(spec, mesh) -> Tuple[str, ...]:
    """The grid's axes that split a leaf by ``spec``, in the grid's order."""
    named = set()
    for a in spec:
        if a is not None:
            named.update((a,) if isinstance(a, str) else a)
    return tuple(a for a in mesh.axis_names
                 if a in named and mesh.shape[a] > 1)


def gather(tree, spec_tree, mesh):
    """``np.asarray`` of a sharded tree: every leaf whole on every rank,
    rebuilt from the ranks' blocks (each leaf of ``tree`` this rank's
    block by its spec).  A collective of the whole grid: each rank writes
    its block into a zero-filled whole and the wholes are summed over the
    ranks that split the leaf, one ``all_reduce`` for the leaves of one
    set of axes and one dtype.  Every leaf returned is a tensor of its
    own.  For tests and for saving."""
    leaves = [leaf for _, leaf in tree_leaves(tree)]
    specs = [spec for _, spec in tree_leaves(spec_tree)]
    out = list(leaves)
    groups: Dict[tuple, list] = {}
    for i, (leaf, spec) in enumerate(zip(leaves, specs)):
        axes = split_axes(spec, mesh)
        if axes:
            groups.setdefault((axes, leaf.dtype, leaf.device), []).append(i)
        else:
            out[i] = leaf.clone()
    for (axes, dtype, device), idx in sorted(groups.items(),
                                             key=lambda kv: kv[1][0]):
        shapes = []
        for i in idx:
            blk = leaves[i].shape
            shapes.append(tuple(n * mesh.axis_size(a) for n, a in zip(
                blk, tuple(specs[i]) + (None,) * (len(blk) - len(specs[i])))))
        sizes = [int(np.prod(shp, dtype=np.int64)) for shp in shapes]
        flat = torch.zeros(sum(sizes), dtype=dtype, device=device)
        at = 0
        for i, shp, n in zip(idx, shapes, sizes):
            whole = flat[at:at + n].view(shp)
            whole[local_slices(shp, specs[i], mesh)] = leaves[i]
            out[i] = whole
            at += n
        mesh.all_reduce(flat, dist.ReduceOp.SUM, axes)
    return tree_unflatten(tree, out)
