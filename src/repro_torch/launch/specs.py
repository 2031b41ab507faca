"""The sharded layout of a serving cell (a partial port of
``repro.launch.specs``): ``make_shard_ctx`` decides the activation layout
(batch shardability, sequence-sharded decode caches) and ``cache_specs``
gives every cache leaf its partition spec, a tuple with one entry a dim
(an axis name, a tuple of names, or None).  ``local_slices`` cuts a rank's
block of a tensor by a spec, as ``NamedSharding`` places block i of a
split dim on the devices whose coordinate on its axes is i.

Each rank of a ``ModelMesh`` allocates and computes on its blocks alone
(``models/model.py::init_cache(..., ctx=)``); the weights are whole on
every rank in this slice.  ``batch_pspecs``, ``to_shardings`` and the dry
run's ``cell_abstract_and_shardings`` wait for ROADMAP items 12.5b and 13.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig
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
        elif name == "h" and len(shp) == bdim + 2 and shp[-1] % tps == 0:
            d[-1] = tp                            # rglru state width
        elif name == "conv" and shp[-1] % tps == 0:
            d[-1] = tp
        return tuple(d)

    def walk(tree, name=None):
        if isinstance(tree, dict):
            return {key: walk(val, key) for key, val in tree.items()}
        return spec(name, tuple(tree.shape))

    return walk(abstract)


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
