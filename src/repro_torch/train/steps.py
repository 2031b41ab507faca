"""Train and serve step builders (a port of ``repro.train.steps``): loss +
gradients + AdamW update, microbatch gradient accumulation, and the
serving entry points.

Gradients come from ``torch.autograd.grad`` over the parameter leaves in
JAX's flatten order (``tree_leaves``), taken of aliases of the params
(``detach().requires_grad_()``), so the state's own tensors never require
grad and the optimizer may update them in place.  ``TrainState`` keeps
JAX's field names, so a checkpoint of it has JAX's leaf names
(``.params/...``, ``.opt/.step``, ``.opt/.m/...``).  The abstract state
of the JAX dry run (``abstract_train_state``) waits for ROADMAP item 13.

On a (data, model) grid of ranks (an enabled ``ShardCtx``) every rank
holds its blocks of the params, m and v (``shard_train_state``) and runs
the same step on its rows of the batch; the gradients it gets are its
blocks of the whole batch's.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.meshctx import require_mesh
from repro_torch.launch.specs import gather, put
from repro_torch.models import model as M
from repro_torch.models import tp as TP
from repro_torch.models.params import (param_pspecs, tree_leaves,
                                       tree_unflatten)
from repro_torch.optim import adamw


class TrainState(NamedTuple):
    params: Any
    opt: adamw.AdamWState


def loss_and_grads(cfg: ModelConfig, params, batch, ctx=None):
    """(loss, metrics, grads): the loss of ``M.loss_fn`` and its gradient
    tree, one leaf per parameter leaf, in the parameters' dtype.  With an
    enabled ``ctx`` the params are this rank's blocks and the batch its
    rows, the loss and metrics are the whole batch's, and each gradient
    leaf is this rank's block of the whole batch's gradient (summed over
    the ranks by ``models/tp.py``'s collectives in the backward)."""
    leaves = [a.detach().requires_grad_() for _, a in tree_leaves(params)]
    loss, metrics = M.loss_fn(tree_unflatten(params, leaves), batch, cfg,
                              ctx)
    # a leaf the batch does not reach (the vlm's token embedding under
    # patch embeddings) gets zeros, as JAX's gradient does
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten(params, grads))


def microbatch(batch: Dict[str, Any], i: int, grad_accum: int):
    """Microbatch i of ``grad_accum``, by JAX's ``mb_slice`` rule verbatim:
    a leaf of more than two dims whose first is 3 is taken for M-RoPE's
    positions and cut on dim 1 (so is an ``embeds`` of batch 3: ROADMAP
    C), every other leaf on dim 0."""
    def mb_slice(x):
        m = x.shape[1] // grad_accum if x.ndim > 2 and x.shape[0] == 3 \
            else x.shape[0] // grad_accum
        if x.ndim > 2 and x.shape[0] == 3:      # M-RoPE positions
            return x[:, i * m:(i + 1) * m]
        return x[i * m:(i + 1) * m]
    return {k: mb_slice(v) for k, v in batch.items()}


def microbatches(batch: Dict[str, Any], grad_accum: int, ctx=None):
    """The step's ``grad_accum`` microbatches.  On a mesh (an enabled
    ``ctx``; ``batch`` this rank's rows by ``batch_pspecs``) microbatch i
    is, as in JAX, the global batch's microbatch i split over ``dp``:
    the rows are gathered over ``dp`` once (one collective a dtype), each
    microbatch is cut from the whole and this rank keeps its rows of it.
    A rank's own rows cut into slices would be another split, with
    other counts of labelled tokens and another MoE aux a microbatch."""
    if ctx is None or not ctx.enabled:
        return [microbatch(batch, i, grad_accum) for i in range(grad_accum)]
    mesh = require_mesh(ctx)
    dp = ctx.dp()
    n = mesh.axis_size(dp)
    rows = batch["labels"].shape[0] * n
    if rows % (grad_accum * n):
        raise ValueError(f"a batch of {rows} rows does not cut into "
                         f"{grad_accum} microbatches split over {n} ranks")
    specs = {k: (None, dp, None) if k == "positions" else
             (dp,) + (None,) * (v.ndim - 1) for k, v in batch.items()}
    whole = gather(batch, specs, mesh)
    return [put(microbatch(whole, i, grad_accum), specs, mesh)
            for i in range(grad_accum)]


def make_train_step(cfg: ModelConfig,
                    opt_cfg: Optional[adamw.AdamWConfig] = None,
                    grad_accum: int = 1, ctx=None):
    """The train step (JAX's ``make_train_step(cfg, ctx, opt_cfg,
    grad_accum)``).  With an enabled ``ctx`` it runs under the current
    ``ModelMesh`` on every rank of the grid together: the state is this
    rank's blocks (``shard_train_state``), the batch its rows
    (``launch/specs.py::batch_pspecs``), and the metrics are the whole
    batch's; with ``grad_accum`` > 1 the gradients cross the ranks once,
    after the last microbatch."""
    opt_cfg = opt_cfg or adamw.AdamWConfig(state_dtype=cfg.opt_dtype)
    sharded = ctx is not None and ctx.enabled

    def train_step(state: TrainState, batch: Dict[str, Any]):
        specs = mesh = None
        if sharded:
            mesh = require_mesh(ctx)
            specs = param_pspecs(cfg, ctx, mesh=mesh)
        if grad_accum == 1:
            loss, metrics, grads = loss_and_grads(cfg, state.params, batch,
                                                  ctx)
        else:
            # Python-unrolled microbatches: each one's activations are
            # freed before the next forward; gradients and losses summed,
            # then divided.  On a mesh each layer's unreduced gradient
            # accumulates in ``sink`` and the last microbatch's backward
            # reduces the sum
            grads, loss, metrics = None, 0.0, None
            sink = TP.GradSink()
            for i, mb in enumerate(microbatches(batch, grad_accum, ctx)):
                with TP.accumulate(sink, final=i == grad_accum - 1) if \
                        sharded else contextlib.nullcontext():
                    li, metrics, gi = loss_and_grads(cfg, state.params, mb,
                                                     ctx)
                if grads is None or sharded:
                    grads = gi
                else:
                    for (_, g), (_, a) in zip(tree_leaves(grads),
                                              tree_leaves(gi)):
                        g.add_(a)
                loss = loss + li
            for _, g in tree_leaves(grads):
                g.div_(grad_accum)
            loss = loss / grad_accum
        params, opt, gnorm = adamw.update(grads, state.opt, state.params,
                                          opt_cfg, specs, mesh)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm)
        return TrainState(params, opt), metrics

    return train_step


def shard_train_state(state: TrainState, cfg: ModelConfig, ctx, mesh
                      ) -> TrainState:
    """This rank's blocks of a whole ``TrainState`` (JAX's ``device_put``
    of the params, m and v to ``param_pspecs(cfg, ctx, mesh=mesh)``'s
    shardings, ``opt=True`` for m and v), as tensors of their own."""
    specs = param_pspecs(cfg, ctx, mesh=mesh)
    opt_specs = param_pspecs(cfg, ctx, opt=True, mesh=mesh)
    return TrainState(put(state.params, specs, mesh), adamw.AdamWState(
        state.opt.step.clone(), put(state.opt.m, opt_specs, mesh),
        put(state.opt.v, opt_specs, mesh)))


def make_serve_steps(cfg: ModelConfig, ctx=None):
    """(prefill_step, decode_step) of ``cfg``; with an enabled ``ctx``
    (a ``ShardCtx``) each takes and returns this rank's parts."""
    def prefill_step(params, batch, caches):
        return M.prefill(params, batch, caches, cfg, ctx)

    def decode_serve_step(params, caches, tokens):
        caches, logits = M.decode_step(params, caches, tokens, cfg, ctx)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return caches, next_tok, logits

    return prefill_step, decode_serve_step


def init_train_state(cfg: ModelConfig, seed: int = 0,
                     opt_cfg: Optional[adamw.AdamWConfig] = None,
                     device="cuda") -> TrainState:
    """Random params from ``seed`` (``M.init_params``) and zero AdamW
    state on ``device``."""
    opt_cfg = opt_cfg or adamw.AdamWConfig(state_dtype=cfg.opt_dtype)
    params = M.init_params(cfg, seed, device)
    return TrainState(params, adamw.init(params, opt_cfg))
