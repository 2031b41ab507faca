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
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.models.params import tree_leaves, tree_unflatten
from repro_torch.optim import adamw


class TrainState(NamedTuple):
    params: Any
    opt: adamw.AdamWState


def loss_and_grads(cfg: ModelConfig, params, batch):
    """(loss, metrics, grads): the loss of ``M.loss_fn`` and its gradient
    tree, one leaf per parameter leaf, in the parameters' dtype."""
    leaves = [a.detach().requires_grad_() for _, a in tree_leaves(params)]
    loss, metrics = M.loss_fn(tree_unflatten(params, leaves), batch, cfg)
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


def make_train_step(cfg: ModelConfig,
                    opt_cfg: Optional[adamw.AdamWConfig] = None,
                    grad_accum: int = 1):
    opt_cfg = opt_cfg or adamw.AdamWConfig(state_dtype=cfg.opt_dtype)

    def train_step(state: TrainState, batch: Dict[str, Any]):
        if grad_accum == 1:
            loss, metrics, grads = loss_and_grads(cfg, state.params, batch)
        else:
            # Python-unrolled microbatches: each one's activations are
            # freed before the next forward; gradients and losses summed,
            # then divided
            grads, loss, metrics = None, 0.0, None
            for i in range(grad_accum):
                li, metrics, gi = loss_and_grads(
                    cfg, state.params, microbatch(batch, i, grad_accum))
                if grads is None:
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
                                          opt_cfg)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm)
        return TrainState(params, opt), metrics

    return train_step


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
