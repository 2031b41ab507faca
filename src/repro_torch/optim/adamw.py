"""AdamW with configurable state dtype (bf16 m/v for >=100B models),
global-norm clipping and warmup + cosine schedule (a port of
``repro.optim.adamw``: the same fields, defaults and arithmetic).

Everything runs in f32 on the parameters' device.  ``step`` is an int32
0-d tensor there, and the schedule, the clip scale and the bias
corrections are computed from it on the device, so an update makes no
host read (the config's scalars enter as Python numbers, which a kernel
takes as arguments: no copy to the device).

``update`` writes the new params, m and v IN PLACE under
``torch.no_grad()``, one layer slice at a time along each stacked leaf
(a leaf of three or more dims is a stack of layers): the f32 temporaries
are then the size of one layer's slice, where a whole-leaf update of
h2o-danube-3-4b's stacked ``mlp/wi`` (24 x 3840 x 10240) would make
several of 3.8 GB each.  ``global_norm`` sums per slice too.  The JAX
functions return new trees; these return the same tensors, updated.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Tuple

import torch
import torch.distributed as dist

from repro_torch.models.params import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup: int = 100
    total_steps: int = 10000
    state_dtype: str = "float32"


def init(params, cfg: AdamWConfig) -> AdamWState:
    dt = getattr(torch, cfg.state_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)  # noqa: E731
    device = next(leaf for _, leaf in tree_leaves(params)).device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def schedule(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    """The learning rate at ``step`` (an int32 tensor), f32 on its
    device: linear warmup, then a cosine to 0 at ``total_steps``."""
    warm = torch.clamp(step / max(cfg.warmup, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup) /
                       max(cfg.total_steps - cfg.warmup, 1), 0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * prog))


def _slices(t: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Views of ``t`` one layer at a time: along dim 0 for a stacked leaf
    (three or more dims), else the whole leaf."""
    return torch.unbind(t, 0) if t.dim() >= 3 else (t,)


def global_norm(tree, specs=None, mesh=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32, summed per slice
    (no f32 copy of a whole stacked leaf).

    With ``specs`` and ``mesh`` (a ``ModelMesh``) the leaves are this
    rank's blocks by ``specs`` and the norm is the whole tree's, a
    collective of the grid.  Trap: the grad norm.  Each element counts
    once: a block is held by every rank of the axes its spec does not
    split (those whose size does not divide the dim included, the spec
    having dropped them), so it is counted on the rank at coordinate 0 of
    those axes, and the sum is summed over the whole grid."""
    from repro_torch.launch.specs import split_axes
    leaves = [leaf for _, leaf in tree_leaves(tree)]
    keep = [True] * len(leaves)
    if specs is not None:
        keep = [all(mesh.coord(a) == 0 for a in mesh.axis_names
                    if a not in split_axes(spec, mesh))
                for _, spec in tree_leaves(specs)]
    parts = [torch.sum(torch.square(s.float()))
             for leaf, k in zip(leaves, keep) if k for s in _slices(leaf)]
    total = torch.sum(torch.stack(parts)) if parts else \
        torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    if specs is not None:
        mesh.all_reduce(total, dist.ReduceOp.SUM, mesh.axis_names)
    return torch.sqrt(total)


@torch.no_grad()
def update(grads, state: AdamWState, params, cfg: AdamWConfig,
           specs=None, mesh=None) -> Tuple[Any, AdamWState, torch.Tensor]:
    """One AdamW step.  Returns (params, state, grad norm before clipping):
    ``params``, ``state.m`` and ``state.v`` updated in place, a new
    ``step``.  With ``specs`` and ``mesh`` every tree holds this rank's
    blocks by ``specs`` (m and v by the same: ``param_pspecs``' ``opt``
    specs equal the params' on a grid with no pod axis) and only the grad
    norm is a collective; the rest stays elementwise on the blocks."""
    gnorm = global_norm(grads, specs, mesh)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step + 1
    lr = schedule(step, cfg)
    stepf = step.float()
    b1c = 1.0 - torch.pow(cfg.b1, stepf)
    b2c = 1.0 - torch.pow(cfg.b2, stepf)

    def upd(p, g, m, v):
        g = g.float() * scale
        m2 = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v2 = cfg.b2 * v.float() + (1 - cfg.b2) * torch.square(g)
        mhat = m2 / b1c
        vhat = v2 / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + \
            cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m2)
        v.copy_(v2)

    leaves = zip(*([leaf for _, leaf in tree_leaves(t)]
                   for t in (params, grads, state.m, state.v)))
    for p, g, m, v in leaves:
        for ps, gs, ms, vs in zip(_slices(p), _slices(g), _slices(m),
                                  _slices(v)):
            upd(ps, gs, ms, vs)
    return params, AdamWState(step, state.m, state.v), gnorm
