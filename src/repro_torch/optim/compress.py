"""Gradient compression: an int8 quantized all-reduce with error feedback
(a port of ``repro.optim.compress``).

Over a process group the gradient all-reduce is replaced by: quantize each
rank's gradient to int8 with a per-tensor scale, sum the int8 planes (as
int32), and dequantize with the group's largest scale.  The quantization
residual is carried to the next step (error feedback), which keeps SGD
convergence; 4x fewer bytes than an f32 all-reduce.  Two collectives a
leaf (the int32 sum and the scale's max), each on every rank of the group
in the same order.
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.models.params import tree_leaves, tree_unflatten


# XLA compiles JAX's ``max / 127.0`` into a product with the f32
# reciprocal of 127 (its algebraic simplifier rewrites a division by a
# constant), which rounds differently from the quotient in about one case
# in ten; the port takes the same product, so scales agree bit for bit
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 plane, f32 0-d scale): round(x / scale) half to even (as
    ``jnp.round``), clipped to +-127, scale = max(|x|.max(), 1e-12) / 127
    (as the f32 product with 1/127 that XLA makes of it)."""
    scale = torch.clamp(x.abs().max(), min=1e-12) * _INV_127
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(grads, residuals, group=None) -> Tuple[Any, Any]:
    """Per-leaf int8 all-reduce over ``group`` (a ``torch.distributed``
    group; None is the default group) with error feedback.  ``grads`` and
    ``residuals`` are tensors or nested dicts of them, residuals in f32.
    Returns (mean grads in each leaf's dtype, new f32 residuals): each rank
    adds its residual, quantizes, and the group's mean is the int32 sum
    times the largest scale over the group size, in that order (JAX's);
    the new residual is what the rank's plane at that scale misses."""
    n = dist.get_world_size(group)

    def one(g, r):
        g32 = g.float() + r
        q, scale = quantize(g32)
        total = q.to(torch.int32)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        scale_max = scale.clone()
        dist.all_reduce(scale_max, op=dist.ReduceOp.MAX, group=group)
        approx = total.float() * scale_max / n
        return approx.to(g.dtype), g32 - dequantize(q, scale_max)

    if isinstance(grads, torch.Tensor):
        return one(grads, residuals)
    pairs = [one(g, r) for (_, g), (_, r) in zip(tree_leaves(grads),
                                                  tree_leaves(residuals))]
    return (tree_unflatten(grads, [p[0] for p in pairs]),
            tree_unflatten(grads, [p[1] for p in pairs]))
