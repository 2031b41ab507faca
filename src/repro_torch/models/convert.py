"""Parameter, cache and training-state trees of the JAX package, as numpy
arrays, into the port's torch trees, so that both packages compute (and
train) from the same state.  Both packages stack layer params and caches
on a leading dim with the same keys, so the conversion is a plain copy,
leaf by leaf.

The trees come in as numpy (``jax.tree.map(np.asarray, tree)`` on the JAX
side): the port imports nothing of JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.launch.specs import put
from repro_torch.models.params import tree_map
from repro_torch.optim.adamw import AdamWState
from repro_torch.train.steps import TrainState


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    """One array into a tensor of the same dtype, copied (the port writes
    caches in place, and arrays from JAX are read-only); bfloat16 (numpy's
    ``ml_dtypes`` extension type) crosses as its 16-bit pattern."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def params_from_jax(tree, device="cuda", specs=None, mesh=None):
    """A JAX parameter tree (``repro.models.params.init_params``), leaves as
    numpy arrays, as the port's parameter tree on ``device``; with
    ``specs`` and ``mesh`` (``param_pspecs(cfg, ctx, mesh=mesh)`` and its
    ``ModelMesh``) this rank's block of each leaf, as
    ``jax.device_put(tree, to_shardings(mesh, specs))`` places it."""
    if specs is not None:
        tree = put(tree_map(np.asarray, tree), specs, mesh)
    return tree_map(lambda a: tensor_from_numpy(a, device), tree)


def cache_from_jax(tree, device="cuda"):
    """A JAX cache tree (``repro.models.model.init_cache`` or what prefill
    and decode_step return), leaves as numpy arrays, as the port's cache
    tree on ``device``."""
    return tree_map(lambda a: tensor_from_numpy(a, device), tree)


def cache_part_from_jax(tree, specs, mesh, device="cuda"):
    """This rank's block of each leaf of a JAX global cache tree (leaves as
    numpy arrays), cut by ``specs`` (``launch/specs.py::cache_specs`` of
    the cache's batch and length: the layout ``init_cache(..., ctx=)``
    allocates), as the port's cache tree on ``device``."""
    return params_from_jax(tree, device, specs, mesh)


def train_state_from_jax(tree, device="cuda", specs=None, mesh=None):
    """A JAX ``TrainState`` (``repro.train.steps``), leaves as numpy arrays,
    as the port's ``TrainState`` on ``device``: the params, the AdamW
    ``step`` (an int32 0-d tensor), ``m`` and ``v`` in their dtypes.  With
    ``specs`` and ``mesh``, this rank's blocks of the params, m and v
    (``params_from_jax``; ``param_pspecs``' ``opt`` specs equal the
    params' on a grid with no pod axis)."""
    opt = tree.opt
    return TrainState(
        params_from_jax(tree.params, device, specs, mesh),
        AdamWState(step=tensor_from_numpy(
                       np.asarray(opt.step, np.int32), device),
                   m=params_from_jax(opt.m, device, specs, mesh),
                   v=params_from_jax(opt.v, device, specs, mesh)))
