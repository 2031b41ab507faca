"""Logical sharding roles and the role -> partition mapping (a port of
``repro.models.sharding``).

Params and activations are annotated with *logical roles*; the active mesh
(``launch/mesh.py::ModelMesh``, held by ``launch/meshctx.py``) decides the
physical axes:

  fsdp   parameter / optimizer sharding axis       -> "data" (+"pod" for opt)
  tp     tensor-parallel axis (heads / ffn / vocab) -> "model"
  dp     batch axis for activations                 -> ("pod", "data")
  ep     expert-parallel axis                       -> "model"
  sp     sequence axis of long KV caches            -> "model"

A partition spec is a plain tuple with one entry a dim: an axis name, a
tuple of axis names, or None (JAX's ``PartitionSpec``).  The port has no
``NamedSharding``: each rank of a ``torch.distributed`` group holds its
block of every split tensor as a plain local tensor, and the code that
needs another rank's part calls a collective on the axis's process group.
The train step holds every weight and its AdamW state in blocks by
``models/params.py::param_pspecs`` (the ``fsdp`` and ``tp`` roles
resolved here); serving keeps the weights whole on every rank.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class ShardCtx:
    """Hashable description of the physical layout."""
    enabled: bool = False
    pod_axis: Optional[str] = None           # None on the single-pod mesh
    data_axis: str = "data"
    model_axis: str = "model"
    batch_shardable: bool = True             # False when dp does not divide B
    seq_shard_cache: bool = False            # sequence-parallel decode cache
    sp_activations: bool = False             # Megatron-SP residual stream
    fsdp_params: bool = True                 # shard params over data axis
    fsdp_opt_over_pod: bool = True           # ZeRO: optimizer over pod too

    # -- role axes ----------------------------------------------------------
    def dp(self):
        if not self.enabled or not self.batch_shardable:
            return None
        axes = tuple(a for a in (self.pod_axis, self.data_axis) if a)
        return axes if len(axes) > 1 else axes[0]

    def fsdp(self):
        return self.data_axis if (self.enabled and self.fsdp_params) else None

    def fsdp_opt(self):
        if not self.enabled:
            return None
        axes = [self.data_axis]
        if self.fsdp_opt_over_pod and self.pod_axis:
            axes.insert(0, self.pod_axis)
        return tuple(axes) if len(axes) > 1 else axes[0]

    def tp(self):
        return self.model_axis if self.enabled else None

    def no_shard(self):
        return replace(self, enabled=False)


CPU_CTX = ShardCtx(enabled=False)


def matrix_spec(ctx: ShardCtx, roles: Tuple[Optional[str], ...]) -> tuple:
    """roles per dim: 'fsdp' | 'fsdp_opt' | 'tp' | 'ep' | 'stack' | None."""
    out = []
    for r in roles:
        if r == "fsdp":
            out.append(ctx.fsdp())
        elif r == "fsdp_opt":
            out.append(ctx.fsdp_opt())
        elif r in ("tp", "ep"):
            out.append(ctx.tp())
        else:
            out.append(None)
    return tuple(out)
