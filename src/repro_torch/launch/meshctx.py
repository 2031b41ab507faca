"""Process-wide current model mesh (a port of ``repro.launch.meshctx``):
the :class:`~repro_torch.launch.mesh.ModelMesh` that the model code's
sharded paths read, as the JAX package's ``constrain`` and
``_sharded_flash_decode`` read the current ``jax.sharding.Mesh``."""
from __future__ import annotations

from typing import Optional

from repro_torch.launch.mesh import ModelMesh

_MESH: Optional[ModelMesh] = None


def set_mesh(mesh: Optional[ModelMesh]) -> None:
    global _MESH
    _MESH = mesh


def get_mesh() -> Optional[ModelMesh]:
    return _MESH


class mesh_context:
    """``with mesh_context(mesh):`` makes ``mesh`` current for the block
    and restores the previous one after it."""

    def __init__(self, mesh: Optional[ModelMesh]):
        self.mesh = mesh

    def __enter__(self):
        self.prev = get_mesh()
        set_mesh(self.mesh)
        return self.mesh

    def __exit__(self, *a):
        set_mesh(self.prev)


def require_mesh(ctx) -> ModelMesh:
    """The current mesh for an enabled ``ShardCtx``.  Raises where there
    is none, where its axes are not the ctx's (``pod_axis`` if set, then
    ``data_axis`` and ``model_axis``), or where it was made for another
    process group: a sharded path never runs on one device instead."""
    import torch.distributed as dist
    mesh = get_mesh()
    if mesh is None:
        raise RuntimeError("an enabled ShardCtx needs a current ModelMesh "
                           "(launch.meshctx.mesh_context)")
    want = tuple(a for a in (ctx.pod_axis, ctx.data_axis, ctx.model_axis)
                 if a)
    if mesh.axis_names != want:
        raise ValueError(f"the mesh's axes {mesh.axis_names} are not the "
                         f"ctx's {want}")
    if dist.is_available() and dist.is_initialized() and (
            dist.get_world_size() != mesh.world
            or dist.get_rank() != mesh.rank):
        raise ValueError(f"a mesh of {mesh.world} ranks (this rank "
                         f"{mesh.rank}) in a group of "
                         f"{dist.get_world_size()} (rank {dist.get_rank()})")
    return mesh
