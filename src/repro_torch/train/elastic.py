"""Elastic scaling: re-mesh a live training state onto a different mesh
(the reference's ``repro/train/elastic.py``).

When ranks are lost (or gained) the driver builds a mesh over the ranks
left (:func:`shrink_mesh`), recomputes every sharding from the *logical*
axis rules (the mesh is an input, not baked into the model) and moves the
state onto it (:func:`remesh_state`); the step is then made anew for the
new mesh by the caller.

Both are collective over the whole process group: every rank calls them,
the ranks that drop out of the new mesh too.  A ``DeviceMesh`` makes one
process group per mesh dim, and ``new_group`` needs every rank of the
world; a leaf's blocks leave the old mesh's ranks for the new mesh's by a
broadcast over the world.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..dist.sharding import ShardingProfile, param_shardings
from ..models.common import tree_leaves, tree_map


def _ranks(mesh) -> list[int]:
    return mesh.mesh.reshape(-1).tolist()


def _whole(x, spec, new_ranks: list[int]) -> torch.Tensor:
    """The whole leaf: gathered on the old mesh's ranks, then broadcast
    from its first rank when the new mesh has ranks the old one lacks.  A
    rank that gets no data (outside both meshes) holds an uninitialized
    tensor of the leaf's shape, which the new mesh does not read."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    old = x.device_mesh
    old_ranks = _ranks(old)
    full = x.full_tensor() if old.get_coordinate() is not None else None
    if full is None:
        full = torch.empty(spec.shape, dtype=spec.dtype,
                           device=x.to_local().device)
    if not set(new_ranks) <= set(old_ranks):
        dist.broadcast(full, src=old_ranks[0])
    return full


def remesh_state(state, state_spec_tree, new_mesh, profile: ShardingProfile):
    """``state`` (a tree of DTensors, or whole tensors) as DTensors on
    ``new_mesh``, each leaf on the sharding the profile's rules give it
    there.  Every rank of the process group calls it; on a rank outside
    ``new_mesh`` each leaf is a DTensor with an empty local tensor, as
    DTensor keeps them."""
    shardings = param_shardings(state_spec_tree, new_mesh, profile)
    new_ranks = _ranks(new_mesh)
    flat_sh = tree_leaves(shardings)
    flat_st = tree_leaves(state)
    if len(flat_sh) != len(flat_st):
        raise ValueError(f"{len(flat_st)} state leaves against "
                         f"{len(flat_sh)} specs")
    out = [sh.distribute(_whole(x, spec, new_ranks)) for x, sh, spec in
           zip(flat_st, flat_sh, tree_leaves(state_spec_tree))]
    it = iter(out)
    return tree_map(lambda _: next(it), shardings)


def shrink_mesh(mesh, lost_fraction_axis: str = "data"):
    """The sub-mesh of the first half along ``lost_fraction_axis``
    (simulated loss of the other half).  Every rank of the process group
    calls it: building the new mesh's groups needs them all."""
    from torch.distributed.device_mesh import DeviceMesh

    names = tuple(mesh.mesh_dim_names)
    shape = dict(zip(names, tuple(mesh.shape)))
    if lost_fraction_axis not in shape:
        raise ValueError(
            f"mesh has no axis {lost_fraction_axis!r} (axes: {names})")
    if shape[lost_fraction_axis] <= 1:
        raise ValueError(f"cannot shrink axis {lost_fraction_axis} below 1")
    keep = shape[lost_fraction_axis] // 2
    idx = [slice(None)] * len(names)
    idx[names.index(lost_fraction_axis)] = slice(0, keep)
    return DeviceMesh(mesh.device_type, mesh.mesh[tuple(idx)],
                      mesh_dim_names=names)
