"""Elastic scaling: the mesh a shrunken (or grown) set of devices can hold,
and a host tree placed on it.

The decision logic of restore-based elasticity (checkpoint, shrink,
restore): ``plan_elastic_mesh`` picks the largest valid ``(data, model)``
shape from the surviving device count, ``survivors_after_failure`` drops
the failed devices, and ``reshard_tree`` places a restored host (numpy)
tree on the new mesh at its partition specs (the LM's
``transformer.param_pspecs`` or a cell's specs); ``gather_tree`` brings
the shards back whole.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

__all__ = ["plan_elastic_mesh", "reshard_tree", "gather_tree", "survivors_after_failure"]


def survivors_after_failure(devices: Sequence, failed_indices: Sequence[int]) -> list:
    failed = set(failed_indices)
    return [d for i, d in enumerate(devices) if i not in failed]


def plan_elastic_mesh(
    n_devices: int,
    axis_names: Tuple[str, ...] = ("data", "model"),
    model_parallel: int = 2,
) -> Tuple[int, ...]:
    """Largest ``(data, model)`` shape with ``model_parallel`` fixed and data
    as large as the surviving devices allow (the remainder is dropped).
    Raises if fewer than one model-parallel group survives."""
    if n_devices < model_parallel:
        raise ValueError(f"{n_devices} devices cannot host model_parallel={model_parallel}")
    return (n_devices // model_parallel, model_parallel)


def reshard_tree(tree, mesh, pspecs):
    """This rank's shards of a host (numpy) tree on ``mesh``, a realised
    ``DeviceMesh`` with dimension names (:func:`repro_torch.launch.mesh.
    realize_mesh`): each leaf's block at its spec (:func:`repro_torch.core.
    sharding.shard_index`), as a tensor on the mesh's device type.  A rank
    outside the mesh gets ``None``."""
    import torch

    from repro_torch.core.sharding import shard_index, spec_map

    rank = _mesh_rank(mesh)
    if rank is None:
        return None
    device = torch.device(mesh.device_type, torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device(mesh.device_type)

    def put(spec, x):
        x = np.asarray(x)
        block = tuple(slice(a, b) for a, b in shard_index(x.shape, spec, mesh, rank))
        return torch.as_tensor(np.ascontiguousarray(x[block]), device=device)

    return spec_map(put, pspecs, tree)


def gather_tree(local, mesh, pspecs, shapes):
    """The whole tree back from every rank's shards (:func:`reshard_tree`'s
    inverse), as numpy arrays on every rank of ``mesh``: one all-gather of
    each leaf's flattened block over the mesh's ranks.  ``shapes`` is a
    tree of the leaves' whole shapes (arrays or tuples).  The mesh spans
    the default group."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.sharding import shard_index, spec_map

    flat = mesh.mesh.reshape(-1).tolist()
    group = _flat_group(mesh)

    def get(spec, x, shape):
        shape = tuple(np.shape(shape)) if not isinstance(shape, tuple) else shape
        parts = [torch.empty_like(x) for _ in flat]
        dist.all_gather(parts, x.contiguous(), group=group)
        out = np.empty(shape, dtype=parts[0].cpu().numpy().dtype)
        for r, part in zip(sorted(flat), parts):  # group ranks in ascending order
            block = shard_index(shape, spec, mesh, flat.index(r))
            out[tuple(slice(a, b) for a, b in block)] = part.cpu().numpy()
        return out

    return spec_map(get, pspecs, local, shapes)


def _mesh_rank(mesh):
    """This process's device number on ``mesh`` (row-major), or ``None``."""
    import torch.distributed as dist

    flat = mesh.mesh.reshape(-1).tolist()
    me = dist.get_rank()
    return flat.index(me) if me in flat else None


def _flat_group(mesh):
    """The default group, which ``mesh`` must span."""
    import torch.distributed as dist

    if sorted(mesh.mesh.reshape(-1).tolist()) != list(range(dist.get_world_size())):
        raise ValueError("gather_tree needs a mesh over every rank of the default group")
    return dist.group.WORLD
