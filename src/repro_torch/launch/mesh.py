"""Production mesh: named axes over devices, abstract until realised.

The reference builds its meshes with ``jax.make_mesh`` on 256 or 512
(virtual) devices.  Here a mesh is first an :class:`AbstractMesh`: axis
names and sizes, nothing else, so building every dry-run cell touches no
device and no process group.  :func:`realize_mesh` turns it into a
``torch.distributed.device_mesh.DeviceMesh`` once a process group of the
mesh's size exists (gloo ranks in the tests, one NCCL rank per card).
Devices are numbered row-major over the axes; a device's number is its
``torch.distributed`` rank.

The shapes are the reference's, so every spec and cell compares equal:
(16, 16) ``("data", "model")`` for one pod, (2, 16, 16) ``("pod", "data",
"model")`` for two.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

__all__ = ["AbstractMesh", "make_production_mesh", "dp_axes", "all_axes", "realize_mesh"]


class AbstractMesh:
    """Named axes and their sizes: ``.shape`` (``{name: size}``, in axis
    order), ``.axis_names`` and ``.size`` (the device count)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} does not match axes {tuple(axis_names)}")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, (int(s) for s in shape)))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def devices_shape(self) -> Tuple[int, ...]:
        return tuple(self.shape.values())

    def __repr__(self) -> str:
        return f"AbstractMesh({self.devices_shape}, {self.axis_names})"


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """(16, 16) data x model for one pod (256 devices) or (2, 16, 16) pod x
    data x model for two (512)."""
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def dp_axes(mesh) -> Tuple[str, ...]:
    """Batch-like axes: ("pod", "data") on the multi-pod mesh."""
    return tuple(a for a in _names(mesh) if a in ("pod", "data"))


def all_axes(mesh) -> Tuple[str, ...]:
    return tuple(_names(mesh))


def _names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def realize_mesh(mesh: AbstractMesh, device_type: str = "cuda"):
    """``mesh`` as a ``DeviceMesh`` over ranks ``0 .. mesh.size - 1`` of the
    initialised default process group, laid out row-major.  Every rank of
    the group calls this (it builds one sub-group per axis)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError("realize_mesh needs torch.distributed initialised (init_process_group)")
    if dist.get_world_size() < mesh.size:
        raise ValueError(f"{mesh} needs {mesh.size} ranks, the group has {dist.get_world_size()}")
    ranks = torch.arange(mesh.size).reshape(mesh.devices_shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=mesh.axis_names)
