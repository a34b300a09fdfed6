"""Partition specs and shard geometry over a named device mesh.

The reference leans on ``jax.sharding`` for this: a ``PartitionSpec`` names,
per array dimension, the mesh axes that dimension is split over, and a
``NamedSharding`` maps each device to its block.  The port keeps the same
vocabulary as plain data:

* :class:`P` is a spec: one entry per leading dimension, each ``None``
  (replicated), an axis name, or a tuple of axis names (split over their
  product, major to minor in the tuple's order).  Missing trailing entries
  are ``None``.  ``tuple(P(...))`` is the reference's ``tuple(PartitionSpec)``.
* A mesh is anything with an ordered ``shape`` mapping of axis name to size
  (:class:`repro_torch.launch.mesh.AbstractMesh`).  Devices are numbered
  row-major over the axes, as JAX numbers a mesh built from
  ``np.arange(n).reshape(shape)``; a ``torch.distributed`` rank is that
  number.
* :func:`shard_shape` / :func:`shard_index` give a device's block of an
  array, :func:`tree_device_bytes` a tree's bytes on one device.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Sequence, Tuple, Union

__all__ = [
    "P",
    "entry_axes",
    "spec_axes",
    "mesh_shape",
    "device_coords",
    "axes_size",
    "dim_splits",
    "shard_shape",
    "shard_index",
    "block_index",
    "is_spec",
    "spec_leaves",
    "spec_map",
    "tree_device_bytes",
]

Entry = Union[None, str, Tuple[str, ...]]


class P(tuple):
    """A partition spec: ``P(None, ("data", "model"), "model")``."""

    def __new__(cls, *entries: Entry):
        for e in entries:
            if not (e is None or isinstance(e, str)
                    or (isinstance(e, tuple) and all(isinstance(a, str) for a in e))):
                raise TypeError(f"a spec entry is None, an axis name or a tuple of names, got {e!r}")
        # a one-name tuple is that name and an empty one None, as JAX
        # normalises them
        return super().__new__(cls, (_normal(e) for e in entries))

    def __getnewargs__(self):  # pickle rebuilds P(*entries)
        return tuple(self)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(e) for e in self) + ")"


def _normal(e: Entry) -> Entry:
    if isinstance(e, tuple) and len(e) <= 1:
        return e[0] if e else None
    return e


def is_spec(x) -> bool:
    return isinstance(x, P)


def entry_axes(entry: Entry) -> Tuple[str, ...]:
    """The axes of one spec entry, major to minor."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def spec_axes(spec: Sequence[Entry]) -> Tuple[str, ...]:
    """Every axis a spec splits over, in dimension order (each at most once)."""
    out = tuple(a for e in spec for a in entry_axes(e))
    if len(set(out)) != len(out):
        raise ValueError(f"{spec!r} names an axis twice")
    return out


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis: size}`` in mesh order, from an abstract mesh or a
    ``DeviceMesh`` with dimension names."""
    if hasattr(mesh, "mesh_dim_names"):  # a torch DeviceMesh
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return dict(mesh.shape)


def axes_size(mesh, axes: Sequence[str]) -> int:
    shape = mesh_shape(mesh)
    return math.prod(shape[a] for a in axes)


def device_coords(mesh, device: int) -> Dict[str, int]:
    """Device ``device``'s coordinate on every axis (row-major numbering)."""
    shape = mesh_shape(mesh)
    coords = {}
    for name in reversed(list(shape)):
        coords[name] = device % shape[name]
        device //= shape[name]
    if device:
        raise ValueError("device number outside the mesh")
    return dict(reversed(list(coords.items())))


def dim_splits(spec: Sequence[Entry], ndim: int, mesh) -> Tuple[int, ...]:
    """Blocks along each dimension (1 where replicated)."""
    if len(spec) > ndim:
        raise ValueError(f"{spec!r} has more entries than the array's {ndim} dimensions")
    spec_axes(spec)
    return tuple(axes_size(mesh, entry_axes(spec[i]) if i < len(spec) else ()) for i in range(ndim))


def shard_shape(shape: Sequence[int], spec: Sequence[Entry], mesh) -> Tuple[int, ...]:
    """One device's block shape (an uneven split rounds up, as JAX pads)."""
    return tuple(-(-d // k) for d, k in zip(shape, dim_splits(spec, len(shape), mesh)))


def block_index(spec: Sequence[Entry], ndim: int, mesh, device: int) -> Tuple[int, ...]:
    """Device ``device``'s block number along each dimension: a dimension
    split over ``(a, b)`` is numbered ``coord(a) * size(b) + coord(b)``."""
    coords, shape = device_coords(mesh, device), mesh_shape(mesh)
    out = []
    for i in range(ndim):
        j = 0
        for a in entry_axes(spec[i] if i < len(spec) else None):
            j = j * shape[a] + coords[a]
        out.append(j)
    return tuple(out)


def shard_index(shape: Sequence[int], spec: Sequence[Entry], mesh, device: int
                ) -> Tuple[Tuple[int, int], ...]:
    """Device ``device``'s block as ``(start, stop)`` per dimension: the
    ``devices_indices_map`` of a ``NamedSharding`` on the same mesh."""
    block = shard_shape(shape, spec, mesh)
    idx = block_index(spec, len(shape), mesh, device)
    return tuple((j * b, min((j + 1) * b, d)) for j, b, d in zip(idx, block, shape))


def tree_device_bytes(shapes, specs, mesh) -> int:
    """Bytes one device holds of a tree of shaped leaves (tensors, or
    anything with ``shape`` and ``dtype``/``itemsize``) at a matching tree
    of specs; a Python int leaf is one int32 scalar, as the reference's
    index argument."""
    leaves, spec_leaves = _leaves(shapes), _leaves(specs, is_leaf=is_spec)
    if len(leaves) != len(spec_leaves):
        raise ValueError(f"{len(leaves)} leaves against {len(spec_leaves)} specs")
    total = 0
    for leaf, spec in zip(leaves, spec_leaves):
        if isinstance(leaf, int):
            total += 4
            continue
        itemsize = getattr(leaf, "itemsize", None) or leaf.dtype.itemsize
        total += math.prod(shard_shape(tuple(leaf.shape), spec, mesh)) * itemsize
    return total


def _leaves(tree, is_leaf=None) -> list:
    """Leaves in ``jax.tree`` order (dict keys sorted), specs kept whole."""
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    if tree is None:
        return []
    if isinstance(tree, Mapping):
        return [x for k in sorted(tree) for x in _leaves(tree[k], is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v, is_leaf)]
    return [tree]


def spec_leaves(specs) -> list:
    """The specs of a spec tree in ``jax.tree`` order."""
    return _leaves(specs, is_leaf=is_spec)


def spec_map(fn, specs, *trees):
    """``fn(spec, *leaves)`` over a spec tree and trees of its structure
    (a spec is a leaf there, though it is a tuple); returns the spec
    tree's structure.  A ``NamedTuple`` of specs is rebuilt as its type."""
    if is_spec(specs):
        return fn(specs, *trees)
    if specs is None:
        return None
    if isinstance(specs, Mapping):
        return {k: spec_map(fn, specs[k], *(t[k] for t in trees)) for k in specs}
    if isinstance(specs, tuple) and hasattr(specs, "_fields"):
        return type(specs)(*(spec_map(fn, s, *(t[i] for t in trees)) for i, s in enumerate(specs)))
    if isinstance(specs, (list, tuple)):
        return type(specs)(spec_map(fn, s, *(t[i] for t in trees)) for i, s in enumerate(specs))
    raise TypeError(f"not a spec tree node: {specs!r}")
