"""Parameter and state trees in ``jax.tree``'s order.

A tree is nested dicts, lists, tuples and ``NamedTuple``s over leaves
(tensors, numpy arrays, numbers).  The leaves are ordered as
``jax.tree.flatten`` orders them: dict keys sorted, sequence and
``NamedTuple`` fields in order; ``None`` is an empty subtree.  Checkpoints
number their leaves in this order, so either package restores the
other's.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

__all__ = ["tree_flatten", "tree_unflatten", "tree_leaves", "tree_map"]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_flatten(tree) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)``; ``tree_unflatten(treedef, leaves)`` rebuilds it."""
    leaves: List[Any] = []

    def walk(x):
        if x is None:
            return None
        if isinstance(x, dict):
            keys = sorted(x)
            return (dict, keys, [walk(x[k]) for k in keys])
        if _is_namedtuple(x):
            return (type(x), None, [walk(v) for v in x])
        if isinstance(x, (list, tuple)):
            return (type(x), None, [walk(v) for v in x])
        leaves.append(x)
        return "leaf"

    treedef = walk(tree)
    return leaves, treedef


def tree_unflatten(treedef, leaves) -> Any:
    it = iter(leaves)

    def build(d):
        if d is None:
            return None
        if d == "leaf":
            return next(it)
        kind, keys, children = d
        values = [build(c) for c in children]
        if kind is dict:
            return dict(zip(keys, values))
        if kind in (list, tuple):
            return kind(values)
        return kind(*values)  # a NamedTuple

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of each of
    ``rest`` (trees of the same structure)."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r) for r in rest]
    for other_leaves, other_def in others:
        if other_def != treedef:
            raise ValueError("tree_map over trees of different structure")
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *(o[0] for o in others))])
