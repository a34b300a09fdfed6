"""The trees' subset DP of :mod:`.colorcoding`, in less device memory.

The same counts (Alon, Yuster and Zwick's DP, rooted at template vertex 0,
children merged in the same order), with two changes to what is live at
once.  A child's state is dropped as soon as its neighbour sum is made.
And the root, whose states are needed by no parent's neighbour sum, first
makes each child's neighbour sum in full and then walks its own merges one
block of graph vertices at a time, summing each block away: the root's
widest state (the 18-vertex tree ``u18`` of ``configs/rmat17-u18.json``
holds 48,620 color sets of 9 vertices there, 51 GB in float64 at 2^17
vertices) never exists whole.  Only the order of the final float64 sum
over vertices differs from :func:`.colorcoding.tree_colorful_count`.

Nothing here imports the program under test.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from .colorcoding import Adjacency, Edges, _merge, _pairing, num_vertices

#: most bytes of one block of the root's widest state
ROOT_BLOCK_BYTES = 4 << 30


def tree_colorful_count(adj: Adjacency, colors: torch.Tensor, edges: Edges) -> float:
    """Colorful maps of the tree ``edges`` under ``colors`` (``(n,)`` in
    ``[0, k)``), as :func:`.colorcoding.tree_colorful_count` counts them."""
    k = num_vertices(edges)
    nbrs: List[List[int]] = [[] for _ in range(k)]
    for u, v in edges:
        nbrs[u].append(v)
        nbrs[v].append(u)
    leaf = torch.nn.functional.one_hot(colors.to(torch.int64), k).to(torch.float64)
    tables: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}

    def table(a: int, b: int):
        if (a, b) not in tables:
            tables[(a, b)] = _pairing(k, a, b, colors.device)
        return tables[(a, b)]

    def summed_child(y: int, parent: int) -> Tuple[torch.Tensor, int]:
        child, size = state(y, parent)
        return adj.neighbour_sum(child), size

    def state(x: int, parent: int) -> Tuple[torch.Tensor, int]:
        own, size = leaf, 1
        for y in sorted(nbrs[x]):
            if y != parent:
                summed, child_size = summed_child(y, x)
                own = _merge(own, summed, *table(size, child_size))
                del summed
                size += child_size
        return own, size

    children = [summed_child(y, 0) for y in sorted(nbrs[0])]
    sizes = [1]
    for _, child_size in children:
        sizes.append(sizes[-1] + child_size)
    widest = max(math.comb(k, s) for s in sizes)
    rows = max(1, ROOT_BLOCK_BYTES // (8 * widest))
    total = 0.0
    for lo in range(0, adj.n, rows):
        own = leaf[lo:lo + rows]
        for (summed, child_size), size in zip(children, sizes):
            own = _merge(own, summed[lo:lo + rows], *table(size, child_size))
        total += float(own.sum())
    return total
