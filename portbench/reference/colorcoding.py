"""Plain color-coding estimates: the reference the benchmark judges against.

For a template ``H`` on ``k`` vertices and a coloring of the graph's
vertices with ``k`` colors, the colorful count is the number of
homomorphisms of ``H`` into the graph whose ``k`` images carry ``k``
distinct colors (such a map is injective, so it is an embedding).  The
estimate of the number of copies of ``H`` is that count over ``k!/k**k``
(the chance that a copy is colorful) and over ``|Aut(H)|``.

Two independent ways to count, both in float64:

* trees: the subset DP of Alon, Yuster and Zwick.  Rooted at vertex 0, a
  subtree's state holds, per graph vertex and per set of colors of the
  subtree's size, the colorful maps of the subtree that send its root
  there.  A child is merged by summing its state over each vertex's
  neighbours (a sparse product) and pairing disjoint color sets.
* graphs of treewidth 2 and at most 5 vertices (the triangle, the paw, the
  4-cycle): the sum over every bijection from template vertices to colors
  of the homomorphisms that respect it, each counted by eliminating
  template vertices one at a time over dense blocks of the adjacency,
  restricted to the vertices of each color.

Nothing here imports the program under test.
"""

from __future__ import annotations

import functools
import itertools
import math
import warnings
from typing import Dict, List, Sequence, Tuple

import torch

Edges = Sequence[Tuple[int, int]]


def num_vertices(edges: Edges) -> int:
    return max(max(u, v) for u, v in edges) + 1


def is_tree(edges: Edges) -> bool:
    return len({frozenset(e) for e in edges}) == num_vertices(edges) - 1


@functools.lru_cache(maxsize=None)
def _automorphisms(edges: Tuple[Tuple[int, int], ...]) -> int:
    k = num_vertices(edges)
    adj = [set() for _ in range(k)]
    for u, v in edges:
        adj[u].add(v)
        adj[v].add(u)
    order: List[int] = [0]  # a BFS order, so each vertex after the first has a mapped neighbour
    for x in order:
        for y in sorted(adj[x]):
            if y not in order:
                order.append(y)
    image = [-1] * k
    used = [False] * k

    def extend(i: int) -> int:
        if i == k:
            return 1
        x = order[i]
        total = 0
        for y in range(k):
            if used[y] or len(adj[y]) != len(adj[x]):
                continue
            if all((image[z] in adj[y]) == (z in adj[x]) for z in order[:i]):
                image[x], used[y] = y, True
                total += extend(i + 1)
                image[x], used[y] = -1, False
        return total

    return extend(0)


def automorphisms(edges: Edges) -> int:
    """|Aut(H)| by backtracking over vertex maps that keep adjacency."""
    return _automorphisms(tuple(tuple(int(x) for x in e) for e in edges))


def colorful_probability(k: int) -> float:
    return math.factorial(k) / k**k


class Adjacency:
    """The graph's adjacency in the forms the two counters use."""

    def __init__(self, src: torch.Tensor, dst: torch.Tensor, n: int, dense: bool):
        self.n = int(n)
        rows = dst.to(torch.int64)
        cols = src.to(torch.int64)
        order = torch.argsort(rows * self.n + cols)
        rows, cols = rows[order], cols[order]
        crow = torch.zeros(self.n + 1, dtype=torch.int64, device=src.device)
        crow[1:] = torch.cumsum(torch.bincount(rows, minlength=self.n), 0)
        with warnings.catch_warnings():  # CSR support is "beta"; its invariants hold here
            warnings.simplefilter("ignore", UserWarning)
            self.csr = torch.sparse_csr_tensor(
                crow, cols, torch.ones(cols.numel(), dtype=torch.float64, device=src.device),
                size=(self.n, self.n))
        self.dense = None
        if dense:
            self.dense = torch.zeros((self.n, self.n), dtype=torch.float64, device=src.device)
            self.dense[rows, cols] = 1.0

    def neighbour_sum(self, state: torch.Tensor) -> torch.Tensor:
        """``(n, C)`` -> ``(n, C)``: row ``v`` sums the rows of ``v``'s
        neighbours."""
        return torch.sparse.mm(self.csr, state)


def _color_sets(k: int, size: int) -> Dict[Tuple[int, ...], int]:
    return {s: i for i, s in enumerate(itertools.combinations(range(k), size))}


def _pairing(k: int, a: int, b: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each color set of size ``a + b``, its splits into a set of size
    ``a`` and the rest: two ``(outputs, splits)`` index tables."""
    sets_a, sets_b, sets_c = _color_sets(k, a), _color_sets(k, b), _color_sets(k, a + b)
    idx_a, idx_b = [], []
    for c in sets_c:
        row_a, row_b = [], []
        for part in itertools.combinations(c, a):
            row_a.append(sets_a[part])
            row_b.append(sets_b[tuple(x for x in c if x not in part)])
        idx_a.append(row_a)
        idx_b.append(row_b)
    return (torch.tensor(idx_a, dtype=torch.int64, device=device),
            torch.tensor(idx_b, dtype=torch.int64, device=device))


def _merge(own: torch.Tensor, child: torch.Tensor, idx_a, idx_b,
           block_bytes: int = 1 << 30) -> torch.Tensor:
    """``out[v, C] = sum over splits (A, B) of C of own[v, A] * child[v, B]``."""
    n = own.shape[0]
    outs, splits = idx_a.shape
    out = torch.empty((n, outs), dtype=own.dtype, device=own.device)
    rows = max(1, block_bytes // (8 * outs))
    for lo in range(0, n, rows):
        a, b = own[lo:lo + rows], child[lo:lo + rows]
        acc = torch.zeros((a.shape[0], outs), dtype=own.dtype, device=own.device)
        for j in range(splits):
            acc += a[:, idx_a[:, j]] * b[:, idx_b[:, j]]
        out[lo:lo + rows] = acc
    return out


def tree_colorful_count(adj: Adjacency, colors: torch.Tensor, edges: Edges) -> float:
    """Colorful maps of the tree ``edges`` under ``colors`` (``(n,)`` in
    ``[0, k)``): the subset DP, rooted at template vertex 0."""
    k = num_vertices(edges)
    nbrs = [[] for _ in range(k)]
    for u, v in edges:
        nbrs[u].append(v)
        nbrs[v].append(u)
    leaf = torch.nn.functional.one_hot(colors.to(torch.int64), k).to(torch.float64)
    tables: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}

    def state(x: int, parent: int) -> Tuple[torch.Tensor, int]:
        own, size = leaf, 1
        for y in sorted(nbrs[x]):
            if y == parent:
                continue
            child, child_size = state(y, x)
            if (size, child_size) not in tables:
                tables[(size, child_size)] = _pairing(k, size, child_size, colors.device)
            own = _merge(own, adj.neighbour_sum(child), *tables[(size, child_size)])
            size += child_size
        return own, size

    root, _ = state(0, -1)
    return float(root.sum())


def _eliminate(adj: Adjacency, supports: List[torch.Tensor], edges: Edges) -> float:
    """Homomorphisms of ``edges`` that send template vertex ``x`` into the
    graph vertices ``supports[x]``, by eliminating vertices of at most two
    remaining neighbours."""
    k = len(supports)
    unary: Dict[int, torch.Tensor] = {}
    binary: Dict[Tuple[int, int], torch.Tensor] = {}  # (x, y), x < y: |S_x| x |S_y|

    def put_binary(x, y, mat):
        if x > y:
            x, y, mat = y, x, mat.t()
        binary[(x, y)] = binary[(x, y)] * mat if (x, y) in binary else mat

    for u, v in {tuple(sorted(e)) for e in edges}:
        put_binary(u, v, adj.dense[supports[u]][:, supports[v]])
    scalar = 1.0
    remaining = set(range(k))
    while remaining:
        def others(x):
            return {y for pair in binary for y in pair if x in pair and y != x and y in remaining}

        v = min(sorted(remaining), key=lambda x: len(others(x)))
        near = sorted(others(v))
        weight = unary.pop(v, torch.ones(supports[v].numel(), dtype=torch.float64,
                                         device=supports[v].device))
        mats = {}
        for y in near:
            mats[y] = binary.pop((v, y)) if (v, y) in binary else binary.pop((y, v)).t()
        if not near:
            scalar *= float(weight.sum())
        elif len(near) == 1:
            (u,) = near
            vec = mats[u].t() @ weight  # mats[u] is |S_v| x |S_u|
            unary[u] = unary[u] * vec if u in unary else vec
        elif len(near) == 2:
            u, w = near
            put_binary(u, w, (mats[u].t() * weight[None, :]) @ mats[w])
        else:
            raise ValueError("template vertex with more than two remaining neighbours: "
                             "treewidth above 2 is not supported")
        remaining.discard(v)
        if scalar == 0.0:
            return 0.0
    return scalar


def graph_colorful_count(adj: Adjacency, colors: torch.Tensor, edges: Edges) -> float:
    """Colorful maps of a small template of treewidth at most 2: the sum over
    bijections ``sigma`` from template vertices to colors."""
    k = num_vertices(edges)
    if k > 5:
        raise ValueError("the bijection sum is for templates of at most 5 vertices")
    if adj.dense is None:
        raise ValueError("the bijection sum needs the dense adjacency")
    by_color = [torch.nonzero(colors == c).flatten() for c in range(k)]
    total = 0.0
    for sigma in itertools.permutations(range(k)):
        total += _eliminate(adj, [by_color[sigma[x]] for x in range(k)], edges)
    return total


def colorful_count(adj: Adjacency, colors: torch.Tensor, edges: Edges) -> float:
    if is_tree(edges):
        return tree_colorful_count(adj, colors, edges)
    return graph_colorful_count(adj, colors, edges)


def estimate(adj: Adjacency, colors: torch.Tensor, edges: Edges) -> float:
    """The copies of ``H`` that this coloring estimates."""
    k = num_vertices(edges)
    return colorful_count(adj, colors, edges) / (colorful_probability(k) * automorphisms(edges))
