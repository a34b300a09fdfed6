"""Templates (trees AND general graphs), partitioning, tree decompositions.

A *template* is a connected graph on ``k`` vertices labeled ``0..k-1``.  Two
compilation routes feed the color-coding DP:

**Trees** (the paper's case) are partitioned into a binary recursion tree of
*sub-templates* (paper §II-C / Fig 2):

* pick a root ``rho`` of ``T``;
* cut one edge ``(rho, tau)`` adjacent to the root — the child keeping ``rho``
  is the **active** child, the child rooted at ``tau`` is the **passive**
  child;
* recurse until every sub-template is a single vertex.

``partition_template`` returns the sub-templates in *topological order*
(children before parents) so the DP can run as a single forward pass.

**General templates** (triangles, cycles, cliques, graphlets) compile through
a *tree decomposition* instead (Chakaravarthy et al., arXiv:1602.04478): the
colorful-counting recurrence runs over decomposition bags, and because a
colorful homomorphism is automatically injective (its ``k`` images carry
pairwise-distinct colors), counting colorful homs over the bags counts
colorful embeddings times ``|Aut(H)|`` — the same normalization as trees.
``build_tree_decomposition`` finds a (minimum-width for small ``k``) rooted
decomposition and ``build_bag_program`` lowers it to a linear *bag program*
of leaf / extend / forget / join ops whose states generalize the tree DP's
``M`` matrices to one vertex axis per live bag vertex.  Rooted trees are
exactly the treewidth-1 special case (single-axis states, no joins).

A copy of ``repro.core.templates`` (the port imports nothing of the JAX
package); canonical forms and partitions are identical to the reference's.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from functools import lru_cache
from math import factorial
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

import numpy as np

__all__ = [
    "Template",
    "SubTemplate",
    "TemplatePartition",
    "partition_template",
    "sub_template_canonical",
    "tree_automorphisms",
    "graph_automorphisms",
    "TreeDecomposition",
    "build_tree_decomposition",
    "BagOp",
    "BagProgram",
    "build_bag_program",
    "bag_state_canonical",
    "path_template",
    "star_template",
    "binary_tree_template",
    "random_tree_template",
    "cycle_template",
    "clique_template",
    "diamond_template",
    "connected_graphlets",
    "PAPER_TEMPLATES",
    "GRAPHLET_TEMPLATES",
    "get_template",
]


@dataclass(frozen=True)
class Template:
    """An unrooted connected template on ``k`` vertices (tree or not)."""

    name: str
    edges: Tuple[Tuple[int, int], ...]

    @property
    def k(self) -> int:
        # Connected ⇒ every vertex of a >=2-vertex template appears in an
        # edge, so the label range determines k (for trees this equals the
        # historical ``len(edges) + 1``).
        if not self.edges:
            return 1
        return max(max(u, v) for u, v in self.edges) + 1

    @property
    def is_tree(self) -> bool:
        """Acyclic (``|E| = k - 1``); ``validate()`` covers connectivity."""
        return len({frozenset(e) for e in self.edges}) == self.k - 1

    def adjacency(self) -> List[List[int]]:
        adj: List[List[int]] = [[] for _ in range(self.k)]
        for u, v in self.edges:
            adj[u].append(v)
            adj[v].append(u)
        return adj

    def edge_set(self) -> FrozenSet[FrozenSet[int]]:
        return frozenset(frozenset(e) for e in self.edges)

    def validate(self) -> None:
        k = self.k
        seen = {u for e in self.edges for u in e}
        if self.edges and (max(seen) >= k or min(seen) < 0):
            raise ValueError(f"template {self.name}: vertex labels must be 0..{k-1}")
        if self.edges and len(seen) != k:
            raise ValueError(f"template {self.name}: not connected")
        for u, v in self.edges:
            if u == v:
                raise ValueError(f"template {self.name}: self-loop at {u}")
        if len(self.edge_set()) != len(self.edges):
            raise ValueError(f"template {self.name}: duplicate edges")
        adj = self.adjacency()
        stack, visited = [0], {0}
        while stack:
            u = stack.pop()
            for v in adj[u]:
                if v not in visited:
                    visited.add(v)
                    stack.append(v)
        if len(visited) != k:
            raise ValueError(f"template {self.name}: not connected")


@dataclass(frozen=True)
class SubTemplate:
    """One node of the partition recursion tree.

    ``vertices`` is the subset of template vertices covered; ``root`` the
    rooted vertex.  Non-leaf sub-templates reference their active / passive
    children by index into ``TemplatePartition.subs``.
    """

    vertices: Tuple[int, ...]
    root: int
    active: Optional[int]  # index into partition list, or None for leaves
    passive: Optional[int]

    @property
    def size(self) -> int:
        return len(self.vertices)

    @property
    def is_leaf(self) -> bool:
        return self.active is None


@dataclass(frozen=True)
class TemplatePartition:
    """Topologically-ordered sub-template list; ``subs[-1]`` is the full T."""

    template: Template
    subs: Tuple[SubTemplate, ...]

    @property
    def root_index(self) -> int:
        return len(self.subs) - 1

    def stage_sizes(self) -> List[Tuple[int, int, int]]:
        """(m, m_a, m_p) for every non-leaf sub-template, in DP order."""
        out = []
        for s in self.subs:
            if not s.is_leaf:
                a = self.subs[s.active]
                p = self.subs[s.passive]
                out.append((s.size, a.size, p.size))
        return out


def partition_template(template: Template, root: Optional[int] = None) -> TemplatePartition:
    """FASCIA-style single-edge-cut partition into a binary recursion tree.

    The root defaults to a maximum-degree vertex (keeps the active chain long
    and passive subtrees small, which minimizes the number of distinct
    ``(m, m_p)`` SpMM column counts).
    """
    template.validate()
    if not template.is_tree:
        raise ValueError(
            f"template {template.name}: partition_template requires a tree; "
            "non-tree templates compile via build_bag_program"
        )
    adj = template.adjacency()
    if root is None:
        root = int(np.argmax([len(a) for a in adj]))

    subs: List[SubTemplate] = []

    def subtree_vertices(start: int, blocked: int) -> Tuple[int, ...]:
        """Vertices reachable from ``start`` without crossing ``blocked``."""
        out, stack, seen = [], [start], {start, blocked}
        while stack:
            u = stack.pop()
            out.append(u)
            for v in adj[u]:
                if v not in seen:
                    seen.add(v)
                    stack.append(v)
        return tuple(sorted(out))

    def rec(vertices: Tuple[int, ...], rho: int) -> int:
        if len(vertices) == 1:
            subs.append(SubTemplate(vertices=vertices, root=rho, active=None, passive=None))
            return len(subs) - 1
        vset = set(vertices)
        # Cut the first root-adjacent edge (deterministic: smallest neighbor).
        taus = sorted(v for v in adj[rho] if v in vset)
        tau = taus[0]
        passive_vertices = tuple(v for v in subtree_vertices(tau, rho) if v in vset)
        active_vertices = tuple(sorted(vset - set(passive_vertices)))
        a_idx = rec(active_vertices, rho)
        p_idx = rec(passive_vertices, tau)
        subs.append(SubTemplate(vertices=vertices, root=rho, active=a_idx, passive=p_idx))
        return len(subs) - 1

    rec(tuple(sorted(range(template.k))), root)
    return TemplatePartition(template=template, subs=tuple(subs))


def sub_template_canonical(template: Template, vertices: Tuple[int, ...], root: int) -> str:
    """AHU canonical string of the rooted sub-template induced by ``vertices``.

    Two sub-templates with equal strings have identical count matrices
    ``M_s`` for every coloring — the key used by the engine backends to share
    DP state and SpMM products across templates (and across stages within one
    template).
    """
    allowed = set(vertices)
    adj: Dict[int, List[int]] = {v: [] for v in vertices}
    for u, v in template.edges:
        if u in allowed and v in allowed:
            adj[u].append(v)
            adj[v].append(u)

    def canon(node: int, parent: int) -> str:
        forms = sorted(canon(c, node) for c in adj[node] if c != parent)
        return "(" + "".join(forms) + ")"

    return canon(root, -1)


# ---------------------------------------------------------------------------
# Automorphism counting (AHU canonical forms).
# ---------------------------------------------------------------------------


def _rooted_canon_and_aut(adj: Sequence[Sequence[int]], root: int, parent: int) -> Tuple[str, int]:
    """AHU canonical string + automorphism count of the subtree at ``root``."""
    forms: List[str] = []
    aut = 1
    for child in adj[root]:
        if child == parent:
            continue
        f, a = _rooted_canon_and_aut(adj, child, root)
        forms.append(f)
        aut *= a
    forms.sort()
    counts: Dict[str, int] = {}
    for f in forms:
        counts[f] = counts.get(f, 0) + 1
    for c in counts.values():
        aut *= factorial(c)
    return "(" + "".join(forms) + ")", aut


def tree_automorphisms(template: Template) -> int:
    """|Aut(T)| of an unrooted tree via its center(s)."""
    template.validate()
    k = template.k
    if k == 1:
        return 1
    adj = [list(a) for a in template.adjacency()]
    # Peel leaves to find the 1- or 2-vertex center.
    degree = [len(a) for a in adj]
    remaining = k
    layer = [v for v in range(k) if degree[v] <= 1]
    removed = [False] * k
    while remaining > 2:
        nxt = []
        for v in layer:
            removed[v] = True
            remaining -= 1
            for u in adj[v]:
                if not removed[u]:
                    degree[u] -= 1
                    if degree[u] == 1:
                        nxt.append(u)
        layer = nxt
    centers = [v for v in range(k) if not removed[v]]
    if len(centers) == 1:
        _, aut = _rooted_canon_and_aut(adj, centers[0], -1)
        return aut
    c1, c2 = centers
    f1, a1 = _rooted_canon_and_aut(adj, c1, c2)
    f2, a2 = _rooted_canon_and_aut(adj, c2, c1)
    aut = a1 * a2
    if f1 == f2:
        aut *= 2  # the edge flip
    return aut


@lru_cache(maxsize=None)
def graph_automorphisms(template: Template) -> int:
    """|Aut(H)| of a general connected template.

    Trees go through the linear-time AHU path; everything else brute-forces
    the k! vertex bijections (graphlet templates have k <= 8, where this is
    at most 40320 cheap set-membership checks).
    """
    template.validate()
    if template.is_tree:
        return tree_automorphisms(template)
    k = template.k
    if k > 8:
        raise ValueError(f"template {template.name}: automorphism search capped at k=8 (got k={k})")
    edges = template.edge_set()
    count = 0
    for perm in itertools.permutations(range(k)):
        if all(frozenset((perm[u], perm[v])) in edges for u, v in template.edges):
            count += 1
    return count


# ---------------------------------------------------------------------------
# Template constructors and the paper's template library.
# ---------------------------------------------------------------------------


def path_template(k: int, name: Optional[str] = None) -> Template:
    return Template(name or f"path{k}", tuple((i, i + 1) for i in range(k - 1)))


def star_template(k: int, name: Optional[str] = None) -> Template:
    return Template(name or f"star{k}", tuple((0, i) for i in range(1, k)))


def binary_tree_template(k: int, name: Optional[str] = None) -> Template:
    """Complete-ish binary tree on k vertices (heap numbering)."""
    return Template(name or f"bintree{k}", tuple(((i - 1) // 2, i) for i in range(1, k)))


def random_tree_template(k: int, seed: int, name: Optional[str] = None) -> Template:
    """Uniform random labeled tree from a Prüfer sequence (deterministic)."""
    rng = np.random.default_rng(seed)
    if k == 1:
        return Template(name or f"rand{k}", ())
    if k == 2:
        return Template(name or f"rand{k}", ((0, 1),))
    prufer = rng.integers(0, k, size=k - 2)
    degree = np.ones(k, dtype=np.int64)
    for x in prufer:
        degree[x] += 1
    edges = []
    import heapq

    leaves = [v for v in range(k) if degree[v] == 1]
    heapq.heapify(leaves)
    for x in prufer:
        leaf = heapq.heappop(leaves)
        edges.append((int(leaf), int(x)))
        degree[leaf] -= 1
        degree[x] -= 1
        if degree[x] == 1:
            heapq.heappush(leaves, int(x))
    u, v = [v for v in range(k) if degree[v] == 1][:2]
    edges.append((u, v))
    return Template(name or f"rand{k}", tuple(edges))


def cycle_template(k: int, name: Optional[str] = None) -> Template:
    if k < 3:
        raise ValueError(f"cycle requires k >= 3, got {k}")
    return Template(name or f"cycle{k}", tuple((i, i + 1) for i in range(k - 1)) + ((0, k - 1),))


def clique_template(k: int, name: Optional[str] = None) -> Template:
    return Template(name or f"clique{k}", tuple(itertools.combinations(range(k), 2)))


def diamond_template(name: str = "diamond") -> Template:
    """K4 minus one edge: two triangles sharing edge (1, 2)."""
    return Template(name, ((0, 1), (0, 2), (1, 2), (1, 3), (2, 3)))


def _graph_canonical_edges(k: int, edges: Tuple[Tuple[int, int], ...]) -> Tuple[Tuple[int, int], ...]:
    """Lexicographically-minimal relabeling of an edge set (graph canon)."""
    best = None
    for perm in itertools.permutations(range(k)):
        relabeled = tuple(sorted(tuple(sorted((perm[u], perm[v]))) for u, v in edges))
        if best is None or relabeled < best:
            best = relabeled
    return best


@lru_cache(maxsize=None)
def connected_graphlets(k: int) -> Tuple[Template, ...]:
    """All connected k-vertex templates up to isomorphism, deterministically
    labeled/ordered (by edge count, then canonical edge list).

    Sizes: k=2 -> 1, k=3 -> 2, k=4 -> 6, k=5 -> 21.
    """
    if not 1 <= k <= 6:
        raise ValueError(f"connected_graphlets supports 1 <= k <= 6, got {k}")
    if k == 1:
        return (Template("g1-0", ()),)
    all_edges = list(itertools.combinations(range(k), 2))
    canons: Set[Tuple[Tuple[int, int], ...]] = set()
    for bits in range(1 << len(all_edges)):
        edges = tuple(e for i, e in enumerate(all_edges) if (bits >> i) & 1)
        if len(edges) < k - 1:
            continue
        # Connectivity over all k vertices.
        adj: Dict[int, List[int]] = {v: [] for v in range(k)}
        for u, v in edges:
            adj[u].append(v)
            adj[v].append(u)
        stack, seen = [0], {0}
        while stack:
            u = stack.pop()
            for v in adj[u]:
                if v not in seen:
                    seen.add(v)
                    stack.append(v)
        if len(seen) != k:
            continue
        canons.add(_graph_canonical_edges(k, edges))
    ordered = sorted(canons, key=lambda es: (len(es), es))
    return tuple(Template(f"g{k}-{i}", es) for i, es in enumerate(ordered))


def _u5_2() -> Template:
    # 5-vertex "chair": path 0-1-2-3 with 4 hanging off 1.
    return Template("u5-2", ((0, 1), (1, 2), (2, 3), (1, 4)))


def _u7() -> Template:
    # FASCIA's u7: two cherries joined by a center path.
    return Template("u7", ((0, 1), (1, 2), (1, 3), (0, 4), (4, 5), (4, 6)))


def _u10() -> Template:
    return Template(
        "u10",
        ((0, 1), (1, 2), (2, 3), (1, 4), (4, 5), (0, 6), (6, 7), (6, 8), (8, 9)),
    )


def _u12() -> Template:
    # Paper Fig 6(b) family: balanced tree of depth ~3.
    return Template(
        "u12",
        (
            (0, 1), (0, 2), (1, 3), (1, 4), (2, 5), (2, 6),
            (3, 7), (4, 8), (5, 9), (6, 10), (10, 11),
        ),
    )


PAPER_TEMPLATES: Dict[str, Template] = {
    "u3": path_template(3, "u3"),
    "u5-1": path_template(5, "u5-1"),
    "u5-2": _u5_2(),
    "u6": binary_tree_template(6, "u6"),
    "u7": _u7(),
    "u10": _u10(),
    "u12": _u12(),
    "u13": random_tree_template(13, seed=13, name="u13"),
    "u14": random_tree_template(14, seed=14, name="u14"),
    "u15-1": random_tree_template(15, seed=151, name="u15-1"),
    "u15-2": random_tree_template(15, seed=152, name="u15-2"),
    "u16": random_tree_template(16, seed=16, name="u16"),
    "u17": random_tree_template(17, seed=17, name="u17"),
    "u18": random_tree_template(18, seed=18, name="u18"),
    "u20": random_tree_template(20, seed=20, name="u20"),
}


GRAPHLET_TEMPLATES: Dict[str, Template] = {
    "triangle": cycle_template(3, "triangle"),
    "square": cycle_template(4, "square"),
    "diamond": diamond_template(),
    "cycle5": cycle_template(5, "cycle5"),
    "clique4": clique_template(4, "clique4"),
    "clique5": clique_template(5, "clique5"),
}


def get_template(name: str) -> Template:
    if name in PAPER_TEMPLATES:
        return PAPER_TEMPLATES[name]
    if name in GRAPHLET_TEMPLATES:
        return GRAPHLET_TEMPLATES[name]
    if name.startswith("path"):
        return path_template(int(name[4:]))
    if name.startswith("star"):
        return star_template(int(name[4:]))
    if name.startswith("bintree"):
        return binary_tree_template(int(name[7:]))
    if name.startswith("cycle"):
        return cycle_template(int(name[5:]))
    if name.startswith("clique"):
        return clique_template(int(name[6:]))
    known = sorted(PAPER_TEMPLATES) + sorted(GRAPHLET_TEMPLATES)
    raise KeyError(f"unknown template {name!r}; known: {known}")


# ---------------------------------------------------------------------------
# Tree decompositions (general templates).
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TreeDecomposition:
    """A rooted tree decomposition of a template.

    ``bags[i]`` is a sorted vertex tuple; ``parent[i]`` indexes the parent
    bag (-1 for the root).  The standard properties hold: every template
    edge lies inside some bag, and for every vertex the bags containing it
    form a connected subtree.  ``width`` = max bag size - 1 (trees: 1).
    """

    template: Template
    bags: Tuple[Tuple[int, ...], ...]
    parent: Tuple[int, ...]
    width: int

    @property
    def root_index(self) -> int:
        return self.parent.index(-1)

    def children(self) -> List[List[int]]:
        out: List[List[int]] = [[] for _ in self.bags]
        for i, p in enumerate(self.parent):
            if p >= 0:
                out[p].append(i)
        return out


def _elimination_width(adj: Sequence[Set[int]], order: Sequence[int]) -> int:
    """Width of the elimination order (max |later-neighbors| after fill-in)."""
    fill = [set(a) for a in adj]
    eliminated: Set[int] = set()
    width = 0
    for v in order:
        nbrs = fill[v] - eliminated
        width = max(width, len(nbrs))
        for a in nbrs:
            fill[a].update(nbrs)
            fill[a].discard(a)
        eliminated.add(v)
    return width


def _min_fill_order(adj: Sequence[Set[int]]) -> List[int]:
    """Greedy min-fill elimination order (exact on chordal graphs and trees)."""
    k = len(adj)
    fill = [set(a) for a in adj]
    remaining = set(range(k))
    order: List[int] = []
    while remaining:
        best_v, best_cost = -1, None
        for v in sorted(remaining):
            nbrs = fill[v] & remaining - {v}
            cost = sum(1 for a, b in itertools.combinations(sorted(nbrs), 2) if b not in fill[a])
            if best_cost is None or cost < best_cost:
                best_v, best_cost = v, cost
        nbrs = fill[best_v] & remaining - {best_v}
        for a in nbrs:
            fill[a].update(nbrs)
            fill[a].discard(a)
        order.append(best_v)
        remaining.discard(best_v)
    return order


@lru_cache(maxsize=None)
def build_tree_decomposition(template: Template) -> TreeDecomposition:
    """Minimum-width rooted tree decomposition (exact for k <= 8).

    Elimination-order construction: min-fill greedy first; if that is not
    already optimal-by-construction (width 1, i.e. a tree) and the template
    is small, an exhaustive search over the k! orders finds the true
    treewidth (early exit at width 2, the minimum for any non-tree).
    Redundant bags (subsets of a neighbor) are pruned, so trees yield the
    familiar one-bag-per-edge decomposition.
    """
    template.validate()
    k = template.k
    adj = [set(a) for a in template.adjacency()]
    order = _min_fill_order(adj)
    width = _elimination_width(adj, order)
    if width > 1 and k <= 8:
        floor = 2  # non-trees can never do better than treewidth 2
        for perm in itertools.permutations(range(k)):
            w = _elimination_width(adj, perm)
            if w < width:
                order, width = list(perm), w
                if width <= floor:
                    break

    # Re-run the elimination to materialize bags.
    pos = {v: i for i, v in enumerate(order)}
    fill = [set(a) for a in adj]
    eliminated: Set[int] = set()
    bags: List[Tuple[int, ...]] = []
    for v in order:
        nbrs = fill[v] - eliminated
        bags.append(tuple(sorted({v} | nbrs)))
        for a in nbrs:
            fill[a].update(nbrs)
            fill[a].discard(a)
        eliminated.add(v)
    # parent(bag of v) = bag of the earliest-eliminated later-neighbor.
    parent: List[int] = []
    for i, v in enumerate(order):
        rest = [u for u in bags[i] if u != v]
        parent.append(min((pos[u] for u in rest), default=-1))

    # Prune bags subsumed by a tree-neighbor.
    bag_of: Dict[int, Set[int]] = {i: set(b) for i, b in enumerate(bags)}
    par: Dict[int, int] = {i: p for i, p in enumerate(parent)}
    changed = True
    while changed:
        changed = False
        for i in sorted(par):
            p = par[i]
            if p < 0:
                continue
            if bag_of[i] <= bag_of[p]:
                for j in par:
                    if par[j] == i:
                        par[j] = p
                del par[i], bag_of[i]
                changed = True
                break
            if bag_of[p] <= bag_of[i]:
                gp = par[p]
                for j in par:
                    if par[j] == p and j != i:
                        par[j] = i
                par[i] = gp
                del par[p], bag_of[p]
                changed = True
                break
    keep = sorted(par)
    remap = {old: new for new, old in enumerate(keep)}
    final_bags = tuple(tuple(sorted(bag_of[i])) for i in keep)
    final_parent = tuple(remap[par[i]] if par[i] >= 0 else -1 for i in keep)
    return TreeDecomposition(template=template, bags=final_bags, parent=final_parent, width=width)


# ---------------------------------------------------------------------------
# Bag programs: lowering a tree decomposition to a linear DP op sequence.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BagOp:
    """One step of a bag program.

    The DP state after an op is a tensor of shape ``(n,) * len(axes) + (B,
    C(k, m))`` where ``axes`` is the sorted tuple of template vertices kept
    as graph-vertex axes and ``m = len(covered)`` is the colorset width —
    entry ``[u_a1, ..., u_ar, b, S]`` counts colorful homomorphisms of the
    subgraph induced by ``covered`` that map axis vertex ``a_i`` to graph
    vertex ``u_ai`` and use exactly the colors ``S`` under coloring ``b``.
    Rooted-tree DP states are the ``len(axes) == 1`` special case.

    Kinds:

    * ``"leaf"``   — materialize the one-hot state of single ``vertex``.
    * ``"extend"`` — introduce ``vertex`` as a new axis.  If ``spmm_vertex``
      is set, that input axis is contracted through the adjacency matrix
      (``backend.spmm``), applying edge ``(spmm_vertex, vertex)``; every
      edge ``(vertex, x)`` for ``x`` in ``mask_vertices`` is applied as a
      dense-adjacency mask; colorset columns are updated against the
      vertex's one-hot leaf via ``SplitTable(k, m, 1)``; finally
      ``forget_vertices`` axes (fully-applied, never needed again) are
      summed out.
    * ``"forget"`` — sum out ``forget_vertices`` (no color change).
    * ``"join"``   — color-subset convolution (``UnionSplitTable``) of two
      states whose axes agree exactly and whose covered sets intersect
      exactly in the bag; the distinct-colors constraint makes the product
      correct without any inclusion-exclusion.

    ``inputs`` index earlier ops in the program; ``canon`` is the state's
    canonical form (shared across templates, and with tree-partition
    sub-templates whenever the covered subgraph is a tree on one axis).
    """

    kind: str
    inputs: Tuple[int, ...]
    vertex: Optional[int]
    spmm_vertex: Optional[int]
    mask_vertices: Tuple[int, ...]
    forget_vertices: Tuple[int, ...]
    axes: Tuple[int, ...]
    covered: Tuple[int, ...]
    canon: str

    @property
    def m(self) -> int:
        return len(self.covered)


@dataclass(frozen=True)
class BagProgram:
    """Topologically-ordered bag ops; ``ops[-1]`` is the full template."""

    template: Template
    decomposition: TreeDecomposition
    ops: Tuple[BagOp, ...]

    @property
    def width(self) -> int:
        return self.decomposition.width

    @property
    def max_axes(self) -> int:
        """Peak tensor rank (vertex axes) over the program, pre-forget."""
        return max(len(op.axes) + len(op.forget_vertices) for op in self.ops)


@lru_cache(maxsize=None)
def bag_state_canonical(template: Template, covered: Tuple[int, ...], axes: Tuple[int, ...]) -> str:
    """Canonical form of a bag DP state.

    Two states with equal canons hold identical tensors for every graph and
    coloring.  When the covered-induced subgraph is a tree carried on a
    single axis, the rooted AHU string is used so the state shares canon
    (and therefore DP slots and SpMM products) with tree-partition
    sub-template states across template families.  Otherwise the canon is
    the lexicographically-minimal relabeling of ``(axes, induced edges)``
    over bijections ``covered -> 0..m-1``, prefixed with ``"bag:"`` so it
    can never collide with an AHU string.
    """
    cov = set(covered)
    m = len(covered)
    induced = tuple((u, v) for u, v in template.edges if u in cov and v in cov)
    if len(axes) == 1 and len(induced) == m - 1:
        adj: Dict[int, List[int]] = {v: [] for v in covered}
        for u, v in induced:
            adj[u].append(v)
            adj[v].append(u)
        stack, seen = [axes[0]], {axes[0]}
        while stack:
            u = stack.pop()
            for v in adj[u]:
                if v not in seen:
                    seen.add(v)
                    stack.append(v)
        if len(seen) == m:  # connected + |E| = m-1: a tree rooted at the axis
            return sub_template_canonical(template, covered, axes[0])
    if m > 9:
        raise ValueError(f"bag canonical form capped at m=9 states (got m={m})")
    best = None
    for perm in itertools.permutations(range(m)):
        sigma = dict(zip(covered, perm))
        es = tuple(sorted(tuple(sorted((sigma[u], sigma[v]))) for u, v in induced))
        ax = tuple(sigma[a] for a in axes)
        key = (ax, es)
        if best is None or key < best:
            best = key
    return f"bag:m={m};axes={best[0]};edges={best[1]}"


@dataclass
class _BagState:
    op: int
    axes: Tuple[int, ...]
    covered: FrozenSet[int]
    applied: FrozenSet[FrozenSet[int]]


class _BagCompiler:
    """Lowers a rooted tree decomposition into a ``BagProgram``.

    Invariant at every op boundary: ``applied`` equals the set of template
    edges with both endpoints covered (an endpoint is only ever summed out
    once all of its edges are applied), so ``(covered, axes)`` fully
    determines the state and its canonical form.
    """

    def __init__(self, template: Template, decomp: TreeDecomposition):
        self.t = template
        self.edges: Set[FrozenSet[int]] = {frozenset(e) for e in template.edges}
        self.adj = template.adjacency()
        self.decomp = decomp
        self.children = decomp.children()
        self.ops: List[BagOp] = []
        # outside_need[nd] = vertices appearing in bags outside subtree(nd):
        # those must survive nd's processing as live axes.
        n_nodes = len(decomp.bags)

        def node_set(nd: int) -> Set[int]:
            s = {nd}
            for c in self.children[nd]:
                s |= node_set(c)
            return s

        self.outside_need: Dict[int, FrozenSet[int]] = {}
        for nd in range(n_nodes):
            inside = node_set(nd)
            outside: Set[int] = set()
            for j in range(n_nodes):
                if j not in inside:
                    outside |= set(decomp.bags[j])
            self.outside_need[nd] = frozenset(outside)

    # -- helpers ----------------------------------------------------------

    def _edges_of(self, x: int) -> Set[FrozenSet[int]]:
        return {frozenset((x, y)) for y in self.adj[x]}

    def _unapplied(self, x: int, applied: FrozenSet[FrozenSet[int]]) -> Set[FrozenSet[int]]:
        return self._edges_of(x) - applied

    def _emit(self, kind, inputs, vertex, spmm_vertex, masks, forgets, axes, covered) -> int:
        covered_t = tuple(sorted(covered))
        canon = bag_state_canonical(self.t, covered_t, axes)
        self.ops.append(
            BagOp(
                kind=kind,
                inputs=tuple(inputs),
                vertex=vertex,
                spmm_vertex=spmm_vertex,
                mask_vertices=tuple(masks),
                forget_vertices=tuple(forgets),
                axes=axes,
                covered=covered_t,
                canon=canon,
            )
        )
        return len(self.ops) - 1

    def _intro_order(self, covered: Set[int], targets: Set[int]) -> List[int]:
        """Introduce bag vertices adjacent to the covered set first (keeps
        broadcast introductions — no incident edge yet — to a minimum)."""
        order: List[int] = []
        cov = set(covered)
        rest = set(targets)
        while rest:
            adjacent = sorted(x for x in rest if any(frozenset((x, y)) in self.edges for y in cov))
            pick = adjacent[0] if adjacent else min(rest)
            order.append(pick)
            cov.add(pick)
            rest.discard(pick)
        return order

    # -- op constructors --------------------------------------------------

    def _leaf(self, w: int) -> _BagState:
        idx = self._emit("leaf", (), w, None, (), (), (w,), {w})
        return _BagState(idx, (w,), frozenset({w}), frozenset())

    def _intro(self, st: _BagState, w: int, needed: FrozenSet[int], allow_elim: bool) -> _BagState:
        assert w not in st.covered, (w, st)
        w_nbr_axes = [x for x in st.axes if frozenset((x, w)) in self.edges]
        spmm_vertex: Optional[int] = None
        if allow_elim:
            for x in w_nbr_axes:
                if x not in needed and self._unapplied(x, st.applied) <= {frozenset((x, w))}:
                    spmm_vertex = x
                    break
        applied = set(st.applied)
        for x in w_nbr_axes:
            applied.add(frozenset((x, w)))
        applied_f = frozenset(applied)
        masks = tuple(x for x in w_nbr_axes if x != spmm_vertex)
        covered = st.covered | {w}
        mid_axes = tuple(sorted((set(st.axes) - {spmm_vertex}) | {w}))
        forgets: Tuple[int, ...] = ()
        if allow_elim:
            forgets = tuple(
                x for x in mid_axes if x not in needed and not self._unapplied(x, applied_f)
            )
        out_axes = tuple(x for x in mid_axes if x not in forgets)
        idx = self._emit("extend", (st.op,), w, spmm_vertex, masks, forgets, out_axes, covered)
        return _BagState(idx, out_axes, covered, applied_f)

    def _forget_to(self, st: _BagState, keep: Set[int]) -> _BagState:
        pending = tuple(x for x in st.axes if x not in keep)
        if not pending:
            return st
        for x in pending:
            assert not self._unapplied(x, st.applied), (x, self._unapplied(x, st.applied))
        out_axes = tuple(x for x in st.axes if x in keep)
        idx = self._emit("forget", (st.op,), None, None, (), pending, out_axes, st.covered)
        return _BagState(idx, out_axes, st.covered, st.applied)

    def _morph(self, st: _BagState, nd: int, strict: bool) -> _BagState:
        bag = set(self.decomp.bags[nd])
        needed = self.outside_need[nd] | (frozenset(bag) if strict else frozenset())
        st = self._forget_to(st, bag)
        for w in self._intro_order(set(st.covered), bag - st.covered):
            st = self._intro(st, w, needed, allow_elim=not strict)
        if strict:
            assert st.axes == tuple(sorted(bag)), (st.axes, bag)
        return st

    def _join(self, s1: _BagState, s2: _BagState, bag: Set[int]) -> _BagState:
        assert s1.axes == s2.axes == tuple(sorted(bag)), (s1.axes, s2.axes, bag)
        assert s1.covered & s2.covered == frozenset(bag), (s1.covered, s2.covered, bag)
        covered = s1.covered | s2.covered
        idx = self._emit("join", (s1.op, s2.op), None, None, (), (), s1.axes, covered)
        return _BagState(idx, s1.axes, covered, s1.applied | s2.applied)

    # -- driver -----------------------------------------------------------

    def _compile(self, nd: int) -> _BagState:
        kids = self.children[nd]
        bag = set(self.decomp.bags[nd])
        if not kids:
            order = self._intro_order(set(), bag)
            st = self._leaf(order[0])
            for w in order[1:]:
                st = self._intro(st, w, self.outside_need[nd], allow_elim=True)
            return st
        if len(kids) == 1:
            return self._morph(self._compile(kids[0]), nd, strict=False)
        states = [self._morph(self._compile(c), nd, strict=True) for c in kids]
        st = states[0]
        for other in states[1:]:
            st = self._join(st, other, bag)
        return st

    def run(self) -> BagProgram:
        st = self._compile(self.decomp.root_index)
        assert st.covered == frozenset(range(self.t.k)), st
        assert not (self.edges - st.applied), self.edges - st.applied
        if st.axes:
            self._forget_to(st, set())
        return BagProgram(template=self.t, decomposition=self.decomp, ops=tuple(self.ops))


@lru_cache(maxsize=None)
def build_bag_program(template: Template) -> BagProgram:
    """Compile a template's tree decomposition into a linear bag program.

    Works for any connected template; the counting pipeline uses it for
    non-trees (trees take the partition route, which this generalizes).
    """
    template.validate()
    decomp = build_tree_decomposition(template)
    return _BagCompiler(template, decomp).run()
