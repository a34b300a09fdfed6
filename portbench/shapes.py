"""The shapes of the counting kernels' work, from each template's frozen stages.

The DP that the counting engine runs is fixed by its templates: a tree is
cut into a binary recursion of rooted sub-templates, one fused stage of
kernel A (``spmm_ema``) per distinct one, and a non-tree template is lowered
through a tree decomposition into a bag program whose extends with an
eliminated neighbour are products with the adjacency (kernel B,
``spmm_blocked``).  A configuration's file freezes, per template under
``shapes``, what the roofline (:mod:`portbench.roofline`) prices:

* a tree's ``tree``: ``[canon, m, m_a]`` for each distinct non-leaf rooted
  sub-template, its canonical (AHU) string, its vertices and its active
  part's vertices;
* a non-tree's ``bag``: ``[canon]`` for each state of its bag program in
  order, and ``[canon, axes_in, m_in]`` for an extend whose product with the
  adjacency reads a state of ``axes_in`` vertex axes over ``m_in`` vertices.

States with equal canons are made once in a set of templates, as the engine
shares them.  The stages were written from the engine's partition and bag
compiler when the benchmark was made, so that a change to the program cannot
move the yardstick its roofline shares are read against.
"""

from __future__ import annotations

from dataclasses import dataclass
from math import comb
from typing import Dict, List, Optional, Sequence, Set


@dataclass(frozen=True)
class Shape:
    """One template as the roofline sees it: its ``k`` vertices and its
    frozen ``tree`` stages or ``bag`` states."""

    name: str
    k: int
    tree: Optional[List] = None
    bag: Optional[List] = None


def shape_of(config: Dict, name: str) -> Shape:
    vertices = {v for e in config["templates"][name] for v in e}
    frozen = config["shapes"][name]
    return Shape(name, len(vertices), frozen.get("tree"), frozen.get("bag"))


@dataclass(frozen=True)
class TreeStage:
    """One fused SpMM + eMA stage: a sub-template of ``m`` vertices made from
    an active part of ``m_a`` and a passive part of ``m - m_a``, ``k``
    colors."""

    k: int
    m: int
    m_a: int

    @property
    def c_p(self) -> int:
        return comb(self.k, self.m - self.m_a)

    @property
    def c_a(self) -> int:
        return comb(self.k, self.m_a)

    @property
    def n_out(self) -> int:
        return comb(self.k, self.m)

    @property
    def n_splits(self) -> int:
        return comb(self.m, self.m_a)


def tree_stages(shapes: Sequence[Shape]) -> List[TreeStage]:
    """The fused stages of one coloring: one per distinct non-leaf rooted
    sub-template of the set's trees (equal sub-templates share one state)."""
    seen: Set[str] = set()
    out: List[TreeStage] = []
    for s in shapes:
        for canon, m, m_a in s.tree or ():
            if canon not in seen:
                seen.add(canon)
                out.append(TreeStage(s.k, m, m_a))
    return out


def bag_product_widths(shapes: Sequence[Shape], n: int) -> List[int]:
    """Columns of each adjacency product of one coloring: per distinct bag
    extend with an eliminated neighbour, ``n ** (axes_in - 1) * C(k, m_in)``
    (states equal to a tree's sub-template, or to an earlier bag state, are
    not made again)."""
    seen: Set[str] = {row[0] for s in shapes for row in s.tree or ()}
    widths: List[int] = []
    for s in shapes:
        for canon, *product in s.bag or ():
            if canon in seen:
                continue
            seen.add(canon)
            if product:
                axes_in, m_in = product
                widths.append(n ** (axes_in - 1) * comb(s.k, m_in))
    return widths
