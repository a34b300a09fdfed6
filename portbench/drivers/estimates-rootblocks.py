"""Traffic ``estimates-rootblocks``: the ``estimates`` driver
(``drivers/estimates.py``: the same closed loop, keys, window and
comparison), its sampled answers recomputed by the tree reference that
walks the root's merges by blocks of vertices
(:mod:`portbench.reference.rootblocks`), for trees whose reference states
do not fit the card whole beside one another."""

from __future__ import annotations

from portbench.drivers import estimates
from portbench.reference import colorcoding, rootblocks


def run(cell):
    plain = colorcoding.tree_colorful_count
    colorcoding.tree_colorful_count = rootblocks.tree_colorful_count
    try:
        return estimates.run(cell)
    finally:
        colorcoding.tree_colorful_count = plain
