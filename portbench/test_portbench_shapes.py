"""The stages frozen in each configuration's file (``shapes``), which the
roofline prices, against the templates themselves: every tree stage is a
rooted sub-template that the template has, by enumeration, and every bag
program ends in the template."""

import itertools
import json
import math
import re
from pathlib import Path

import pytest

from portbench.shapes import bag_product_widths, shape_of, tree_stages

ROOT = Path(__file__).resolve().parents[1]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CONFIGS = {c["name"]: json.loads((ROOT / c["file"]).read_text()) for c in SPEC["configs"]}
TEMPLATES = [(c, t) for c, cfg in CONFIGS.items() for t in cfg["templates"]]


def adjacency(edges):
    adj = {}
    for u, v in edges:
        adj.setdefault(u, set()).add(v)
        adj.setdefault(v, set()).add(u)
    return adj


def ahu(adj, allowed, node, parent=-1):
    return "(" + "".join(sorted(ahu(adj, allowed, c, node) for c in adj[node]
                                if c != parent and c in allowed)) + ")"


def rooted_subtrees(edges):
    """The AHU string of every connected vertex set of a tree, at every root."""
    adj = adjacency(edges)
    found = set()
    vertices = sorted(adj)
    for size in range(1, len(vertices) + 1):
        for subset in itertools.combinations(vertices, size):
            allowed, seen, stack = set(subset), {subset[0]}, [subset[0]]
            while stack:
                for v in adj[stack.pop()] & allowed - seen:
                    seen.add(v)
                    stack.append(v)
            if seen == allowed:
                found |= {ahu(adj, allowed, r) for r in subset}
    return found


def is_tree(edges):
    return len(edges) == len(adjacency(edges)) - 1


@pytest.mark.parametrize("config,name", TEMPLATES, ids=lambda x: x)
def test_frozen_stages_belong_to_the_template(config, name):
    cfg = CONFIGS[config]
    edges = [tuple(e) for e in cfg["templates"][name]]
    shape = shape_of(cfg, name)
    assert shape.k == len(adjacency(edges))
    if is_tree(edges):
        assert shape.bag is None and shape.tree
        subtrees = rooted_subtrees(edges)
        sizes = {1} | {m for _, m, _ in shape.tree}
        canons = [canon for canon, _, _ in shape.tree]
        assert len(canons) == len(set(canons))
        for canon, m, m_a in shape.tree:
            assert canon in subtrees and canon.count("(") == m
            assert 1 <= m_a < m and {m_a, m - m_a} <= sizes
        assert shape.tree[-1][1] == shape.k
        assert len(tree_stages([shape])) == len(shape.tree)
    else:
        assert shape.tree is None and shape.bag
        states = [re.match(r"bag:m=(\d+);axes=\(([\d, ]*)\);edges=(.*)$", row[0])
                  for row in shape.bag[1:]]
        assert shape.bag[0] == ["()"] and all(states)
        ms = [int(s.group(1)) for s in states]
        assert ms == sorted(ms) and ms[-1] == shape.k and states[-1].group(2) == ""
        last = {tuple(e) for e in json.loads(states[-1].group(3).replace("(", "[").replace(
            ")", "]"))}
        assert any({tuple(sorted((p[u], p[v]))) for u, v in edges} == last
                   for p in itertools.permutations(range(shape.k)))
        for row in shape.bag:
            if len(row) == 3:
                assert 1 <= row[1] <= 2 and 1 <= row[2] < shape.k
        products = [row for row in shape.bag if len(row) == 3]
        assert bag_product_widths([shape], 8) == [8 ** (a - 1) * math.comb(shape.k, m)
                                                  for _, a, m in products]
