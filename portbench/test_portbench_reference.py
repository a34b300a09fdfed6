"""The reference against exact colorful counts by enumeration on tiny graphs,
and its frozen draw and generator against known answers."""

import itertools

import numpy as np
import pytest
import torch

from portbench.reference import colorcoding, threefry
from portbench.reference.rmat import rmat_edges

TREES = {
    "path3": ((0, 1), (0, 2)),
    "star4": ((0, 1), (0, 2), (0, 3)),
    "path4": ((0, 1), (0, 2), (1, 3)),
    "path5": ((0, 1), (1, 2), (2, 3), (3, 4)),
    "chair5": ((0, 1), (1, 2), (2, 3), (1, 4)),
}
GRAPHS = {
    "triangle": ((0, 1), (0, 2), (1, 2)),
    "paw": ((0, 1), (0, 2), (0, 3), (1, 2)),
    "square": ((0, 1), (0, 2), (1, 3), (2, 3)),
    "diamond": ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3)),
}
AUTOMORPHISMS = {"path3": 2, "star4": 6, "path4": 2, "path5": 2, "chair5": 2,
                 "triangle": 6, "paw": 2, "square": 8, "diamond": 4, "u12": 2}
U12 = ((0, 1), (0, 2), (1, 3), (1, 4), (2, 5), (2, 6), (3, 7), (4, 8), (5, 9), (6, 10),
       (10, 11))

#: ``jax.random.randint(fold_in(PRNGKey(seed), data), (n,), 0, k)``, keyed by
#: ``(seed, data, n, k)``, and ``jax.random.split(PRNGKey(seed), num)``
#: (values JAX drew, as ``chip_smoke.py`` keeps them)
KNOWN_COLORINGS = {
    (0, 0, 16, 3): (1, 2, 1, 1, 1, 1, 1, 1, 1, 0, 1, 1, 1, 0, 2, 0),
    (42, 7, 25, 12): (9, 0, 6, 7, 10, 2, 3, 7, 10, 7, 7, 0, 7, 1, 3, 2, 0, 1, 9, 5, 1, 7, 5,
                      5, 5),
    (2**31 + 5, 1, 9, 5): (1, 4, 3, 2, 4, 0, 1, 4, 1),
}
KNOWN_SPLITS = {
    (0, 4): ((1797259609, 2579123966), (928981903, 3453687069), (4146024105, 2718843009),
             (2467461003, 3840466878)),
    (17, 2): ((1410583977, 344060510), (677216225, 3396477011)),
}


def graph(n, m, seed):
    rng = np.random.default_rng(seed)
    pairs = set()
    while len(pairs) < m:
        u, v = (int(x) for x in rng.integers(0, n, 2))
        if u != v:
            pairs.add((min(u, v), max(u, v)))
    src = torch.tensor([u for u, v in pairs] + [v for u, v in pairs], dtype=torch.int32)
    dst = torch.tensor([v for u, v in pairs] + [u for u, v in pairs], dtype=torch.int32)
    return pairs, src, dst


def brute_colorful(pairs, n, colors, edges):
    """Maps of the template into the graph that keep every edge and give its
    vertices distinct colors, by enumerating injective maps."""
    k = colorcoding.num_vertices(edges)
    adj = {(u, v) for u, v in pairs} | {(v, u) for u, v in pairs}
    count = 0
    for image in itertools.permutations(range(n), k):
        if len({int(colors[x]) for x in image}) != k:
            continue
        if all((image[a], image[b]) in adj for a, b in edges):
            count += 1
    return count


@pytest.mark.parametrize("name", sorted(TREES) + sorted(GRAPHS))
def test_counts_equal_enumeration(name):
    edges = {**TREES, **GRAPHS}[name]
    k = colorcoding.num_vertices(edges)
    n = 9
    pairs, src, dst = graph(n, 20, seed=k)
    adj = colorcoding.Adjacency(src, dst, n, dense=True)
    rng = np.random.default_rng(len(name))
    for _ in range(3):
        colors = torch.as_tensor(rng.integers(0, k, n))
        want = brute_colorful(pairs, n, colors, edges)
        assert colorcoding.colorful_count(adj, colors, edges) == want
        if name in TREES:
            assert colorcoding.graph_colorful_count(adj, colors, edges) == want


@pytest.mark.parametrize("name", sorted(AUTOMORPHISMS))
def test_automorphisms(name):
    edges = {**TREES, **GRAPHS, "u12": U12}[name]
    assert colorcoding.automorphisms(edges) == AUTOMORPHISMS[name]


def test_estimate_is_copies_on_a_colorful_coloring():
    # a 4-cycle colored with four distinct colors: one copy, seen once
    src = torch.tensor([0, 1, 1, 2, 2, 3, 3, 0], dtype=torch.int32)
    dst = torch.tensor([1, 0, 2, 1, 3, 2, 0, 3], dtype=torch.int32)
    adj = colorcoding.Adjacency(src, dst, 4, dense=True)
    colors = torch.tensor([0, 1, 2, 3])
    got = colorcoding.estimate(adj, colors, GRAPHS["square"])
    assert got == pytest.approx(1.0 / colorcoding.colorful_probability(4))


def test_known_draws():
    for (seed, data, n, k), want in KNOWN_COLORINGS.items():
        key = threefry.fold_in(threefry.prng_key(seed), data)
        assert threefry.randint(key, n, k).tolist() == list(want)
    for (seed, num), want in KNOWN_SPLITS.items():
        assert threefry.split(threefry.prng_key(seed), num).tolist() == [list(w) for w in want]


def test_rmat_is_canonical_and_seeded():
    n = 1 << 9
    src, dst = rmat_edges(n, 4000, seed=2**33 + 1)
    again = rmat_edges(n, 4000, seed=2**33 + 1)
    assert torch.equal(src, again[0]) and torch.equal(dst, again[1])
    assert not torch.equal(src, rmat_edges(n, 4000, seed=2**33 + 2)[0])
    s, d = src.long(), dst.long()
    assert bool((s != d).all())
    keys = d * n + s
    assert bool((keys[1:] > keys[:-1]).all())  # sorted by (dst, src), no duplicates
    assert torch.equal(torch.sort(s * n + d).values, torch.sort(keys).values)  # symmetric
