"""Non-tree templates (bag stages) in the port, against the reference and
independent oracles, on the CPU.  Mirrors the reference's
``tests/test_graphlets.py``.

* Per-coloring raw totals equal the reference engine's for every connected
  graphlet of sizes 3-5 (2 + 6 + 21) on that file's Erdos-Renyi graphs
  (n = 7-9) and an R-MAT graph of 32 vertices, through the ``edges``,
  ``dense`` and ``blocked`` backends, at ``rtol=1e-5`` (the reference's own
  bar across its backends).  On the CPU ``blocked`` runs its kernels' plain
  versions.
* Counts equal the brute-force oracle (an ordered-tuple enumeration copied
  from the reference's test, sharing no code with the engine) and the
  port's own brute force.
* Trees and non-trees run in one engine; the ``custom`` backend
  (``spmm_fn``) runs bag extends through the caller's function.
* The cost model's peak and transient element counts and
  ``admission_estimate`` equal the reference's, with the reference's fusion
  slack pinned to 1.0 (the port keeps 1.0; the reference would read its
  XLA:CPU ``memory_model`` rows); ``degradation_ladder`` equals the
  reference's minus the rungs the port leaves out.
"""

import functools
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as ref_engine
from repro.core import graph as ref_graph
from repro.core import templates as ref_templates
from repro.plan import cost as ref_cost
from repro.plan.ir import build_template_plan as ref_build_plan

from repro_torch.core import graph as port_graph
from repro_torch.core import templates as port_templates
from repro_torch.core.counting import brute_force_colorful, build_counting_plan
from repro_torch.core.engine import CountingEngine
from repro_torch.core.estimator import estimate_embeddings, required_iterations
from repro_torch.core.templates import connected_graphlets, graph_automorphisms
from repro_torch.plan import cost as port_cost
from repro_torch.plan.ir import build_template_plan

RTOL = 1e-5

#: The reference's tests/test_graphlets.py graphs, and a small R-MAT one.
GRAPH_SPECS = {
    "er7": ("erdos_renyi_graph", dict(n=7, num_edges=16, seed=1)),
    "er8": ("erdos_renyi_graph", dict(n=8, num_edges=22, seed=2)),
    "er9": ("erdos_renyi_graph", dict(n=9, num_edges=30, seed=5)),
    "rmat32": ("rmat_graph", dict(n=32, num_edges=90, seed=4)),
}
NON_TREE_NAMES = ["triangle", "square", "diamond", "clique4"]
FIVE_GRAPHLETS = [t.name for t in connected_graphlets(5) if not t.is_tree][:4]


@functools.lru_cache(maxsize=None)
def _graphs(gname):
    fn, kw = GRAPH_SPECS[gname]
    return getattr(ref_graph, fn)(**kw), getattr(port_graph, fn)(**kw)


def _port_template(name):
    by_name = {t.name: t for k in (3, 4, 5) for t in connected_graphlets(k)}
    return by_name[name] if name in by_name else port_templates.get_template(name)


def oracle_colorful_injective(graph, template, colors) -> int:
    """Injective colorful homomorphisms (= |Aut| * colorful embeddings) by
    enumerating every ordered k-tuple of distinct vertices: O(n^k)."""
    k = template.k
    adj = {(int(u), int(v)) for u, v in zip(graph.src, graph.dst)}
    count = 0
    for tup in itertools.permutations(range(graph.n), k):
        if len({int(colors[v]) for v in tup}) != k:
            continue
        if all((tup[a], tup[b]) in adj for a, b in template.edges):
            count += 1
    return count


def _raw(engine, colors):
    return engine.backend_impl.counts_for_colors(torch.as_tensor(colors)).numpy().astype(np.float64)


@functools.lru_cache(maxsize=None)
def _reference_totals(gname, k):
    """The reference engine's raw totals of all connected k-graphlets in one
    engine (one jit per graph and size), on seeded colorings."""
    ref_g, _ = _graphs(gname)
    colors = np.random.default_rng(100 * k + ref_g.n).integers(0, k, size=(5, ref_g.n))
    eng = ref_engine.CountingEngine(ref_g, list(ref_templates.connected_graphlets(k)),
                                    backend="edges")
    return colors, np.asarray(eng.backend_impl.counts_for_colors(jnp.asarray(colors)), np.float64)


@pytest.mark.parametrize("backend", ["edges", "dense", "blocked"])
@pytest.mark.parametrize("k", [3, 4, 5])
@pytest.mark.parametrize("gname", list(GRAPH_SPECS))
def test_graphlet_totals_match_reference(gname, k, backend):
    colors, want = _reference_totals(gname, k)
    _, g = _graphs(gname)
    eng = CountingEngine(g, list(connected_graphlets(k)), device="cpu", backend=backend)
    got = _raw(eng, colors)
    assert got.shape == want.shape == (5, len(connected_graphlets(k)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL)
    # normalised estimates through the chunk function, chunked
    est = eng.count_colorings(colors)
    norm = eng._norm_factors.numpy().astype(np.float64)
    np.testing.assert_allclose(est, want * norm[None, :], rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("name", NON_TREE_NAMES)
@pytest.mark.parametrize("backend", ["edges", "sell", "blocked"])
def test_engine_matches_oracle_per_coloring(name, backend):
    t = port_templates.get_template(name)
    rng = np.random.default_rng(11)
    hits = 0
    for gname in ("er7", "er8", "er9"):
        _, g = _graphs(gname)
        eng = CountingEngine(g, [t], device="cpu", backend=backend)
        colors = rng.integers(0, t.k, size=(6, g.n))
        raw = _raw(eng, colors)
        for b in range(colors.shape[0]):
            exact = oracle_colorful_injective(g, t, colors[b])
            assert raw[b, 0] == pytest.approx(exact, rel=RTOL, abs=RTOL)
            assert exact == pytest.approx(brute_force_colorful(g, t, colors[b])
                                          * graph_automorphisms(t))
            hits += exact > 0
    assert hits > 0, "test graphs too sparse: no colorful hit exercised"


@pytest.mark.parametrize("name", FIVE_GRAPHLETS)
def test_five_graphlets_match_oracle(name):
    t = _port_template(name)
    _, g = _graphs("er9")
    colors = np.random.default_rng(13).integers(0, 5, size=(8, g.n))
    raw = _raw(CountingEngine(g, [t], device="cpu", backend="blocked"), colors)
    for b in range(colors.shape[0]):
        assert raw[b, 0] == pytest.approx(oracle_colorful_injective(g, t, colors[b]),
                                          rel=RTOL, abs=RTOL)


def test_mixed_tree_and_bag_one_engine():
    _, g = _graphs("er8")
    path3, tri = port_templates.get_template("u3"), port_templates.get_template("triangle")
    colors = np.random.default_rng(7).integers(0, 3, size=(6, g.n))
    for backend in ("edges", "blocked"):
        raw = _raw(CountingEngine(g, [path3, tri], device="cpu", backend=backend), colors)
        for b in range(colors.shape[0]):
            assert raw[b, 0] == pytest.approx(oracle_colorful_injective(g, path3, colors[b]), rel=RTOL)
            assert raw[b, 1] == pytest.approx(oracle_colorful_injective(g, tri, colors[b]), rel=RTOL)


def test_custom_backend_runs_the_callers_neighbor_sum():
    _, g = _graphs("rmat32")
    adj = torch.as_tensor(g.dense_adjacency())
    calls = []

    def spmm_fn(m):
        calls.append(tuple(m.shape))
        return adj @ m

    ts = [port_templates.get_template("u3"), port_templates.get_template("triangle")]
    eng = CountingEngine(g, ts, device="cpu", spmm_fn=spmm_fn, backend="blocked")
    assert (eng.backend, eng.backend_source) == ("custom", "custom")
    colors = np.random.default_rng(2).integers(0, 3, size=(3, g.n))
    want = _raw(CountingEngine(g, ts, device="cpu", backend="edges"), colors)
    np.testing.assert_allclose(_raw(eng, colors), want, rtol=RTOL)
    assert calls and all(c[0] == g.n for c in calls)
    # a function that hands its input back must not have it masked in place
    ident = CountingEngine(g, [port_templates.get_template("triangle")], device="cpu",
                           spmm_fn=lambda m: m)
    first = _raw(ident, colors)
    assert np.array_equal(first, _raw(ident, colors))
    with pytest.raises(ValueError, match="spmm_fn"):
        CountingEngine(g, ts, device="cpu", backend="custom")


def test_bag_plans_bit_exact_across_chunk_sizes():
    _, g = _graphs("rmat32")
    ts = list(connected_graphlets(4))
    colors = np.random.default_rng(5).integers(0, 4, size=(5, g.n))
    a = CountingEngine(g, ts, device="cpu", backend="blocked", chunk_size=5).count_colorings(colors)
    b = CountingEngine(g, ts, device="cpu", backend="blocked", chunk_size=2).count_colorings(colors)
    assert np.array_equal(a, b)


def _ref_cost_model(gname, names):
    ref_g, _ = _graphs(gname)
    plan = ref_build_plan([ref_templates.connected_graphlets(int(n[1]))[int(n[3:])]
                           if n.startswith("g") else ref_templates.get_template(n) for n in names])
    return ref_cost.CostModel(plan, ref_g, jnp.float32, fusion_slack=1.0)


@pytest.mark.parametrize("k", [3, 4, 5])
@pytest.mark.parametrize("gname", ["er9", "rmat32"])
def test_cost_model_element_counts_match_reference(gname, k):
    ref_g, g = _graphs(gname)
    sell_slots = port_graph.build_sell(g).padded_slots
    for t in connected_graphlets(k):
        cm = port_cost.CostModel(build_template_plan([t]), g)
        ref = _ref_cost_model(gname, [t.name])
        assert cm.resident_elements() == ref.resident_elements(), t.name
        for target in ("edges", "custom", "ell", "sell", "dense", "blocked"):
            slots = sell_slots if target == "sell" else None
            for cb in (1, 4, 16):
                assert cm.transient_elements(target, cb, sell_padded_slots=slots) == \
                    ref.transient_elements(target, cb, sell_padded_slots=slots), (t.name, target)
            if t.is_tree:
                continue
            assert cm.bag_transient_elements(target, sell_padded_slots=slots) == \
                ref.bag_transient_elements(target, sell_padded_slots=slots), (t.name, target)
        assert cm.describe() == ref.describe()
        raw = cm.bytes_per_coloring(cm.transient_elements("edges", 16), cm.resident_elements())
        assert raw == ref.bytes_per_coloring(ref.transient_elements("edges", 16),
                                             ref.resident_elements())
    # a whole size's graphlets in one plan, as the service builds them
    cm = port_cost.CostModel(build_template_plan(list(connected_graphlets(k))), g)
    ref = ref_cost.CostModel(ref_build_plan(list(ref_templates.connected_graphlets(k))), ref_g,
                             jnp.float32, fusion_slack=1.0)
    assert cm.resident_elements() == ref.resident_elements()
    assert cm.transient_elements("blocked", 16) == ref.transient_elements("blocked", 16)


@pytest.mark.parametrize("names", [["u5-1"], ["triangle"], ["g4-2", "g4-3"], ["u3", "triangle"]])
@pytest.mark.parametrize("chunk", [None, 3])
def test_admission_estimate_matches_reference(names, chunk):
    ref_g, g = _graphs("er9")
    ref_ts = [ref_templates.connected_graphlets(int(n[1]))[int(n[3:])] if n.startswith("g")
              else ref_templates.get_template(n) for n in names]
    for dtype, ref_dtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        for budget in (1 << 12, 1 << 20, 32 << 20):
            got = port_cost.admission_estimate(g, [_port_template(n) for n in names],
                                               store_dtype=dtype, chunk_size=chunk,
                                               memory_budget_bytes=budget)
            want = ref_cost.admission_estimate(ref_g, ref_ts, store_dtype=ref_dtype,
                                               chunk_size=chunk, memory_budget_bytes=budget,
                                               fusion_slack=1.0)
            assert tuple(vars(got).values()) == tuple(vars(want).values())


@pytest.mark.parametrize("chunk,cb,backend", [(1, None, "edges"), (8, None, "blocked"),
                                              (5, 16, "sell"), (64, 3, "custom"),
                                              (2, 1, "dense")])
def test_degradation_ladder_matches_reference(chunk, cb, backend):
    """The reference's rungs minus the two the port leaves out: the fallback
    to ``edges`` (it would route a card's query around the kernels) and, on
    ``blocked``, the column-batch rungs (its kernels read no column batch)."""
    got = [(r.chunk_size, r.column_batch, r.action)
           for r in port_cost.degradation_ladder(chunk, cb, backend)]
    want = [(r.chunk_size, r.column_batch, r.action)
            for r in ref_cost.degradation_ladder(chunk, cb, backend)
            if r.action != "fallback_backend"
            and not (backend == "blocked" and r.action == "shrink_columns")]
    assert got == want
    assert all(r.action != "fallback_backend"
               for r in port_cost.degradation_ladder(chunk, cb, backend))


def test_estimate_embeddings_runs_nontree_and_adaptive():
    _, g = _graphs("er9")
    tri = port_templates.get_template("triangle")
    res = estimate_embeddings(g, tri, iterations=6, device="cpu")
    assert np.isfinite(res.mean) and res.mean >= 0 and res.iterations == 6
    ad = estimate_embeddings(g, tri, epsilon=0.5, delta=0.2, max_iterations=40,
                             chunk_size=4, device="cpu", backend="edges")
    assert 8 <= ad.iterations <= 40 and ad.per_iteration.shape == (ad.iterations,)


def test_required_iterations_generic_over_templates():
    import math

    assert required_iterations(port_templates.get_template("triangle"), 0.1, 0.05) == \
        required_iterations(3, 0.1, 0.05)
    k, eps, delta = 5, 0.1, 0.05
    assert required_iterations(k, eps, delta) == math.ceil(
        k**k / math.factorial(k) * math.log(1 / delta) / eps**2)


def test_counting_plan_automorphisms_of_bag_plans():
    for name in NON_TREE_NAMES:
        t = port_templates.get_template(name)
        assert build_counting_plan(t).automorphisms == graph_automorphisms(t)
