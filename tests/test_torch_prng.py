"""The port's threefry PRNG and key-driven counting against ``jax.random``
and the reference engine, on the CPU.

* ``prng_key``, ``split``, ``fold_in`` and ``randint`` are bit-equal to
  ``jax.random`` (JAX's defaults: threefry2x32, partitionable) over a sweep
  of seeds, sizes ``n`` (1 and odd ones included) and ``k`` = 2..12.
* ``estimate``, ``count_keys`` and ``count_keys_chunk`` (a short increment
  padded to the chunk) equal the reference engine's to ``rtol=1e-5`` (the
  reference's own bar across its backends) for u3-u7 on an R-MAT graph of
  2048 vertices, an Erdos-Renyi graph and a grid.
* ``engine_cache_key`` equality follows plan equality, as in the
  reference's ``tests/test_plan.py``.
* The known-answer colorings written into ``chip_smoke.py`` (the card's
  machine has no JAX) are what JAX draws.
* The committed ``tableIII/rmat2k/*/subgraph2vec`` counts reproduce under
  ``benchmarks/bench_counting.py``'s seeds.
"""

import functools
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as ref_engine
from repro.core import graph as ref_graph
from repro.core import templates as ref_templates

from repro_torch.core import graph as port_graph
from repro_torch.core import prng
from repro_torch.core import templates as port_templates
from repro_torch.core.engine import CountingEngine, engine_cache_key
from repro_torch.plan.ir import build_template_plan

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SEEDS = [0, 1, 42, 2**31 - 1, 2**31 + 5, 2**32 - 1, -3]
SIZES = [1, 2, 7, 64, 1001]

GRAPH_SPECS = {
    "rmat2k": ("rmat_graph", dict(n=2048, num_edges=20_000, seed=1)),
    "er": ("erdos_renyi_graph", dict(n=600, num_edges=2400, seed=2)),
    "grid": ("grid_graph", dict(rows=20, cols=25)),
}
TEMPLATE_SETS = {"u3": ["u3"], "u5": ["u5-1", "u5-2"], "u6": ["u6"], "u7": ["u7"]}
RTOL = 1e-5


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in_bit_equal(seed):
    key = jax.random.PRNGKey(seed)
    ours = prng.prng_key(seed)
    assert np.array_equal(np.asarray(key), ours.numpy())
    for num in (1, 2, 3, 16):
        assert np.array_equal(np.asarray(jax.random.split(key, num)), prng.split(ours, num).numpy())
    for data in (0, 1, 12345, 2**32 - 1):
        assert np.array_equal(np.asarray(jax.random.fold_in(key, data)),
                              prng.fold_in(ours, data).numpy())
    # batched fold_in, as the service draws a launch's keys
    keys = jax.random.split(key, 5)
    idx = np.arange(3, 8, dtype=np.uint32)
    want = jax.vmap(jax.random.fold_in)(keys, jnp.asarray(idx))
    assert np.array_equal(np.asarray(want), prng.fold_in(np.asarray(keys), idx).numpy())


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("seed", SEEDS[:5])
def test_randint_bit_equal(seed, n):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 7)
    ours = prng.fold_in(prng.prng_key(seed), 7)
    for k in range(2, 13):
        want = np.asarray(jax.random.randint(key, (n,), 0, k))
        got = prng.randint(ours, (n,), 0, k).numpy()
        assert np.array_equal(want, got), (seed, n, k)
    # batched keys, as the engine draws a chunk's colorings
    keys = jax.random.split(key, 3)
    want = jax.vmap(lambda kk: jax.random.randint(kk, (n,), 0, 5))(keys)
    assert np.array_equal(np.asarray(want), prng.randint(np.asarray(keys), (n,), 0, 5).numpy())


def test_randint_wide_spans_and_bounds():
    key = jax.random.PRNGKey(9)
    ours = prng.prng_key(9)
    for lo, hi in [(0, 2**31 - 1), (-(2**31), 2**31 - 1), (0, 65_537), (-7, 100_000), (5, 3)]:
        want = np.asarray(jax.random.randint(key, (40,), lo, hi))
        assert np.array_equal(want, prng.randint(ours, (40,), lo, hi).numpy()), (lo, hi)
    with pytest.raises(ValueError, match="int32"):
        prng.randint(ours, (3,), 0, 2**31)
    with pytest.raises(ValueError, match="trailing axis"):
        prng.randint(torch.zeros(3, dtype=torch.int64), (3,), 0, 2)


@functools.lru_cache(maxsize=None)
def _graphs(gname):
    fn, kw = GRAPH_SPECS[gname]
    return getattr(ref_graph, fn)(**kw), getattr(port_graph, fn)(**kw)


@functools.lru_cache(maxsize=None)
def _reference(gname, tset):
    ref_g, _ = _graphs(gname)
    ts = [ref_templates.get_template(t) for t in TEMPLATE_SETS[tset]]
    eng = ref_engine.CountingEngine(ref_g, ts, backend="edges", chunk_size=4)
    keys = jax.random.split(jax.random.PRNGKey(17), 6)
    est = eng.estimate(iterations=6, seed=17)
    return {
        "keys": np.asarray(keys),
        "count_keys": eng.count_keys(keys),
        "chunk": eng.count_keys_chunk(keys[:3]),
        "estimate": np.stack([e.per_iteration for e in est], axis=1),
        "means": [e.mean for e in est],
    }


@pytest.mark.parametrize("tset", list(TEMPLATE_SETS))
@pytest.mark.parametrize("gname", list(GRAPH_SPECS))
def test_key_driven_counting_matches_reference(gname, tset):
    want = _reference(gname, tset)
    _, g = _graphs(gname)
    ts = [port_templates.get_template(t) for t in TEMPLATE_SETS[tset]]
    eng = CountingEngine(g, ts, device="cpu", backend="edges", chunk_size=4)
    np.testing.assert_allclose(eng.count_keys(want["keys"]), want["count_keys"], rtol=RTOL)
    np.testing.assert_allclose(eng.count_keys(prng.split(prng.prng_key(17), 6)),
                               want["count_keys"], rtol=RTOL)
    chunk = eng.count_keys_chunk(want["keys"][:3])  # 3 keys padded to the chunk of 4
    assert chunk.shape == (3, len(ts))
    np.testing.assert_allclose(chunk, want["chunk"], rtol=RTOL)
    est = eng.estimate(iterations=6, seed=17)
    np.testing.assert_allclose(np.stack([e.per_iteration for e in est], axis=1),
                               want["estimate"], rtol=RTOL)
    np.testing.assert_allclose([e.mean for e in est], want["means"], rtol=RTOL)
    assert eng.trace_count == 1  # one chunk function served every call


def test_count_keys_chunk_bounds_and_blocked_backend():
    _, g = _graphs("er")
    t = port_templates.get_template("u5-2")
    keys = prng.split(prng.prng_key(3), 5)
    eng = CountingEngine(g, [t], device="cpu", backend="blocked", chunk_size=4)
    with pytest.raises(ValueError, match="exceeds chunk_size"):
        eng.count_keys_chunk(keys)
    assert eng.count_keys_chunk(keys[:0]).shape == (0, 1)
    edges = CountingEngine(g, [t], device="cpu", backend="edges", chunk_size=2)
    np.testing.assert_allclose(eng.count_keys(keys), edges.count_keys(keys), rtol=RTOL)


def test_engine_cache_key_follows_plan_equality():
    _, g = _graphs("er")
    other = port_graph.erdos_renyi_graph(600, 2400, seed=3)
    tri = port_templates.get_template("triangle")
    tri_p = port_templates.Template(name="tri2", edges=((1, 2), (0, 2), (0, 1)))
    dia = port_templates.get_template("diamond")
    dia_p = port_templates.Template(
        name="dia2", edges=tuple(sorted((3 - a, 3 - b) for a, b in dia.edges)))
    star4 = port_templates.Template(name="star4", edges=((0, 1), (0, 2), (0, 3)))
    for a, b in ((tri, tri_p), (dia, dia_p)):
        assert build_template_plan([a]) == build_template_plan([b])
        assert engine_cache_key(g, [a], device="cpu") == engine_cache_key(g, [b], device="cpu")
    square = port_templates.get_template("square")
    assert build_template_plan([square]) != build_template_plan([star4])
    assert engine_cache_key(g, [square], device="cpu") != engine_cache_key(g, [star4], device="cpu")
    u5 = [port_templates.get_template("u5-1")]
    key = engine_cache_key(g, u5, device="cpu")
    assert key != engine_cache_key(other, u5, device="cpu")
    assert engine_cache_key(g, u5, device="cpu", chunk_size=4) != engine_cache_key(
        g, u5, device="cpu", chunk_size=8)
    assert engine_cache_key(g, u5, device="cpu", dtype_policy="bf16") != key
    eng = CountingEngine(g, u5, device="cpu", chunk_size=4)
    assert eng.cache_key() == engine_cache_key(g, u5, device="cpu", chunk_size=4)
    assert eng.describe()["cache_key"] == eng.cache_key()
    # the anatomy is the reference's: same signature, canons, backend, dtypes
    ref_g, _ = _graphs("er")
    want = ref_engine.engine_cache_key(ref_g, [ref_templates.get_template("u5-1")],
                                       backend="edges", chunk_size=4)
    assert engine_cache_key(g, u5, device="cpu", backend="edges", chunk_size=4) == want


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(_REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_known_colorings_are_what_jax_draws():
    smoke = _chip_smoke()
    assert smoke.KNOWN_COLORINGS and smoke.KNOWN_SPLITS
    for (seed, data, n, k), values in smoke.KNOWN_COLORINGS.items():
        key = jax.random.fold_in(jax.random.PRNGKey(seed), data)
        assert list(np.asarray(jax.random.randint(key, (n,), 0, k))) == list(values)
    for (seed, num), words in smoke.KNOWN_SPLITS.items():
        assert np.asarray(jax.random.split(jax.random.PRNGKey(seed), num)).tolist() == [
            list(w) for w in words]
    # and the port's own draws, which the card's phase holds against them
    smoke.check_known_colorings(torch.device("cpu"))


def test_table_iii_rmat2k_counts_reproduce():
    """``benchmarks/bench_counting.py::_run_table_iii`` draws, for dataset
    rmat2k first, one ``rng.integers(0, k, size=n)`` coloring per template
    in the order u5-1, u5-2, u6, u7 from ``default_rng(0)``, and commits
    each raw colorful total to 4 digits."""
    with open(os.path.join(_REPO, "BENCH_counting.json")) as fh:
        rows = {r["name"]: r["derived"] for r in json.load(fh)["rows"]}
    smoke = _chip_smoke()
    got = smoke.table_iii_counts(torch.device("cpu"))
    ref_g = ref_graph.rmat_graph(2048, 20_000, seed=1)
    rng = np.random.default_rng(0)
    for tname, value in got.items():
        committed = rows[f"tableIII/rmat2k/{tname}/subgraph2vec"].split(";")[0]
        assert committed == f"count={value:.3e}" == f"count={smoke.TABLE_III_COUNTS[tname]:.3e}"
        t = ref_templates.get_template(tname)
        colors = rng.integers(0, t.k, size=ref_g.n)
        want = float(ref_engine.CountingEngine(ref_g, [t], backend="edges").raw_counts(colors)[0])
        assert value == pytest.approx(want, rel=RTOL)
