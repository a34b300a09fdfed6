"""The port's engine against the reference engine, end to end on the CPU.

The same numpy colorings go through ``repro.core.CountingEngine`` and
``repro_torch.core.CountingEngine(device="cpu")`` for u3-u7 on an R-MAT
graph of 2048 vertices (the benchmarks' rmat2k), an Erdos-Renyi graph and a
grid, for every ported backend.  fp32 is held at ``rtol=1e-5`` (the
reference's own bar across its backends); bf16 storage with fp32
accumulation at the reference's bf16 bar, ``rel=2e-2``.  On the CPU the
``blocked`` backend runs its kernels' plain versions.
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as ref_engine
from repro.core import graph as ref_graph
from repro.core import templates as ref_templates

from repro_torch.core import graph as port_graph
from repro_torch.core import templates as port_templates
from repro_torch.core.counting import brute_force_colorful, build_counting_plan
from repro_torch.core.engine import CountingEngine, DtypePolicy
from repro_torch.core.estimator import estimate_embeddings, required_iterations
from repro_torch.exec.select import BACKEND_ENV_VAR, BLOCKED_MIN_VERTICES, heuristic_backend

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GRAPH_SPECS = {
    "rmat2k": ("rmat_graph", dict(n=2048, num_edges=20_000, seed=1)),
    "er": ("erdos_renyi_graph", dict(n=600, num_edges=2400, seed=2)),
    "grid": ("grid_graph", dict(rows=20, cols=25)),
}
TEMPLATE_SETS = {"u3": ["u3"], "u5": ["u5-1", "u5-2"], "u6": ["u6"], "u7": ["u7"]}
BACKENDS = ["edges", "ell", "sell", "dense", "blocked"]
BF16_REL = 2e-2


@functools.lru_cache(maxsize=None)
def _graphs(gname):
    fn, kw = GRAPH_SPECS[gname]
    return getattr(ref_graph, fn)(**kw), getattr(port_graph, fn)(**kw)


def _colorings(gname, k, count=2):
    n = _graphs(gname)[0].n
    return np.random.default_rng(k * 1000 + n).integers(0, k, size=(count, n))


@functools.lru_cache(maxsize=None)
def _reference_raw(gname, tset, policy):
    ref_g, _ = _graphs(gname)
    ts = [ref_templates.get_template(t) for t in TEMPLATE_SETS[tset]]
    eng = ref_engine.CountingEngine(ref_g, ts, backend="edges", dtype_policy=policy)
    colors = jnp.asarray(_colorings(gname, ts[0].k))
    # what raw_counts computes per coloring, jitted once for both colorings
    return np.asarray(jax.jit(eng.backend_impl.counts_for_colors)(colors), dtype=np.float64)


def _port_engine(gname, tset, backend, policy, **kw):
    _, g = _graphs(gname)
    ts = [port_templates.get_template(t) for t in TEMPLATE_SETS[tset]]
    return CountingEngine(g, ts, device="cpu", backend=backend, dtype_policy=policy, **kw)


def _check(gname, tset, backend, policy, rel):
    want = _reference_raw(gname, tset, policy)
    eng = _port_engine(gname, tset, backend, policy, chunk_size=2)
    colors = _colorings(gname, eng.k)
    raw0 = eng.raw_counts(colors[0]).numpy().astype(np.float64)
    np.testing.assert_allclose(raw0, want[0], rtol=rel)
    est = eng.count_colorings(colors)
    assert est.shape == (2, len(eng.templates)) and est.dtype == np.float64
    np.testing.assert_allclose(est / eng._norm_factors.numpy()[None, :], want, rtol=rel)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("tset", list(TEMPLATE_SETS))
@pytest.mark.parametrize("gname", list(GRAPH_SPECS))
def test_engine_matches_reference_fp32(gname, tset, backend):
    _check(gname, tset, backend, "fp32", 1e-5)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("tset", list(TEMPLATE_SETS))
def test_engine_matches_reference_bf16(tset, backend):
    _check("rmat2k", tset, backend, "bf16", BF16_REL)


@pytest.mark.parametrize("tname", ["u3", "u5-2", "u6", "u7"])
@pytest.mark.parametrize("gname", ["grid", "er"])
def test_blocked_equals_brute_force_on_tiny_graphs(gname, tname):
    g = port_graph.grid_graph(4, 6) if gname == "grid" else port_graph.erdos_renyi_graph(30, 60, seed=5)
    t = port_templates.get_template(tname)
    plan = build_counting_plan(t)
    eng = CountingEngine(g, [t], device="cpu", backend="blocked")
    for seed in range(2):
        colors = np.random.default_rng(seed).integers(0, t.k, size=g.n)
        raw = float(eng.raw_counts(colors)[0]) / plan.automorphisms
        assert raw == brute_force_colorful(g, t, colors)


@pytest.mark.parametrize("tname", ["u3", "u5-2", "u7"])
def test_blocked_sends_every_tree_stage_to_the_fused_kernel(monkeypatch, tname):
    """The one-hot leaf's narrow passive included; the SpMM is never called."""
    from repro_torch.exec.local import BlockedEllBackend
    from repro_torch.kernels.spmm_ema import ops as ema_ops

    calls = []
    fused = ema_ops.spmm_ema

    def counted(operand, m_p, m_a, tables):
        calls.append((m_p.shape[2], tables.n_out))
        return fused(operand, m_p, m_a, tables)

    def no_spmm(self, m):
        raise AssertionError("a tree stage called the blocked SpMM")

    monkeypatch.setattr(ema_ops, "spmm_ema", counted)
    monkeypatch.setattr(BlockedEllBackend, "spmm", no_spmm)
    _, g = _graphs("er")
    t = port_templates.get_template(tname)
    eng = CountingEngine(g, [t], device="cpu", backend="blocked")
    eng.raw_counts(np.random.default_rng(0).integers(0, t.k, size=g.n))
    assert len(calls) == eng.counters["passive_aggregations"] > 0
    assert min(c_p for c_p, _ in calls) == t.k  # the leaf stage, k passive columns


@pytest.mark.parametrize("backend", ["edges", "blocked"])
def test_chunked_equals_unchunked_bit_exact(backend):
    _, g = _graphs("er")
    t = port_templates.get_template("u6")
    colors = np.random.default_rng(3).integers(0, t.k, size=(7, g.n))
    a = CountingEngine(g, [t], device="cpu", backend=backend, chunk_size=3).count_colorings(colors)
    b = CountingEngine(g, [t], device="cpu", backend=backend, chunk_size=1).count_colorings(colors)
    assert np.array_equal(a, b)


def test_default_device_is_the_card():
    _, g = _graphs("grid")
    t = port_templates.get_template("u3")
    if torch.cuda.is_available():
        assert CountingEngine(g, [t]).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            CountingEngine(g, [t])
        with pytest.raises(RuntimeError):
            estimate_embeddings(g, t, iterations=2)


def test_backend_selection_ladder(monkeypatch):
    _, g = _graphs("rmat2k")
    big = port_graph.rmat_graph(BLOCKED_MIN_VERTICES, 4 * BLOCKED_MIN_VERTICES, seed=1)
    assert heuristic_backend(big, "cuda")[0] == "blocked"
    assert heuristic_backend(big, "cpu")[0] != "blocked"
    assert heuristic_backend(g, "cuda")[0] != "blocked"  # below the threshold
    t = port_templates.get_template("u3")
    eng = CountingEngine(g, [t], device="cpu")
    assert eng.backend_source == "heuristic"
    monkeypatch.setenv(BACKEND_ENV_VAR, "blocked")
    eng = CountingEngine(g, [t], device="cpu")
    assert (eng.backend, eng.backend_source) == ("blocked", "env")
    monkeypatch.setenv(BACKEND_ENV_VAR, "bogus")
    with pytest.raises(ValueError, match=BACKEND_ENV_VAR):
        CountingEngine(g, [t], device="cpu")


def test_unported_paths_raise_with_their_roadmap_item():
    _, g = _graphs("grid")
    with pytest.raises(NotImplementedError, match="item 11"):
        CountingEngine(g, [port_templates.get_template("u3")], device="cpu", backend="mesh")
    # the mixed backend is ported (tests/test_torch_tune.py); without its
    # TuningConfig it refuses as the reference does
    with pytest.raises(ValueError, match="TuningConfig"):
        CountingEngine(g, [port_templates.get_template("u3")], device="cpu", backend="mixed")


def test_estimate_describe_and_policy():
    _, g = _graphs("er")
    t = port_templates.get_template("u5-1")
    eng = CountingEngine(g, [t], device="cpu", backend="blocked", chunk_size=4)
    res = eng.estimate(iterations=6, seed=11)[0]
    again = eng.estimate(iterations=6, seed=11)[0]
    assert res.per_iteration.shape == (6,) and np.isfinite(res.mean) and res.mean > 0
    assert np.array_equal(res.per_iteration, again.per_iteration)
    assert eng.trace_count == 1  # one chunk function, reused
    d = eng.describe()
    assert d["backend"]["name"] == "blocked" and d["chunk_size"] == 4
    assert d["memory"]["fusion_slack"] == 1.0 and d["device"] == "cpu"
    assert DtypePolicy.resolve("bf16") == DtypePolicy(torch.bfloat16, torch.float32)
    with pytest.raises(ValueError):
        DtypePolicy.resolve("fp8")
    assert required_iterations(t, 0.1, 0.1) == required_iterations(5, 0.1, 0.1)


def test_port_imports_neither_jax_nor_repro():
    """Every module of the port imports with ``jax`` and ``repro`` blocked."""
    code = r"""
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "repro")]
print(len(names))
"""
    env = dict(os.environ, PYTHONPATH=os.path.join(_REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15
