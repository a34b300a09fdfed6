"""The port's CUDA kernels against their plain versions, on a card.

Every test here is marked ``cuda`` and skips without a card; on one, run::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The file imports neither ``jax`` nor ``repro``, so it runs where only
PyTorch is installed.  Graphs have isolated trailing vertices (empty
destination blocks) and ``n`` that is no multiple of any block size.
Tolerances: the plain versions sum with ``index_add_``, whose CUDA atomics
add in no fixed order, and the kernels contract multiply-adds into FMAs.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.colorsets import binom, build_split_table
from repro_torch.core.counting import brute_force_colorful, build_counting_plan
from repro_torch.core.engine import CountingEngine
from repro_torch.core.graph import Graph, grid_graph, rmat_graph
from repro_torch.core.templates import get_template
from repro_torch.kernels.spmm_blocked.ops import prepare_operand, spmm_blocked
from repro_torch.kernels.spmm_blocked.ref import spmm_ref
from repro_torch.kernels.spmm_ema.ops import prepare_stage_tables, spmm_ema
from repro_torch.kernels.spmm_ema.ref import spmm_ema_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _graph():
    g = rmat_graph(3000, 12000, seed=2)
    return Graph(n=3100, src=g.src, dst=g.dst)


@pytest.mark.parametrize("cols", [1, 24, 130])
def test_spmm_blocked_kernel(card, cols):
    g = _graph()
    op = prepare_operand(g, card)
    m = torch.rand((g.n, cols), device=card)
    before = spmm_blocked.launches
    got = spmm_blocked(op, m)
    torch.cuda.synchronize()
    assert spmm_blocked.launches == before + 1
    torch.testing.assert_close(got, spmm_ref(op.src, op.dst, g.n, m), rtol=1e-4, atol=1e-5)
    assert float(got[3000:].abs().max()) == 0.0


@pytest.mark.parametrize("k,m,m_a,bsz", [(7, 4, 1, 3), (7, 7, 3, 2), (12, 6, 4, 1), (16, 9, 1, 1)])
def test_spmm_ema_kernel(card, k, m, m_a, bsz):
    """(16, 9, 1) has 11,440 outputs: more than one output tile."""
    g = _graph()
    op = prepare_operand(g, card)
    table = build_split_table(k, m, m_a)
    tables = prepare_stage_tables(table.idx_a, table.idx_p, binom(k, m - m_a), binom(k, m_a), card)
    m_p = torch.rand((g.n, bsz, binom(k, m - m_a)), device=card)
    m_aa = torch.rand((g.n, bsz, binom(k, m_a)), device=card)
    before = spmm_ema.launches
    got = spmm_ema(op, m_p, m_aa, tables)
    torch.cuda.synchronize()
    assert spmm_ema.launches == before + 1
    want = spmm_ema_ref(op.src, op.dst, g.n, m_p, m_aa, tables.idx_a, tables.idx_p)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_blocked_engine_on_card_matches_edges_and_brute_force(card):
    g = _graph()
    t = get_template("u7")
    colors = np.random.default_rng(0).integers(0, t.k, size=(3, g.n))
    blocked = CountingEngine(g, [t], backend="blocked", chunk_size=2)
    assert blocked.device.type == "cuda"
    edges = CountingEngine(g, [t], backend="edges", chunk_size=2)
    np.testing.assert_allclose(
        blocked.count_colorings(colors), edges.count_colorings(colors), rtol=1e-5
    )
    tiny = grid_graph(4, 6)
    for tname in ("u5-2", "u7"):
        plan = build_counting_plan(get_template(tname))
        eng = CountingEngine(tiny, [plan.template], backend="blocked")
        c = np.random.default_rng(1).integers(0, plan.template.k, size=tiny.n)
        before = spmm_ema.launches
        raw = float(eng.raw_counts(c)[0]) / plan.automorphisms
        assert spmm_ema.launches > before  # every stage went through the fused kernel
        assert raw == brute_force_colorful(tiny, plan.template, c)
