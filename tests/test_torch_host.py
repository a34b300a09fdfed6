"""The port's host side against the reference: graphs, layouts, split
tables, canonical forms, plans and the cost model's picks.

Inputs are built from the same seeds in both packages (the host modules are
NumPy in both), and every comparison is exact.
"""

import dataclasses
import hashlib
import os

import numpy as np
import pytest

from repro.core import colorsets as ref_colorsets
from repro.core import graph as ref_graph
from repro.core import templates as ref_templates
from repro.plan import cost as ref_cost
from repro.plan import ir as ref_ir

from repro_torch import interop
from repro_torch.core import colorsets, graph as port_graph, templates
from repro_torch.plan import cost, ir

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GRAPHS = [
    ("rmat", dict(n=700, num_edges=3000, seed=4)),
    ("rmat", dict(n=2048, num_edges=20_000, seed=1)),
    ("er", dict(n=333, num_edges=1200, seed=2)),
    ("grid", dict(rows=7, cols=9)),
]


def _pair(kind, kw):
    fn = {"rmat": "rmat_graph", "er": "erdos_renyi_graph", "grid": "grid_graph"}[kind]
    return getattr(ref_graph, fn)(**kw), getattr(port_graph, fn)(**kw)


@pytest.mark.parametrize("kind,kw", GRAPHS)
def test_graphs_and_signatures_equal(kind, kw):
    ref, port = _pair(kind, kw)
    assert ref.n == port.n
    np.testing.assert_array_equal(ref.src, port.src)
    np.testing.assert_array_equal(ref.dst, port.dst)
    assert ref.signature() == port.signature()
    for a, b in zip(ref.csr(), port.csr()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind,kw", GRAPHS[::2])
def test_layouts_equal(kind, kw):
    ref, port = _pair(kind, kw)
    for a, b in zip(ref.ell(), port.ell()):
        np.testing.assert_array_equal(a, b)
    rs, ps = ref_graph.build_sell(ref, group_size=64), port_graph.build_sell(port, group_size=64)
    assert rs.padded_slots == ps.padded_slots
    np.testing.assert_array_equal(rs.inv_order, ps.inv_order)
    for field in ("group_rows", "group_nbr", "group_mask"):
        for a, b in zip(getattr(rs, field), getattr(ps, field)):
            np.testing.assert_array_equal(a, b)
    rb = ref_graph.build_blocked_ell(ref, block_size=128)
    pb = port_graph.build_blocked_ell(port, block_size=128)
    for field in dataclasses.fields(rb):
        np.testing.assert_array_equal(getattr(rb, field.name), getattr(pb, field.name))


def test_interop_graph_roundtrip():
    ref = ref_graph.rmat_graph(500, 2500, seed=3)
    port = interop.graph_from_arrays(ref.n, ref.src, ref.dst)
    assert port.signature() == ref.signature()
    with pytest.raises(ValueError, match="sorted"):
        interop.graph_from_arrays(ref.n, ref.src[::-1], ref.dst[::-1])
    colors = np.random.default_rng(0).integers(0, 5, size=(3, ref.n))
    t = interop.colorings_to_tensor(colors, "cpu")
    assert t.dtype.is_floating_point is False and t.shape == (3, ref.n)
    np.testing.assert_array_equal(t.numpy(), colors)


@pytest.mark.parametrize("k,m,m_a", [(5, 3, 1), (7, 4, 2), (12, 6, 4), (12, 12, 5)])
def test_split_tables_and_buckets_equal(k, m, m_a):
    rt = ref_colorsets.build_split_table(k, m, m_a)
    pt = colorsets.build_split_table(k, m, m_a)
    np.testing.assert_array_equal(rt.idx_a, pt.idx_a)
    np.testing.assert_array_equal(rt.idx_p, pt.idx_p)
    for width in (4, 16, 64):
        rb = ref_colorsets.bucketed_split_entries(rt, width)
        pb = colorsets.bucketed_split_entries(pt, width)
        assert len(rb) == len(pb)
        for r, p in zip(rb, pb):
            assert r[:2] == p[:2]
            for a, b in zip(r[2:], p[2:]):
                if a is None:
                    assert b is None
                else:
                    np.testing.assert_array_equal(a, b)


def test_union_split_tables_equal():
    for args in [(6, 3, 3, 1), (7, 4, 3, 2)]:
        rt = ref_colorsets.build_union_split_table(*args)
        pt = colorsets.build_union_split_table(*args)
        np.testing.assert_array_equal(rt.idx_a, pt.idx_a)
        np.testing.assert_array_equal(rt.idx_p, pt.idx_p)


def test_tree_canons_hash_to_committed_digest():
    payload = [
        f"{name}: {ir.template_canon_sequence(templates.PAPER_TEMPLATES[name])!r}"
        for name in sorted(templates.PAPER_TEMPLATES)
    ]
    digest = hashlib.sha256("\n".join(payload).encode()).hexdigest()
    with open(os.path.join(_REPO, "scripts", "tree_canons.sha256")) as fh:
        assert digest == fh.read().strip()


PLAN_SETS = [
    ["u3"], ["u5-1"], ["u5-2"], ["u6"], ["u7"], ["u10"], ["u12"], ["u13"],
    ["u14"], ["u15-1"], ["u15-2"], ["u16"], ["u5-1", "u5-2"], ["u7", "u7"],
    ["triangle"], ["square", "diamond"], ["cycle5", "clique5", "u5-1"],
]


@pytest.mark.parametrize("names", PLAN_SETS, ids=lambda ns: "+".join(ns))
def test_template_plans_equal(names):
    rp = ref_ir.build_template_plan([ref_templates.get_template(n) for n in names])
    pp = ir.build_template_plan([templates.get_template(n) for n in names])
    assert rp.schedule_key() == pp.schedule_key()
    assert [dataclasses.astuple(s) for s in rp.stages] == [
        dataclasses.astuple(s) for s in pp.stages
    ]
    assert dict(rp.free_at) == dict(pp.free_at)
    assert dict(rp.exec_groups) == dict(pp.exec_groups)
    assert (rp.peak_columns, rp.max_passive_columns, rp.max_stage_columns) == (
        pp.peak_columns, pp.max_passive_columns, pp.max_stage_columns
    )
    assert (rp.has_bag_stages, rp.decomposition_widths) == (
        pp.has_bag_stages, pp.decomposition_widths
    )


@pytest.mark.parametrize("name", ["u3", "u6", "u7", "u12"])
@pytest.mark.parametrize("target", ["edges", "ell", "dense", "blocked"])
def test_cost_picks_equal_with_slack_pinned(name, target):
    import jax.numpy as jnp
    import torch

    g_ref, g_port = _pair("rmat", dict(n=2048, num_edges=20_000, seed=1))
    rp = ref_ir.build_template_plan([ref_templates.get_template(name)])
    pp = ir.build_template_plan([templates.get_template(name)])
    for jdt, tdt in [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]:
        rc = ref_cost.CostModel(rp, g_ref, jdt, fusion_slack=1.0)
        pc = cost.CostModel(pp, g_port, tdt)
        assert pc.fusion_slack == 1.0
        assert rc.pick_local_column_batch() == pc.pick_local_column_batch()
        cb = pc.pick_local_column_batch()
        assert rc.resident_elements() == pc.resident_elements()
        assert rc.transient_elements(target, cb) == pc.transient_elements(target, cb)
        rb = rc.bytes_per_coloring(rc.transient_elements(target, cb), rc.resident_elements())
        pb = pc.bytes_per_coloring(pc.transient_elements(target, cb), pc.resident_elements())
        assert rb == pb
        for budget in (1 << 20, 32 << 20, 48 << 30):
            assert rc.pick_chunk_size(rb, budget) == pc.pick_chunk_size(pb, budget)


def test_graphlet_decompositions_equal():
    ref_gl = ref_templates.connected_graphlets(5)
    port_gl = templates.connected_graphlets(5)
    assert [t.edges for t in ref_gl] == [t.edges for t in port_gl]
    for rt, pt in zip(ref_gl, port_gl):
        rd, pd = ref_templates.build_tree_decomposition(rt), templates.build_tree_decomposition(pt)
        assert (rd.width, rd.bags, rd.parent) == (pd.width, pd.bags, pd.parent)
