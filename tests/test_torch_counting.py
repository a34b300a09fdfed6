"""The port's tree DP (``repro_torch.core.counting``) against the reference.

Per coloring: brute force == traversal (Algorithm 2) == vectorized DP
(Algorithm 5) with the ``index_add_`` and ELL SpMMs, in both packages, on
the same graphs and numpy colorings (mirrors ``tests/test_counting.py``).
"""

from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import counting as ref_counting
from repro.core import graph as ref_graph
from repro.core import templates as ref_templates

from repro_torch.core import counting, graph, templates

GRAPHS = {
    "grid": (dict(rows=4, cols=5), "grid_graph"),
    "er": (dict(n=24, num_edges=50, seed=3), "erdos_renyi_graph"),
}


@pytest.mark.parametrize("tname", ["u3", "u5-1", "u5-2", "u6", "u7"])
@pytest.mark.parametrize("gname", list(GRAPHS))
def test_exactness_chain_per_coloring(gname, tname):
    kw, fn = GRAPHS[gname]
    rg, pg = getattr(ref_graph, fn)(**kw), getattr(graph, fn)(**kw)
    rt, pt = ref_templates.get_template(tname), templates.get_template(tname)
    rplan, pplan = ref_counting.build_counting_plan(rt), counting.build_counting_plan(pt)
    assert pplan.automorphisms == rplan.automorphisms
    colors = np.random.default_rng(42).integers(0, pt.k, size=pg.n)

    bf = counting.brute_force_colorful(pg, pt, colors)
    assert bf == ref_counting.brute_force_colorful(rg, rt, colors)
    assert counting.count_colorful_traversal(pplan, pg, colors) / pplan.automorphisms == bf

    src = torch.as_tensor(pg.src, dtype=torch.long)
    dst = torch.as_tensor(pg.dst, dtype=torch.long)
    vec = float(counting.count_colorful_vectorized(
        pplan, torch.as_tensor(colors), partial(counting.spmm_edges, src, dst, pg.n)))
    ref = float(ref_counting.count_colorful_vectorized(
        rplan, jnp.asarray(colors),
        partial(ref_counting.spmm_edges, jnp.asarray(rg.src), jnp.asarray(rg.dst), rg.n)))
    assert vec == pytest.approx(ref, rel=1e-6)
    assert vec / pplan.automorphisms == pytest.approx(bf, rel=1e-6)

    nbr, mask = pg.ell()
    ell = float(counting.count_colorful_vectorized(
        pplan, torch.as_tensor(colors),
        partial(counting.spmm_ell, torch.as_tensor(nbr, dtype=torch.long), torch.as_tensor(mask))))
    assert ell == pytest.approx(vec, rel=1e-6)


@pytest.mark.parametrize("k,m,m_a,width", [(5, 3, 1, 2), (7, 5, 3, 8), (6, 6, 3, 4)])
def test_fused_aggregate_ema_matches_reference(k, m, m_a, width):
    rg, pg = ref_graph.rmat_graph(150, 700, seed=k * m), graph.rmat_graph(150, 700, seed=k * m)
    from repro.core.colorsets import bucketed_split_entries as ref_bucket
    from repro.core.colorsets import build_split_table as ref_table
    from repro_torch.core.colorsets import binom, bucketed_split_entries, build_split_table

    rng = np.random.default_rng(0)
    m_p = rng.standard_normal((pg.n, 2, binom(k, m - m_a))).astype(np.float32)
    m_a_ = rng.standard_normal((pg.n, 2, binom(k, m_a))).astype(np.float32)
    rt = ref_table(k, m, m_a)
    ref_batches = tuple(
        (lo, w, jnp.asarray(ia), jnp.asarray(ip), None if va is None else jnp.asarray(va))
        for lo, w, ia, ip, va in ref_bucket(rt, width)
    )
    import jax

    def ref_spmm(x):
        return jax.ops.segment_sum(x[jnp.asarray(rg.src)], jnp.asarray(rg.dst), num_segments=rg.n)

    want = ref_counting.fused_aggregate_ema(
        jnp.asarray(m_p), jnp.asarray(m_a_), ref_batches, rt.n_out, ref_spmm, jnp.float32)
    pt = build_split_table(k, m, m_a)
    batches = tuple(
        (lo, w, torch.as_tensor(ia, dtype=torch.long), torch.as_tensor(ip, dtype=torch.long),
         None if va is None else torch.as_tensor(va))
        for lo, w, ia, ip, va in bucketed_split_entries(pt, width)
    )
    src = torch.as_tensor(pg.src, dtype=torch.long)
    dst = torch.as_tensor(pg.dst, dtype=torch.long)
    got = counting.fused_aggregate_ema(
        torch.from_numpy(m_p), torch.from_numpy(m_a_), batches, pt.n_out,
        partial(counting.spmm_edges, src, dst, pg.n), torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


def test_liveness_and_normalization_equal():
    names = ["u5-1", "u5-2"]
    rplans = [ref_counting.build_counting_plan(ref_templates.get_template(n)) for n in names]
    pplans = [counting.build_counting_plan(templates.get_template(n)) for n in names]
    rc = [p.stage_canons() for p in rplans]
    pc = [p.stage_canons() for p in pplans]
    assert rc == pc
    for track in (False, True):
        assert ref_counting.schedule_liveness(rplans, rc, track) == counting.schedule_liveness(
            pplans, pc, track)
        assert ref_counting.liveness_peak_columns(rplans, rc, 4, track) == (
            counting.liveness_peak_columns(pplans, pc, 4, track))
    assert ref_counting.liveness_peak_elements(rplans, rc, 50) == counting.liveness_peak_elements(
        pplans, pc, 50)
    assert float(ref_counting.normalize_count(1e6, rplans[0])) == pytest.approx(
        counting.normalize_count(1e6, pplans[0]), rel=1e-6)
