"""The tree walk's exact range shift (``CountingEngine.range``).

Scaling the one-hot leaf by ``2^-s`` scales every ``m``-vertex state by
exactly ``2^(-s m)``: on every local backend, estimates and raw totals with
a forced shift equal those of the unshifted walk bit for bit.  The float64
homomorphism bound the engine picks the shift from holds every entry of
every state, every aggregate and every total; a small case whose margin is
set low takes a shift and agrees with the plain float64 reference; bag
plans keep shift 0; a shift that would push a count of one below fp32's
normal range is refused at build.  The file imports neither ``jax`` nor
``repro``.
"""

import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench.reference import colorcoding, threefry
from repro_torch import obs
from repro_torch.core import engine as engine_mod
from repro_torch.core.engine import CountingEngine, choose_range_shift, rooted_homomorphisms
from repro_torch.core.graph import rmat_graph
from repro_torch.core.prng import prng_key, split
from repro_torch.core.templates import get_template
from repro_torch.exec.local import LOCAL_BACKEND_CLASSES, LocalBackend

TREES = ("u3", "u5-1", "u5-2", "u6", "u7", "u10", "u12")
BACKENDS = sorted(LOCAL_BACKEND_CLASSES)
SHIFTS = (1, 3, 7)


def small_graph(seed=3):
    return rmat_graph(64, 300, seed=seed)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: beside the other test workers, more would only
    contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def engine(graph, names, backend="edges", **kw):
    return CountingEngine(graph, [get_template(t) for t in names], device="cpu", backend=backend,
                          **kw)


def force_shift(eng, shift):
    eng.range_shift = shift


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", TREES)
def test_forced_shift_is_bitwise_equal(name, backend):
    g = small_graph()
    eng = engine(g, [name], backend=backend, chunk_size=3, column_batch=128)
    assert eng.range_shift == 0
    keys = split(prng_key(11), 3)
    colors = torch.randint(0, eng.k, (g.n,), generator=torch.Generator().manual_seed(4))
    want_est, want_raw = eng.count_keys(keys), eng.raw_counts(colors)
    assert want_raw.dtype == torch.float64 and np.all(want_est > 0)
    for shift in SHIFTS:
        force_shift(eng, shift)
        got_est, got_raw = eng.count_keys(keys), eng.raw_counts(colors)
        assert np.array_equal(got_est, want_est), (shift, got_est, want_est)
        assert torch.equal(got_raw, want_raw), shift


def state_recorder(eng, seen):
    """Wrap the engine's per-group seam: record each stage's passive
    aggregate (a dense float64 product) and each output, by canon."""
    ir, impl = eng.plan_ir, eng.backend_impl
    adj = torch.as_tensor(eng.graph.dense_adjacency(), dtype=torch.float64)
    inner = impl._group_aggregate

    def recorded(leader, m_p, stage_inputs):
        outs = inner(leader, m_p, stage_inputs)
        p, i = leader
        sub = ir.counting_plans[p].partition.subs[i]
        passive = ir.canons[p][sub.passive]
        seen.append(("agg", passive, (adj @ m_p.double().reshape(m_p.shape[0], -1))))
        for (q, j), out in zip(ir.exec_groups[leader], outs):
            seen.append(("out", ir.canons[q][j], out.double().reshape(out.shape[0], -1)))
        return outs

    impl._group_aggregate = recorded


@pytest.mark.parametrize("case", range(6))
def test_homomorphism_bound_holds_every_state(case):
    rng = np.random.default_rng(case)
    names = [TREES[i] for i in sorted(rng.choice(len(TREES), size=2, replace=False))]
    names = [n for n in names if get_template(n).k == get_template(names[-1]).k] or names[-1:]
    g = rmat_graph(int(rng.integers(40, 120)), int(rng.integers(150, 600)), seed=case)
    eng = engine(g, names, backend=BACKENDS[case % len(BACKENDS)], chunk_size=2)
    hom, agg = rooted_homomorphisms(eng.plan_ir, g, torch.device("cpu"))
    adj = torch.as_tensor(g.dense_adjacency(), dtype=torch.float64)
    seen = []
    state_recorder(eng, seen)
    keys = split(prng_key(case), 4)
    est = eng.count_keys(keys)
    assert {kind for kind, _, _ in seen} == {"agg", "out"}
    for kind, canon, value in seen:
        bound = hom[canon] if kind == "out" else adj @ hom[canon]
        assert torch.all(value <= bound[:, None]), (kind, canon)
    for st in eng.plan_ir.stages:  # a stage: its active's maps times its passive's, summed
        if st.passive_canon is not None:
            assert torch.equal(agg[st.canon], adj @ hom[st.passive_canon])
            assert torch.equal(hom[st.canon], hom[st.active_canon] * agg[st.canon])
    for t, plan in enumerate(eng.plans):
        root = hom[eng.plan_ir.canons[t][plan.partition.root_index]].sum().item()
        assert np.all(est[:, t] <= root * eng._norms[t])


@pytest.mark.parametrize("name,margin", [("u7", 9), ("u10", 12), ("u12", 14)])
def test_low_margin_takes_a_shift_and_matches_the_reference(monkeypatch, name, margin):
    monkeypatch.setattr(engine_mod, "RANGE_MARGIN_LOG2", margin)
    g = small_graph(seed=5)
    eng = engine(g, [name], backend="blocked", chunk_size=2)
    rng = eng.describe()["range"]
    assert eng.range_shift > 0 and rng["shift"] == eng.range_shift == eng.counters["range_shift"]
    assert rng["margin_log2"] == margin and rng["shifted_log2"] < margin <= rng["bound_log2"]
    keys = split(prng_key(7), 3)
    est = eng.count_keys(keys)
    src, dst = torch.as_tensor(g.src, dtype=torch.int64), torch.as_tensor(g.dst, dtype=torch.int64)
    adj = colorcoding.Adjacency(src, dst, g.n, dense=False)
    edges = [tuple(e) for e in get_template(name).edges]
    for j in range(keys.shape[0]):
        colors = threefry.randint(threefry.split(threefry.prng_key(7), 3)[j], g.n, eng.k)
        want = colorcoding.estimate(adj, colors, edges)
        assert want > 0 and abs(est[j, 0] - want) <= 1e-5 * want, (j, est[j, 0], want)


@pytest.mark.parametrize("names", [["triangle"], ["path4", "square"], ["diamond"]])
def test_bag_plans_keep_shift_zero(monkeypatch, names):
    monkeypatch.setattr(engine_mod, "RANGE_MARGIN_LOG2", 1)
    eng = engine(small_graph(), names, chunk_size=2)
    assert eng.range_shift == 0 and eng.counters["range_shift"] == 0
    rng = eng.describe()["range"]
    assert rng["shift"] == 0 and rng["bound_log2"] is None and rng["why"] == "a bag plan"
    est = eng.count_keys(split(prng_key(1), 2))
    assert np.all(np.isfinite(est))


@pytest.mark.parametrize("bounds,k,refused", [
    ([(198.7, 18), (150.0, 10)], 18, False),  # u18 on 2^17 vertices: s = 5, 90 of 126
    ([(500.0, 18)], 18, True),  # s = 22: a count of one would read 2^-396
    ([(400.0, 20)], 20, True),  # s = 15: 2^-300
])
def test_shift_past_the_normal_range_is_refused(bounds, k, refused):
    if refused:
        with pytest.raises(ValueError, match=r"bounded by 2\^.*below fp32's smallest normal"):
            choose_range_shift(bounds, k, [1.0], 110)
    else:
        got = choose_range_shift(bounds, k, [1.0], 110)
        assert got.shift == 5 and got.shifted_log2 == pytest.approx(108.7)


def test_engine_refuses_a_shift_past_the_normal_range(monkeypatch):
    monkeypatch.setattr(engine_mod, "RANGE_MARGIN_LOG2", -200)
    with pytest.raises(ValueError, match="below fp32's smallest normal"):
        engine(small_graph(), ["u12"])


def test_choice_is_the_smallest_shift():
    got = choose_range_shift([(120.0, 12), (100.0, 6), (3.0, 2)], 12, [2.0], 110)
    # (120 - 110) / 12 -> 1; 100 under the margin already
    assert got.shift == 1 and got.bound_log2 == 120.0 and got.shifted_log2 == 108.0
    assert choose_range_shift([(109.9, 12)], 12, [1.0], 110).shift == 0
    assert choose_range_shift([(-math.inf, 3)], 3, [1.0], 110).bound_log2 is None


def test_spans_time_the_shift(monkeypatch):
    monkeypatch.setattr(engine_mod, "RANGE_MARGIN_LOG2", 9)
    g = small_graph()
    with profile(activities=[ProfilerActivity.CPU]):
        eng = engine(g, ["u7"], chunk_size=2)
        eng.count_keys(split(prng_key(3), 2))
    assert eng.range_shift > 0
    assert len(obs.spans("repro_torch.engine.range_bound")) == 1
    # the leaf's scale and the float64 assembly of the one chunk
    assert len(obs.spans("repro_torch.engine.range")) == 2


def test_only_local_backends_scale_the_leaf():
    assert all(cls.scales_leaf for cls in LOCAL_BACKEND_CLASSES.values())
    assert LocalBackend.scales_leaf
    from repro_torch.exec.mesh import MeshBackend

    assert not MeshBackend.scales_leaf
