"""The port's counting service against the reference's, on the CPU.

Mirrors ``tests/test_stopping.py``, ``tests/test_service.py`` and the
service half of ``tests/test_faults.py``: every scenario runs twice, once
through ``repro.serve.CountingService`` and once through
``repro_torch.serve.counting.CountingService(device="cpu")``, with the same
graphs, submissions, seeds, fault plans and a ``ManualClock`` each, and the
outcomes must agree: statuses, iteration counts, retry counts, stopping
decisions, error kinds, fault counters and ladder walks exactly; estimates
at ``rtol=1e-5`` (the two frameworks sum fp32 in different orders).  The
reference's fusion slack is pinned to 1.0, the port's, so both pick and
price the same chunks.  The reference's service walks its own degradation
ladder minus the rungs the port leaves out (the fallback to ``edges``, and
the column-batch rungs on ``blocked``), so a walk that would take one of
them is compared as the port walks it.
"""

import functools
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.plan.cost as ref_cost
import repro.serve as ref_serve
import repro.serve.counting as ref_service_module
import repro.testing.faults as ref_faults
from repro.core import graph as ref_graph
from repro.serve.stopping import AdaptiveStopper as RefStopper

import repro_torch.testing.faults as port_faults
from repro_torch.core import graph as port_graph
from repro_torch.core.engine import CountingEngine
from repro_torch.core.prng import fold_in, prng_key
from repro_torch.core.templates import connected_graphlets, get_template
from repro_torch.serve import counting as port_counting
from repro_torch.serve import qos as port_qos
from repro_torch.serve import resilience as port_resilience
from repro_torch.serve.cache import EngineCache
from repro_torch.serve.stopping import AdaptiveStopper, adaptive_estimate, normal_quantile

RTOL = 1e-5
CHUNK = 8
GRAPHS = {"a": (160, 700, 2), "b": (140, 520, 3)}
FAST = dict(max_retries=3, backoff_base=0.0)

REF = SimpleNamespace(
    name="reference", Service=ref_serve.CountingService, Clock=ref_serve.ManualClock,
    RetryPolicy=ref_serve.RetryPolicy, FaultPlan=ref_faults.FaultPlan,
    FaultSpec=ref_faults.FaultSpec, graph=ref_graph.rmat_graph, kwargs={},
    QuarantinedError=ref_serve.QuarantinedError,
)
PORT = SimpleNamespace(
    name="port", Service=port_counting.CountingService, Clock=port_qos.ManualClock,
    RetryPolicy=port_resilience.RetryPolicy, FaultPlan=port_faults.FaultPlan,
    FaultSpec=port_faults.FaultSpec, graph=port_graph.rmat_graph, kwargs={"device": "cpu"},
    QuarantinedError=port_resilience.QuarantinedError,
)


def _reference_ladder_as_ported(chunk_size, column_batch, backend):
    return [r for r in ref_cost.degradation_ladder(chunk_size, column_batch, backend)
            if r.action != "fallback_backend"
            and not (backend == "blocked" and r.action == "shrink_columns")]


@pytest.fixture(autouse=True)
def _reference_slack_pinned(monkeypatch):
    monkeypatch.setattr(ref_cost, "load_fusion_slack", lambda path=None: 1.0)
    monkeypatch.setattr(ref_service_module, "degradation_ladder", _reference_ladder_as_ported)


@functools.lru_cache(maxsize=None)
def _build_graph(graph_fn, name):
    n, e, s = GRAPHS[name]
    return graph_fn(n, e, seed=s)


def _graph(side, name):
    return _build_graph(side.graph, name)


def _service(side, **kw):
    kw.setdefault("chunk_size", CHUNK)
    kw.setdefault("retry_policy", side.RetryPolicy(**FAST))
    kw.setdefault("clock", side.Clock())
    svc = side.Service(**side.kwargs, **kw)
    for name in GRAPHS:
        svc.register_graph(name, _graph(side, name))
    return svc


def _outcome(svc, queries):
    """What must agree between the two services."""
    out = []
    for q in queries:
        rec = {"status": q.status, "iterations": q.iterations, "retries": q.retries,
               "degraded": q.degraded, "error": None if q.error is None else q.error.kind}
        if q.done:
            rec["means"] = [e.mean for e in q.result()]
            rec["converged"] = [e.converged for e in q.result()]
            rec["halfwidth"] = [e.halfwidth for e in q.result()]
        out.append(rec)
    stats = svc.stats()
    faults = {k: stats["faults"][k] for k in
              ("transient", "memory", "deterministic", "invalid", "non_finite", "retries")}
    ladder = [[{k: v for k, v in r.items()} for r in walk]
              for walk in stats["faults"]["ladder"].values()]
    return {"queries": out, "faults": faults, "ladder": ladder,
            "launches": stats["launches"], "completed": stats["queries_completed"],
            "failed": stats["queries_failed"], "degraded": stats["queries_degraded"]}


def _assert_same(ref, port):
    assert len(ref["queries"]) == len(port["queries"])
    for r, p in zip(ref["queries"], port["queries"]):
        for key in ("status", "iterations", "retries", "degraded", "error"):
            assert r[key] == p[key], (key, r, p)
        if "means" in r:
            np.testing.assert_allclose(p["means"], r["means"], rtol=RTOL)
            np.testing.assert_allclose(p["halfwidth"], r["halfwidth"], rtol=1e-4)
            assert p["converged"] == r["converged"]
    for key in ("faults", "ladder", "launches", "completed", "failed", "degraded"):
        assert ref[key] == port[key], (key, ref[key], port[key])


def _fixed_and_batched(side):
    svc = _service(side)
    qs = [svc.submit("a", t, iterations=it, seed=s)
          for t, it, s in (("u3", 5, 11), ("u3", 3, 22), ("u5-1", 9, 1), ("u7", 4, 2))]
    qs.append(svc.submit("b", ["u3", "triangle"], iterations=6, seed=3))
    svc.run()
    return svc, qs


def _adaptive(side):
    svc = _service(side)
    qs = [svc.submit("a", "u5-1", epsilon=0.1, delta=0.1, iterations=256, seed=9),
          svc.submit("a", "u5-2", epsilon=0.2, delta=0.05, iterations=64, seed=4,
                     bound="bernstein"),
          svc.submit("b", "triangle", epsilon=0.5, delta=0.2, iterations=40, seed=6)]
    svc.run()
    return svc, qs


def _transient_retries(side):
    svc = _service(side)
    with side.FaultPlan([side.FaultSpec(site="launch", kind="transient", max_fires=2)], seed=11):
        q = svc.submit("a", "u3", iterations=24, seed=7)
        svc.run()
    return svc, [q]


def _retries_exhausted(side):
    svc = _service(side)
    with side.FaultPlan([side.FaultSpec(site="launch", kind="transient")], seed=0):
        q = svc.submit("a", "u3", iterations=8, seed=1,
                       retry_policy=side.RetryPolicy(max_retries=2, backoff_base=0.0))
        svc.run()
    return svc, [q]


def _launch_mates(side):
    svc = _service(side)
    with side.FaultPlan([side.FaultSpec(site="launch", kind="transient", max_fires=3)], seed=0):
        doomed = svc.submit("a", "u3", iterations=16, seed=9,
                            retry_policy=side.RetryPolicy(max_retries=0))
        survivor = svc.submit("a", "u3", iterations=16, seed=3)
        svc.run()
    return svc, [doomed, survivor]


def _memory_rung(side):
    svc = _service(side)
    with side.FaultPlan([side.FaultSpec(site="launch", kind="memory", max_fires=1)], seed=5):
        q = svc.submit("a", "u3", iterations=24, seed=7)
        svc.run()
    return svc, [q]


def _ladder_exhausted(side):
    svc = _service(side, chunk_size=2)
    with side.FaultPlan([side.FaultSpec(site="engine_build", kind="memory")], seed=0):
        q = svc.submit("a", "u3", iterations=8, seed=1)
        svc.run()
    return svc, [q]


def _ladder_exhausted_blocked(side):
    svc = _service(side, chunk_size=4, backend="blocked")
    with side.FaultPlan([side.FaultSpec(site="engine_build", kind="memory")], seed=0):
        q = svc.submit("a", "u3", iterations=8, seed=1)
        svc.run()
    return svc, [q]


def _quarantine(side):
    svc = _service(side)
    clk = svc.clock
    with side.FaultPlan([side.FaultSpec(site="launch", kind="deterministic", max_fires=2)],
                        seed=0):
        q1 = svc.submit("a", "u3", iterations=8, seed=1)
        svc.run()
        q2 = svc.submit("a", "u3", iterations=8, seed=2)
        svc.run()
        with pytest.raises(side.QuarantinedError):
            svc.submit("a", "u3", iterations=8, seed=3)
        ok = svc.submit("b", "u3", iterations=8, seed=1)
        svc.run()
    clk.advance(svc.quarantine_base_s + 1.0)
    q4 = svc.submit("a", "u3", iterations=8, seed=1)
    svc.run()
    return svc, [q1, q2, ok, q4]


def _deadlines(side):
    svc = _service(side)
    q = svc.submit("a", "u3", epsilon=1e-9, iterations=64, seed=5, deadline=100.0)
    for _ in range(2):
        svc.step()
    svc.clock.advance(101.0)
    svc.step()
    early = svc.submit("b", "u3", iterations=8, seed=1, deadline=5.0)
    svc.clock.advance(6.0)
    svc.step()
    return svc, [q, early]


def _nan_isolation(side):
    svc = _service(side)
    with side.FaultPlan([side.FaultSpec(site="launch", kind="nan", max_fires=1)], seed=2):
        qs = [svc.submit("a", "u3", iterations=16, seed=s) for s in (4, 5)]
        svc.run()
    return svc, qs


def _round_robin(side):
    svc = _service(side, max_engines=4, chunk_size=2)
    hot = [svc.submit("a", "u5-1", iterations=8, seed=s) for s in range(3)]
    cold = svc.submit("b", "u5-1", iterations=4, seed=0)
    svc.run()
    names = {hot[0].engine_key: "hot", cold.engine_key: "cold"}
    svc.launch_names = [names[k] for k in svc.launch_log]
    return svc, hot + [cold]


SCENARIOS = {f.__name__.lstrip("_"): f for f in (
    _fixed_and_batched, _adaptive, _transient_retries, _retries_exhausted, _launch_mates,
    _memory_rung, _ladder_exhausted, _ladder_exhausted_blocked, _quarantine, _deadlines,
    _nan_isolation, _round_robin)}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_service_matches_reference(scenario):
    run = SCENARIOS[scenario]
    ref_svc, ref_qs = run(REF)
    port_svc, port_qs = run(PORT)
    _assert_same(_outcome(ref_svc, ref_qs), _outcome(port_svc, port_qs))
    if scenario == "round_robin":
        assert port_svc.launch_names == ref_svc.launch_names
    if scenario.startswith("ladder_exhausted"):
        (walk,) = port_svc.stats()["faults"]["ladder"].values()
        assert port_qs[0].error.kind == "memory_exhausted"
        assert all("backend" not in rung for rung in walk)
        if scenario == "ladder_exhausted_blocked":
            assert [rung["action"] for rung in walk] == ["halve_chunk", "halve_chunk"]


def test_served_rows_equal_count_keys_on_fold_in_keys():
    svc = _service(PORT)
    qa = svc.submit("a", "u5-2", iterations=5, seed=11, record_rows=True)
    qb = svc.submit("a", "u5-2", iterations=6, seed=22, record_rows=True)
    svc.run()
    assert svc.stats()["launches_by_key"][qa.engine_key] == 2  # 11 slots, chunks of 8
    engine = CountingEngine(_graph(PORT, "a"), [get_template("u5-2")], device="cpu",
                            backend="edges", chunk_size=CHUNK)
    for q, seed in ((qa, 11), (qb, 22)):
        keys = fold_in(prng_key(seed), torch.arange(q.iterations))
        assert np.array_equal(q.per_iteration(), engine.count_keys(keys))


def test_warm_requery_builds_nothing_and_graphlet_profile(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tuned.json"))
    svc = _service(PORT, chunk_size=4)
    g = port_graph.erdos_renyi_graph(8, 22, seed=2)
    svc.register_graph("tiny", g)
    prof = svc.graphlet_profile("tiny", 4, iterations=4)
    assert set(prof) == {t.name for k in (3, 4) for t in connected_graphlets(k)}
    builds = {k: svc.engine(k).trace_count for k in svc._cache.keys()}
    assert set(builds.values()) == {1}
    again = svc.graphlet_profile("tiny", 4, iterations=4, seed=0)
    assert {k: svc.engine(k).trace_count for k in svc._cache.keys()} == builds
    for name in prof:
        assert again[name].mean == prof[name].mean
    ref = _service(REF, chunk_size=4)
    ref.register_graph("tiny", ref_graph.erdos_renyi_graph(8, 22, seed=2))
    want = ref.graphlet_profile("tiny", 4, iterations=4)
    for name, est in want.items():
        assert prof[name].mean == pytest.approx(est.mean, rel=RTOL, abs=RTOL)
    assert svc.admission_bytes("tiny", "triangle") > 0
    # tuning is ported: a tune drops the stale warm engine of its workload
    g3 = connected_graphlets(3)
    key = svc.engine_key_for("tiny", g3)
    assert svc.engine(key) is not None
    result = svc.tune("tiny", g3, top_n=2, probes=1,
                      measure_fn=lambda engine, probes: 10.0 * engine.chunk_size)
    assert result.device == "cpu" and svc.engine(key) is None
    assert svc.stats()["tuning"]["tunes_completed"] == 1
    assert svc.engine_key_for("tiny", g3)[-1] == result.config.key_fragment()


STREAMS = {
    "tight": lambda rng: np.full((40, 2), 50.0) + rng.normal(0, 1e-3, (40, 2)),
    "normal": lambda rng: rng.normal(100.0, 5.0, size=(200, 2)),
    "heavy": lambda rng: rng.pareto(1.5, size=(300, 2)) * 10.0 + 1.0,
    "quiet_prefix": lambda rng: np.concatenate([np.full((20, 2), 5.0),
                                                rng.normal(5.0, 20.0, (100, 2))]),
}


@pytest.mark.parametrize("bound", ["normal", "bernstein"])
@pytest.mark.parametrize("stream", list(STREAMS))
def test_stopper_decisions_match_reference(stream, bound):
    rows = STREAMS[stream](np.random.default_rng(3))
    for eps in (None, 0.01, 0.1):
        ours = AdaptiveStopper(2, epsilon=eps, delta=0.05, budget=250, bound=bound)
        theirs = RefStopper(2, epsilon=eps, delta=0.05, budget=250, bound=bound)
        for lo in range(0, rows.shape[0], 7):
            if ours.done:
                break
            ours.update(rows[lo:lo + 7])
            theirs.update(rows[lo:lo + 7])
            assert (ours.done, ours.converged, ours.iterations) == (
                theirs.done, theirs.converged, theirs.iterations)
            assert [vars(e) for e in ours.estimates()] == [vars(e) for e in theirs.estimates()]


def test_stopper_guards():
    assert normal_quantile(0.975) == pytest.approx(1.959964, abs=1e-5)
    with pytest.raises(ValueError):
        AdaptiveStopper(1, bound="bogus")
    st = AdaptiveStopper(2, epsilon=0.1)
    st.update(np.ones((3, 2)))
    with pytest.raises(ValueError, match="non-finite"):
        st.update(np.array([[1.0, np.nan]]))
    assert st.iterations == 3 and all(math.isfinite(e.mean) for e in st.estimates())


def test_adaptive_estimate_matches_reference():
    from repro.core import CountingEngine as RefEngine
    from repro.core import get_template as ref_template
    from repro.serve.stopping import adaptive_estimate as ref_adaptive

    g_ref, g = _graph(REF, "a"), _graph(PORT, "a")
    want = ref_adaptive(RefEngine(g_ref, [ref_template("u5-1")], backend="edges", chunk_size=8),
                        epsilon=0.08, delta=0.1, seed=0, max_iterations=512)[0]
    got = adaptive_estimate(CountingEngine(g, [get_template("u5-1")], device="cpu",
                                           backend="edges", chunk_size=8),
                            epsilon=0.08, delta=0.1, seed=0, max_iterations=512)[0]
    assert got.iterations == want.iterations < 512
    np.testing.assert_allclose(got.per_iteration, want.per_iteration, rtol=RTOL)


def test_classify_failure_families_and_fault_plans():
    classify = port_resilience.classify_failure
    assert classify(torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate")) == "memory"
    assert classify(torch.cuda.OutOfMemoryError("allocator said no")) == "memory"
    assert classify(port_faults.TransientFault("launch")) == "transient"
    assert classify(port_faults.MemoryFault("launch")) == "memory"
    assert classify(port_faults.DeterministicFault("launch")) == "deterministic"
    assert classify(RuntimeError("UNAVAILABLE: try again")) == "transient"
    assert classify(ValueError("some compiler bug")) == "deterministic"
    # the same seeded plan fires at the same visits as the reference's
    specs = [("launch", "transient", 0.3), ("launch", "nan", 0.5), ("engine_build", "memory", 0.2)]
    ours = port_faults.FaultPlan([port_faults.FaultSpec(site=s, kind=k, rate=r) for s, k, r in specs],
                                 seed=7)
    theirs = ref_faults.FaultPlan([ref_faults.FaultSpec(site=s, kind=k, rate=r) for s, k, r in specs],
                                  seed=7)
    for plan, mod in ((ours, port_faults), (theirs, ref_faults)):
        with plan:
            for _ in range(40):
                for site in ("launch", "engine_build"):
                    try:
                        mod.maybe_fail(site)
                    except mod.FaultInjected:
                        pass
                mod.corrupt_result("launch", np.ones((4, 2)))
    assert ours.describe() == theirs.describe()


def test_engine_cache_counters():
    cache = EngineCache(capacity=2)
    built = []

    def factory(name):
        return lambda: built.append(name) or name

    assert cache.get("a", factory("a")) == "a" and cache.get("a", factory("x")) == "a"
    cache.get("b", factory("b"))
    cache.get("c", factory("c"))  # evicts a
    assert "a" not in cache and built == ["a", "b", "c"]
    assert cache.counters()["hits"] == 1 and cache.counters()["evictions"] == 1
    with pytest.raises(RuntimeError):
        cache.get("d", lambda: (_ for _ in ()).throw(RuntimeError("boom")))
    assert "d" not in cache and cache.counters()["build_failures"] == 1
