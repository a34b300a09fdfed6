"""The port's asynchronous front-end against the reference's, on the CPU.

Mirrors the 22 tests of ``tests/test_frontend.py`` and the five front-end
cases of ``tests/test_faults.py`` that need no mesh.  Every single-stepped
scenario runs twice, once through ``repro.serve.ServiceFrontend`` and once
through ``repro_torch.serve.ServiceFrontend`` over a
``CountingService(device="cpu")``, with the same rmat graphs, submissions,
``ManualClock``s and fault plans; each side must pass the reference test's
own assertions (its results bit-equal to its own serial oracle), and the two
must agree on statuses, admission order per round, rejections by reason,
tunes run, the ``health()`` and ``stats()`` fields the reference has, and
estimates at ``rtol=1e-5`` (the two frameworks sum fp32 in different
orders).  The threaded cases (16-thread submissions against the serial
oracle, with and without transient chaos, random interleavings, the
engine-cache hammers and the watchdog on a dead scheduler thread) run on
the port alone, with the reference's timeouts.

The reference's fusion slack is pinned to 1.0, the port's, so both price
the same admission bytes and chunks.
"""

import functools
import random
import threading
from concurrent.futures import CancelledError
from types import SimpleNamespace

import numpy as np
import pytest

import repro.plan.cost as ref_cost
import repro.serve as ref_serve
import repro.serve.resilience as ref_resilience
import repro.testing.faults as ref_faults
import repro.tune.search as ref_search
from repro.core import graph as ref_graph
from repro.core import templates as ref_templates
from repro.testing.hypothesis_fallback import given, settings
from repro.testing.hypothesis_fallback import strategies as st

import repro_torch.serve as port_serve
import repro_torch.serve.resilience as port_resilience
import repro_torch.testing.faults as port_faults
import repro_torch.tune.search as port_search
from repro_torch.core import graph as port_graph
from repro_torch.core import templates as port_templates
from repro_torch.plan import cost as port_cost

pytestmark = [pytest.mark.timeout(300)]

RTOL = 1e-5
CHUNK = 4
GRAPHS = {"a": (200, 900, 2), "b": (180, 700, 3)}
#: tests/test_faults.py's service: its graphs, chunk and zero-backoff retries
CHAOS_CHUNK = 8
CHAOS_GRAPHS = {"a": (160, 700, 2), "b": (140, 520, 3)}

REF = SimpleNamespace(
    name="reference", serve=ref_serve, faults=ref_faults, resilience=ref_resilience,
    graph=ref_graph, templates=ref_templates, cost=ref_cost, search=ref_search, kwargs={},
)
PORT = SimpleNamespace(
    name="port", serve=port_serve, faults=port_faults, resilience=port_resilience,
    graph=port_graph, templates=port_templates, cost=port_cost, search=port_search,
    kwargs={"device": "cpu"},
)


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    monkeypatch.setattr(ref_cost, "load_fusion_slack", lambda path=None: 1.0)
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tuned.json"))
    monkeypatch.delenv("REPRO_ENGINE_BACKEND", raising=False)
    monkeypatch.delenv("REPRO_TUNE", raising=False)


@functools.lru_cache(maxsize=None)
def _build_graph(side_name, spec):
    side = REF if side_name == "reference" else PORT
    n, e, s = spec
    return side.graph.rmat_graph(n, e, seed=s)


def _service(side, graphs=GRAPHS, **kw):
    kw.setdefault("chunk_size", CHUNK)
    svc = side.serve.CountingService(**side.kwargs, **kw)
    for name, spec in graphs.items():
        svc.register_graph(name, _build_graph(side.name, spec))
    return svc


def _chaos_service(side, **kw):
    kw.setdefault("chunk_size", CHAOS_CHUNK)
    kw.setdefault("retry_policy", side.serve.RetryPolicy(max_retries=3, backoff_base=0.0))
    return _service(side, CHAOS_GRAPHS, **kw)


def _frontend(side, **fe_kw):
    svc_kw = fe_kw.pop("svc_kw", {})
    clock = fe_kw.pop("clock", None) or side.serve.ManualClock()
    svc = _service(side, **svc_kw)
    fe = side.serve.ServiceFrontend(svc, clock=clock, **fe_kw)
    return svc, fe, clock


def _chaos_frontend(side):
    svc = _chaos_service(side)
    clk = side.serve.ManualClock()
    return svc, side.serve.ServiceFrontend(svc, clock=clk), clk


# one serial oracle per side and configuration: plain synchronous queries,
# memoized — the ground truth every run of that side must match bit for bit
_ORACLE_SVC = {}
_ORACLE_CACHE = {}


def _oracle(side, gname, tname, seed, iterations, chaos=False):
    key = (side.name, chaos, gname, tname, seed, iterations)
    if key not in _ORACLE_CACHE:
        skey = (side.name, chaos)
        if skey not in _ORACLE_SVC:
            _ORACLE_SVC[skey] = _chaos_service(side) if chaos else _service(side)
        ests = _ORACLE_SVC[skey].query(gname, tname, iterations=iterations, seed=seed)
        _ORACLE_CACHE[key] = tuple(e.mean for e in ests)
    return _ORACLE_CACHE[key]


def _means(fut):
    return [e.mean for e in fut.result(timeout=0)]


def _tenants(fe):
    """Per-tenant counters, without the token balance (compared apart)."""
    return {name: {k: v for k, v in rec.items() if k != "tokens"}
            for name, rec in fe.stats()["tenants"].items()}


def _frontend_stats(fe):
    """The reference's ``stats()`` fields that do not describe engines."""
    s = fe.stats()
    svc = s["service"]
    return {
        **{k: s[k] for k in ("rounds", "state", "inflight_bytes", "admission_budget_bytes",
                             "queries_failed", "rejections", "warm", "tune")},
        "tenants": _tenants(fe),
        "service": {k: svc[k] for k in ("tuning", "cache", "launches", "queries_submitted",
                                        "queries_completed", "queries_cancelled",
                                        "queries_failed", "queries_degraded")},
    }


def _health(fe):
    h = dict(fe.health())
    err = h.pop("last_error")
    h["last_error"] = None if err is None else (err["kind"], err["round_index"])
    h["quarantined_keys"] = len(h["quarantined_keys"])
    return h


def _assert_same(ref, port, path="outcome"):
    """Exact equality everywhere, but estimates (keys named ``means``) at
    ``rtol``."""
    if isinstance(ref, dict):
        assert set(ref) == set(port), (path, set(ref) ^ set(port))
        for k in ref:
            if k == "means":
                np.testing.assert_allclose(np.asarray(port[k], float), np.asarray(ref[k], float),
                                           rtol=RTOL, err_msg=path)
            else:
                _assert_same(ref[k], port[k], f"{path}.{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(ref) == len(port), (path, ref, port)
        for i, (r, p) in enumerate(zip(ref, port)):
            _assert_same(r, p, f"{path}[{i}]")
    else:
        assert ref == port, (path, ref, port)


def _pair(scenario):
    ref = scenario(REF)
    port = scenario(PORT)
    _assert_same(ref, port)
    return port


def _admitted(info):
    return [name for name, _ in info["admitted"]]


# ---------------------------------------------------------------------------
# QoS primitives (pure fake-clock units)
# ---------------------------------------------------------------------------


def _token_bucket(side):
    clock = side.serve.ManualClock()
    bucket = side.serve.TokenBucket(rate=2.0, burst=3.0, clock=clock)
    seq = [bucket.try_acquire() for _ in range(3)]
    assert seq == [True, True, True]
    seq.append(bucket.try_acquire())
    assert not seq[-1]  # drained, clock frozen
    clock.advance(0.5)  # +1 token
    seq += [bucket.try_acquire(), bucket.try_acquire()]
    assert seq[-2:] == [True, False]
    clock.advance(10.0)  # refill caps at burst
    assert bucket.available() == pytest.approx(3.0)
    return {"acquired": seq, "available": bucket.available()}


def test_token_bucket_refill_is_clock_driven():
    _pair(_token_bucket)


def _manual_clock(side):
    clock = side.serve.ManualClock(start=5.0)
    assert clock.now() == clock.now() == 5.0
    assert clock.advance(1.5) == 6.5
    with pytest.raises(ValueError):
        clock.advance(-1)
    return {"now": clock.now()}


def test_manual_clock_never_moves_on_its_own():
    _pair(_manual_clock)


# ---------------------------------------------------------------------------
# Futures API basics (single-stepped)
# ---------------------------------------------------------------------------


def _submit_and_drain(side):
    _, fe, _ = _frontend(side)
    fut = fe.submit("t0", "a", "u3", iterations=4, seed=1)
    assert not fut.done() and fut.state == "queued"
    assert fe.stats()["service"]["launches"] == 0
    snap = fut.progress()
    assert snap[0].status == "queued" and snap[0].iterations == 0
    rounds = fe.drain()
    assert fut.done() and not fut.cancelled()
    assert tuple(_means(fut)) == _oracle(side, "a", "u3", 1, 4)
    return {"rounds": rounds, "state": fut.state, "means": _means(fut),
            "stats": _frontend_stats(fe), "health": _health(fe)}


def test_submit_returns_future_immediately_and_resolves_on_drain():
    _pair(_submit_and_drain)


def _result_timeout(side):
    _, fe, _ = _frontend(side)
    fut = fe.submit("t0", "a", "u3", iterations=2)
    with pytest.raises(TimeoutError):
        fut.result(timeout=0.01)
    return {"state": fut.state, "health": _health(fe)}


def test_result_timeout_raises_when_not_driven():
    _pair(_result_timeout)


def _cancel_queued(side):
    _, fe, _ = _frontend(side)
    keep = fe.submit("t0", "a", "u3", iterations=4, seed=1)
    drop = fe.submit("t0", "a", "u3", iterations=4, seed=2)
    assert drop.cancel()
    assert drop.cancelled() and not drop.cancel()
    with pytest.raises(CancelledError):
        drop.result(timeout=0)
    fe.drain()
    assert tuple(_means(keep)) == _oracle(side, "a", "u3", 1, 4)
    assert fe.stats()["tenants"]["t0"]["cancelled"] == 1
    return {"states": [keep.state, drop.state], "means": _means(keep),
            "stats": _frontend_stats(fe)}


def test_cancel_queued_future_before_any_round():
    _pair(_cancel_queued)


def _cancel_running(side):
    svc, fe, _ = _frontend(side)
    victim = fe.submit("t0", "a", "u5-1", epsilon=1e-6, iterations=64, seed=7)
    bystander = fe.submit("t1", "a", "u5-1", iterations=8, seed=3)
    fe.step()
    fe.step()
    assert victim.state == "admitted" and victim.iterations > 0
    iters_at_cancel = victim.iterations
    assert victim.cancel()
    with pytest.raises(CancelledError):
        victim.result(timeout=0)
    rounds = fe.drain()
    assert rounds < 64
    assert tuple(_means(bystander)) == _oracle(side, "a", "u5-1", 3, 8)
    assert svc.stats()["queries_cancelled"] == 1
    return {"iters_at_cancel": iters_at_cancel, "rounds": rounds,
            "means": _means(bystander), "stats": _frontend_stats(fe)}


def test_cancel_running_query_conserves_other_results():
    _pair(_cancel_running)


# ---------------------------------------------------------------------------
# Streaming progress
# ---------------------------------------------------------------------------


def _streaming_progress(side):
    _, fe, _ = _frontend(side)
    fut = fe.submit("t0", "a", "u5-1", epsilon=1e-9, iterations=24, seed=5)
    seen_iters = [fut.progress()[0].iterations]
    seen_done = [fut.done()]
    means, lows, highs = [], [], []
    for _ in range(10):
        fe.step()
        p = fut.progress()[0]
        seen_iters.append(p.iterations)
        seen_done.append(fut.done())
        if p.iterations >= 2:
            assert p.lower <= p.mean <= p.upper
            assert np.isfinite(p.halfwidth_normal) and np.isfinite(p.halfwidth_bernstein)
            assert p.halfwidth_bernstein >= p.halfwidth_normal
            means.append(p.mean)
            lows.append(p.lower)
            highs.append(p.upper)
    assert seen_iters == sorted(seen_iters)
    assert seen_iters[-1] == 24
    first_done = seen_done.index(True)
    assert all(seen_done[first_done:])
    assert fut.progress()[0].status == "done"
    return {"iters": seen_iters, "done": seen_done, "progress": {"means": means},
            "lower": {"means": lows}, "upper": {"means": highs}}


def test_streaming_progress_monotone_with_both_ci_bounds():
    _pair(_streaming_progress)


def _progress_converges(side):
    _, fe, _ = _frontend(side)
    fut = fe.submit("t0", "a", "u3", iterations=8, seed=2)
    fe.drain()
    final = fut.result(0)[0]
    p = fut.progress()[0]
    assert p.mean == final.mean and p.iterations == 8
    return {"means": [p.mean], "status": p.status}


def test_progress_mean_converges_to_final_result():
    _pair(_progress_converges)


# ---------------------------------------------------------------------------
# Fairness / priority / rate limits
# ---------------------------------------------------------------------------


def _cold_tenant(side):
    _, fe, _ = _frontend(side)
    hot = [fe.submit("hot", "a", "u5-1", iterations=8, seed=100 + i) for i in range(12)]
    cold = fe.submit("cold", "b", "u3", iterations=4, seed=1)
    rounds, order = 0, []
    while not cold.done():
        info = fe.step()
        order.append(_admitted(info))
        rounds += 1
        assert rounds <= 6, "cold tenant starved by the flooding tenant"
    assert not all(f.done() for f in hot)
    assert cold.resolved_round is not None and cold.resolved_round <= 6
    fe.drain()
    assert tuple(_means(cold)) == _oracle(side, "b", "u3", 1, 4)
    return {"admitted_per_round": order, "resolved_round": cold.resolved_round,
            "means": _means(cold) + [m for f in hot for m in _means(f)],
            "stats": _frontend_stats(fe)}


def test_cold_tenant_not_starved_by_flooding_tenant():
    _pair(_cold_tenant)


def _priority_tier(side):
    svc = _service(side)
    one_query_bytes = svc.admission_bytes("a", "u5-1")
    fe = side.serve.ServiceFrontend(svc, clock=side.serve.ManualClock(),
                                    admission_budget_bytes=one_query_bytes)
    fe.register_tenant("low", priority=0)
    fe.register_tenant("high", priority=5)
    low = fe.submit("low", "a", "u5-1", iterations=4, seed=1)
    high = fe.submit("high", "a", "u5-1", iterations=4, seed=2)
    fe.drain()
    assert high.admitted_round < low.admitted_round
    assert high.resolved_round <= low.resolved_round
    for fut, seed in ((high, 2), (low, 1)):
        assert tuple(_means(fut)) == _oracle(side, "a", "u5-1", seed, 4)
    return {"bytes": one_query_bytes,
            "rounds": [high.admitted_round, low.admitted_round, high.resolved_round,
                       low.resolved_round],
            "means": _means(high) + _means(low), "stats": _frontend_stats(fe)}


def test_priority_tier_admits_first_under_scarce_budget():
    _pair(_priority_tier)


def _round_robin(side):
    _, fe, _ = _frontend(side)
    futs = {t: [fe.submit(t, "a", "u3", iterations=4, seed=i) for i in range(4)]
            for t in ("t0", "t1", "t2")}
    info = fe.step()
    assert sorted(_admitted(info)) == ["t0", "t1", "t2"]
    fe.drain()
    for t in futs:
        for i, f in enumerate(futs[t]):
            assert tuple(_means(f)) == _oracle(side, "a", "u3", i, 4)
    return {"first_round": info["admitted"], "launched": info["launched"] is not None,
            "means": [m for t in futs for f in futs[t] for m in _means(f)]}


def test_round_robin_within_tier_splits_admissions_evenly():
    _pair(_round_robin)


def _rate_limit(side):
    _, fe, clock = _frontend(side)
    fe.register_tenant("limited", rate_qps=1.0, burst=1.0)
    futs = [fe.submit("limited", "a", "u3", iterations=4, seed=i) for i in range(4)]

    def admitted():
        return fe.stats()["tenants"]["limited"]["admitted"]

    seen = []
    fe.step()
    seen.append(admitted())
    assert admitted() == 1
    for _ in range(5):
        fe.step()
    seen.append(admitted())
    assert admitted() == 1
    clock.advance(1.0)
    fe.step()
    seen.append(admitted())
    assert admitted() == 2
    clock.advance(10.0)
    fe.step()
    seen.append(admitted())
    assert admitted() == 3
    clock.advance(1.0)
    fe.drain()
    seen.append(admitted())
    assert admitted() == 4
    for i, f in enumerate(futs):
        assert tuple(_means(f)) == _oracle(side, "a", "u3", i, 4)
    return {"admitted": seen, "tokens": fe.stats()["tenants"]["limited"]["tokens"],
            "means": [m for f in futs for m in _means(f)]}


def test_rate_limit_admissions_follow_the_fake_clock():
    _pair(_rate_limit)


# ---------------------------------------------------------------------------
# Backpressure / load shedding
# ---------------------------------------------------------------------------


def _queue_cap(side):
    _, fe, _ = _frontend(side)
    fe.register_tenant("t0", max_pending=2)
    fe.submit("t0", "a", "u3", iterations=2)
    fe.submit("t0", "a", "u3", iterations=2)
    with pytest.raises(side.serve.QoSRejected) as exc:
        fe.submit("t0", "a", "u3", iterations=2)
    assert exc.value.reason == "queue_full"
    stats = fe.stats()
    assert stats["rejections"]["queue_full"] == 1
    assert stats["tenants"]["t0"]["rejected"] == 1
    fe.submit("t1", "a", "u3", iterations=2)
    fe.drain()
    return {"reason": exc.value.reason, "stats": _frontend_stats(fe)}


def test_queue_cap_rejects_with_backpressure():
    _pair(_queue_cap)


def _sheds(side):
    svc = _service(side)
    fe = side.serve.ServiceFrontend(svc, clock=side.serve.ManualClock(), admission_budget_bytes=1)
    with pytest.raises(side.serve.QoSRejected) as exc:
        fe.submit("t0", "a", "u5-1", iterations=2)
    assert exc.value.reason == "over_budget"
    assert fe.stats()["rejections"]["over_budget"] == 1
    return {"reason": exc.value.reason, "stats": _frontend_stats(fe)}


def test_cost_model_sheds_queries_that_can_never_fit():
    _pair(_sheds)


def _inflight_cap(side):
    svc = _service(side)
    one = svc.admission_bytes("a", "u5-1")
    fe = side.serve.ServiceFrontend(svc, clock=side.serve.ManualClock(),
                                    admission_budget_bytes=one)
    futs = [fe.submit("t0", "a", "u5-1", iterations=8, seed=i) for i in range(3)]
    peak, rounds, trace = 0, 0, []
    while not all(f.done() for f in futs):
        fe.step()
        trace.append(fe.stats()["inflight_bytes"])
        peak = max(peak, trace[-1])
        rounds += 1
        assert rounds < 100
    assert 0 < peak <= one
    for i, f in enumerate(futs):
        assert tuple(_means(f)) == _oracle(side, "a", "u5-1", i, 8)
    return {"inflight": trace, "means": [m for f in futs for m in _means(f)]}


def test_admission_budget_caps_inflight_bytes_not_throughput():
    _pair(_inflight_cap)


def _admission_estimate(side):
    g = _build_graph(side.name, GRAPHS["a"])
    est = side.cost.admission_estimate(g, [side.templates.get_template("u5-1")],
                                       chunk_size=CHUNK)
    assert est.resident_bytes > 0 and est.chunk_bytes == est.resident_bytes * CHUNK
    svc = _service(side)
    cold = svc.admission_bytes("a", "u5-1")
    assert cold == est.chunk_bytes
    svc.query("a", "u5-1", iterations=2)
    warm = svc.admission_bytes("a", "u5-1")
    assert warm >= cold
    return {"cold": cold, "warm": warm, "resident": est.resident_bytes}


def test_admission_estimate_plan_vs_warm_engine():
    _pair(_admission_estimate)


# ---------------------------------------------------------------------------
# Warming (the port builds a chunk function where the reference traces)
# ---------------------------------------------------------------------------


def _prewarm(side):
    svc, fe, _ = _frontend(side)
    key = fe.prewarm("a", "u5-1")
    assert fe.prewarm("a", "u5-1") == key
    assert fe.stats()["warm"] == {"queued": 1, "completed": 0}
    info = fe.step()
    assert info["warmed"] == key
    assert fe.stats()["warm"] == {"queued": 0, "completed": 1}
    assert svc.engine(key) is not None and svc.engine(key).trace_count >= 1
    fe.prewarm("a", "u5-1")
    assert fe.stats()["warm"] == {"queued": 0, "completed": 1}
    return {"key_backend": key[3], "key_chunk": key[6], "warm": fe.stats()["warm"],
            "progressed": info["progressed"]}


def test_prewarm_compiles_off_the_query_path_and_dedupes():
    _pair(_prewarm)


def _warm_concurrent(side):
    svc, fe, _ = _frontend(side)
    key = fe.prewarm("a", "u5-1")
    fe.step()
    engine = svc.engine(key)
    traces = engine.trace_count
    futs = [fe.submit(f"t{i % 2}", "a", "u5-1", iterations=6, seed=i) for i in range(6)]
    fe.drain()
    assert engine.trace_count == traces, "a warm concurrent query rebuilt its engine's program"
    assert svc.engine(key) is engine
    for i, f in enumerate(futs):
        assert tuple(_means(f)) == _oracle(side, "a", "u5-1", i, 6)
    return {"means": [m for f in futs for m in _means(f)], "stats": _frontend_stats(fe)}


def test_warm_concurrent_queries_trace_zero_new_programs():
    _pair(_warm_concurrent)


# ---------------------------------------------------------------------------
# Background tuning through the warm/tune slot
# ---------------------------------------------------------------------------


def _tune_slot(side, monkeypatch, fail=False):
    def measure(engine, probes):
        if fail:
            raise RuntimeError("probe launch failed")
        return {"edges": 50.0, "sell": 10.0}.get(engine.backend, 30.0) + 0.01 * engine.chunk_size

    monkeypatch.setattr(side.search, "measure_engine_us", measure)
    svc, fe, _ = _frontend(side)
    fut = fe.submit("t0", "a", "u3", iterations=4, seed=1)
    task = fe.tune("a", "u5-1")
    assert fe.tune("a", "u5-1") == task  # de-duplicated while queued
    if fail:
        with pytest.raises(side.serve.ServiceError) as exc:
            fe.step()
        assert exc.value.kind == "scheduler" and "probe launch failed" in str(exc.value)
        assert fut.failed() and fut.exception().kind == "scheduler"
        return {"health": _health(fe), "tunes_run": fe.tunes_run}
    infos = [fe.step() for _ in range(2)]
    fe.drain()
    assert infos[0]["tuned"] == ("a", ("u5-1",)) and infos[1]["tuned"] is None
    assert fe.tunes_run == 1 and svc.tunes_completed == 1
    fe.tune("a", "u5-1")  # already tuned: nothing queued
    assert fe.stats()["tune"] == {"queued": 0, "completed": 1}
    tuned = svc.submit("a", "u5-1", iterations=2, seed=3)
    svc.run()
    return {"tuned": [i["tuned"] for i in infos], "admitted": [i["admitted"] for i in infos],
            "means": _means(fut), "stats": _frontend_stats(fe),
            "source": svc.engine(tuned.engine_key).describe()["backend"]["source"]}


def test_tune_task_runs_in_the_warm_slot_and_binds_the_winner(monkeypatch):
    out = _pair(functools.partial(_tune_slot, monkeypatch=monkeypatch))
    assert out["source"] == "tuned"


def test_a_failing_tune_trips_the_scheduler(monkeypatch):
    out = _pair(functools.partial(_tune_slot, monkeypatch=monkeypatch, fail=True))
    assert out["health"]["state"] == "draining" and out["tunes_run"] == 0


# ---------------------------------------------------------------------------
# Threaded: concurrent submission vs the serial oracle (port alone)
# ---------------------------------------------------------------------------


def _ref_close(gname, tname, seed, iters, got, chaos=False):
    np.testing.assert_allclose(got, _oracle(REF, gname, tname, seed, iters, chaos), rtol=RTOL)


@pytest.mark.timeout(600)
def test_concurrent_submission_bit_exact_vs_serial_16_threads():
    svc = _service(PORT)
    fe = port_serve.ServiceFrontend(svc)
    jobs = [("a" if i % 2 else "b", "u3" if i % 3 else "u5-1", i % 5, 5) for i in range(32)]
    results = {}
    lock = threading.Lock()

    def worker(wid):
        for j in range(wid, len(jobs), 16):
            gname, tname, seed, iters = jobs[j]
            fut = fe.submit(f"tenant{wid % 4}", gname, tname, iterations=iters, seed=seed)
            means = tuple(e.mean for e in fut.result(timeout=300))
            with lock:
                results[j] = means

    with fe:
        threads = [threading.Thread(target=worker, args=(w,)) for w in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    assert len(results) == len(jobs)
    for j, (gname, tname, seed, iters) in enumerate(jobs):
        assert results[j] == _oracle(PORT, gname, tname, seed, iters), j
    for shape in set(jobs):
        _ref_close(*shape, results[jobs.index(shape)])


# ---------------------------------------------------------------------------
# EngineCache under concurrent hammering (port alone)
# ---------------------------------------------------------------------------


def test_engine_cache_hammered_from_threads_keeps_counters_consistent():
    cache = port_serve.EngineCache(capacity=3)
    keys = [f"k{i}" for i in range(6)]
    builds = []
    build_lock = threading.Lock()
    ops_per_thread, n_threads = 400, 8

    def factory(key):
        def build():
            with build_lock:
                builds.append(key)
            return object()

        return build

    def hammer(tid):
        rng = random.Random(tid)
        for _ in range(ops_per_thread):
            key = rng.choice(keys)
            assert cache.get(key, factory(key)) is not None
            if rng.random() < 0.1:
                cache.peek(key)
                cache.keys()

    threads = [threading.Thread(target=hammer, args=(t,)) for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    c = cache.counters()
    assert c["hits"] + c["misses"] == n_threads * ops_per_thread
    assert c["misses"] == len(builds)
    assert c["size"] <= c["capacity"]
    assert c["evictions"] == len(builds) - c["size"]


def test_engine_cache_raising_factory_never_poisons_the_miss_path():
    cache = port_serve.EngineCache(capacity=4)
    keys = [f"k{i}" for i in range(5)]
    outcomes = []
    state_lock = threading.Lock()

    def factory(key, should_fail):
        def build():
            with state_lock:
                if should_fail():
                    outcomes.append(("raised", key))
                    raise RuntimeError(f"flaky build of {key}")
                outcomes.append(("built", key))
            return ("engine", key)

        return build

    n_threads, ops = 8, 300

    def hammer(tid):
        rng = random.Random(1000 + tid)
        for _ in range(ops):
            key = rng.choice(keys)
            fails_now = rng.random() < 0.5
            try:
                got = cache.get(key, factory(key, lambda: fails_now))
            except RuntimeError:
                assert cache.peek(key) is None or cache.peek(key) == ("engine", key)
            else:
                assert got == ("engine", key)

    threads = [threading.Thread(target=hammer, args=(t,)) for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    c = cache.counters()
    raised = sum(1 for kind, _ in outcomes if kind == "raised")
    built = sum(1 for kind, _ in outcomes if kind == "built")
    assert raised > 0 and built > 0
    assert c["build_failures"] == raised
    assert c["misses"] == raised + built
    assert c["hits"] + c["misses"] == n_threads * ops
    for key in keys:
        assert cache.get(key, factory(key, lambda: False)) == ("engine", key)


# ---------------------------------------------------------------------------
# Random interleavings of submit/cancel/step (port alone)
# ---------------------------------------------------------------------------

_STRESS_TEMPLATES = ("u3", "path4")


@settings(max_examples=4, deadline=None)
@given(st.integers(min_value=0, max_value=10**6))
def test_random_interleavings_never_deadlock_or_drop_queries(seed):
    rng = random.Random(seed)
    svc = _service(PORT)
    clock = port_serve.ManualClock()
    fe = port_serve.ServiceFrontend(svc, clock=clock)
    fe.register_tenant("t0", priority=rng.randint(0, 2))
    fe.register_tenant("t1", priority=rng.randint(0, 2))
    fe.register_tenant("t2", rate_qps=2.0, burst=2.0)
    live, cancelled, expected = [], set(), {}
    for _ in range(rng.randint(10, 28)):
        op = rng.random()
        if op < 0.55:
            gname = rng.choice(list(GRAPHS))
            tname = rng.choice(_STRESS_TEMPLATES)
            iters = rng.randint(2, 6)
            qseed = rng.randint(0, 4)
            fut = fe.submit(f"t{rng.randint(0, 2)}", gname, tname, iterations=iters, seed=qseed)
            live.append(fut)
            expected[id(fut)] = (gname, tname, qseed, iters)
        elif op < 0.7 and live:
            fut = rng.choice(live)
            if fut.cancel():
                cancelled.add(id(fut))
        elif op < 0.9:
            fe.step()
        else:
            clock.advance(rng.uniform(0.1, 1.5))
    for _ in range(500):
        if not fe._unresolved():
            break
        fe.step()
        clock.advance(0.5)
    assert fe._unresolved() == 0, "stress drive loop failed to converge"
    for fut in live:
        assert fut.done()
        if id(fut) in cancelled:
            assert fut.cancelled()
            with pytest.raises(CancelledError):
                fut.result(timeout=0)
        else:
            shape = expected[id(fut)]
            assert tuple(_means(fut)) == _oracle(PORT, *shape)
    stats = fe.stats()["tenants"]
    total = {k: sum(s[k] for s in stats.values()) for k in ("submitted", "admitted")}
    assert total["submitted"] == len(live)
    assert total["admitted"] >= len(live) - len(cancelled)


# ---------------------------------------------------------------------------
# tests/test_faults.py's front-end cases: deadlines, quarantine, watchdog
# ---------------------------------------------------------------------------


def _deadline_in_queue(side):
    _, fe, clk = _chaos_frontend(side)
    fe.register_tenant("slow", rate_qps=0.001, burst=1.0)
    f1 = fe.submit("slow", "a", "u3", iterations=8, seed=1)
    fe.step()
    f2 = fe.submit("slow", "a", "u3", iterations=8, seed=2, deadline=2.0)
    clk.advance(5.0)
    info = fe.step()
    assert f2.failed() and f2.exception().kind == "deadline"
    with pytest.raises(side.serve.ServiceError, match="deadline"):
        f2.result(timeout=0)
    fe.drain()
    assert tuple(_means(f1)) == _oracle(side, "a", "u3", 1, 8, chaos=True)
    assert fe.stats()["tenants"]["slow"]["failed"] == 1
    return {"failed": info["failed"], "means": _means(f1), "stats": _frontend_stats(fe),
            "health": _health(fe)}


def test_frontend_deadline_expires_in_queue_before_admission():
    _pair(_deadline_in_queue)


def _quarantine_passthrough(side):
    expected = _oracle(side, "b", "u3", 1, 8, chaos=True)
    _, fe, _ = _chaos_frontend(side)
    strikes = side.resilience.QUARANTINE_STRIKES
    kinds = []
    with side.faults.FaultPlan(
        [side.faults.FaultSpec(site="launch", kind="deterministic", max_fires=strikes)], seed=1
    ) as plan:
        for s in range(strikes):
            doomed = fe.submit("t", "a", "u3", iterations=8, seed=s)
            fe.drain()
            assert doomed.failed() and doomed.exception().kind == "deterministic"
            kinds.append(doomed.exception().kind)
        late = fe.submit("t", "a", "u3", iterations=8, seed=9)
        fe.step()
        assert late.failed() and late.exception().kind == "quarantined"
        h = fe.health()
        assert h["state"] == "running" and h["healthy"]
        assert h["quarantined_keys"] != []
        health = _health(fe)
        ok = fe.submit("t", "b", "u3", iterations=8, seed=1)
        fe.drain()
        assert tuple(_means(ok)) == expected
        fires = plan.fires_by_site()
    return {"kinds": kinds + [late.exception().kind], "health": health, "fires": fires,
            "means": _means(ok), "stats": _frontend_stats(fe)}


def test_quarantined_submit_fails_one_future_not_the_scheduler():
    _pair(_quarantine_passthrough)


def _watchdog_manual(side):
    _, fe, _ = _chaos_frontend(side)
    f1 = fe.submit("t0", "a", "u3", iterations=8, seed=1)
    f2 = fe.submit("t1", "b", "u3", iterations=8, seed=2)
    with side.faults.FaultPlan(
        [side.faults.FaultSpec(site="clock", kind="deterministic", max_fires=1)], seed=0
    ):
        with pytest.raises(side.serve.ServiceError) as exc:
            fe.step()
    err = exc.value
    assert err.kind == "scheduler" and err.round_index == 1
    assert isinstance(err.cause, side.faults.DeterministicFault)
    for f in (f1, f2):
        assert f.failed() and f.exception().kind == "scheduler"
        with pytest.raises(side.serve.ServiceError, match="scheduler"):
            f.result(timeout=0)
    h = fe.health()
    assert h["state"] == "draining" and not h["healthy"]
    assert h["last_error"]["kind"] == "scheduler"
    assert h["unresolved"] == 0
    with pytest.raises(side.serve.QoSRejected, match="draining"):
        fe.submit("t0", "a", "u3", iterations=4)
    with pytest.raises(side.serve.ServiceError, match="scheduler"):
        fe.step()
    return {"error": (err.kind, err.round_index), "health": _health(fe),
            "stats": _frontend_stats(fe)}


def test_watchdog_trips_on_scheduler_fatal_fault_manual():
    _pair(_watchdog_manual)


@pytest.mark.timeout(60)
def test_watchdog_fails_futures_when_scheduler_thread_dies():
    svc = _chaos_service(PORT)
    fe = port_serve.ServiceFrontend(svc, watchdog_interval=1.0, poll_interval=0.002)
    with port_faults.FaultPlan(
        [port_faults.FaultSpec(site="clock", kind="deterministic", max_fires=1)], seed=0
    ):
        with fe:
            fut = fe.submit("t0", "a", "u3", iterations=8, seed=1)
            with pytest.raises(port_serve.ServiceError, match="scheduler"):
                fut.result(timeout=fe.watchdog_interval)
            assert fut.failed()
            deadline = 50
            while fe._thread is not None and fe._thread.is_alive() and deadline:
                threading.Event().wait(0.01)
                deadline -= 1
            h = fe.health()
            assert h["state"] == "draining" and not h["thread_alive"]


@pytest.mark.timeout(600)
def test_concurrent_submission_bit_exact_under_transient_chaos():
    jobs = [("a" if i % 2 else "b", "u3", i % 4, 5) for i in range(32)]
    expected = {j: _oracle(PORT, *jobs[j], chaos=True) for j in range(len(jobs))}
    svc = _chaos_service(PORT)
    fe = port_serve.ServiceFrontend(svc, poll_interval=0.002)
    results, errors = {}, {}
    lock = threading.Lock()

    def worker(wid):
        for j in range(wid, len(jobs), 16):
            gname, tname, seed, iters = jobs[j]
            fut = fe.submit(f"tenant{wid % 4}", gname, tname, iterations=iters, seed=seed)
            try:
                means = tuple(e.mean for e in fut.result(timeout=300))
                with lock:
                    results[j] = means
            except port_serve.ServiceError as exc:
                with lock:
                    errors[j] = exc

    plan = port_faults.FaultPlan(
        [port_faults.FaultSpec(site="launch", kind="transient", rate=1 / 8)], seed=None
    )
    with plan, fe:
        threads = [threading.Thread(target=worker, args=(w,)) for w in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert len(results) + len(errors) == len(jobs)
    for j, means in results.items():
        assert means == expected[j], f"job {j} diverged under transient chaos"
    for j, exc in errors.items():
        assert exc.kind == "retries_exhausted"
    assert len(results) > len(jobs) // 2
    for shape in {jobs[j] for j in results}:
        _ref_close(*shape, expected[jobs.index(shape)], chaos=True)
