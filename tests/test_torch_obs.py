"""The port's span recorder (``repro_torch.obs``), the spans and query
records the service and the engine write with it, and the benchmark's
per-layer readers that read them.

CPU tests: nothing is recorded, and no ``record_function`` entered or clock
read, while no profiler runs; spans nest under their parents; a thread
started before a session is recorded; each session starts a fresh buffer;
a main-thread span lines up with its kineto event; the front-end's four
query stamps on a ``ManualClock``.  The ``cuda`` test (skips without a
card) checks that device-timed spans carry device time and that no span
shows among the trace's device events; on a card::

    PYTHONPATH=src python -m pytest -q tests/test_torch_obs.py

The file imports neither ``jax`` nor ``repro``.
"""

import statistics
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import obs
from repro_torch.core.engine import CountingEngine
from repro_torch.core.graph import rmat_graph
from repro_torch.core.prng import prng_key, split
from repro_torch.core.templates import get_template
from repro_torch.serve import CountingService, ManualClock, ServiceFrontend

ROOT = Path(__file__).resolve().parents[1]
DRAW, STAGE = "repro_torch.engine.draw", "repro_torch.engine.stage"


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def kineto_names(prof):
    return {e.name() for e in prof.profiler.kineto_results.events()}


def _service(chunk_size=4):
    svc = CountingService(device="cpu", chunk_size=chunk_size)
    svc.register_graph("a", rmat_graph(200, 900, seed=2))
    return svc


# -- the recorder -------------------------------------------------------------


def test_off_records_nothing_enters_no_record_function_reads_no_clock(monkeypatch):
    calls = []
    monkeypatch.setattr(obs, "time", SimpleNamespace(time_ns=lambda: calls.append("clock")))
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        lambda *a, **k: calls.append("record_function"))
    before = (len(obs.spans()), len(obs.requests()))
    # the service's and the engine's instrumented paths, no profiler running
    fe = ServiceFrontend(_service(), clock=ManualClock())
    fut = fe.submit("t", "a", "u3", iterations=8, seed=1)
    fe.drain()
    assert fut.done() and fut._record is None
    engine = CountingEngine(rmat_graph(120, 500, seed=1), [get_template("u5-1")], device="cpu",
                            chunk_size=3)
    engine.count_keys(split(prng_key(0), 5))
    engine.count_keys_chunk(split(prng_key(1), 2))
    with obs.span("repro_torch.test.off", device=torch.device("cpu"), address=(0, 1)) as s:
        pass
    assert s is obs.span("repro_torch.test.other") and obs.request("t") is None
    assert calls == []
    assert (len(obs.spans()), len(obs.requests())) == before


def test_spans_nest_carry_addresses_and_show_in_the_host_trace():
    with cpu_profile() as prof:
        with obs.span("repro_torch.test.outer") as outer:
            with obs.span("repro_torch.test.inner", address=(0, 2)) as inner:
                pass
    assert [s.name for s in obs.spans()] == ["repro_torch.test.inner", "repro_torch.test.outer"]
    assert outer.parent is None and inner.parent == outer.id and inner.address == (0, 2)
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert inner.device_ms is None  # timed no device
    assert {"repro_torch.test.outer", "repro_torch.test.inner"} <= kineto_names(prof)


def test_engine_spans_per_chunk_and_stage():
    g = rmat_graph(150, 700, seed=3)
    engine = CountingEngine(g, [get_template("u3"), get_template("triangle")], device="cpu",
                            chunk_size=2)
    with cpu_profile():
        engine.count_keys(split(prng_key(4), 6))  # three chunks
    by_id = {s.id: s for s in obs.spans()}
    names = [s.name for s in obs.spans()]
    assert names.count(DRAW) == names.count("repro_torch.engine.leaf") == 3
    assert names.count("repro_torch.engine.walk") == 3
    assert names.count("repro_torch.engine.copy_back") == 1
    stages = obs.spans(STAGE)
    assert stages and all(by_id[s.parent].name == "repro_torch.engine.walk" for s in stages)
    # the tree's exec groups and the triangle's bag ops, the same in every chunk
    per_chunk = {s.address for s in stages}
    assert len(stages) == 3 * len(per_chunk) and {p for p, _ in per_chunk} == {0, 1}


def test_a_thread_started_before_the_session_is_recorded():
    go, done = threading.Event(), threading.Event()

    def work():
        go.wait(30)
        with obs.span("repro_torch.test.thread"):
            pass
        done.set()

    thread = threading.Thread(target=work)
    thread.start()
    try:
        with cpu_profile():
            go.set()
            assert done.wait(30)
    finally:
        go.set()
        thread.join(30)
    assert [s.name for s in obs.spans()] == ["repro_torch.test.thread"]


def test_each_session_starts_a_fresh_buffer():
    with cpu_profile():
        with obs.span("repro_torch.test.first"):
            pass
        assert obs.request("t") is not None
    assert [s.name for s in obs.spans()] == ["repro_torch.test.first"]
    assert len(obs.requests()) == 1
    with cpu_profile():
        with obs.span("repro_torch.test.second"):
            pass
    # the records outlive their session until the next one starts
    assert [s.name for s in obs.spans()] == ["repro_torch.test.second"]
    assert obs.requests() == []


def test_main_thread_spans_line_up_with_their_kineto_events():
    count = 12
    with cpu_profile() as prof:
        for i in range(count):
            with obs.span(f"repro_torch.test.clock{i}"):
                time.sleep(0.002)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    starts, ends = [], []
    for s in obs.spans()[1:]:  # the first pays record_function's first call
        e = events[s.name]
        starts.append(abs(s.start_ns - e.start_ns()))
        ends.append(abs(s.end_ns - (e.start_ns() + e.duration_ns())))
    # one clock: a preempted span may lag, the typical one lies within 0.5 ms
    assert statistics.median(starts) < 0.5e6 and statistics.median(ends) < 0.5e6


# -- the service's stamps ---------------------------------------------------------


def test_query_stamps_on_a_manual_clock():
    clock = ManualClock()
    fe = ServiceFrontend(_service(), clock=clock)
    rounds = {}  # round -> the engine key it launched
    with cpu_profile():
        futs = [fe.submit(tenant, "a", tpl, iterations=8, seed=seed)
                for seed, (tenant, tpl) in enumerate(
                    [("x", "u3"), ("y", "u3"), ("x", "u5-1"), ("y", "u5-1")])]
        while fe._unresolved():
            clock.advance(1.0)
            info = fe.step()
            rounds[info["round"]] = info["launched"]
    launches = obs.spans("repro_torch.serve.launch")
    round_spans = obs.spans("repro_torch.serve.round")
    assert len(launches) == len(round_spans) == len(rounds)
    by_id = {s.id: s for s in obs.spans()}
    assert all(by_id[s.parent].name == "repro_torch.serve.round" for s in launches)
    submits = obs.spans("repro_torch.serve.submit")
    assert len(submits) == len(futs)
    for fut, submit in zip(futs, submits):
        assert fut.submitted_at <= fut.admitted_at <= fut.resolved_at
        first = min(r for r, key in rounds.items()
                    if key == fut._query.engine_key and r >= fut.admitted_round)
        assert fut.admitted_round <= first <= fut.resolved_round
        rec = fut._record
        assert rec.submitted_ns == submit.start_ns  # before pricing and the lock
        assert rec.qid == fut._query.qid and rec.tenant == fut.tenant and rec.state == "done"
        assert rec.submitted_ns <= rec.admitted_ns <= rec.launched_ns <= rec.resolved_ns
        assert rec.launched_ns == launches[first - 1].start_ns
    assert sorted(r.qid for r in obs.requests()) == sorted(f._query.qid for f in futs)


@pytest.mark.timeout(120)
def test_a_started_frontend_records_its_rounds_and_queries():
    fe = ServiceFrontend(_service())
    with fe:  # the scheduler thread starts before the session
        with cpu_profile():
            futs = [fe.submit("x", "a", tpl, iterations=6, seed=s)
                    for s, tpl in enumerate(["u3", "u5-1", "u3"])]
            for fut in futs:
                fut.result(timeout=60)
    by_id = {s.id: s for s in obs.spans()}
    for name in ("admit", "launch", "complete"):
        got = obs.spans(f"repro_torch.serve.{name}")
        assert got and all(by_id[s.parent].name == "repro_torch.serve.round" for s in got)
    assert {by_id[s.parent].name for s in obs.spans(DRAW)} == {"repro_torch.serve.launch"}
    submits = obs.spans("repro_torch.serve.submit")
    assert len(submits) == 3
    for child in ("price", "lock_wait"):
        got = obs.spans(f"repro_torch.serve.{child}")
        assert sorted(s.parent for s in got) == sorted(s.id for s in submits)
    recs = obs.requests()
    assert [r.qid for r in recs] == [f._query.qid for f in futs]
    assert all(r.submitted_ns <= r.admitted_ns <= r.launched_ns <= r.resolved_ns for r in recs)


# -- the benchmark's readers ---------------------------------------------------------


READERS = ("query_wait_ms.service", "submit_lock_wait_ms.service",
           "idle_with_work_ms_per_query.service", "engine_draw_share.batch")
MS = 1_000_000  # ns


def reader(name):
    from portbench.registry import Benchmark

    return Benchmark(ROOT).reader(name)


class FakeEvent:
    def __init__(self, ms):
        self.ms = ms

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return other.ms - self.ms


def make_span(name, start_ms, end_ms, device_ms=None):
    s = obs.Span(name, events=None if device_ms is None else (FakeEvent(0.0), FakeEvent(device_ms)))
    s.start_ns, s.end_ns = start_ms * MS, end_ms * MS
    return s


def make_request(submitted, launched, resolved, state="done"):
    r = obs.Request("t")
    r.submitted_ns, r.launched_ns, r.resolved_ns = submitted * MS, launched * MS, resolved * MS
    r.state = state
    return r


def context(device=(), busy_s=0.0, completed=0):
    from portbench.common import Context
    from portbench.trace import DeviceEvent, TraceSummary

    events = [DeviceEvent("k", s * MS, t * MS) for s, t in device]
    trace = TraceSummary(window_s=1.0, busy_s=busy_s, device_events=events, seconds_by_name={})
    ctx = Context(n=1, e=1, templates=[], trace=trace)
    ctx.counters["queries_completed"] = completed
    return ctx


@pytest.fixture
def session(monkeypatch):
    fresh = obs._Session()
    monkeypatch.setattr(obs, "_session", fresh)
    return fresh


def test_query_wait_reader(session):
    session.requests += [make_request(0, 10, 40), make_request(5, 35, 50),
                         make_request(0, 100, 200, state="failed")]
    assert reader("query_wait_ms.service")(context()) == pytest.approx(20.0)


def test_submit_lock_wait_reader(session):
    session.spans += [make_span("repro_torch.serve.submit", 0, 5),
                      make_span("repro_torch.serve.lock_wait", 1, 4),
                      make_span("repro_torch.serve.submit", 10, 12),
                      make_span("repro_torch.serve.lock_wait", 10, 11)]
    assert reader("submit_lock_wait_ms.service")(context()) == pytest.approx(2.0)


def test_idle_with_work_reader(session):
    # device busy [0, 10] and [20, 40] ms; queries live [5, 22], [35, 50], [60, 70]
    session.requests += [make_request(5, 6, 22), make_request(35, 36, 50),
                         make_request(60, 61, 70, state="failed")]
    ctx = context(device=[(0, 10), (20, 30), (25, 40)], busy_s=0.03, completed=3)
    # idle while a query lived: 10 + 10 + 10 ms, over 3 completed queries
    assert reader("idle_with_work_ms_per_query.service")(ctx) == pytest.approx(10.0)


def test_engine_draw_share_reader(session):
    session.spans += [make_span(DRAW, 0, 1, device_ms=100.0), make_span(DRAW, 2, 3, device_ms=300.0),
                      make_span(STAGE, 3, 9, device_ms=900.0)]
    assert reader("engine_draw_share.batch")(context(busy_s=2.0)) == pytest.approx(20.0)


@pytest.mark.parametrize("name", READERS)
def test_reader_finds_nothing_where_nothing_is_recorded(session, name):
    assert reader(name)(context(device=[(0, 10)], busy_s=0.01, completed=3)) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_finds_nothing_in_a_program_without_the_recorder(monkeypatch, session, name):
    import sys

    import repro_torch

    session.requests.append(make_request(0, 1, 20))
    session.spans += [make_span("repro_torch.serve.submit", 0, 2),
                      make_span("repro_torch.serve.lock_wait", 0, 1),
                      make_span(DRAW, 0, 1, device_ms=1.0)]
    ctx = context(device=[(0, 10)], busy_s=0.01, completed=1)
    assert reader(name)(ctx) is not None
    # as in a program older than the recorder: importing it fails
    monkeypatch.delattr(repro_torch, "obs")
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    assert reader(name)(ctx) is None


# -- on a card --------------------------------------------------------------------


@pytest.mark.cuda
def test_device_spans_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the counting kernels have no CPU mode)")
    from portbench.trace import WINDOW_SPAN, profiler, summarize

    card = torch.device("cuda", 0)
    engine = CountingEngine(rmat_graph(3000, 12000, seed=2),
                            [get_template("u3"), get_template("triangle")], device=card,
                            backend="blocked", chunk_size=4)
    keys = split(prng_key(5, card), 8)
    engine.count_keys(keys)  # kernels built and loaded
    with profiler() as prof:
        with record_function(WINDOW_SPAN):
            engine.count_keys(keys)
    draws, stages = obs.spans(DRAW), obs.spans(STAGE)
    assert len(draws) == 2 and stages
    assert all(s.device_ms > 0 for s in draws + stages)
    summary = summarize(prof)
    assert summary is not None and summary.busy_s > 0
    assert [d.name for d in summary.device_events if d.name.startswith("repro_torch.")] == []
