"""Traffic ``service``: an open loop through a started ``ServiceFrontend``.

Keys of the traffic file: ``rate_qps`` and ``schedule_seed`` (one Poisson
schedule that every run replays, :func:`arrival_times`), ``iterations``
(colorings a query), ``warm_queries`` (per tenant and template set, before
the window), ``tenants`` (each a ``name`` and its ``templates``, or
``template_sets`` that its queries take in turn), and optionally ``faults``
(the program's fault specs, ``repro_torch.testing.faults.FaultSpec``
fields, installed for the window with the run's seed).  Queries alternate
between the tenants; each query's coloring seed is drawn from the run's
seed; each is timed from when it was due to when its result was resolved,
and a failed, refused or unresolved one counts as the window's length.
After the window every completed query's rows are checked in their shape and
finite, and a sample drawn from the seed is recomputed by the reference, its
rows and its means.
"""

from __future__ import annotations

import contextlib
import time

from portbench.common import DRAIN_S, GIB, Context, percentile, rel_gap, synchronize, templates_of


def arrival_times(rate_qps: float, seconds: float, schedule_seed: int):
    """Arrivals of a Poisson stream at ``rate_qps`` over ``seconds``: the
    ``N = round(rate * seconds)`` quantiles of the exponential gap, in one
    order drawn from the traffic's ``schedule_seed``, scaled to span the
    window.  Every run replays this one schedule, and its seed draws what
    each query asks: the 95th percentile of ~100 queries swings by a
    quarter with where the bursts fall, far more than with the system."""
    import numpy as np

    count = max(1, int(round(rate_qps * seconds)))
    gaps = -np.log1p(-(np.arange(count) + 0.5) / count)
    gaps = np.random.default_rng(schedule_seed).permutation(gaps)
    ends = np.cumsum(gaps)
    return np.concatenate([[0.0], ends[:-1]]) * (seconds / ends[-1])


def thirds(values):
    """``(p50, mean)`` of the first and of the last third of ``values``."""
    third = max(1, len(values) // 3)
    first, last = values[:third], values[-third:]
    return (percentile(first, 50), sum(first) / len(first),
            percentile(last, 50), sum(last) / len(last))


def fault_plan(specs, seed):
    if not specs:
        return contextlib.nullcontext()
    from repro_torch.testing.faults import FaultPlan, FaultSpec

    return FaultPlan([FaultSpec(**s) for s in specs], seed=seed)


def run(cell):
    from concurrent.futures import CancelledError

    import numpy as np
    import torch

    from repro_torch.serve import CountingService, ServiceFrontend
    from repro_torch.serve.frontend import QoSRejected
    from repro_torch.serve.resilience import ServiceError
    from torch.profiler import record_function

    from portbench import trace as tr

    traffic, device, out = cell.traffic, cell.device, cell.out
    seed, seconds = cell.seed, cell.seconds
    tenants = []  # (name, [(programs, yardsticks, edges) per template set])
    for t in traffic["tenants"]:
        sets = t.get("template_sets") or [t["templates"]]
        tenants.append((t["name"], [templates_of(cell.cfg, s) for s in sets]))
    iterations = int(traffic["iterations"])
    svc = CountingService(device=device, dtype_policy=out["precision"],
                          memory_budget_bytes=int(cell.cfg["memory_budget_gib"] * GIB))
    name = cell.cfg["name"]
    svc.register_graph(name, cell.graph)
    fe = ServiceFrontend(svc)
    rng = np.random.default_rng(seed)
    times = arrival_times(float(traffic["rate_qps"]), seconds, int(traffic["schedule_seed"]))
    qseeds = rng.integers(0, 2**31 - 1, size=len(times))
    asked = []  # per arrival: (tenant, its template set)
    for i in range(len(times)):
        tname, sets = tenants[i % len(tenants)]
        asked.append((tname, sets[(i // len(tenants)) % len(sets)]))
    sent, submit_s = [], []
    with fe:
        for tname, sets in tenants:
            for progs, _, _ in sets:
                fe.prewarm(name, progs)
        # each tenant's shapes, before the window: engines built, kernels loaded
        warm = [fe.submit(tname, name, s[0], iterations=iterations, seed=2**31 + w,
                          record_rows=True)
                for w in range(int(traffic["warm_queries"])) for tname, sets in tenants
                for s in sets]
        for f in warm:
            f.result(timeout=600)
        synchronize(device)
        out["setup_end"] = time.perf_counter()
        stats0 = svc.stats()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        prof = tr.profiler() if cell.trace_on else None
        if prof is not None:
            prof.__enter__()
        try:
            with record_function(tr.WINDOW_SPAN), fault_plan(traffic.get("faults"), seed):
                t0 = time.monotonic()
                for i, offset in enumerate(times):
                    due = t0 + float(offset)
                    wait = due - time.monotonic()
                    if wait > 0:
                        with record_function("portbench.await_arrival"):
                            time.sleep(wait)
                    tname, (progs, _, _) = asked[i]
                    before = time.perf_counter()
                    try:
                        with record_function("portbench.submit"):
                            fut = fe.submit(tname, name, progs, iterations=iterations,
                                            seed=int(qseeds[i]), record_rows=True)
                    except QoSRejected:
                        fut = None
                    submit_s.append(time.perf_counter() - before)
                    sent.append((i, due, time.monotonic() - due, fut))
                for _, _, _, fut in sent:
                    if fut is None:
                        continue
                    with record_function("portbench.await_result"), contextlib.suppress(
                            ServiceError, TimeoutError, CancelledError):  # counted as failed below
                        fut.result(timeout=max(0.0, t0 + seconds + DRAIN_S - time.monotonic()))
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
        stats1 = svc.stats()
        # colorings each launch carried, padding included, by engine key
        widths = {key: (svc.engine(key).chunk_size if svc.engine(key) is not None else None)
                  for key in stats1["launches_by_key"]}
    latencies, failed, done = [], 0, []
    for i, due, _, fut in sent:
        if fut is not None and fut.done() and not fut.failed() and not fut.cancelled():
            latencies.append(fut.resolved_at - due)
            done.append((i, fut))
        else:
            failed += 1
            latencies.append(float(seconds))
    resolved = [fut.resolved_at for _, fut in done]
    p50_first, mean_first, p50_last, mean_last = thirds(latencies)
    out.update(vertices=cell.graph.n, directed_edges=cell.graph.num_directed,
               attempted=len(sent), failed=failed, queries=len(sent),
               generator_late_max_s=max(s[2] for s in sent),
               # a backlog that grows through the window: the last third of the
               # arrivals wait longer than the first
               latency_p50_first_third_s=p50_first, latency_p50_last_third_s=p50_last,
               latency_mean_first_third_s=mean_first, latency_mean_last_third_s=mean_last,
               outstanding_at_close=sum(1 for t in resolved if t > t0 + seconds) + failed,
               completed_per_s=len(done) / (max(resolved, default=t0 + seconds) - t0))
    out["metrics_e2e"] = {"query_p50_s": percentile(latencies, 50),
                          "query_p95_s": percentile(latencies, 95)}
    if device.type == "cuda":
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    ctx = Context(n=cell.graph.n, e=cell.graph.num_directed,
                  templates=[y for _, sets in tenants for s in sets for y in s[1]])
    completed = stats1["queries_completed"] - stats0["queries_completed"]
    ctx.counters["queries_completed"] = completed
    ctx.counters["service_launches"] = stats1["launches"] - stats0["launches"]
    ctx.counters["submit_s_mean"] = sum(submit_s) / len(submit_s)
    if None not in widths.values():
        slots = sum((count - stats0["launches_by_key"].get(key, 0)) * widths[key]
                    for key, count in stats1["launches_by_key"].items())
        ctx.counters["padded_colorings"] = slots - completed * iterations
    out["service_counters"] = dict(ctx.counters)
    out["faults"] = {k: v - stats0["faults"][k] for k, v in stats1["faults"].items()
                     if isinstance(v, int)}
    if prof is not None:
        t_read = time.perf_counter()
        ctx.trace = tr.summarize(prof)
        out["trace_read_s"] = time.perf_counter() - t_read
        del prof

    # every completed query's rows; a sample, drawn from the seed, against the reference
    t_check = time.perf_counter()
    from portbench.reference import colorcoding, threefry

    results = []
    for i, fut in done:
        results.append((i, fut._query.per_iteration(), [e.mean for e in fut.result()]))
    del fe, svc, warm, sent
    if device.type == "cuda":
        torch.cuda.empty_cache()
    shape_faults = sum(1 for i, rows, _ in results
                       if rows.shape != (iterations, len(asked[i][1][2]))
                       or not np.all(np.isfinite(rows)))
    checks = {"unanswered_queries": (failed, 0),
              "malformed_answers": (shape_faults, 0)}
    adj = colorcoding.Adjacency(cell.src, cell.dst, cell.graph.n, dense=any(
        not colorcoding.is_tree(e) for _, sets in tenants for s in sets for e in s[2]))
    picks = rng.choice(len(results), size=min(int(cell.check["sample"]), len(results)),
                       replace=False) if results else []
    worst = 0.0
    for p in sorted(int(p) for p in picks):
        i, rows, means = results[p]
        edges = asked[i][1][2]
        k = max(colorcoding.num_vertices(e) for e in edges)
        base = threefry.prng_key(int(qseeds[i]), device)
        want = np.zeros((iterations, len(edges)))
        for it in range(iterations):
            colors = threefry.randint(threefry.fold_in(base, it), cell.graph.n, k)
            for t, e in enumerate(edges):
                want[it, t] = colorcoding.estimate(adj, colors, e)
                worst = max(worst, rel_gap(rows[it, t], want[it, t]))
        for t in range(len(edges)):
            worst = max(worst, rel_gap(means[t], float(want[:, t].mean())))
    checks["max_rel_gap"] = (worst, float(cell.check["max_rel_gap_limit"]))
    out["compared"] = len(picks)
    out["check_s"] = time.perf_counter() - t_check
    return ctx, checks
