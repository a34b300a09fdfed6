"""Traffic ``estimates``: one analyst's closed loop of estimates, back to back.

Keys of the traffic file: ``templates`` (names in the configuration),
``colorings`` per estimate, and optionally ``entry``, the engine's call
(``count_keys``, the default, or ``count_keys_chunk``, the streaming
increment, which pads each call to the engine's chunk), with
``keys_per_call`` (default: the whole estimate in one call; it divides
``colorings``).  Estimate ``i`` colors with ``split(prng_key(seed + i),
colorings)``.  The window ends with the first estimate that finishes past
``--seconds``, so all work and all time count.  After it, every answer is
checked finite and a sample drawn from the seed is recomputed by the
reference.
"""

from __future__ import annotations

import time

from portbench.common import GIB, Context, rel_gap, synchronize, templates_of

ENTRIES = ("count_keys", "count_keys_chunk")


def estimate_keys(seed: int, i: int, colorings: int, device):
    from portbench.reference import threefry

    return threefry.split(threefry.prng_key(seed + i, device), colorings)


def run(cell):
    import numpy as np
    import torch

    from repro_torch.core.engine import CountingEngine
    from repro_torch.kernels.spmm_blocked.ops import spmm_blocked
    from repro_torch.kernels.spmm_ema.ops import spmm_ema
    from torch.profiler import record_function

    from portbench import trace as tr

    traffic, device, out, seed = cell.traffic, cell.device, cell.out, cell.seed
    colorings = int(traffic["colorings"])
    entry = traffic.get("entry", "count_keys")
    per_call = int(traffic.get("keys_per_call", colorings))
    if entry not in ENTRIES or colorings % per_call:
        raise ValueError(f"estimates: entry {entry!r} with {per_call} keys a call "
                         f"for {colorings} colorings")
    progs, yard, edges = templates_of(cell.cfg, traffic["templates"])
    engine = CountingEngine(cell.graph, progs, device=device, dtype_policy=out["precision"],
                            memory_budget_bytes=int(cell.cfg["memory_budget_gib"] * GIB))
    chunk = engine.chunk_size
    call = getattr(engine, entry)
    if entry == "count_keys_chunk" and per_call > chunk:
        raise ValueError(f"count_keys_chunk takes at most the chunk, {chunk} keys")
    # each launch's width and the launches of one call
    width = chunk if entry == "count_keys_chunk" else min(chunk, per_call)
    launches_per_call = -(-per_call // width)

    def estimate(i):
        keys = estimate_keys(seed, i, colorings, device)
        return np.concatenate([call(keys[s:s + per_call]) for s in range(0, colorings, per_call)])

    for _ in range(2):  # the launch's shape: libraries, tables, allocator blocks
        call(estimate_keys(seed, -1, min(width, per_call), device))
    synchronize(device)
    out["setup_end"] = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
        resident = torch.cuda.memory_allocated(device)
    launches0 = (spmm_ema.launches, spmm_blocked.launches)
    answers = []
    prof = tr.profiler() if cell.trace_on else None
    if prof is not None:
        prof.__enter__()
    try:
        with record_function(tr.WINDOW_SPAN):
            t0 = time.perf_counter()
            while True:
                with record_function("portbench.estimate"):
                    answers.append(estimate(len(answers)))
                if time.perf_counter() - t0 >= cell.seconds:
                    break
            window_s = time.perf_counter() - t0
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    ctx = Context(n=cell.graph.n, e=cell.graph.num_directed, templates=yard, chunk_size=width,
                  chunks=launches_per_call * (colorings // per_call) * len(answers))
    ctx.counters["predicted_peak_bytes"] = engine.predicted_peak_bytes()
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device)
        ctx.counters["window_temp_bytes"] = peak - resident
        out["memory_peak_bytes"] = peak
    out.update(vertices=cell.graph.n, directed_edges=cell.graph.num_directed,
               backend=engine.backend, chunk_size=chunk, entry=entry, keys_per_call=per_call,
               estimates=len(answers), kernel_a_calls=spmm_ema.launches - launches0[0],
               kernel_b_calls=spmm_blocked.launches - launches0[1],
               attempted=colorings * len(answers), failed=0)
    out["metrics_e2e"] = {"colorings_per_s": colorings * len(answers) / window_s}
    del engine, call
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if prof is not None:
        t_read = time.perf_counter()
        ctx.trace = tr.summarize(prof)
        out["trace_read_s"] = time.perf_counter() - t_read
        del prof

    # the answers: all finite, and a sample drawn from the seed against the reference
    t_check = time.perf_counter()
    from portbench.reference import colorcoding, threefry

    values = np.stack(answers)  # (estimates, colorings, templates)
    checks = {"nonfinite_answers": (int(np.count_nonzero(~np.isfinite(values))), 0)}
    rng = np.random.default_rng(seed)
    total = values.shape[0] * values.shape[1]
    picks = rng.choice(total, size=min(int(cell.check["sample"]), total), replace=False)
    adj = colorcoding.Adjacency(cell.src, cell.dst, cell.graph.n,
                                dense=any(not colorcoding.is_tree(e) for e in edges))
    worst = 0.0
    k = max(colorcoding.num_vertices(e) for e in edges)
    for flat in sorted(int(p) for p in picks):
        i, j = divmod(flat, values.shape[1])
        key = threefry.split(threefry.prng_key(seed + i, device), colorings)[j]
        colors = threefry.randint(key, cell.graph.n, k)
        for t, e in enumerate(edges):
            worst = max(worst, rel_gap(values[i, j, t], colorcoding.estimate(adj, colors, e)))
    checks["max_rel_gap"] = (worst, float(cell.check["max_rel_gap_limit"]))
    out["compared"] = len(picks)
    out["check_s"] = time.perf_counter() - t_check
    return ctx, checks
