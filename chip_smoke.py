#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

Run from the repository root, with no arguments::

    python3 chip_smoke.py [--out results.json]

Phases, in order; any failure ends the run with a nonzero exit code:

1. Card and build: the card's name and power limit (``nvidia-smi``), the
   torch and CUDA versions, and the build of every CUDA kernel of the port
   (``src/repro_torch/**/csrc/*.cu``), with the compiler's register and
   spill report.
2. The blocked SpMM kernel against its plain PyTorch version on the full
   R-MAT graph (2^20 vertices, 2^23 sampled edges), at 64 and 792 columns;
   ``torch.sparse.mm`` on the same CSR is timed as a yardstick (the port
   never calls it).  Tree stages do not launch this kernel (only the bag
   stages of non-tree templates will), so this phase is where it runs.
3. The fused SpMM+eMA kernel against its plain version on the full graph,
   at every stage geometry the main path gives it (u12 at 2 colorings).
4. The main path: ``CountingEngine(graph, [u12])`` with ``backend="auto"``
   (which must resolve to ``blocked``) counts one chunk of seeded colorings
   through ``count_colorings``; the launch counters are reset just before
   and read just after, and every kernel of the path (the fused one) must
   have launched.  The same colorings go through the plain ``edges``
   backend on the card, and the totals must agree.
5. Exactness: on tiny grid and Erdos-Renyi graphs the ``blocked`` engine's
   raw counts, every stage through the fused kernel, equal the brute-force
   colorful counts.

The second-to-last line of output is the ``kernels`` JSON record; the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA card, or without
the repository beside this file, the script prints no result and exits
nonzero.  Times come from CUDA events; ``bound_ms`` is the larger of the
compulsory bytes over 3.35 TB/s and the operations over 67 TFLOP/s (fp32),
the H100 SXM's published peaks.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

#: H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 FLOP/s
#: outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

GRAPH_SPEC = dict(n=1 << 20, num_edges=8_388_608, seed=1)
TEMPLATE = "u12"
MEMORY_BUDGET_BYTES = 48 * 2**30
SPMM_WIDTHS = (64, 792)
EMA_CHUNK = 2  # colorings per chunk at this budget (checked in phase 4)
#: Kernels that the tree-template main path launches.
MAIN_PATH_KERNELS = ("spmm_ema",)
EXACT_TEMPLATES = ("u3", "u5-2", "u6", "u7")

#: Kernel vs plain version: relative tolerance.  The plain versions sum
#: with ``index_add_``, whose CUDA atomics add in no fixed order, and the
#: kernels contract multiply-adds into FMAs.
KERNEL_RTOL = 1e-4
#: Engine totals, ``blocked`` vs the plain ``edges`` path (same reasons).
TOTALS_RTOL = 1e-4


def log(*args) -> None:
    print(*args, flush=True)


def bound_ms(nbytes: float, flops: float) -> tuple:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def max_abs_err(got, want, rtol: float, what: str) -> float:
    import torch

    err = (got - want).abs()
    scale = float(want.abs().max()) if want.numel() else 0.0
    ok = bool(torch.all(err <= rtol * want.abs() + 1e-6 * scale))
    worst = float(err.max()) if err.numel() else 0.0
    if not ok or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: kernel disagrees with its plain version "
                             f"(max |err| {worst:g}, max |ref| {scale:g})")
    return worst


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def build_kernels() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    per_source = _build.build()
    log(f"[build] {len(per_source)} sources compiled in {time.perf_counter() - t0:.1f} s "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in per_source.items()) or 'cached'})")
    for source in _build.KERNEL_SOURCES:
        for line in _build.build_log(source).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {source.stem}: {line.strip()}")
        _build.load(source)


def load_balance(graph, rows=64, warps=8) -> dict:
    """Edges of the heaviest destination block and of the heaviest warp when
    each block of ``rows`` vertices is walked by ``warps`` warps taking rows
    ``w, w + warps, ...`` (the kernels' assignment at 64 rows per CTA), and
    the sizes of the compact operand and of the reference's padded one."""
    import numpy as np

    deg = graph.degrees().astype(np.int64)
    pad = (-graph.n) % rows
    per_row = np.concatenate([deg, np.zeros(pad, np.int64)]).reshape(-1, rows)
    per_warp = per_row.reshape(per_row.shape[0], rows // warps, warps).sum(axis=1)
    # the reference's blocked-ELL operand at its block of 256: every
    # (dst-block, src-block) pair padded to the largest (three 4-byte arrays)
    n_blocks = -(-graph.n // 256)
    pair = (graph.dst // 256).astype(np.int64) * n_blocks + graph.src // 256
    pair_sizes = np.unique(pair, return_counts=True)[1]
    return {
        "blocked_ell_256_pairs": int(pair_sizes.size),
        "blocked_ell_256_max_pair": int(pair_sizes.max()),
        "blocked_ell_256_padded_bytes": int(pair_sizes.size * pair_sizes.max() * 12),
        "compact_operand_bytes": int((graph.num_directed + graph.n + 1) * 4),
        "rows_per_block": rows,
        "blocks": int(per_row.shape[0]),
        "mean_block_edges": float(per_row.sum(axis=1).mean()),
        "max_block_edges": int(per_row.sum(axis=1).max()),
        "max_warp_edges": int(per_warp.max()),
        "empty_blocks": int((per_row.sum(axis=1) == 0).sum()),
    }


# ---------------------------------------------------------------------------
# phase 2: kernel B
# ---------------------------------------------------------------------------


def check_spmm_blocked(operand, widths, device, reps=5) -> list:
    import torch

    from repro_torch.kernels.spmm_blocked.ops import spmm_blocked
    from repro_torch.kernels.spmm_blocked.ref import spmm_ref

    n, e = operand.n, operand.num_directed
    gen = torch.Generator(device=device).manual_seed(0)
    csr = None
    if device.type == "cuda":
        csr = torch.sparse_csr_tensor(
            operand.row_ptr.long(), operand.src.long(),
            torch.ones(e, dtype=torch.float32, device=device), size=(n, n),
        )
    rows = []
    for c in widths:
        m = torch.rand((n, c), generator=gen, device=device)
        got = spmm_blocked(operand, m)
        want = spmm_ref(operand.src, operand.dst, n, m, col_chunk=64)
        err = max_abs_err(got, want, KERNEL_RTOL, f"spmm_blocked C={c}")
        del got, want
        row = {"shape": f"n={n} C={c}", "max_abs_err": err}
        nbytes = 2 * n * c * 4 + (n + 1) * 4 + e * 4
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, e * c)
        if device.type == "cuda":
            row["ms"] = time_ms(lambda: spmm_blocked(operand, m), reps)
            row["plain_ms"] = time_ms(
                lambda: spmm_ref(operand.src, operand.dst, n, m, col_chunk=64), 2)
            row["library_ms"] = time_ms(lambda: torch.sparse.mm(csr, m), reps)
        log(f"[spmm_blocked] {json.dumps(row)}")
        rows.append(row)
        del m
    return rows


# ---------------------------------------------------------------------------
# phase 3: kernel A
# ---------------------------------------------------------------------------


def fused_geometries(template_name: str):
    """Distinct ``(k, m, m_a)`` stages of the template, in DP order: the
    blocked backend sends every one of them to the fused kernel."""
    from repro_torch.core.templates import get_template
    from repro_torch.plan.ir import build_template_plan

    plan = build_template_plan([get_template(template_name)])
    seen = []
    for cplan in plan.counting_plans:
        for table in cplan.tables:
            if table is None:
                continue
            key = (table.k, table.m, table.m_a)
            if key not in seen:
                seen.append(key)
    return seen


def check_spmm_ema(operand, geometries, bsz, device, reps=3) -> list:
    import torch

    from repro_torch.core.colorsets import binom, build_split_table
    from repro_torch.kernels.spmm_ema.ops import prepare_stage_tables, spmm_ema
    from repro_torch.kernels.spmm_ema.ref import spmm_ema_ref

    n, e = operand.n, operand.num_directed
    gen = torch.Generator(device=device).manual_seed(1)
    rows = []
    for k, m, m_a in geometries:
        table = build_split_table(k, m, m_a)
        c_p, c_a = binom(k, m - m_a), binom(k, m_a)
        tables = prepare_stage_tables(table.idx_a, table.idx_p, c_p, c_a, device)
        m_p = torch.rand((n, bsz, c_p), generator=gen, device=device)
        m_aa = torch.rand((n, bsz, c_a), generator=gen, device=device)

        def plain():
            return spmm_ema_ref(operand.src, operand.dst, n, m_p, m_aa,
                                tables.idx_a, tables.idx_p, col_chunk=64)

        got = spmm_ema(operand, m_p, m_aa, tables)
        want = plain()
        err = max_abs_err(got, want, KERNEL_RTOL, f"spmm_ema (k,m,m_a)={(k, m, m_a)}")
        del got, want
        row = {"shape": f"k={k} m={m} m_a={m_a} B={bsz} C_p={c_p} C_a={c_a} "
                        f"n_out={table.n_out} splits={table.n_splits}",
               "max_abs_err": err}
        nbytes = (n * bsz * (c_p + c_a + table.n_out) * 4 + (n + 1) * 4 + e * 4
                  + 2 * tables.ent_a.numel() * 4)
        flops = e * bsz * c_p + 2 * n * bsz * table.n_out * table.n_splits
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops)
        if device.type == "cuda":
            row["ms"] = time_ms(lambda: spmm_ema(operand, m_p, m_aa, tables), reps)
            row["plain_ms"] = time_ms(plain, 1)
        log(f"[spmm_ema] {json.dumps(row)}")
        rows.append(row)
        del m_p, m_aa
    return rows


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------


def device_profile(fn) -> dict:
    """Device time by kernel over one call of ``fn``, and the device's busy
    share of the call's wall time (``torch.profiler``)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def device_us(evt):
        return getattr(evt, "self_device_time_total", 0) or getattr(evt, "self_cuda_time_total", 0)

    averages = prof.key_averages()
    # device-side events (kernels, copies); operator rows would count them twice
    events = [e for e in averages
              if str(getattr(e, "device_type", "")).endswith("CUDA") and device_us(e) > 0]
    source = "device events"
    if not events:
        events, source = [e for e in averages if device_us(e) > 0], "operators"
    busy_ms = sum(device_us(e) for e in events) / 1e3
    top = sorted(events, key=device_us, reverse=True)[:6]
    return {
        "source": source,
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": (1.0 - busy_ms / wall_ms) if events else None,
        "top": [{"name": e.key[:60], "ms": device_us(e) / 1e3, "calls": e.count} for e in top],
    }


def main_path(graph, template_name, device, budget, with_profile=False) -> dict:
    import numpy as np
    import torch

    from repro_torch.core.engine import CountingEngine
    from repro_torch.core.templates import get_template
    from repro_torch.kernels.spmm_blocked.ops import spmm_blocked
    from repro_torch.kernels.spmm_ema.ops import spmm_ema

    template = get_template(template_name)
    kwargs = {} if device.type == "cuda" else {"device": device}
    t0 = time.perf_counter()
    engine = CountingEngine(graph, [template], memory_budget_bytes=budget, **kwargs)
    build_s = time.perf_counter() - t0
    if engine.backend != "blocked":
        raise AssertionError(f"backend='auto' resolved to {engine.backend!r}, not 'blocked'")
    colors = engine.draw_colorings(engine.chunk_size, seed=0)
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    spmm_ema.launches = 0
    spmm_blocked.launches = 0
    t0 = time.perf_counter()
    est = engine.count_colorings(colors)  # returns on the host: synchronised
    run_s = time.perf_counter() - t0
    launches = {"spmm_ema": spmm_ema.launches, "spmm_blocked": spmm_blocked.launches}

    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else None
    profile = device_profile(lambda: engine.count_colorings(colors)) if with_profile else None
    raw = est / engine._norm_factors.cpu().numpy()[None, :]
    if not np.all(np.isfinite(est)) or np.any(est < 0):
        raise AssertionError(f"{template_name}: totals not finite and >= 0: {est.tolist()}")

    plain = CountingEngine(graph, [template], backend="edges",
                           memory_budget_bytes=budget, **kwargs)
    t0 = time.perf_counter()
    est_plain = plain.count_colorings(colors)
    plain_s = time.perf_counter() - t0
    if not np.allclose(est, est_plain, rtol=TOTALS_RTOL, atol=0.0):
        raise AssertionError(f"blocked {est.tolist()} vs edges {est_plain.tolist()} "
                             f"beyond rtol={TOTALS_RTOL}")
    for name in MAIN_PATH_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    out = {
        "template": template_name,
        "backend": engine.backend,
        "backend_reason": engine.backend_reason,
        "chunk_size": engine.chunk_size,
        "colorings": int(colors.shape[0]),
        "engine_build_s": build_s,
        "seconds_per_coloring": run_s / colors.shape[0],
        "plain_edges_seconds_per_coloring": plain_s / colors.shape[0],
        "max_memory_allocated": peak,
        "predicted_peak_bytes": engine.predicted_peak_bytes(),
        "launches": launches,
        "profile": profile,
        "estimates": est[:, 0].tolist(),
        "raw_totals": raw[:, 0].tolist(),
        "max_rel_diff_vs_edges": float(np.max(np.abs(est - est_plain) / np.abs(est_plain))),
    }
    log(f"[main] {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# phase 5: exactness on tiny graphs
# ---------------------------------------------------------------------------


def exactness(device) -> None:
    import numpy as np

    from repro_torch.core.counting import brute_force_colorful, build_counting_plan
    from repro_torch.core.engine import CountingEngine
    from repro_torch.core.graph import erdos_renyi_graph, grid_graph
    from repro_torch.core.templates import get_template
    from repro_torch.kernels.spmm_ema.ops import spmm_ema

    rng = np.random.default_rng(7)
    for gname, graph in (("grid5x7", grid_graph(5, 7)), ("er45", erdos_renyi_graph(45, 90, seed=3))):
        for tname in EXACT_TEMPLATES:
            t = get_template(tname)
            plan = build_counting_plan(t)
            engine = CountingEngine(graph, [t], backend="blocked", device=device)
            for _ in range(2):
                colors = rng.integers(0, t.k, size=graph.n)
                before = spmm_ema.launches
                raw = float(engine.raw_counts(colors)[0]) / plan.automorphisms
                if spmm_ema.launches <= before:
                    raise AssertionError(f"{gname}/{tname}: the fused kernel was not launched")
                want = brute_force_colorful(graph, t, colors)
                if raw != want:
                    raise AssertionError(f"{gname}/{tname}: blocked {raw} != brute force {want}")
    log(f"[exact] blocked raw counts, through the fused kernel, equal brute force "
        f"on grid5x7 and er45 ({', '.join(EXACT_TEMPLATES)})")


# ---------------------------------------------------------------------------


def kernel_record(name, source, replaces, launches, rows) -> dict:
    """One kernel's entry: sums over the shapes it was checked at (for the
    fused kernel, those the main path gives it)."""
    return {
        "name": name,
        "on_main_path": name in MAIN_PATH_KERNELS,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": sum(r["ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": sum(r["bound_ms"] for r in rows),
        "bound_by": max(rows, key=lambda r: r["bound_ms"])["bound_by"],
        "library_ms": (sum(r["library_ms"] for r in rows)
                       if all("library_ms" in r for r in rows) else None),
        "roofline_share": sum(r["bound_ms"] for r in rows) / sum(r["ms"] for r in rows),
        "shapes": rows,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="also write the full record to this JSON file")
    parser.add_argument("--profile", action="store_true",
                        help="also profile one more main-path chunk with torch.profiler")
    args = parser.parse_args(argv)

    if not (HERE / "src" / "repro_torch" / "kernels" / "_build.py").is_file():
        print("chip_smoke.py: src/repro_torch not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE / "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA card (torch.cuda.is_available() is False)", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    card = card_line()
    log(f"[card] {card}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    build_kernels()

    from repro_torch.core.graph import rmat_graph
    from repro_torch.kernels.spmm_blocked.ops import prepare_operand

    t0 = time.perf_counter()
    graph = rmat_graph(**GRAPH_SPEC)
    log(f"[graph] rmat n={graph.n} directed edges={graph.num_directed} "
        f"max degree={graph.max_degree()} in {time.perf_counter() - t0:.1f} s")
    log(f"[graph] {json.dumps(load_balance(graph))}")
    operand = prepare_operand(graph, device)

    spmm_rows = check_spmm_blocked(operand, SPMM_WIDTHS, device)
    ema_rows = check_spmm_ema(operand, fused_geometries(TEMPLATE), EMA_CHUNK, device)
    del operand
    torch.cuda.empty_cache()

    main = main_path(graph, TEMPLATE, device, MEMORY_BUDGET_BYTES, with_profile=args.profile)
    if main["chunk_size"] != EMA_CHUNK:
        raise AssertionError(f"chunk {main['chunk_size']} != the {EMA_CHUNK} the kernels were checked at")
    del graph
    torch.cuda.empty_cache()
    exactness(device)

    kernels = [
        kernel_record(
            "spmm_ema", "src/repro_torch/kernels/spmm_ema/csrc/spmm_ema.cu",
            "src/repro/kernels/spmm_ema/kernel.py:48", main["launches"]["spmm_ema"],
            ema_rows,
        ),
        kernel_record(
            "spmm_blocked", "src/repro_torch/kernels/spmm_blocked/csrc/spmm_blocked.cu",
            "src/repro/kernels/spmm_blocked/kernel.py:62",
            main["launches"]["spmm_blocked"], spmm_rows,
        ),
    ]
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "main": main, "kernels": kernels}, indent=1))
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
