#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

Run from the repository root, with no arguments::

    python3 chip_smoke.py [--out results.json]

Phases, in order; any failure ends the run with a nonzero exit code:

1. Card and build: the card's name and power limit (``nvidia-smi``), the
   torch and CUDA versions, and the build of every CUDA kernel of the port
   (``src/repro_torch/**/csrc/*.cu``), with the compiler's register and
   spill report for each kernel instantiation.  Then the R-MAT graph (2^20
   vertices, 2^23 sampled edges) and the edge-balanced partition both
   counting kernels launch over: heavy rows, segments, light ranges, the
   kernels' scratch bytes, and the most edge visits (edges x column tiles)
   any warp makes on each u12 stage, counted on the host from the schedule
   both libraries export (checked as they load); more than 32,768 fails
   the run.
2. The blocked SpMM kernel against its plain PyTorch version on the full
   graph, at 64 and 792 columns, and a second launch bitwise equal to the
   first; ``torch.sparse.mm`` on the same CSR is timed as a yardstick (the
   port never calls it).  Tree stages do not launch this kernel (only the
   bag stages of non-tree templates will), so this phase is where it runs.
3. The fused SpMM+eMA kernel against its plain version on the full graph,
   at every stage geometry the main path gives it (u12 at 2 colorings),
   with the bitwise repeat; ``torch.sparse.mm`` on the passive state is
   timed beside it as the yardstick of its SpMM half.
4. The main path: ``CountingEngine(graph, [u12])`` with ``backend="auto"``
   (which must resolve to ``blocked``) counts one chunk of seeded colorings
   through ``count_colorings``; the launch counters are reset just before
   and read just after, and every kernel of the path (the fused one) must
   have launched (``launches`` counts wrapper calls that launched,
   ``device_launches`` the kernels those calls issued).  The same colorings go through the plain ``edges``
   backend on the card, and the totals must agree.  Records the engine's
   build time (the partition's part of it too), the kernels' scratch bytes
   and the peak device memory.
5. Exactness: on tiny grid and Erdos-Renyi graphs the ``blocked`` engine's
   raw counts, every stage through the fused kernel, equal the brute-force
   colorful counts.
6. The bf16 flash-attention kernel (tensor cores,
   ``flash_attention_sm90.cu``) against its plain version at granite-8b's
   head geometry (h=32, h_kv=8, d=128, bf16, causal) at (b, s) = (4, 4096),
   (1, 32768) and a ragged (2, 4000), with its achieved TFLOP/s;
   ``F.scaled_dot_product_attention`` is timed as a yardstick (the port
   never calls it).
7. The LM main path: granite-8b at full width and depth with
   ``attn_impl="flash"`` and seeded random weights, ``forward`` on b=4,
   s=4096 tokens.  In fp32 its logits must agree with the ``sdpa`` forward
   within 5e-5 of their largest magnitude, through the fp32 kernel alone
   (no tensor-core launch); then the config's bf16 forward, with the launch
   counters reset just before and read just after, must launch the
   tensor-core kernel once per layer and give finite logits.  Records
   tokens/s, peak memory and a ``torch.profiler`` split.
8. ``ServeEngine`` (fp32, 8 slots of 1024) answers 4 requests with 64-token
   prompts, token for token equal to offline greedy decoding through
   ``forward``, then 8 requests with prompts of 16-512 tokens, each of
   which must finish with its 16 tokens; 4 more run under
   ``torch.profiler``.

The second-to-last line of output is the ``kernels`` JSON record; the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA card, or without
the repository beside this file, the script prints no result and exits
nonzero.  Times come from CUDA events; ``bound_ms`` is the larger of the
compulsory bytes over 3.35 TB/s and the operations over the H100 SXM's
published peak for their type: 67 TFLOP/s fp32 for the counting kernels,
989 TFLOP/s dense bf16 for attention.
"""

from __future__ import annotations

import argparse
import dataclasses
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
PEAK_BF16_FLOPS = 989e12  # dense, tensor cores

GRAPH_SPEC = dict(n=1 << 20, num_edges=8_388_608, seed=1)
TEMPLATE = "u12"
MEMORY_BUDGET_BYTES = 48 * 2**30
SPMM_WIDTHS = (64, 792)
EMA_CHUNK = 2  # colorings per chunk at this budget (checked in phase 4)
#: Kernels that each main path launches: tree counting, the LM forward.
COUNTING_PATH_KERNELS = ("spmm_ema",)
LM_PATH_KERNELS = ("flash_attention",)
EXACT_TEMPLATES = ("u3", "u5-2", "u6", "u7")

#: Kernel vs plain version: relative tolerance.  The plain versions sum
#: with ``index_add_``, whose CUDA atomics add in no fixed order, and the
#: kernels contract multiply-adds into FMAs.
KERNEL_RTOL = 1e-4
#: Engine totals, ``blocked`` vs the plain ``edges`` path (same reasons).
TOTALS_RTOL = 1e-4
#: Most edge visits (edges x passive tiles) any warp may make on a stage of
#: TEMPLATE on the smoke graph.
VISIT_CAP = 32_768

#: LM path: (b, s) of the flash checks, of the forward, and the serving run.
FLASH_SHAPES = ((4, 4096), (1, 32768), (2, 4000))
LM_BATCH, LM_SEQ = 4, 4096
SERVE_SLOTS, SERVE_LEN, SERVE_NEW = 8, 1024, 16
#: Flash kernel vs plain version, both outputs in bf16 of values computed
#: in fp32 by both: one bf16 rounding is at most 2^-7 of |want|, and the
#: absolute term only covers fp32 summation-order error near zero.  It must
#: stay well below a typical output (~0.009 on a 32k-key causal row), or a
#: dropped key tile or a shifted causal boundary on long rows would pass.
FLASH_RTOL = 1e-2
FLASH_ATOL = 1e-4
#: fp32 forward, flash vs sdpa: max |diff| over max |logits| (measured
#: 3.5e-6 on the H100, so the gate leaves a margin of about 14x).
LOGITS_RTOL = 5e-5


def log(*args) -> None:
    print(*args, flush=True)


def bound_ms(nbytes: float, flops: float, peak_flops: float = PEAK_FP32_FLOPS) -> tuple:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
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


def max_abs_err(got, want, rtol: float, what: str, atol=None) -> float:
    """Max |got - want|; raises unless every |got - want| <= atol + rtol |want|
    (``atol`` defaults to 1e-6 of the largest |want|)."""
    import torch

    err = (got - want).abs()
    scale = float(want.abs().max()) if want.numel() else 0.0
    atol = 1e-6 * scale if atol is None else atol
    ok = bool(torch.all(err <= rtol * want.abs() + atol))
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


def kernel_name(mangled: str) -> str:
    """``spmm_ema_kernel<4, 1, 32>`` from its mangled name (the last name of
    the nested name, and its integer template arguments)."""
    import re

    i, names = 3 if mangled.startswith("_ZN") else 2, []
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        names.append(mangled[j:j + int(mangled[i:j])])
        i = j + int(mangled[i:j])
    args = re.match(r"I((?:Li\d+E)+)E", mangled[i:])
    targs = "<" + ", ".join(re.findall(r"Li(\d+)E", args[1])) + ">" if args else ""
    return names[-1] + targs if names else mangled


def build_kernels() -> None:
    """Build every source; per source, one line with its kernel instances'
    register range, and a line for each instance that spills or whose
    ``wgmma``s ptxas serialised (C7515)."""
    import re

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    per_source = _build.build()
    log(f"[build] {len(per_source)} sources compiled in {time.perf_counter() - t0:.1f} s "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in per_source.items()) or 'cached'})")
    for source in _build.KERNEL_SOURCES:
        function, regs = "?", {}
        for line in _build.build_log(source).splitlines():
            if "Function properties for" in line:
                function = kernel_name(line.split()[-1])
            elif "Used" in line and "registers" in line:
                regs[function] = int(re.search(r"Used (\d+) registers", line)[1])
            elif "spill" in line and not line.strip().startswith("0 bytes stack frame, 0 bytes spill stores"):
                log(f"[build] {source.stem} {function}: {line.strip()}")
            elif "C7515" in line:   # ptxas serialised the wgmmas of a kernel
                log(f"[build] {source.stem} {kernel_name(line.split()[-1].strip(chr(39)))}: "
                    f"{line.split(':', 1)[-1].split(' in the function')[0].strip()}")
        if regs:
            lo, hi = min(regs.values()), max(regs.values())
            log(f"[build] {source.stem}: {len(regs)} kernel instances, {lo}-{hi} registers "
                f"({max(regs, key=regs.get)} the most)")
        _build.load(source)


def load_balance(graph, operand, geometries, bsz, widths) -> dict:
    """The partition the kernels launch over (``operand.partition``): heavy
    rows, segments, light ranges, and per fused stage and SpMM width the
    most edge visits (edges walked serially x column tiles walked for) any
    warp makes, counted on the host from the partition and the schedule
    that both libraries export (checked first).  Beside them, figures worked
    out here, not measured: the kernels' scratch bytes, the no-reuse gather
    floor of each stage's SpMM half (``|E| * B * C_p * 4`` bytes at
    :data:`PEAK_BYTES_PER_S`), the visits of a split by rows (one warp per
    row, rows ``w, w + 8, ...`` of a 64-row block, every 64-column passive
    tile in turn), and the sizes of the compact operand and of the
    reference's padded one.  Raises if a fused stage exceeds
    :data:`VISIT_CAP`."""
    import numpy as np

    from repro_torch.core.colorsets import binom
    from repro_torch.kernels.spmm_blocked import ops as blocked_ops
    from repro_torch.kernels.spmm_ema import ops as ema_ops

    for lib in (blocked_ops._library(), ema_ops._library()):
        blocked_ops.check_schedule(lib)
    part = operand.partition
    e = operand.num_directed
    deg = graph.degrees().astype(np.int64)
    rows, warps = 64, 8
    pad = (-graph.n) % rows
    per_row = np.concatenate([deg, np.zeros(pad, np.int64)]).reshape(-1, rows)
    row_split_warp = int(per_row.reshape(per_row.shape[0], rows // warps, warps).sum(axis=1).max())
    # the reference's blocked-ELL operand at its block of 256: every
    # (dst-block, src-block) pair padded to the largest (three 4-byte arrays)
    n_blocks = -(-graph.n // 256)
    pair = (graph.dst // 256).astype(np.int64) * n_blocks + graph.src // 256
    pair_sizes = np.unique(pair, return_counts=True)[1]
    stages = []
    for k, m, m_a in geometries:
        c_p, c_a = binom(k, m - m_a), binom(k, m_a)
        if not ema_ops.row_fits(c_p, c_a):
            raise AssertionError(f"{TEMPLATE} stage {(k, m, m_a)} takes the wide path, which "
                                 f"the visit count does not model")
        rows_pass = ema_ops.kernel_geometry(c_p, c_a, blocked_ops.RANGE_ROWS)
        v = blocked_ops.edge_visits(operand, c_p, rows_pass)
        stages.append({"stage": [k, m, m_a], "c_p": c_p, "rows_per_pass": rows_pass,
                       "max_warp_visits": v["max"], "light_warp_visits": v["light_warp"],
                       "heavy_warp_visits": v["heavy_warp"],
                       "row_split_warp_visits": row_split_warp * -(-c_p // 64),
                       "scratch_bytes": ema_ops.scratch_bytes(operand, bsz, c_p),
                       "gather_floor_ms": e * bsz * c_p * 4 / PEAK_BYTES_PER_S * 1e3})
    spmm = [{"cols": c, "max_warp_visits": blocked_ops.edge_visits(operand, c)["max"],
             "scratch_bytes": part.n_segments * c * 4} for c in widths]
    out = {
        "blocked_ell_256_pairs": int(pair_sizes.size),
        "blocked_ell_256_max_pair": int(pair_sizes.max()),
        "blocked_ell_256_padded_bytes": int(pair_sizes.size * pair_sizes.max() * 12),
        "compact_operand_bytes": int((graph.num_directed + graph.n + 1) * 4),
        "heavy_degree": blocked_ops.HEAVY_DEGREE, "segment_edges": blocked_ops.SEGMENT_EDGES,
        "range_rows": blocked_ops.RANGE_ROWS, "range_edges": blocked_ops.RANGE_EDGES,
        "heavy_rows": part.n_heavy,
        "heavy_edges": int(deg[deg > blocked_ops.HEAVY_DEGREE].sum()),
        "segments": part.n_segments,
        "light_ranges": part.n_ranges,
        "partition_build_s": part.build_seconds,
        "partition_bytes": int(sum(t.numel() * 4 for t in (
            part.range_ptr, part.heavy_rows, part.heavy_slot, part.seg_ptr, part.seg_beg,
            part.seg_end))),
        "row_split_max_warp_edges": row_split_warp,
        "fused_stages": stages,
        "gather_floor_ms": sum(st["gather_floor_ms"] for st in stages),
        "spmm_widths": spmm,
    }
    worst = max(st["max_warp_visits"] for st in stages)
    if worst > VISIT_CAP:
        raise AssertionError(f"a warp makes {worst} edge visits on a {TEMPLATE} stage "
                             f"(cap {VISIT_CAP})")
    return out


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
        bitwise = bool(torch.equal(got, spmm_blocked(operand, m)))
        if not bitwise:
            raise AssertionError(f"spmm_blocked C={c}: two launches differ")
        want = spmm_ref(operand.src, operand.dst, n, m, col_chunk=64)
        err = max_abs_err(got, want, KERNEL_RTOL, f"spmm_blocked C={c}")
        del got, want
        row = {"shape": f"n={n} C={c}", "max_abs_err": err, "bitwise_repeatable": bitwise}
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
    """Per stage: kernel vs plain version, two launches bitwise equal, and
    the times of the kernel, the plain version and ``torch.sparse.mm`` on the
    ``(n, B * C_p)`` passive state (``library_spmm_half_ms``: only the SpMM
    half of the function; the port never calls it)."""
    import torch

    from repro_torch.core.colorsets import binom, build_split_table
    from repro_torch.kernels.spmm_ema.ops import prepare_stage_tables, spmm_ema
    from repro_torch.kernels.spmm_ema.ref import spmm_ema_ref

    n, e = operand.n, operand.num_directed
    gen = torch.Generator(device=device).manual_seed(1)
    csr = None
    if device.type == "cuda":
        csr = torch.sparse_csr_tensor(
            operand.row_ptr.long(), operand.src.long(),
            torch.ones(e, dtype=torch.float32, device=device), size=(n, n),
        )
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
        bitwise = bool(torch.equal(got, spmm_ema(operand, m_p, m_aa, tables)))
        if not bitwise:
            raise AssertionError(f"spmm_ema (k,m,m_a)={(k, m, m_a)}: two launches differ")
        want = plain()
        err = max_abs_err(got, want, KERNEL_RTOL, f"spmm_ema (k,m,m_a)={(k, m, m_a)}")
        del got, want
        row = {"shape": f"k={k} m={m} m_a={m_a} B={bsz} C_p={c_p} C_a={c_a} "
                        f"n_out={table.n_out} splits={table.n_splits}",
               "max_abs_err": err, "bitwise_repeatable": bitwise}
        nbytes = (n * bsz * (c_p + c_a + table.n_out) * 4 + (n + 1) * 4 + e * 4
                  + table.n_out * table.n_splits * 4)
        flops = e * bsz * c_p + 2 * n * bsz * table.n_out * table.n_splits
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops)
        if device.type == "cuda":
            row["ms"] = time_ms(lambda: spmm_ema(operand, m_p, m_aa, tables), reps)
            row["plain_ms"] = time_ms(plain, 1)
            flat = m_p.reshape(n, bsz * c_p)
            row["library_spmm_half_ms"] = time_ms(lambda: torch.sparse.mm(csr, flat), reps)
        log(f"[spmm_ema] {json.dumps(row)}")
        rows.append(row)
        del m_p, m_aa
    return rows


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------


def device_profile(fn, classify=None) -> dict:
    """Device time by kernel over one call of ``fn``, and the device's busy
    share of the call's wall time (``torch.profiler``).  With ``classify``
    (kernel name -> kind), also the device time per kind."""
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
    out = {
        "source": source,
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": (1.0 - busy_ms / wall_ms) if events else None,
        "top": [{"name": e.key[:60], "ms": device_us(e) / 1e3, "calls": e.count} for e in top],
    }
    if classify is not None:
        split = {}
        for e in events:
            kind = classify(e.key)
            split[kind] = split.get(kind, 0.0) + device_us(e) / 1e3
        out["split_ms"] = split
    return out


def main_path(graph, template_name, device, budget, with_profile=False) -> dict:
    import numpy as np
    import torch

    from repro_torch.core.engine import CountingEngine
    from repro_torch.core.templates import get_template
    from repro_torch.kernels.spmm_blocked.ops import spmm_blocked
    from repro_torch.kernels.spmm_ema.ops import scratch_bytes, spmm_ema

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

    spmm_ema.launches = spmm_ema.device_launches = 0
    spmm_blocked.launches = spmm_blocked.device_launches = 0
    t0 = time.perf_counter()
    est = engine.count_colorings(colors)  # returns on the host: synchronised
    run_s = time.perf_counter() - t0
    launches = {"spmm_ema": spmm_ema.launches, "spmm_blocked": spmm_blocked.launches}
    device_launches = {"spmm_ema": spmm_ema.device_launches,
                       "spmm_blocked": spmm_blocked.device_launches}

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
    for name in COUNTING_PATH_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    out = {
        "template": template_name,
        "backend": engine.backend,
        "backend_reason": engine.backend_reason,
        "chunk_size": engine.chunk_size,
        "colorings": int(colors.shape[0]),
        "engine_build_s": build_s,
        "partition_build_s": engine.backend_impl.operand.partition.build_seconds,
        "kernel_scratch_bytes": max(
            scratch_bytes(engine.backend_impl.operand, engine.chunk_size, t.c_p)
            for t in engine.backend_impl._fused_tables.values()),
        "seconds_per_coloring": run_s / colors.shape[0],
        "plain_edges_seconds_per_coloring": plain_s / colors.shape[0],
        "max_memory_allocated": peak,
        "predicted_peak_bytes": engine.predicted_peak_bytes(),
        "launches": launches,
        "device_launches": device_launches,
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
# phase 6: the flash-attention kernel
# ---------------------------------------------------------------------------


def check_flash(cfg, shapes, device, reps=3) -> list:
    """The kernel against its plain version at ``cfg``'s head geometry in
    bf16, causal, at each ``(b, s)``; ``F.scaled_dot_product_attention`` on
    the same inputs (laid out as it wants them beforehand) is the yardstick."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    h, h_kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    gen = torch.Generator(device=device).manual_seed(2)
    rows = []
    for b, s in shapes:
        q = torch.randn((b, s, h, d), generator=gen, device=device).to(torch.bfloat16)
        k = torch.randn((b, s, h_kv, d), generator=gen, device=device).to(torch.bfloat16)
        v = torch.randn((b, s, h_kv, d), generator=gen, device=device).to(torch.bfloat16)

        def plain():
            return flash_attention_ref(q, k, v, causal=True)

        before = flash_attention.tensor_core_launches
        got = flash_attention(q, k, v, causal=True)
        if flash_attention.tensor_core_launches != before + 1:
            raise AssertionError(f"flash_attention b={b} s={s}: bf16 did not launch the "
                                 f"tensor-core kernel")
        want = plain()
        got, want = got.float(), want.float()
        err = max_abs_err(got, want, FLASH_RTOL, f"flash_attention b={b} s={s}", atol=FLASH_ATOL)
        # worst error relative to |want| (elements below the absolute term
        # are measured against it)
        rel = float(((got - want).abs() / want.abs().clamp_min(FLASH_ATOL)).max())
        del got, want
        row = {"shape": f"b={b} s={s} h={h} h_kv={h_kv} d={d} bf16 causal", "max_abs_err": err,
               "max_rel_err": rel}
        nbytes = 2 * (2 * b * s * h * d + 2 * b * s * h_kv * d)   # q, o; k, v
        flops = 4 * b * h * s * s * d / 2
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops, PEAK_BF16_FLOPS)
        row["ms"] = time_ms(lambda: flash_attention(q, k, v, causal=True), reps)
        row["tflops"] = flops / row["ms"] / 1e9
        row["plain_ms"] = time_ms(plain, 1)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        row["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), reps)
        log(f"[flash] {json.dumps(row)}")
        rows.append(row)
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 7: the LM forward
# ---------------------------------------------------------------------------


def lm_kernel_kind(name: str) -> str:
    low = name.lower()
    if "flash_attention" in low:
        return "flash_attention"
    if any(t in low for t in ("gemm", "xmma", "cutlass", "nvjet", "cublas")):
        return "cublas_products"
    return "rest"


def lm_forward(cfg, device, reps=2):
    """granite-8b forward at full width and depth: the fp32 flash-vs-sdpa
    gate, then the bf16 forward (the config's dtype) as the main path.
    Returns the record and the parameters (phase 8 reuses them)."""
    import numpy as np
    import torch

    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.models import transformer as T

    cfg32 = dataclasses.replace(cfg, attn_impl="flash", dtype="float32")
    t0 = time.perf_counter()
    params = T.init_params(cfg32, seed=0, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(LM_BATCH, LM_SEQ)), device=device)

    before = flash_attention.launches, flash_attention.tensor_core_launches
    t0 = time.perf_counter()
    ref32, _, _ = T.forward(params, cfg32, tokens)
    torch.cuda.synchronize()
    fp32_s = time.perf_counter() - t0
    fp32_launches = flash_attention.launches - before[0]
    fp32_tensor_core = flash_attention.tensor_core_launches - before[1]
    sdpa32, _, _ = T.forward(params, dataclasses.replace(cfg32, attn_impl="sdpa"), tokens)
    scale = float(sdpa32.abs().max())
    diff = float((ref32 - sdpa32).abs().max())
    del sdpa32
    if not (diff <= LOGITS_RTOL * scale) or not bool(torch.isfinite(ref32).all()):
        raise AssertionError(f"fp32 logits: flash vs sdpa max |diff| {diff:g} > "
                             f"{LOGITS_RTOL} x max |logits| {scale:g}")
    if fp32_launches != cfg.n_layers or fp32_tensor_core != 0:
        raise AssertionError(f"fp32 forward launched flash_attention {fp32_launches} times "
                             f"({fp32_tensor_core} on the tensor cores), not {cfg.n_layers} "
                             f"(0 on the tensor cores)")

    cfg16 = dataclasses.replace(cfg32, dtype="bfloat16")
    torch.cuda.synchronize()
    flash_attention.launches = 0
    flash_attention.tensor_core_launches = 0
    logits, _, _ = T.forward(params, cfg16, tokens)
    torch.cuda.synchronize()
    launches = {"flash_attention": flash_attention.launches,
                "flash_attention_tensor_core": flash_attention.tensor_core_launches}
    if set(launches.values()) != {cfg.n_layers}:
        raise AssertionError(f"bf16 forward launched flash_attention {launches}, not "
                             f"{cfg.n_layers} times, all on the tensor cores")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("bf16 logits are not finite")
    bf16_dev = float((logits.float() - ref32).abs().max())
    del logits, ref32
    torch.cuda.reset_peak_memory_stats()  # bf16 forwards over the resident weights
    ms = time_ms(lambda: T.forward(params, cfg16, tokens), reps)
    peak = torch.cuda.max_memory_allocated()
    profile = device_profile(lambda: (T.forward(params, cfg16, tokens),
                                      torch.cuda.synchronize()), lm_kernel_kind)
    out = {
        "config": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "param_count": cfg.param_count(),
        "batch": LM_BATCH, "seq": LM_SEQ,
        "init_params_s": init_s,
        "fp32_forward_s": fp32_s,
        "fp32_flash_vs_sdpa_max_abs_diff": diff,
        "fp32_max_abs_logit": scale,
        "bf16_vs_fp32_max_abs_diff": bf16_dev,
        "launches": launches,
        "bf16_forward_ms": ms,
        "bf16_tokens_per_s": LM_BATCH * LM_SEQ / (ms / 1e3),
        "bf16_max_memory_allocated": peak,
        "profile": profile,
    }
    log(f"[lm] {json.dumps(out)}")
    return out, params, cfg32


# ---------------------------------------------------------------------------
# phase 8: ServeEngine
# ---------------------------------------------------------------------------


def serve(cfg32, params, device) -> dict:
    import numpy as np
    import torch

    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import Request, ServeEngine

    rng = np.random.default_rng(1)
    engine = ServeEngine(cfg32, params, max_batch=SERVE_SLOTS, max_len=SERVE_LEN)
    equal = [Request(uid=i, prompt=rng.integers(0, cfg32.vocab_size, 64).astype(np.int32),
                     max_new_tokens=SERVE_NEW) for i in range(4)]
    t0 = time.perf_counter()
    engine.run(equal)
    equal_s = time.perf_counter() - t0
    toks = torch.as_tensor(np.stack([r.prompt for r in equal]), device=device).long()
    for _ in range(SERVE_NEW):
        logits, _, _ = T.forward(params, cfg32, toks)
        toks = torch.cat([toks, logits[:, -1].argmax(-1)[:, None]], 1)
        del logits
    greedy = toks[:, 64:].tolist()
    for req, want in zip(equal, greedy):
        if req.generated != want:
            raise AssertionError(f"request {req.uid}: served {req.generated} != greedy {want}")

    lengths = rng.integers(16, 513, size=SERVE_SLOTS)
    mixed = [Request(uid=100 + i, prompt=rng.integers(0, cfg32.vocab_size, int(n)).astype(np.int32),
                     max_new_tokens=SERVE_NEW) for i, n in enumerate(lengths)]
    t0 = time.perf_counter()
    engine.run(mixed)
    mixed_s = time.perf_counter() - t0
    for req in mixed:
        if not req.done or len(req.generated) != SERVE_NEW:
            raise AssertionError(f"request {req.uid} ended with {len(req.generated)} tokens")
    st = dict(engine.stats)
    # four more requests under torch.profiler, for the device's idle share
    # while serving (kept out of the numbers above)
    more = [Request(uid=200 + i, prompt=rng.integers(0, cfg32.vocab_size, 64).astype(np.int32),
                    max_new_tokens=SERVE_NEW) for i in range(4)]
    profile = device_profile(lambda: engine.run(more), lm_kernel_kind)
    out = {
        "slots": SERVE_SLOTS, "max_len": SERVE_LEN, "dtype": cfg32.dtype,
        "requests": len(equal) + len(mixed),
        "equal_prompt_group_s": equal_s, "mixed_prompt_lengths": lengths.tolist(),
        "mixed_group_s": mixed_s,
        "prefill_ms_per_request": st["prefill_seconds"] / st["prefills"] * 1e3,
        "decode_steps": st["decode_steps"], "decode_tokens": st["decode_tokens"],
        "decode_tokens_per_s": st["decode_tokens"] / st["decode_seconds"],
        "decode_ms_per_step": st["decode_seconds"] / st["decode_steps"] * 1e3,
        "greedy_match": True,
        "profile_of_4_more_requests": profile,
    }
    log(f"[serve] {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------


def kernel_record(name, path, source, replaces, launches, rows, timed=None) -> dict:
    """One kernel's entry.  Times and bounds sum over ``timed`` (default:
    every row; for the fused kernel, the shapes the main path gives it);
    the error is the worst over all rows."""
    timed = rows if timed is None else timed
    return {
        "name": name,
        "path": path,
        "on_main_path": name in COUNTING_PATH_KERNELS + LM_PATH_KERNELS,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": sum(r["ms"] for r in timed),
        "plain_ms": sum(r["plain_ms"] for r in timed),
        "bound_ms": sum(r["bound_ms"] for r in timed),
        "bound_by": max(timed, key=lambda r: r["bound_ms"])["bound_by"],
        "library_ms": (sum(r["library_ms"] for r in timed)
                       if all("library_ms" in r for r in timed) else None),
        "roofline_share": sum(r["bound_ms"] for r in timed) / sum(r["ms"] for r in timed),
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
    operand = prepare_operand(graph, device)
    geometries = fused_geometries(TEMPLATE)
    partition = load_balance(graph, operand, geometries, EMA_CHUNK, SPMM_WIDTHS)
    log(f"[partition] {json.dumps(partition)}")

    spmm_rows = check_spmm_blocked(operand, SPMM_WIDTHS, device)
    ema_rows = check_spmm_ema(operand, geometries, EMA_CHUNK, device)
    del operand
    torch.cuda.empty_cache()

    main = main_path(graph, TEMPLATE, device, MEMORY_BUDGET_BYTES, with_profile=args.profile)
    if main["chunk_size"] != EMA_CHUNK:
        raise AssertionError(f"chunk {main['chunk_size']} != the {EMA_CHUNK} the kernels were checked at")
    del graph
    torch.cuda.empty_cache()
    exactness(device)
    log(f"[time] counting phases done at {time.perf_counter() - t_start:.1f} s")

    from repro_torch.configs.granite_8b import CONFIG as LM_CONFIG

    flash_rows = check_flash(LM_CONFIG, FLASH_SHAPES, device)
    lm, params, cfg32 = lm_forward(LM_CONFIG, device)
    served = serve(cfg32, params, device)
    del params
    torch.cuda.empty_cache()
    log(f"[time] LM phases done at {time.perf_counter() - t_start:.1f} s")

    kernels = [
        dict(kernel_record(
            "spmm_ema", "counting", "src/repro_torch/kernels/spmm_ema/csrc/spmm_ema.cu",
            "src/repro/kernels/spmm_ema/kernel.py:48", main["launches"]["spmm_ema"],
            ema_rows,
        ), library_spmm_half_ms=sum(r["library_spmm_half_ms"] for r in ema_rows),
            device_launches=main["device_launches"]["spmm_ema"]),
        dict(kernel_record(
            "spmm_blocked", "counting",
            "src/repro_torch/kernels/spmm_blocked/csrc/spmm_blocked.cu",
            "src/repro/kernels/spmm_blocked/kernel.py:62",
            main["launches"]["spmm_blocked"], spmm_rows,
        ), device_launches=main["device_launches"]["spmm_blocked"]),
        # times: one launch at the forward's shape (b=4, s=4096), which the
        # bf16 forward launches once per layer (the fp32 gate forward runs
        # flash_attention.cu, checked by the logits gate)
        dict(kernel_record(
            "flash_attention", "lm",
            "src/repro_torch/kernels/flash_attention/csrc/flash_attention_sm90.cu",
            "src/repro/kernels/flash_attention/kernel.py:30",
            lm["launches"]["flash_attention"], flash_rows, timed=flash_rows[:1],
        ), tensor_core_launches=lm["launches"]["flash_attention_tensor_core"],
            fp32_source="src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"),
    ]
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "partition": partition, "main": main, "lm": lm, "serve": served,
             "kernels": kernels},
            indent=1))
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
