"""Run one cell of the counting benchmark once, on one CUDA card.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and the program, ``src/repro_torch``.  The seed makes the graph (on the
card, by the configuration's generator, ``graphs/<generator>.py``; a
configuration may fix its graph's seed instead) and every query and
coloring; the same seed gives the same inputs.  Set-up builds the two
counting kernels (once per checkout, under ``build/kernels``; that compile
is recorded as ``compile_s`` and left out of ``setup_s``), the graph and the
engines, and warms the cell's shapes; then the window runs the cell's
traffic for ``--seconds`` through the driver that the traffic's ``kind``
names (``drivers/<kind>.py``).

After the window the program's state is freed and the plain reference
(:mod:`portbench.reference`) recomputes a sample of the answers, drawn from
the seed.  The last line of standard output is one JSON object; the numbers
compared and their limits are the last lines of standard error and the
result's last key.  ``--trace 1`` traces the window with ``torch.profiler``
and reports the per-layer metrics instead of the end-to-end ones.
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

from .common import Cell  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: modules that may not be loaded in the process that prints the result
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")
#: the two counting kernels' sources, relative to ``src/repro_torch/kernels``
KERNEL_SOURCES = ("spmm_ema/csrc/spmm_ema.cu", "spmm_blocked/csrc/spmm_blocked.cu")


def set_environment(root: Path) -> None:
    """Pin what the program reads from the environment: kernel caches at
    fixed paths in the checkout, tuning off, no tuned entry or calibration
    file that an earlier run could have written."""
    build = root / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    scratch = Path(tempfile.gettempdir()) / "portbench"
    os.environ["REPRO_TUNE_CACHE"] = str(scratch / "TUNED_counting.json")
    os.environ["REPRO_FUSION_SLACK_BENCH"] = str(scratch / "BENCH_counting.json")
    os.environ["REPRO_TUNE"] = "off"
    os.environ["USE_FLAX"] = "0"
    for name in ("REPRO_ENGINE_BACKEND", "REPRO_MESH_COMM", "REPRO_MESH_LINK_BYTES_PER_US",
                 "REPRO_FAULT_SEED"):
        os.environ.pop(name, None)
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def build_kernels(root: Path) -> float:
    """Compile the counting kernels that are not built yet; seconds spent."""
    from repro_torch.kernels import _build

    kernels = root / "src" / "repro_torch" / "kernels"
    # the sources compile in parallel; each entry is seconds from the start
    return max(_build.build([kernels / s for s in KERNEL_SOURCES]).values(), default=0.0)


def make_graph(bench, spec: Dict, seed: int, device):
    """The port's ``Graph`` and the same edge arrays on ``device``, from the
    configuration's generator and the run's seed."""
    from repro_torch.core.graph import Graph

    src, dst = bench.graph(spec["generator"])(spec, seed, device)
    graph = Graph(n=int(spec["n"]), src=src.cpu().numpy(), dst=dst.cpu().numpy())
    return graph, src, dst


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------


def run(root: Path, workload: str, seed: int, seconds: float, trace_on: bool, device,
        precision: Optional[str] = None, budget_gib: Optional[float] = None,
        traffic_changes: Optional[Dict] = None) -> Dict:
    """One run of ``workload``; returns the result object (``checks`` last).
    ``precision`` and ``budget_gib`` replace the configuration's (the
    control's lower precision, at the budget that keeps its chunks), and
    ``traffic_changes`` some of the traffic's parameters (the sweep's
    rates)."""
    import torch

    from .registry import Benchmark

    bench = Benchmark(root)
    cell = bench.cell(workload)
    cfg = bench.config(cell["config"])
    if budget_gib is not None:
        cfg = dict(cfg, memory_budget_gib=budget_gib)
    traffic = dict(bench.traffic(cell["traffic"]), **(traffic_changes or {}))
    out: Dict = {"cell": workload, "precision": precision or cfg["precision"]}
    out["compile_s"] = build_kernels(root) if device.type == "cuda" else 0.0
    graph, src, dst = make_graph(bench, cfg["graph"], seed, device)
    ctx, checks = bench.driver(traffic["kind"])(Cell(
        cfg=cfg, traffic=traffic, check=bench.check(workload), graph=graph, src=src, dst=dst,
        seed=seed, seconds=seconds, trace_on=trace_on, device=device, out=out))
    # set-up runs from the process's start to the window, less a first compile
    out["setup_s"] = out.pop("setup_end") - _T_START - out["compile_s"]
    if trace_on:
        metrics = {}
        for m in bench.per_layer(workload):
            value = bench.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(out.pop("metrics_e2e"), setup_s=out["setup_s"])
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in bench.end_to_end(workload)}
    out.pop("metrics_e2e", None)
    result = {
        "correct": all(value <= limit for value, limit in checks.values()),
        "attempted": out.pop("attempted"),
        "failed": out.pop("failed"),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": 1,
            "memory_peak_bytes": out.pop("memory_peak_bytes", 0),
        },
    }
    summary = ctx.trace
    if trace_on and summary is not None:
        result["device"].update(busy_s=summary.busy_s, window_s=summary.window_s)
        result["breakdown"] = {"device_ops": summary.top_ops(10),
                               "idle_gaps": [[k, v] for k, v in summary.idle_by_host[:10]]}
    result["run"] = out
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, (value, limit) in checks.items()}
    return result


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    if not (ROOT / "src" / "repro_torch" / "kernels" / "_build.py").is_file():
        print("portbench: the program (src/repro_torch) is not in this checkout", file=sys.stderr)
        return 2
    set_environment(ROOT)
    import torch

    from .registry import Benchmark

    chips = Benchmark(ROOT).cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                 torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"portbench: the process loaded {', '.join(found)}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
