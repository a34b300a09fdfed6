"""Autotuner CLI: ``python -m repro_torch.tune [templates...] [--graph SPEC]``.

The port of ``python -m repro.tune``.  Tunes one ``(graph, template set)``
pair on the CUDA card (``--device cpu`` to tune on the CPU instead),
prints the measured-vs-predicted table for every probed candidate, and
persists the winner (plus per-backend calibration ratios) in the port's
tuning cache — the file a ``CountingService`` running with
``REPRO_TUNE=cached`` (the default) picks up on its next engine build for
the same workload on the same kind of device.

Examples::

    python -m repro_torch.tune                  # rmat2k u5-1, the bench pair
    python -m repro_torch.tune u5-1 --graph rmat:8192:80000:2 --top-n 4 --probes 3
    python -m repro_torch.tune u3 --device cpu --cache build/tuning/cpu.json

Graph specs: ``rmat:N:E[:SEED]``, ``er:N:E[:SEED]``, ``grid:R:C``.
"""

from __future__ import annotations

import argparse
import logging
import sys

from repro_torch.core.graph import graph_from_spec
from repro_torch.core.templates import get_template

from .cache import default_cache_path
from .search import DEFAULT_PROBES, DEFAULT_TOP_N, tune


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tune",
        description="measurement-driven autotuning for the counting engine",
    )
    ap.add_argument(
        "templates",
        nargs="*",
        default=["u5-1"],
        help="template names tuned as one set (default: u5-1)",
    )
    ap.add_argument(
        "--graph",
        default="rmat:2048:20000:1",
        help="graph spec rmat:N:E[:SEED] | er:N:E[:SEED] | grid:R:C "
        "(default: the rmat2k bench graph)",
    )
    ap.add_argument(
        "--top-n",
        type=int,
        default=DEFAULT_TOP_N,
        help=f"predicted-best candidates to measure (default {DEFAULT_TOP_N})",
    )
    ap.add_argument(
        "--probes",
        type=int,
        default=DEFAULT_PROBES,
        help=f"timed launches per candidate (default {DEFAULT_PROBES})",
    )
    ap.add_argument(
        "--dtype", default="fp32", choices=["fp32", "bf16"], help="dtype policy"
    )
    ap.add_argument(
        "--device",
        default=None,
        help="device to tune on (default: the CUDA card; 'cpu' to tune on the CPU)",
    )
    ap.add_argument(
        "--budget-gib",
        type=float,
        default=None,
        help="memory budget of one chunk in GiB (default: the cost model's)",
    )
    ap.add_argument(
        "--cache",
        default=None,
        help="cache file to write (default: REPRO_TUNE_CACHE or "
        "build/tuning/TUNED_counting.json)",
    )
    ap.add_argument(
        "--dry-run", action="store_true", help="measure but do not persist"
    )
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.WARNING,
        format="%(name)s %(levelname)s %(message)s",
    )
    try:
        graph, graph_desc = graph_from_spec(args.graph)
    except ValueError as exc:
        raise SystemExit(str(exc)) from exc
    templates = [get_template(name) for name in args.templates]
    print(f"tuning [{', '.join(t.name for t in templates)}] on {graph_desc}")
    result = tune(
        graph,
        templates,
        top_n=args.top_n,
        probes=args.probes,
        dtype_policy=args.dtype,
        memory_budget_bytes=None if args.budget_gib is None else int(args.budget_gib * 2**30),
        device=args.device,
        cache_path=args.cache,
        save=not args.dry_run,
    )
    print(
        f"device={result.device}  lattice={result.lattice_size} candidates, "
        f"measured top {len(result.measured)}  "
        f"(heuristic would pick: {result.heuristic_backend})"
    )
    print(f"{'backend':>8s} {'cb':>4s} {'chunk':>5s} "
          f"{'predicted':>12s} {'measured':>12s} {'miss':>7s}")
    for m in result.measured:
        marker = "  <- winner" if m.config == result.config else ""
        miss = (
            m.measured_us / m.predicted_us if m.predicted_us > 0 else float("inf")
        )
        print(
            f"{m.config.backend_name:>8s} {str(m.config.column_batch):>4s} "
            f"{str(m.config.chunk_size):>5s} {m.predicted_us:>10.1f}us "
            f"{m.measured_us:>10.1f}us {miss:>6.2f}x{marker}"
        )
    if result.config.mixed:
        print("winner group bindings:")
        for (p, i), b in result.config.group_backends:
            print(f"  stage {p}:{i} -> {b}")
    if result.calibration:
        calib = ", ".join(
            f"{k}={v:.3f}" for k, v in sorted(result.calibration.items())
        )
        print(f"per-backend calibration (measured/raw-predicted): {calib}")
    if result.cache_path:
        print(f"persisted -> {result.cache_path}")
    else:
        print(f"dry run: NOT persisted (would write {args.cache or default_cache_path()})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
