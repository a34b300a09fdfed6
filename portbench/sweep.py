"""Find the highest rate the counting service sustains, once, on the card.

    python3 -m portbench.sweep --workload rmat8k-motifs-service --seed <n> \\
        --seconds 51 --rates 1.5,2,2.5 --repeats 2

Runs the cell's traffic at each offered rate, ``--repeats`` times with
different seeds (one process, set-up paid per run), and prints one JSON line
per run: queries offered and completed per second, the median and 95th
percentile latency, the median and mean latency of the first and the last
third of the arrivals, the queries still outstanding when the window closed,
how late the generator ran, failures, and the verdict of one backlog test
applied to every run: the backlog grows where the last third's mean latency
passes :data:`BACKLOG_RATIO` times the first third's.  A rate is sustained
where no run of it fails the test; the cell's fixed rate is four fifths of
the highest sustained rate.  The benchmark's runs never search.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import run as harness

#: the last third's mean latency over the first third's past which the backlog grows
BACKLOG_RATIO = 1.5


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=51.0)
    parser.add_argument("--rates", required=True, help="comma-separated queries per second")
    parser.add_argument("--repeats", type=int, default=2)
    args = parser.parse_args(argv)
    harness.set_environment(harness.ROOT)
    import torch

    if not torch.cuda.is_available():
        print("portbench.sweep: no CUDA card", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    keys = ("attempted", "failed", "completed_per_s", "latency_p50_first_third_s",
            "latency_p50_last_third_s", "latency_mean_first_third_s",
            "latency_mean_last_third_s", "outstanding_at_close", "generator_late_max_s")
    i = 0
    for rate in (float(r) for r in args.rates.split(",")):
        for _ in range(args.repeats):
            result = harness.run(harness.ROOT, args.workload, args.seed + i, args.seconds, False,
                                 device, traffic_changes={"rate_qps": rate})
            out = result["run"]
            growing = (out["latency_mean_last_third_s"]
                       > BACKLOG_RATIO * out["latency_mean_first_third_s"])
            row = {"rate_qps": rate, "seed": args.seed + i,
                   **{k: v["value"] for k, v in result["metrics"].items()},
                   "attempted": result["attempted"], "failed": result["failed"],
                   **{k: out[k] for k in keys if k in out}, "backlog_grows": growing}
            print(json.dumps(row), flush=True)
            torch.cuda.empty_cache()
            i += 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
