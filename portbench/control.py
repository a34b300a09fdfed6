"""Readings that a cell's limits are set from, on the card, in one process.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 \\
        [--precision bf16 --budget-gib 36] [--seconds 1]

Runs the cell once per seed, exactly as ``portbench.run`` does (the same
graph, traffic, window and comparison), and prints one JSON line per seed
with every number compared.  With ``--precision bf16`` the engines store
their DP states in bfloat16 (the program's own path one precision below the
configuration's fp32) and, at half the budget, as many colorings to a
chunk as in fp32: that is the control, which has to come out not correct.
Without it, the program's readings on many seeds give the lower end from
which each limit is set.  The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import run as harness


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated seeds")
    parser.add_argument("--precision", default=None)
    parser.add_argument("--seconds", type=float, default=1.0)
    parser.add_argument("--budget-gib", type=float, default=None,
                        help="the engines' memory budget; the control in bf16 takes half "
                             "the configuration's, so that its chunks hold as many colorings")
    args = parser.parse_args(argv)
    harness.set_environment(harness.ROOT)
    import torch

    if not torch.cuda.is_available():
        print("portbench.control: no CUDA card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in (int(s) for s in args.seeds.split(",")):
        result = harness.run(harness.ROOT, args.workload, seed, args.seconds, False,
                             torch.device("cuda", 0), precision=args.precision,
                             budget_gib=args.budget_gib)
        print(json.dumps({"seed": seed, "precision": result["run"]["precision"],
                          "chunk_size": result["run"].get("chunk_size"),
                          "correct": result["correct"], "compared": result["run"]["compared"],
                          "checks": result["checks"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
