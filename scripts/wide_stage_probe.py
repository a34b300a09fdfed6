"""Time kernel A's wide stages at the full-width cells, one launch each.

Builds the ``[wide]`` cells' graphs of ``chip_smoke.py`` (R-MAT at 8
sampled edges per vertex, seed 1: u18 on 2^17 vertices, u20 on 2^15),
prepares each wide stage's tables and times one ``spmm_ema`` launch at one
coloring with CUDA events, after a warm-up launch that it also holds
bitwise against the timed one.  It uses only functions that every version
of the port has had since kernel A's wide path first ran (``rmat_graph``,
``prepare_operand``, ``build_split_table``, ``prepare_stage_tables``,
``spmm_ema``), so one commit's package can be timed beside another's on
the same card::

    git archive <commit> | tar -x -C build/parent
    python3 scripts/wide_stage_probe.py --src build/parent/src --tag parent
    python3 scripts/wide_stage_probe.py --tag change

Each stage prints one JSON line (ms, route, an fp64 checksum of the
output); ``--out`` appends them to a file.  ``--wide-smem BYTES`` lowers
``WIDE_SMEM_BYTES`` (supports of at most BYTES / 16 columns), and
``--profile`` adds the timed launch's device time by kernel
(``chip_smoke.device_profile``).  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CELLS = (("u18", 1 << 17), ("u20", 1 << 15))
WIDE_STAGES = {"u18": ((18, 10, 7), (18, 14, 10)),
               "u20": ((20, 7, 1), (20, 10, 3), (20, 11, 1), (20, 18, 11))}
EDGES_PER_VERTEX = 8


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--src", default=str(ROOT / "src"), help="the package's parent directory")
    parser.add_argument("--tag", default="change")
    parser.add_argument("--stages", default="", help="k:m:m_a,... (default: all six)")
    parser.add_argument("--wide-smem", type=int, default=0)
    parser.add_argument("--profile", action="store_true")
    parser.add_argument("--out", default="")
    args = parser.parse_args()
    sys.path[:0] = [str(Path(args.src).resolve()), str(ROOT)]

    import torch

    import chip_smoke as C
    from portbench.roofline import PEAK_BYTES_PER_S
    from repro_torch.core.colorsets import binom, build_split_table
    from repro_torch.core.graph import rmat_graph
    from repro_torch.kernels.spmm_blocked.ops import prepare_operand
    from repro_torch.kernels.spmm_ema import ops

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = C.card_line()
    if args.wide_smem:
        ops.WIDE_SMEM_BYTES = args.wide_smem
    wanted = {tuple(int(x) for x in s.split(":")) for s in args.stages.split(",") if s}
    rows = []
    for template, n in CELLS:
        stages = [s for s in WIDE_STAGES[template] if not wanted or s in wanted]
        if not stages:
            continue
        graph = rmat_graph(n, EDGES_PER_VERTEX * n, seed=1)
        operand = prepare_operand(graph, dev)
        for k, m, m_a in stages:
            table = build_split_table(k, m, m_a)
            c_p, c_a = binom(k, m - m_a), binom(k, m_a)
            t0 = time.perf_counter()
            tables = ops.prepare_stage_tables(table.idx_a, table.idx_p, c_p, c_a, dev)
            prep_s = time.perf_counter() - t0
            gen = torch.Generator(device=dev).manual_seed(3)
            m_p = torch.rand((n, 1, c_p), generator=gen, device=dev)
            m_aa = torch.rand((n, 1, c_a), generator=gen, device=dev)
            route = getattr(tables, "route", "tiles")
            first = ops.spmm_ema(operand, m_p, m_aa, tables)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            before = ops.spmm_ema.device_launches
            start.record()
            out = ops.spmm_ema(operand, m_p, m_aa, tables)
            stop.record()
            torch.cuda.synchronize()
            launched = ops.spmm_ema.device_launches - before
            repeatable = bool(torch.equal(first, out))
            checksum = sum(float(out[i:i + 4096].double().sum()) for i in range(0, n, 4096))
            del first, out
            by_kernel = C.device_profile(lambda: ops.spmm_ema(operand, m_p, m_aa, tables),
                                         C.kernel_family)["split_ms"] if args.profile else None
            row = {"tag": args.tag, "template": template, "n": n,
                   "directed_edges": graph.num_directed, "stage": [k, m, m_a], "c_p": c_p,
                   "c_a": c_a, "n_out": table.n_out, "splits": table.n_splits,
                   "route": route, "ms": start.elapsed_time(stop),
                   "device_launches": launched,
                   "bitwise_repeatable": repeatable, "checksum": checksum,
                   "prepare_s": prep_s,
                   "gather_floor_ms": graph.num_directed * c_p * 4 / PEAK_BYTES_PER_S * 1e3,
                   "wide_smem_bytes": args.wide_smem or None, "card": card}
            if by_kernel is not None:
                row["profile_ms_by_kernel"] = by_kernel
            print(json.dumps(row), flush=True)
            rows.append(row)
            del m_p, m_aa, tables
            torch.cuda.empty_cache()
        del operand
    if args.out:
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return 0 if all(r["bitwise_repeatable"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
