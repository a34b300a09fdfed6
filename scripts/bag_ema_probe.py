"""Time each bag op of the motif benchmark's graphlets on the card.

Builds the motif configuration's graph (``portbench/configs/rmat8k-motifs.
json``: R-MAT, n = 8192, 131,072 sampled edges, seed 2) on the card and,
per template and chunk, an fp32 ``blocked`` engine; draws one chunk of
colorings and walks the template's bag program op by op through the
backend's ``_run_bag_op`` (every version of the port has it), timing each
whole extend, forget and join with CUDA events (one warm-up, then
``--reps`` runs): its SpMM, axis move, update and forget.  The templates:
g4-2 (paw) and g4-3 (4-cycle) at a chunk of 10 (the batch cell's), g3-1
(triangle) at 10 and 23 (the service's chunk); the g4 states at 23 pass
the card's memory.

Where the package has the bag eMA kernel (``kernels/spmm_ema/ops.py``
``bag_ema``), each extend and join also times its update alone on the
operands the op hands it: the executor's loop
(``LocalBackend._bag_extend_loop`` / ``_bag_join_loop``) against the
kernel, with the update's bytes model (``chip_smoke.bag_update_bytes``:
each operand row read once where its masks are nonzero, the adjacency
once, the output written once), the achieved TB/s, the bound at 3.35
TB/s, the largest relative gap between the two and whether two kernel
launches gave the same bits.  To time a
parent tree beside this one on the same card::

    git archive <commit> | tar -x -C build/parent
    python3 scripts/bag_ema_probe.py --src build/parent/src --tag parent
    python3 scripts/bag_ema_probe.py --tag change --profile

Prints one JSON line per op (``--out`` appends them to a file);
``--profile`` adds each op's device time by kernel
(``chip_smoke.device_profile``).
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CASES = (("g4-2", 10), ("g4-3", 10), ("g3-1", 10), ("g3-1", 23))


def checksum(t) -> float:
    """The float64 sum of a state, 256 rows of its first axis at a time
    (a whole float64 copy of a g4 state would take 32 GB)."""
    import torch

    if t.dim() == 0 or t.shape[0] == 0:
        return float(t.double().sum())
    return sum(float(t[i:i + 256].double().sum()) for i in range(0, t.shape[0], 256))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--src", default=str(ROOT / "src"), help="the package's parent directory")
    parser.add_argument("--tag", default="change")
    parser.add_argument("--cases", default=",".join(f"{t}:{b}" for t, b in CASES))
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--profile", action="store_true")
    parser.add_argument("--out", default="")
    args = parser.parse_args()
    sys.path[:0] = [str(Path(args.src).resolve()), str(ROOT)]

    import torch

    import chip_smoke as C
    from portbench.graphs.rmat import make
    from portbench.roofline import PEAK_BYTES_PER_S
    from repro_torch.core.engine import CountingEngine
    from repro_torch.core.graph import Graph
    from repro_torch.core.templates import Template
    from repro_torch.exec.local import LocalBackend
    from repro_torch.kernels.spmm_ema import ops

    has_kernel = hasattr(ops, "bag_ema")
    device = torch.device("cuda", 0)
    cfg = json.loads((ROOT / "portbench" / "configs" / "rmat8k-motifs.json").read_text())
    src, dst = make(cfg["graph"], 0, device)
    graph = Graph(n=cfg["graph"]["n"], src=src.cpu().numpy(), dst=dst.cpu().numpy())
    head = {"tag": args.tag, "card": C.card_line(), "torch": torch.__version__,
            "n": graph.n, "edges": graph.num_directed, "bag_ema": has_kernel}
    print(json.dumps(head), flush=True)
    lines = [head]
    for case in args.cases.split(","):
        name, bsz = case.split(":")
        bsz = int(bsz)
        template = Template(name=name, edges=tuple(map(tuple, cfg["templates"][name])))
        eng = CountingEngine(graph, [template], device=device, backend="blocked",
                             chunk_size=bsz, memory_budget_bytes=72 << 30)
        be = eng.backend_impl
        cplan, canons = eng.plan_ir.counting_plans[0], eng.plan_ir.canons[0]
        gen = torch.Generator(device=device).manual_seed(bsz)
        colors = torch.randint(0, eng.k, (bsz, graph.n), generator=gen, device=device)
        leaf = torch.nn.functional.one_hot(colors.t().long(), eng.k).to(torch.float32)
        captured = {}
        if has_kernel:
            update = be._bag_update

            def spy(a, p, tables, mask_axes=(), update=update):
                if "on" in captured:
                    captured.update(a=a, p=p, tables=tables, mask_axes=tuple(mask_axes))
                return update(a, p, tables, mask_axes)

            be._bag_update = spy
        slots = {}
        for i, op in enumerate(cplan.bag_program.ops):
            if op.kind == "leaf":
                slots[canons[i]] = leaf
                continue

            def run(i=i, op=op):
                return be._run_bag_op(cplan, canons, 0, i, op, leaf, slots)

            state = run()
            torch.cuda.synchronize()
            row = {"tag": args.tag, "template": name, "chunk": bsz, "op": i, "kind": op.kind,
                   "axes": list(op.axes), "spmm": op.spmm_vertex is not None,
                   "masks": len(op.mask_vertices), "forget": list(op.forget_vertices),
                   "out_shape": list(state.shape),
                   "checksum": checksum(state),
                   "op_ms": C.time_ms(run, args.reps)}
            if args.profile:
                row["op_profile_ms"] = C.device_profile(run, C.kernel_family)["split_ms"]
            if has_kernel and op.kind != "forget":
                captured["on"] = True  # one more run, keeping the update's operands
                run()
                a, p, tables = captured["a"], captured["p"], captured["tables"]
                mask_axes = captured["mask_axes"]
                adj = be._bag_adj if mask_axes else None
                captured.clear()
                model = C.bag_update_bytes(a, p, mask_axes, adj, tables.n_out)
                total = model["out"] + model["a"] + model["p"] + model["adj"]
                # at most two outputs live beside the op's operands: the g4
                # states take 10.7-16.1 GB each
                fused = ops.bag_ema(a, p, tables.ent, mask_axes, adj)
                again = ops.bag_ema(a, p, tables.ent, mask_axes, adj)
                bitwise = bool(torch.equal(fused, again))
                del again
                head, fused_sum = fused[:64].clone(), checksum(fused)
                del fused
                kernel_ms = C.time_ms(lambda: ops.bag_ema(a, p, tables.ent, mask_axes, adj),
                                      args.reps)
                if op.kind == "extend":
                    owned = p.stride(0) != 0
                    leaf_b = leaf

                    def loop():
                        # masks multiply an owned state in place: 0/1, so idempotent
                        return LocalBackend._bag_extend_loop(
                            p, owned, leaf_b, tables, list(mask_axes), be._bag_adj,
                            torch.float32)
                else:
                    def loop():
                        return LocalBackend._bag_join_loop(a, p, tables, torch.float32)

                want = loop()
                gap = float(((head - want[:64]).abs() / want[:64].abs().clamp_min(1e-30)).max())
                want_sum = checksum(want)
                del want
                loop_ms = C.time_ms(loop, args.reps)
                row.update({
                    "update": {"rank": p.dim() - 2, "c_a": a.shape[-1], "c_p": p.shape[-1],
                               "n_out": tables.n_out, "n_terms": tables.n_terms,
                               "p_broadcast": p.stride(0) == 0,
                               "p_contiguous": p.is_contiguous()},
                    "bytes": model, "bytes_total": total,
                    "bound_ms": total / PEAK_BYTES_PER_S * 1e3,
                    "kernel_ms": kernel_ms, "kernel_tb_s": total / kernel_ms / 1e9,
                    "loop_ms": loop_ms, "loop_tb_s": total / loop_ms / 1e9,
                    "kernel_bitwise_repeat": bitwise,
                    "kernel_vs_loop_max_rel_gap_first_64_rows": gap,
                    "kernel_vs_loop_sum_rel_gap":
                        abs(fused_sum - want_sum) / max(abs(want_sum), 1e-30),
                })
                if args.profile:
                    row["kernel_profile_ms"] = C.device_profile(
                        lambda: ops.bag_ema(a, p, tables.ent, mask_axes, adj),
                        C.kernel_family)["split_ms"]
                    row["loop_profile_ms"] = C.device_profile(loop, C.kernel_family)["split_ms"]
                del a, p, head, loop
            slots[canons[i]] = state
            print(json.dumps(row), flush=True)
            lines.append(row)
            torch.cuda.empty_cache()
        del slots, state, eng, be, leaf
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
