"""Plan inspector CLI: ``python -m repro_torch.plan <template> [...] [--graph SPEC]``.

The port of ``python -m repro.plan``.  Pretty-prints a
:class:`~repro_torch.plan.ir.TemplatePlan` — the stage schedule (with
canonical sharing and liveness frees), the shared-passive exec groups, and
the liveness peak — and, when a graph is given, binds a real
``CountingEngine`` on the CUDA card (``--device cpu`` for the CPU) to print
the calibrated cost-model verdict (backend, predicted resident/transient
bytes, fusion slack, picked chunk).

Examples::

    python -m repro_torch.plan u6
    python -m repro_torch.plan path6 star6 bintree6 u6
    python -m repro_torch.plan u7 --graph rmat:2048:20000:1
    python -m repro_torch.plan u6 --graph grid:30:30 --backend ell --dtype bf16 --device cpu
    python -m repro_torch.plan --template triangle --template square --graph er:500:2000

Non-tree templates (triangle, square, diamond, clique4, ...) print their
bag schedule — tree-decomposition ops (extend/forget/join), live axes,
decomposition width — alongside the same liveness and cost verdicts.

Templates of different vertex counts cannot share colorings, so the CLI
groups them by ``k`` and prints one plan (and one cost verdict) per group.

Graph specs: ``rmat:N:E[:SEED]``, ``er:N:E[:SEED]``, ``grid:R:C``.
``--mesh-shards D`` adds the mesh comm model's per-stage verdict (blocking
vs the pipelined ring, wire bytes, overlap) for a D-rank 1-D group, priced
on the engine's device type; it needs no process group.
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.core.graph import graph_from_spec
from repro_torch.core.templates import get_template

from .ir import build_template_plan


def _fmt_bytes(b: float) -> str:
    if b >= 2**20:
        return f"{b / 2**20:.2f} MiB"
    if b >= 2**10:
        return f"{b / 2**10:.1f} KiB"
    return f"{int(b)} B"


def _print_plan(plan) -> None:
    d = plan.describe()
    names = ", ".join(d["templates"])
    print(f"TemplatePlan: [{names}]  k={d['k']}")
    print(
        f"  {d['total_subs']} sub-templates -> {d['unique_canons']} unique canons "
        f"-> {d['stages']} scheduled stages ({d['positions']} positions incl. "
        f"root reads)"
    )
    print(
        f"  liveness peak: {d['peak_columns']} live M columns per coloring "
        f"(naive per-plan in-place bound: {d['naive_peak_columns']})"
    )
    print(
        f"  widest passive state: {d['max_passive_columns']} cols | widest "
        f"stage (a+p+out): {d['max_stage_columns']} cols"
    )
    print(f"  split tables (k, m, m_a): {d['table_keys'] or '-'}")
    if d.get("bag_stages"):
        widths = ", ".join(f"{name}={w}" for name, w in d["decomposition_widths"].items())
        print(
            f"  bag stages: {d['bag_stages']} (max live axes "
            f"{d['max_bag_axes']}) | decomposition widths: {widths}"
        )
        print(f"  join tables (k, m1, m2, overlap): {d['join_table_keys'] or '-'}")

    print("\n  pos  stage        kind  cols  active+passive -> out          frees")
    by_pos = {s.position: s for s in plan.stages}
    tmpl_names = [t.name for t in plan.templates]
    pos = 0
    for p_idx, cplan in enumerate(plan.counting_plans):
        if cplan.partition is None:
            for i, op in enumerate(cplan.bag_program.ops):
                s = by_pos.get(pos)
                if s is None or (s.plan_idx, s.sub_idx) != (p_idx, i):
                    continue  # duplicate canon: executed earlier, no position
                frees = ",".join(plan.free_at.get(pos, ())) or "-"
                label = f"{tmpl_names[p_idx]}[{i}]"
                axes = ",".join(map(str, op.axes)) or "-"
                if op.kind == "leaf":
                    body = f"leaf  {s.columns:4d}  {'one-hot coloring':28s}"
                else:
                    bits = [f"axes[{axes}]"]
                    if op.kind == "extend":
                        bits.append(f"+v{op.vertex}")
                        if op.spmm_vertex is not None:
                            bits.append(f"spmm(v{op.spmm_vertex})")
                        if op.mask_vertices:
                            bits.append("mask(" + ",".join(f"v{v}" for v in op.mask_vertices) + ")")
                    elif op.kind == "join":
                        bits.append("color-conv")
                    if op.forget_vertices:
                        bits.append("fgt(" + ",".join(f"v{v}" for v in op.forget_vertices) + ")")
                    kind = {"extend": "ext ", "join": "join", "forget": "fgt "}[op.kind]
                    body = f"{kind}  {s.columns:4d}  {' '.join(bits):28s}"
                print(f"  {pos:3d}  {label:11s}  {body}  {frees}")
                pos += 1
        else:
            for i, _sub in enumerate(cplan.partition.subs):
                s = by_pos.get(pos)
                if s is None or (s.plan_idx, s.sub_idx) != (p_idx, i):
                    continue  # duplicate canon: executed earlier, no position
                frees = ",".join(plan.free_at.get(pos, ())) or "-"
                label = f"{tmpl_names[s.plan_idx]}[{s.sub_idx}]"
                if s.is_leaf:
                    body = f"leaf  {s.columns:4d}  {'one-hot coloring':28s}"
                else:
                    arrow = f"{s.active_columns}+{s.passive_columns} -> {s.columns}"
                    body = f"ema   {s.columns:4d}  {arrow:28s}"
                print(f"  {pos:3d}  {label:11s}  {body}  {frees}")
                pos += 1
        frees = ",".join(plan.free_at.get(pos, ())) or "-"
        print(
            f"  {pos:3d}  {tmpl_names[p_idx]:11s}  root        "
            f"{'sum over colors+vertices':28s}  {frees}"
        )
        pos += 1

    shared = {lead: m for lead, m in plan.exec_groups.items() if len(m) > 1}
    if shared:
        print("\n  shared-passive exec groups (one column-batch sweep each):")
        for (p, i), members in shared.items():
            mem = ", ".join(f"{tmpl_names[q]}[{j}]" for q, j in members)
            print(f"    leader {tmpl_names[p]}[{i}] <- [{mem}]")
    else:
        print("\n  shared-passive exec groups: none (all singletons)")


def _print_cost(graph, gdesc, group, args) -> None:
    from repro_torch.core.engine import CountingEngine
    from repro_torch.plan.cost import DEFAULT_MEMORY_BUDGET_BYTES

    eng = CountingEngine(
        graph,
        group,
        device=args.device,
        backend=args.backend,
        dtype_policy=args.dtype,
        memory_budget_bytes=args.budget or DEFAULT_MEMORY_BUDGET_BYTES,
        column_batch=args.column_batch,
        chunk_size=args.chunk_size,
    )
    d = eng.describe()
    mem = d["memory"]
    print(f"\nCost model on {gdesc}:")
    print(f"  backend: {d['backend']['name']} ({d['backend']['source']}: {d['backend']['reason']})")
    print(
        f"  dtype: store={d['dtype_policy']['store']} "
        f"accum={d['dtype_policy']['accum']} | "
        f"column_batch={d['column_batch']}"
    )
    print(
        f"  predicted bytes/coloring: "
        f"{_fmt_bytes(mem['bytes_per_coloring'])} "
        f"(resident {_fmt_bytes(mem['predicted_resident_bytes'])} + "
        f"transient {_fmt_bytes(mem['predicted_transient_bytes'])}, "
        f"fusion slack {mem['fusion_slack']:.4f})"
    )
    print(
        f"  chunk: {d['chunk_size']} colorings under a "
        f"{_fmt_bytes(mem['budget_bytes'])} budget -> predicted peak "
        f"{_fmt_bytes(eng.predicted_peak_bytes())}"
    )
    if args.mesh_shards is not None:
        _print_comm_schedule(eng.cost, args.mesh_shards, args.column_batch)


def _print_comm_schedule(cost, n_shards: int, column_batch) -> None:
    """The comm model's per-stage verdict for a 1-D ``n_shards`` group: the
    :class:`~repro_torch.plan.cost.CommSchedule` the mesh backend resolves
    (absent an override) and ``describe()['comm']`` reports."""
    from .cost import mesh_link_bytes_per_us

    cb = column_batch or cost.pick_mesh_column_batch()
    schedules = cost.mesh_comm_schedules(n_shards, column_batch=cb)
    print(
        f"\nMesh comm schedule ({n_shards} shards, column_batch={cb}, "
        f"link {mesh_link_bytes_per_us():.0f} B/us):"
    )
    print("  stage      mode       wire        comm_us  compute_us  overlap  reason")
    for leader, s in sorted(schedules.items()):
        d = s.describe()
        print(
            f"  {leader[0]}:{leader[1]:<7d} {d['mode']:10s} "
            f"{_fmt_bytes(d['wire_bytes']):>10s}  {d['comm_us']:7.1f}  "
            f"{d['compute_us']:10.1f}  {d['overlap_efficiency']:7.2f}  "
            f"{d['reason']}"
        )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.plan",
        description="Inspect the TemplatePlan IR (and, with --graph, the "
        "calibrated cost-model verdict) for a template set.",
    )
    ap.add_argument("templates", nargs="*", help="template names (same k), e.g. u6 or triangle")
    ap.add_argument(
        "--template",
        action="append",
        default=[],
        dest="extra_templates",
        metavar="NAME",
        help="additional template (repeatable) — same namespace as the "
        "positionals; graphlets like triangle/square/diamond compile to "
        "bag schedules",
    )
    ap.add_argument("--graph", help="rmat:N:E[:SEED] | er:N:E[:SEED] | grid:R:C")
    ap.add_argument("--backend", default="auto", help="engine backend (default auto)")
    ap.add_argument("--dtype", default="fp32", help="dtype policy: fp32 | bf16")
    ap.add_argument("--budget", type=int, default=None, help="memory budget bytes for the picker")
    ap.add_argument("--column-batch", type=int, default=None)
    ap.add_argument("--chunk-size", type=int, default=None)
    ap.add_argument(
        "--device",
        default=None,
        help="device of the engine behind the cost verdict (default: the CUDA card; "
        "cpu to run on the CPU)",
    )
    ap.add_argument(
        "--mesh-shards",
        type=int,
        default=None,
        metavar="D",
        help="print the mesh comm model's per-stage verdict (blocking vs "
        "pipelined ring, wire bytes, overlap efficiency) for a D-shard "
        "1-D mesh — needs --graph",
    )
    args = ap.parse_args(argv)
    if args.mesh_shards is not None and not args.graph:
        ap.error("--mesh-shards needs --graph (the comm model prices real edges)")

    names = list(args.templates) + list(args.extra_templates)
    if not names:
        ap.error("need at least one template (positional or --template)")
    templates = [get_template(name) for name in names]
    # templates of different k cannot share colorings — one plan per k
    groups: dict = {}
    for t in templates:
        groups.setdefault(t.k, []).append(t)

    graph = gdesc = None
    if args.graph:
        try:
            graph, gdesc = graph_from_spec(args.graph)
        except ValueError as exc:
            raise SystemExit(str(exc)) from exc

    for g_idx, (_k, group) in enumerate(sorted(groups.items())):
        if g_idx:
            print("\n" + "=" * 72 + "\n")
        _print_plan(build_template_plan(group))
        if graph is not None:
            _print_cost(graph, gdesc, group, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
