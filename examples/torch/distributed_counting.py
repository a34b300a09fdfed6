"""Distributed SUBGRAPH2VEC through the port's mesh backend.

The PyTorch/CUDA counterpart of ``examples/distributed_counting.py``: the
same graph, template, column batch and seeds.  It spawns its own ranks, one
``torch.distributed`` group: NCCL with one rank per CUDA card by default,
or gloo on the CPU.  Every rank builds the same ``CountingEngine`` with
``mesh=`` (vertex 1-D partition, column-batched all-gather SpMM, streamed
eMA) and gets the same totals; rank 0 prints them and cross-checks a fixed
coloring against the single-device local engine.

  PYTHONPATH=src python examples/torch/distributed_counting.py                 # the cards
  PYTHONPATH=src python examples/torch/distributed_counting.py --device cpu --ranks 4
"""

import argparse

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import CountingEngine, get_template, rmat_graph
from repro_torch.testing.ranks import run_ranks


def rank_main(rank, world, device_type):
    """One rank's run; returns the lines rank 0 prints."""
    device = "cpu" if device_type == "cpu" else None  # None: this rank's card
    graph = rmat_graph(2048, 20_000, seed=11)
    template = get_template("u7")

    # The mesh backend shards the graph once (degree-balanced row partition),
    # builds the split tables once, and runs chunks of colorings batched
    # through the column-batched all-gather SpMM + streamed eMA.
    engine = CountingEngine(
        graph,
        [template],
        device=device,
        backend="mesh",
        mesh=dist.group.WORLD,
        column_batch=16,
        balance_degrees=True,
    )
    sharded = engine.backend_impl.sharded
    lines = [
        f"mesh: {world} ranks ({dist.get_backend()}, {engine.device.type})",
        f"graph: {graph.n} vertices; {sharded.edges_per_shard} edges/shard "
        f"(degree-balanced); chunk_size={engine.chunk_size} "
        f"column_batch={engine.backend_impl.column_batch}",
    ]
    result = engine.estimate(iterations=8, seed=0)[0]
    lines.append(
        f"distributed estimate: {result.mean:.4g} "
        f"(std over colorings {result.std:.3g}, {result.iterations} iterations)"
    )

    # cross-check one fixed coloring against the single-device local engine
    colors = np.random.default_rng(0).integers(0, template.k, size=graph.n)
    raw_mesh = float(engine.raw_counts(colors)[0])
    if rank == 0:
        local = CountingEngine(graph, [template], device=device, backend="edges")
        raw_local = float(local.raw_counts(colors)[0])
        rel = abs(raw_mesh - raw_local) / max(abs(raw_local), 1e-9)
        lines.append(
            f"mesh vs local engine: {raw_mesh:.6g} vs {raw_local:.6g} (rel err {rel:.2e})"
        )
        if rel >= 1e-5:
            raise AssertionError(f"mesh and local engines disagree: rel err {rel:.2e}")
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: NCCL, one rank per card) or cpu (gloo)")
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks to spawn (default: every card; 4 on the CPU)")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds the whole run (and each collective) may take")
    args = ap.parse_args(argv)
    if args.device == "cpu":
        backend, ranks = "gloo", args.ranks or 4
    else:
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA card: pass --device cpu to run on the CPU over gloo")
        backend, ranks = "nccl", args.ranks or torch.cuda.device_count()
    lines = run_ranks(rank_main, ranks, args=(args.device,), backend=backend,
                      timeout_s=args.timeout)[0]
    print("\n".join(lines))


if __name__ == "__main__":
    main()
