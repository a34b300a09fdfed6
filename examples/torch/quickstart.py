"""Quickstart: count tree-like subgraphs in a synthetic network, on the port.

The PyTorch/CUDA counterpart of ``examples/quickstart.py``: same graphs,
templates, seeds and iterations.  Runs on the CUDA card unless told
otherwise:

  PYTHONPATH=src python examples/torch/quickstart.py                 # the card
  PYTHONPATH=src python examples/torch/quickstart.py --device cpu
"""

import argparse

from repro_torch.core import (
    CountingEngine,
    brute_force_embeddings,
    estimate_embeddings,
    get_template,
    rmat_graph,
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default: the card) or cpu")
    args = ap.parse_args(argv)

    # An RMAT network (the paper's synthetic family) and a 7-vertex treelet.
    graph = rmat_graph(n=2048, num_edges=20_000, seed=0)
    template = get_template("u7")
    print(f"graph: {graph.n} vertices, {graph.num_undirected} edges, "
          f"avg degree {graph.avg_degree:.1f}")
    print(f"template: {template.name} (k={template.k})")

    # SUBGRAPH2VEC color-coding estimate: the CountingEngine picks the SpMM
    # backend from graph statistics and the device, and runs the colorings
    # in chunks fused into the M-matrix column dimension.
    engine = CountingEngine(graph, [template], device=args.device)
    print(f"engine: backend={engine.backend} chunk_size={engine.chunk_size} "
          f"peak_columns={engine.peak_columns()}")
    result = engine.estimate(iterations=24, seed=1)[0]
    print(f"estimated embeddings: {result.mean:.4g}  "
          f"(std over colorings {result.std:.3g}, {result.iterations} iterations)")

    # Exact validation on a smaller instance (brute force is exponential).
    small = rmat_graph(n=64, num_edges=300, seed=3)
    t_small = get_template("u5-2")
    exact = brute_force_embeddings(small, t_small)
    est = estimate_embeddings(small, t_small, iterations=400, seed=2, device=args.device)
    rel = abs(est.mean - exact) / max(exact, 1e-9)
    print(f"small-graph validation: exact={exact:.0f} estimate={est.mean:.1f} "
          f"rel_err={rel:.2%}")


if __name__ == "__main__":
    main()
