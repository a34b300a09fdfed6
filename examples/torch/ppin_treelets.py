"""Fig 1 analog: compare treelet distributions across PPIN-like networks, on the port.

The PyTorch/CUDA counterpart of ``examples/ppin_treelets.py``.  The paper
compares five protein-protein interaction networks by the normalized
frequencies of 9-vertex treelets.  Real PPIN files are not bundled; this
example synthesizes networks with the published vertex/edge statistics
(Table II: Ecoli, Worm, Yeast), so nothing is downloaded, and shows the
comparison pipeline: count several treelet shapes per network -> normalize
-> distribution distance.  The graph seeds come from ``hash(name)``, as in
the reference, so set ``PYTHONHASHSEED`` to compare two processes.

  PYTHONPATH=src python examples/torch/ppin_treelets.py                 # the card
  PYTHONPATH=src python examples/torch/ppin_treelets.py --device cpu
"""

import argparse

import numpy as np

from repro_torch.core import (
    CountingEngine,
    Template,
    erdos_renyi_graph,
    rmat_graph,
)

# Reduced treelet family (the paper uses 47 9-vertex treelets; we use
# 5 six-vertex ones so the example runs in seconds).
TREELETS = [
    Template("t6-path", ((0, 1), (1, 2), (2, 3), (3, 4), (4, 5))),
    Template("t6-star", ((0, 1), (0, 2), (0, 3), (0, 4), (0, 5))),
    Template("t6-y", ((0, 1), (1, 2), (2, 3), (2, 4), (4, 5))),
    Template("t6-chair", ((0, 1), (1, 2), (2, 3), (1, 4), (4, 5))),
    Template("t6-cross", ((0, 1), (1, 2), (1, 3), (1, 4), (4, 5))),
]

# Table II statistics (vertices, edges) — synthetic stand-ins.
NETWORKS = {
    "Ecoli": (1474, 6896, "rmat"),
    "Worm1": (1239, 1736, "er"),
    "Yeast1": (1622, 9070, "rmat"),
    "Yeast2": (1536, 2925, "er"),
}


def treelet_distribution(graph, iterations=12, seed=0, device=None):
    # ONE engine counts all five treelets per coloring: the leaf one-hot and
    # every coinciding passive sub-template (shared canonical form) is
    # computed once, and the same colorings serve every template.
    engine = CountingEngine(graph, TREELETS, device=device)
    results = engine.estimate(iterations=iterations, seed=seed)
    counts = [max(r.mean, 0.0) for r in results]
    total = sum(counts) or 1.0
    return np.array([c / total for c in counts])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default: the card) or cpu")
    args = ap.parse_args(argv)

    dists = {}
    for name, (n, e, kind) in NETWORKS.items():
        make = rmat_graph if kind == "rmat" else erdos_renyi_graph
        g = make(n, e, seed=hash(name) % 997)
        dists[name] = treelet_distribution(g, device=args.device)
        row = " ".join(f"{x:.3f}" for x in dists[name])
        print(f"{name:8s} treelet distribution: [{row}]")

    print("\npairwise L1 distribution distances (Fig 1 comparison):")
    names = list(dists)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            d = float(np.abs(dists[a] - dists[b]).sum())
            print(f"  {a} vs {b}: {d:.3f}")


if __name__ == "__main__":
    main()
