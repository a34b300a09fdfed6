"""R-MAT graphs (:mod:`portbench.reference.rmat`), by the configuration's
``graph`` keys: ``n`` vertices, ``edges`` sampled edges, the initiator's
``a``, ``b``, ``c`` (``d`` is the rest; ``a = b = c = 0.25`` samples
uniform pairs, an Erdos-Renyi graph), and ``seed`` where the configuration
fixes one graph for every run instead of the run's seed."""

from portbench.reference.rmat import rmat_edges


def make(spec, seed, device):
    return rmat_edges(spec["n"], spec["edges"], spec.get("seed", seed), spec["a"], spec["b"],
                      spec["c"], device=device)
