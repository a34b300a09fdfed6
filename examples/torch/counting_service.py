"""Multi-tenant serving demo: the CountingService end to end, on the port.

The PyTorch/CUDA counterpart of ``examples/counting_service.py``.
Registers two graphs, then drives three tenant workloads through one
service instance:

1. concurrent fixed-N queries on the same (graph, template) key — their
   colorings merge into shared chunk launches;
2. a warm repeat query — cache hit, no new chunk-function build;
3. an adaptive (epsilon, delta) query — stops at its CI target instead of
   the blind ``required_iterations`` bound.

Run:  PYTHONPATH=src python examples/torch/counting_service.py [--device cpu]
"""

import argparse
import logging

from repro_torch.core import rmat_graph
from repro_torch.core.estimator import required_iterations
from repro_torch.serve import CountingService


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default: the card) or cpu")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")

    svc = CountingService(max_engines=4, device=args.device)
    svc.register_graph("social", rmat_graph(2048, 20_000, seed=0))
    svc.register_graph("ppin", rmat_graph(500, 4_000, seed=7))

    # -- 1: concurrent tenants share launches ------------------------------
    tenants = [svc.submit("social", "u5-1", iterations=16, seed=s) for s in range(3)]
    ppin_q = svc.submit("ppin", ["path6", "star6", "u6"], iterations=16, seed=0)
    svc.run()
    for i, q in enumerate(tenants):
        print(f"tenant {i}: u5-1 ~= {q.result()[0].mean:.4g} ({q.iterations} iters)")
    for est in ppin_q.result():
        print(f"ppin {est.template}: ~= {est.mean:.4g}")

    # -- 2: warm repeat query — no new chunk-function build ----------------
    engine = svc.engine(tenants[0].engine_key)
    before = engine.trace_count
    repeat = svc.submit("social", "u5-1", iterations=24, seed=99)
    svc.run()
    print(
        f"warm repeat: {repeat.result()[0].mean:.4g} "
        f"(new compilations: {engine.trace_count - before})"
    )

    # -- 3: adaptive accuracy target ---------------------------------------
    adaptive = svc.submit("social", "u5-1", epsilon=0.01, delta=0.05, seed=1)
    svc.run()
    est = adaptive.result()[0]
    blind = required_iterations(5, 0.01, 0.05)
    print(
        f"adaptive: {est.mean:.4g} +- {est.halfwidth:.3g} "
        f"(converged={est.converged}, {adaptive.iterations} iters vs "
        f"blind bound {blind})"
    )

    stats = svc.stats()
    print(
        f"service: {stats['queries_completed']} queries, "
        f"{stats['launches']} launches, cache {stats['cache']}"
    )


if __name__ == "__main__":
    main()
