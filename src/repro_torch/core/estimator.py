"""Multi-iteration color-coding estimator (Algorithm 1).

The port of ``repro.core.estimator``: a thin wrapper over
:class:`repro_torch.core.engine.CountingEngine`.  The iteration count for
an (epsilon, delta) guarantee is ``ceil(p^-1 log(1/delta) / epsilon^2)``
(Alon et al.).  With an ``epsilon`` / ``delta`` target the run streams
through the serving layer's adaptive stopper instead
(:func:`repro_torch.serve.stopping.adaptive_estimate`).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

from .colorsets import colorful_probability
from .engine import CountingEngine, EstimateResult
from .graph import Graph
from .templates import Template

__all__ = ["required_iterations", "EstimateResult", "estimate_embeddings"]


def required_iterations(template_or_k, epsilon: float, delta: float) -> int:
    """Alon et al. iteration bound ``ceil(p^-1 log(1/delta) / eps^2)`` with
    ``p = k!/k^k``; accepts a :class:`Template` or the vertex count."""
    k = template_or_k.k if isinstance(template_or_k, Template) else int(template_or_k)
    inv_p = 1.0 / colorful_probability(k)
    return int(math.ceil(inv_p * math.log(1.0 / delta) / (epsilon**2)))


def estimate_embeddings(
    graph: Graph,
    template: Template,
    iterations: Optional[int] = None,
    seed: int = 0,
    dtype="fp32",
    backend: str = "auto",
    chunk_size: Optional[int] = None,
    memory_budget_bytes: Optional[int] = None,
    device=None,
    spmm_fn: Optional[Callable] = None,
    epsilon: Optional[float] = None,
    delta: Optional[float] = None,
    max_iterations: Optional[int] = None,
    bound: str = "normal",
) -> EstimateResult:
    """End-to-end estimator on ``device`` (``None``: the CUDA card).

    Without a target: ``iterations`` (default 32) colorings from
    ``split(prng_key(seed), iterations)``, as the reference.  With
    ``epsilon`` or ``delta`` (defaults 0.05 each): colorings stream in
    engine-chunk increments from ``fold_in(prng_key(seed), i)`` and stop
    once the CI halfwidth (``bound``: ``"normal"`` or ``"bernstein"``) is
    within ``epsilon * |mean|`` at confidence ``1 - delta``, or at the
    budget ``max_iterations`` (else ``iterations``, else 1024).
    """
    engine = CountingEngine(
        graph,
        [template],
        device=device,
        backend=backend,
        spmm_fn=spmm_fn,
        dtype_policy=dtype,
        chunk_size=chunk_size,
        memory_budget_bytes=memory_budget_bytes,
    )
    if epsilon is not None or delta is not None:
        # lazy import: the serving layer sits above core and imports it
        from repro_torch.serve.stopping import adaptive_estimate

        return adaptive_estimate(
            engine,
            epsilon=0.05 if epsilon is None else float(epsilon),
            delta=0.05 if delta is None else float(delta),
            seed=seed,
            max_iterations=int(max_iterations or iterations or 1024),
            bound=bound,
        )[0]
    return engine.estimate(iterations=iterations or 32, seed=seed)[0]
