"""Multi-iteration color-coding estimator (Algorithm 1).

The port of ``repro.core.estimator``: a thin wrapper over
:class:`repro_torch.core.engine.CountingEngine`.  The iteration count for
an (epsilon, delta) guarantee is ``ceil(p^-1 log(1/delta) / epsilon^2)``
(Alon et al.).  The reference's adaptive stopping path comes with the
serving slice (ROADMAP queue 1 item 8).
"""

from __future__ import annotations

import math
from typing import Optional

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
) -> EstimateResult:
    """End-to-end estimator: ``iterations`` (default 32) seeded colorings
    through one engine on ``device`` (``None``: the CUDA card)."""
    engine = CountingEngine(
        graph,
        [template],
        device=device,
        backend=backend,
        dtype_policy=dtype,
        chunk_size=chunk_size,
        memory_budget_bytes=memory_budget_bytes,
    )
    return engine.estimate(iterations=iterations or 32, seed=seed)[0]
