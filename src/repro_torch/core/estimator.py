"""Multi-iteration color-coding estimator (Algorithm 1).

The port of ``repro.core.estimator``: a thin wrapper over
:class:`repro_torch.core.engine.CountingEngine`.  The iteration count for
an (epsilon, delta) guarantee is ``ceil(p^-1 log(1/delta) / epsilon^2)``
(Alon et al.).  With an ``epsilon`` / ``delta`` target the run streams
through the serving layer's adaptive stopper instead
(:func:`repro_torch.serve.stopping.adaptive_estimate`).
``make_count_step`` is kept for callers that want the one-coloring step.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from repro_torch.device import resolve_device

from .colorsets import colorful_probability
from .counting import CountingPlan, count_colorful_vectorized, normalize_count
from .engine import CountingEngine, EstimateResult
from .graph import Graph
from .prng import as_keys, randint
from .templates import Template

__all__ = ["required_iterations", "EstimateResult", "estimate_embeddings", "make_count_step"]


def required_iterations(template_or_k, epsilon: float, delta: float) -> int:
    """Alon et al. iteration bound ``ceil(p^-1 log(1/delta) / eps^2)`` with
    ``p = k!/k^k``; accepts a :class:`Template` or the vertex count."""
    k = template_or_k.k if isinstance(template_or_k, Template) else int(template_or_k)
    inv_p = 1.0 / colorful_probability(k)
    return int(math.ceil(inv_p * math.log(1.0 / delta) / (epsilon**2)))


def make_count_step(
    plan: CountingPlan,
    n: int,
    spmm_fn: Callable[[torch.Tensor], torch.Tensor],
    ema_fn=None,
    dtype: torch.dtype = torch.float32,
    device=None,
):
    """One-coloring step: ``(2,)`` PRNG key -> normalised embedding estimate
    (a 0-d tensor on ``device``; ``None``: the CUDA card).

    The coloring is ``randint(key, (n,), 0, k)``, bit-equal to the
    reference's ``jax.random.randint``; ``spmm_fn`` and ``ema_fn`` are those
    of :func:`count_colorful_vectorized`.  Prefer :class:`CountingEngine`
    (one launch sequence per chunk instead of per coloring) unless a custom
    ``ema_fn`` or per-key control is needed.
    """
    dev = resolve_device(device)

    def step(key) -> torch.Tensor:
        colors = randint(as_keys(key, dev), (n,), 0, plan.k)
        raw = count_colorful_vectorized(plan, colors, spmm_fn, ema_fn=ema_fn, dtype=dtype)
        return normalize_count(raw, plan)

    return step


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
    mesh=None,
    column_batch: Optional[int] = None,
    gather_dtype: Optional[torch.dtype] = None,
    balance_degrees: bool = True,
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

    With ``mesh=`` (a 1-D ``DeviceMesh`` or ``ProcessGroup``) the run is one
    rank of the engine's ``mesh`` backend (``backend="auto"`` resolves to
    it); every rank calls this with the same arguments and gets the same
    estimate.  ``column_batch``, ``gather_dtype`` and ``balance_degrees``
    are the mesh backend's knobs (:class:`repro_torch.exec.mesh.MeshBackend`).
    """
    kwargs = {}
    if mesh is not None:
        kwargs.update(mesh=mesh, column_batch=column_batch, gather_dtype=gather_dtype,
                      balance_degrees=balance_degrees)
    engine = CountingEngine(
        graph,
        [template],
        device=device,
        backend=backend,
        spmm_fn=spmm_fn,
        dtype_policy=dtype,
        chunk_size=chunk_size,
        memory_budget_bytes=memory_budget_bytes,
        **kwargs,
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
