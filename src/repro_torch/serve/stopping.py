"""Adaptive (epsilon, delta) stopping for color-coding estimation runs.

A copy of ``repro.serve.stopping``; :func:`adaptive_estimate` draws its keys
with :mod:`repro_torch.core.prng`, bit-equal to the reference's.

The color-coding estimate is a mean of i.i.d. per-coloring counts, so the
blind a-priori iteration bound ``N = ceil(e^k log(1/delta) / eps^2)`` (Alon
et al.; ``estimator.required_iterations``) is wildly conservative — it must
cover the worst-case variance of *any* graph.  The serving layer replaces it
with sequential stopping on the *observed* variance: run an increment of
colorings, fold the per-coloring estimates into a running mean/variance
(Welford), and stop as soon as the normal-approximation confidence interval
is relatively tight enough::

    halfwidth = z_{1 - delta/2} * sqrt(var_sample / n)
    stop when  halfwidth <= epsilon * |mean|   (for every template)

or when the iteration budget runs out.  With ~dozens of increments the CLT
approximation is solid (the paper's estimates need >= tens of iterations for
useful accuracy anyway), and empirically the stopper lands 3-5 orders of
magnitude below the blind bound at the same (epsilon, delta) target.

For very small iteration counts or heavy-tailed per-coloring counts the
normal CI can under-cover (the sample variance lags the true tail);
``AdaptiveStopper(bound="bernstein")`` switches the halfwidth to the
**empirical-Bernstein** bound (Audibert et al. 2007; Maurer & Pontil 2009)

    halfwidth = sqrt(2 * var_sample * ln(3/delta) / n)
                + 3 * range_n * ln(3/delta) / n

which is variance-adaptive AND range-guarded: the second term keeps the
interval honest while the variance estimate is still warming up, at the
price of stopping later (never earlier) than the normal CI on the same
stream.  ``range_n`` is the *observed* sample range — the classical bound
assumes a known a-priori range, which per-coloring counts do not have, so
this is the standard plug-in variant (still a far heavier tail guard than
the CLT).  The normal CI stays the default.

Everything here is host-side float64 NumPy — deterministic under a fixed
seed and independent of how iterations were batched into launches.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

__all__ = [
    "normal_quantile",
    "AdaptiveStopper",
    "TemplateCI",
    "adaptive_estimate",
]

#: Guard against stopping on the degenerate variance of the first couple of
#: samples: the CI test only arms after this many iterations.
DEFAULT_MIN_ITERATIONS = 8


def normal_quantile(p: float) -> float:
    """Inverse standard-normal CDF (Acklam's rational approximation).

    Max absolute error ~1.15e-9 over (0, 1) — far below what a stopping
    rule can feel — with no SciPy dependency.
    """
    if not 0.0 < p < 1.0:
        raise ValueError(f"quantile needs p in (0, 1), got {p}")
    # coefficients: P. Acklam, "An algorithm for computing the inverse
    # normal cumulative distribution function"
    a = (-3.969683028665376e01, 2.209460984245205e02, -2.759285104469687e02,
         1.383577518672690e02, -3.066479806614716e01, 2.506628277459239e00)
    b = (-5.447609879822406e01, 1.615858368580409e02, -1.556989798598866e02,
         6.680131188771972e01, -1.328068155288572e01)
    c = (-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e00,
         -2.549732539343734e00, 4.374664141464968e00, 2.938163982698783e00)
    d = (7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e00,
         3.754408661907416e00)
    p_low, p_high = 0.02425, 1 - 0.02425
    if p < p_low:
        q = math.sqrt(-2 * math.log(p))
        return (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / (
            (((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1
        )
    if p <= p_high:
        q = p - 0.5
        r = q * q
        return (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * q / (
            ((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1
        )
    q = math.sqrt(-2 * math.log(1 - p))
    return -(((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / (
        (((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1
    )


@dataclass
class TemplateCI:
    """Per-template running estimate at the moment of inspection.

    ``halfwidth``/``converged`` are the *stopping rule's* view (inf / False
    until the CI arms; 0.0 halfwidth for fixed-N queries — unchanged
    semantics).  The trailing fields are the *streaming-progress* view used
    by ``ServiceFrontend`` futures: BOTH CI halfwidths — the CLT z-interval
    (``halfwidth_normal``) and the empirical-Bernstein bound
    (``halfwidth_bernstein``) — are always computed once two samples exist,
    whatever bound the stopper tests and even for fixed-N queries, plus the
    ``lower``/``upper`` interval edges under the stopper's configured
    bound (``mean ∓ halfwidth``; ±inf before two samples).
    """

    mean: float
    std: float  # sample std (ddof=1); 0.0 before two samples
    halfwidth: float  # z * std / sqrt(n); inf before the CI arms
    converged: bool
    halfwidth_normal: float = math.inf
    halfwidth_bernstein: float = math.inf
    lower: float = -math.inf
    upper: float = math.inf


class AdaptiveStopper:
    """Running mean/variance + the relative-halfwidth stopping rule.

    One stopper per query; feed it ``(m, T)`` blocks of per-coloring
    normalized estimates in iteration order (`update`) and poll ``done``.
    A query stops when EVERY template's CI halfwidth is within
    ``epsilon * |mean|`` (after ``min_iterations``), or at ``budget``
    iterations.  ``epsilon=None`` disables the CI rule — the stopper
    degenerates to a fixed-``budget`` run, so fixed-N and adaptive queries
    drive through one code path.  ``bound`` picks the CI: ``"normal"``
    (default, CLT z-interval) or ``"bernstein"`` (empirical-Bernstein —
    variance-adaptive with an observed-range guard, sequentially more
    conservative; see the module docstring).

    State is a vectorized Welford accumulation in float64: deterministic,
    O(T) memory, and independent of launch batching (the same sample
    sequence gives the same stop decision however it was chunked —
    decisions are only TAKEN at increment boundaries, so coarser batching
    can only overshoot, never diverge).
    """

    def __init__(
        self,
        num_templates: int,
        *,
        epsilon: Optional[float] = None,
        delta: float = 0.05,
        budget: int = 1024,
        min_iterations: int = DEFAULT_MIN_ITERATIONS,
        bound: str = "normal",
    ):
        if epsilon is not None and epsilon <= 0:
            raise ValueError(f"epsilon must be positive, got {epsilon}")
        if not 0 < delta < 1:
            raise ValueError(f"delta must be in (0, 1), got {delta}")
        if budget < 1:
            raise ValueError(f"budget must be >= 1, got {budget}")
        if bound not in ("normal", "bernstein"):
            raise ValueError(f"unknown CI bound {bound!r} (normal | bernstein)")
        self.num_templates = int(num_templates)
        self.epsilon = epsilon
        self.delta = float(delta)
        self.budget = int(budget)
        self.min_iterations = max(2, int(min_iterations))
        self.bound = bound
        self.z = normal_quantile(1 - self.delta / 2) if epsilon is not None else None
        # reporting quantile: progress snapshots carry a CI even for
        # fixed-N queries (self.z stays None so the STOPPING rule is
        # untouched — fixed-N queries still never converge early)
        self._z_report = normal_quantile(1 - self.delta / 2)
        # ln(3/delta) — the empirical-Bernstein confidence term
        self._log3d = math.log(3.0 / self.delta)
        self.count = 0
        self._mean = np.zeros(self.num_templates, np.float64)
        self._m2 = np.zeros(self.num_templates, np.float64)
        # observed per-template sample range (the bernstein range guard);
        # tracked unconditionally — it is O(T) and makes bound switches in
        # tests/debugging honest
        self._min = np.full(self.num_templates, np.inf)
        self._max = np.full(self.num_templates, -np.inf)

    # -- accumulation --------------------------------------------------------

    def update(self, rows: np.ndarray) -> None:
        """Fold ``(m, T)`` per-coloring estimates into the running moments.

        Rejects any block containing a non-finite value (NaN/Inf) *before*
        touching the Welford state: one NaN would silently poison the
        running mean AND the variance — and a NaN variance makes the CI
        halfwidth NaN, whose ``<=`` comparison is False-but-plausible, so
        a corrupted stream could fake convergence or never stop.  The
        whole block is refused atomically (state unchanged), so the
        serving layer can fail just the affected query and keep going.
        """
        rows = np.asarray(rows, np.float64)
        if rows.ndim != 2 or rows.shape[1] != self.num_templates:
            raise ValueError(f"expected (m, {self.num_templates}) rows, got {rows.shape}")
        if not np.isfinite(rows).all():
            bad = [tuple(map(int, cell)) for cell in np.argwhere(~np.isfinite(rows))[:4]]
            raise ValueError(
                f"non-finite per-coloring estimate at (row, template) "
                f"{bad} — rejecting the block; Welford state is unchanged"
            )
        for row in rows:
            self.count += 1
            delta = row - self._mean
            self._mean += delta / self.count
            self._m2 += delta * (row - self._mean)
        if rows.shape[0]:
            np.minimum(self._min, rows.min(axis=0), out=self._min)
            np.maximum(self._max, rows.max(axis=0), out=self._max)

    # -- inspection ----------------------------------------------------------

    @property
    def iterations(self) -> int:
        return self.count

    def _halfwidth_normal(self, std: float) -> float:
        z = self.z if self.z is not None else self._z_report
        return z * std / math.sqrt(self.count)

    def _halfwidth_bernstein(self, t: int, std: float) -> float:
        n = self.count
        rng = float(self._max[t] - self._min[t]) if n >= 1 else 0.0
        return (
            math.sqrt(2.0 * std * std * self._log3d / n)
            + 3.0 * rng * self._log3d / n
        )

    def _halfwidth(self, t: int, std: float) -> float:
        """CI halfwidth for template ``t`` under the configured bound."""
        if self.bound == "bernstein":
            return self._halfwidth_bernstein(t, std)
        return self._halfwidth_normal(std)

    def estimates(self) -> List[TemplateCI]:
        """Current per-template mean / std / CI halfwidth."""
        out = []
        for t in range(self.num_templates):
            if self.count >= 2:
                var = self._m2[t] / (self.count - 1)
                std = math.sqrt(max(var, 0.0))
            else:
                std = 0.0
            if self.epsilon is not None and self.count >= self.min_iterations:
                half = self._halfwidth(t, std)
                conv = half <= self.epsilon * abs(self._mean[t])
            else:
                half = math.inf if self.epsilon is not None else 0.0
                conv = False
            mean = float(self._mean[t])
            if self.count >= 2:
                hw_n = self._halfwidth_normal(std)
                hw_b = self._halfwidth_bernstein(t, std)
                hw_used = hw_b if self.bound == "bernstein" else hw_n
                lower, upper = mean - hw_used, mean + hw_used
            else:
                hw_n = hw_b = math.inf
                lower, upper = -math.inf, math.inf
            out.append(
                TemplateCI(
                    mean=mean,
                    std=std,
                    halfwidth=half,
                    converged=conv,
                    halfwidth_normal=hw_n,
                    halfwidth_bernstein=hw_b,
                    lower=lower,
                    upper=upper,
                )
            )
        return out

    @property
    def converged(self) -> bool:
        """Every template's relative CI target met (False without a target)."""
        if self.z is None or self.count < self.min_iterations:
            return False
        return all(e.converged for e in self.estimates())

    @property
    def done(self) -> bool:
        return self.converged or self.count >= self.budget

    def remaining_budget(self) -> int:
        return max(0, self.budget - self.count)


def adaptive_estimate(
    engine,
    *,
    epsilon: float,
    delta: float = 0.05,
    seed: int = 0,
    max_iterations: int = 1024,
    min_iterations: int = DEFAULT_MIN_ITERATIONS,
    bound: str = "normal",
):
    """Drive one :class:`~repro_torch.core.engine.CountingEngine` adaptively.

    Streams ``chunk_size``-wide increments through the engine's
    :meth:`~repro_torch.core.engine.CountingEngine.count_keys_chunk`,
    folding each into an :class:`AdaptiveStopper`, until the relative
    ``(epsilon, delta)`` CI target is met or ``max_iterations`` is spent.
    Iteration ``i``'s coloring key is ``fold_in(prng_key(seed), i)`` (the
    reference's), stable under any increment size.

    Returns one ``EstimateResult`` per template (``per_iteration`` holds
    exactly the iterations run).
    """
    from repro_torch.core.engine import EstimateResult
    from repro_torch.core.prng import fold_in, prng_key

    stopper = AdaptiveStopper(
        len(engine.templates),
        epsilon=epsilon,
        delta=delta,
        budget=max_iterations,
        min_iterations=min_iterations,
        bound=bound,
    )
    base = prng_key(seed)
    rows: List[np.ndarray] = []
    drawn = 0
    while not stopper.done:
        width = min(engine.chunk_size, stopper.remaining_budget())
        vals = engine.count_keys_chunk(fold_in(base, np.arange(drawn, drawn + width)))
        drawn += width
        rows.append(vals)
        stopper.update(vals)
    per_iter = np.concatenate(rows, axis=0) if rows else np.zeros((0, len(engine.templates)))
    return [
        EstimateResult(
            mean=float(per_iter[:, t].mean()),
            std=float(per_iter[:, t].std()),
            per_iteration=per_iter[:, t],
            iterations=int(per_iter.shape[0]),
        )
        for t in range(len(engine.templates))
    ]
