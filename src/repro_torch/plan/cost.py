"""The cost model: resource predictions for the single-device targets.

The port of the local half of ``repro.plan.cost``.  One :class:`CostModel`
per (plan, graph, dtype) owns:

* the **resident** figure — ``n * TemplatePlan.peak_columns`` live M-matrix
  elements per coloring;
* the **transient** formulas per target — one fused ``column_batch``-wide
  slice of the backend's gather scratch (edge messages, padded rows, SELL
  groups), or one stage's staging width on the ``blocked`` target;
* **column-batch picking** and **chunk picking** — the largest coloring
  chunk whose live footprint fits the memory budget;
* the serving layer's prices: :func:`admission_estimate` (a query's
  footprint from its plan alone) and :func:`degradation_ladder` (the
  retreat a memory failure walks);
* the tuner's **candidate lattice** (:meth:`CostModel.candidate_lattice`):
  every (budget, backend, column batch, chunk) configuration plus greedy
  per-group mixes, ranked by a per-stage work model scaled by the
  per-backend measured/predicted ratios the tuner itself persists
  (:func:`load_backend_calibration`).

Plans with bag stages (non-tree templates) hold states of ``n**r`` rows
over ``r`` vertex axes, so their resident figure is the plan's
element-level liveness peak and their transient takes the bag ops' scratch
into account (:meth:`CostModel.bag_transient_elements`).

The reference corrects its byte model by a fusion-slack factor read from
XLA:CPU ``memory_model`` rows in ``BENCH_counting.json``.  Those rows say
nothing about PyTorch on a GPU, so the port never reads them: the factor
is fixed at 1.0 until the port measures its own.  The time calibration
is the tuner's: the ratios come from the port's own tuning cache, filled
by stopwatch measurements on the engine's device.

Two lattice decisions are the port's own.  ``blocked`` is a candidate on
a CUDA card (the reference offers it only on a TPU) and never on the CPU,
where both kernels run their plain versions, a correctness path.  And on
``blocked`` the lattice prices the work the port runs: neither kernel
reads ``column_batch`` and an exec group runs as a per-stage loop, so each
member stage pays its own gather and one launch, and the lattice holds one
``blocked`` candidate per (budget, chunk) with ``column_batch=None``.  The
mesh comm model and the mesh candidates wait for the mesh slice (ROADMAP
queue 1 item 11).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core.colorsets import binom

__all__ = [
    "CostModel",
    "AdmissionEstimate",
    "admission_estimate",
    "LadderRung",
    "degradation_ladder",
    "RankedCandidate",
    "load_backend_calibration",
    "pick_chunk_size",
    "DEFAULT_MEMORY_BUDGET_BYTES",
    "MAX_CHUNK_SIZE",
    "LOCAL_COLUMN_BATCH",
    "CALIBRATION_CLAMP",
    "WORK_ELEMENT_US",
    "SWEEP_OVERHEAD_US",
    "LAUNCH_OVERHEAD_US",
]

#: Default live-footprint budget for one chunk of colorings (bytes).  Sized
#: for small graphs; on the card pass a budget sized to its memory.
DEFAULT_MEMORY_BUDGET_BYTES = 32 * 1024 * 1024

#: Hard cap on colorings fused into one chunk (diminishing returns beyond).
MAX_CHUNK_SIZE = 64

#: Default passive columns per fused SpMM+eMA slice on the plain local
#: backends.  The reference's value, tuned on XLA:CPU; a starting point to
#: re-measure on the card, not a measurement of it.
LOCAL_COLUMN_BATCH = 16

#: Per-backend calibration ratios outside this band are treated as noise —
#: the lattice is a *ranker*, a 100x ratio would let one bad probe freeze a
#: backend out of every future candidate set.
CALIBRATION_CLAMP = (0.1, 10.0)

#: Nominal cost of one gathered/FMA'd element in the per-stage work model
#: (microseconds; absolute scale is arbitrary — the lattice only ranks).
WORK_ELEMENT_US = 1e-3

#: Fixed cost per fused column-batch sweep call, and per kernel launch on
#: ``blocked`` — what makes narrow column batches predictedly worse.
SWEEP_OVERHEAD_US = 12.0

#: Fixed per-chunk-launch cost, amortized over the chunk's colorings —
#: what makes tiny chunks predictedly worse.
LAUNCH_OVERHEAD_US = 150.0


def load_backend_calibration(path: Optional[str] = None) -> Dict[str, float]:
    """Per-backend measured/predicted cost ratios from the port's tuning
    cache (:func:`repro_torch.tune.cache.load_calibration`), clamped to
    :data:`CALIBRATION_CLAMP`.

    Every tuning run records, for each uniform candidate it measured, the
    ratio of measured us-per-coloring to the lattice's raw (uncalibrated)
    prediction; :meth:`CostModel.candidate_lattice` multiplies each
    backend's predicted cost by its ratio.  A missing or corrupt cache
    yields ``{}`` (the uncalibrated analytic ranking)."""
    # local import: repro_torch.tune.cache is a leaf over tune.config only
    from repro_torch.tune.cache import load_calibration

    return {
        name: min(max(float(ratio), CALIBRATION_CLAMP[0]), CALIBRATION_CLAMP[1])
        for name, ratio in load_calibration(path).items()
    }


def _dense_work_advantage() -> int:
    # exec.select owns the constant (it imports nothing from plan)
    from repro_torch.exec.select import DENSE_WORK_ADVANTAGE

    return DENSE_WORK_ADVANTAGE


@dataclass(frozen=True)
class RankedCandidate:
    """One point of the tuner's candidate lattice.

    ``predicted_us`` is the calibrated per-coloring cost estimate used for
    ranking; ``raw_us`` is the same figure *without* per-backend
    calibration (what measured ratios are computed against, so calibration
    reaches a fixed point instead of compounding run over run).
    """

    config: object  # TuningConfig (typed loosely: repro_torch.tune is downstream)
    predicted_us: float
    raw_us: float


def pick_chunk_size(
    bytes_per_coloring: int,
    memory_budget_bytes: int,
    max_chunk: int = MAX_CHUNK_SIZE,
) -> int:
    """Largest chunk whose live footprint stays under the budget (>= 1)."""
    if bytes_per_coloring <= 0:
        return max_chunk
    return max(1, min(max_chunk, int(memory_budget_bytes // bytes_per_coloring)))


@dataclass(frozen=True)
class AdmissionEstimate:
    """Predicted footprint of one query, for serving-layer load shedding.

    Computed from the plan alone (no engine, no device operands), so a
    query is priced at submit time.  ``resident_bytes`` is the per-coloring
    live DP state; ``chunk_bytes`` is what one launch of the engine that
    would serve the query keeps live (``chunk_size * resident_bytes``).
    The backend's gather transient is left out: it is only known once an
    engine binds.
    """

    resident_elements: int
    resident_bytes: int  # per coloring
    chunk_size: int
    chunk_bytes: int  # resident_bytes * chunk_size
    peak_columns: int


def admission_estimate(
    graph,
    templates,
    *,
    store_dtype: torch.dtype = torch.float32,
    chunk_size: Optional[int] = None,
    memory_budget_bytes: int = DEFAULT_MEMORY_BUDGET_BYTES,
) -> AdmissionEstimate:
    """Price a ``(graph, templates)`` query without building an engine: the
    :class:`CostModel` resident formula, with the chunk picked against
    ``memory_budget_bytes`` as an engine construction would (unless
    ``chunk_size`` is given)."""
    from .ir import build_template_plan  # local: keeps import cycles out

    plan = build_template_plan(list(templates))
    cm = CostModel(plan, graph, store_dtype)
    resident = cm.resident_elements()
    per_coloring = cm.bytes_per_coloring(0, resident)
    chunk = int(chunk_size) if chunk_size else cm.pick_chunk_size(per_coloring, memory_budget_bytes)
    return AdmissionEstimate(
        resident_elements=resident,
        resident_bytes=per_coloring,
        chunk_size=chunk,
        chunk_bytes=per_coloring * chunk,
        peak_columns=plan.peak_columns,
    )


@dataclass(frozen=True)
class LadderRung:
    """One step of the memory degradation ladder (:func:`degradation_ladder`)."""

    chunk_size: int
    column_batch: Optional[int]  # None = keep the engine's pick
    action: str  # "halve_chunk" | "shrink_columns"


def degradation_ladder(
    chunk_size: int, column_batch: Optional[int], backend: str
) -> List[LadderRung]:
    """The ordered retreat a memory failure walks before a query fails,
    cheapest first: halve ``chunk_size`` down to 1 (estimates do not depend
    on the chunk size); then, where the backend's passive sweep is cut into
    ``column_batch`` slices (every backend but ``blocked``, whose kernels
    read no column batch), halve ``column_batch`` down to 1 at chunk 1.
    Returns the rungs below the given configuration; none left means the
    query cannot fit.

    Unlike the reference, no rung falls back to the ``edges`` backend: on
    the card that would send the query around the kernels to the plain
    PyTorch path."""
    rungs = []
    chunk = int(chunk_size)
    while chunk > 1:
        chunk //= 2
        rungs.append(LadderRung(chunk_size=chunk, column_batch=None, action="halve_chunk"))
    if backend != "blocked":
        cb = int(column_batch) if column_batch else LOCAL_COLUMN_BATCH
        while cb > 1:
            cb //= 2
            rungs.append(LadderRung(chunk_size=1, column_batch=cb, action="shrink_columns"))
    return rungs


class CostModel:
    """Resource predictions for one ``TemplatePlan`` on one graph.

    All element counts are *store-dtype elements per coloring*; byte
    figures multiply by the store itemsize and divide by the fusion-slack
    factor (fixed at 1.0).
    """

    fusion_slack = 1.0

    def __init__(self, plan, graph, store_dtype: torch.dtype = torch.float32):
        self.plan = plan
        self.graph = graph
        self.itemsize = store_dtype.itemsize

    def pick_local_column_batch(self) -> int:
        """Fused-slice width for the single-device backends."""
        return min(LOCAL_COLUMN_BATCH, self.plan.max_passive_columns)

    def resident_elements(self) -> int:
        """Live DP-state elements one coloring keeps resident: ``n`` rows
        times the plan's liveness-aware peak columns, or, with bag stages,
        the plan's element-level liveness peak (a bag state over ``r`` axes
        holds ``n**r * C(k, m)`` elements)."""
        if self.plan.has_bag_stages:
            return self.plan.peak_elements(self.graph.n)
        return self.graph.n * self.plan.peak_columns

    def transient_elements(
        self,
        target: str,
        column_batch: int,
        *,
        sell_padded_slots: Optional[int] = None,
    ) -> int:
        """Widest per-stage scratch one coloring needs on ``target``: the
        backend's gather intermediate plus the aggregated
        ``(n, column_batch)`` slice — never the full passive width.  With
        bag stages, the larger of that and the bag ops' scratch."""
        g = self.graph
        if target in ("edges", "custom"):
            out = (g.num_directed + g.n) * column_batch
        elif target == "ell":
            out = (g.n * max(g.max_degree(), 1) + g.n) * column_batch
        elif target == "sell":
            if sell_padded_slots is None:
                raise ValueError("sell transient needs the built SELL geometry")
            out = (sell_padded_slots + g.n) * column_batch
        elif target == "dense":
            out = g.n * column_batch
        elif target == "blocked":
            # one stage's operands + output; the fused kernel keeps the
            # aggregate in shared memory, so no (n, C_p) intermediate exists
            out = g.n * self.plan.max_stage_columns
        else:
            raise ValueError(f"unknown cost target {target!r}")
        if self.plan.has_bag_stages:
            out = max(out, self.bag_transient_elements(target, sell_padded_slots=sell_padded_slots))
        return out

    def bag_transient_elements(
        self, target: str, *, sell_padded_slots: Optional[int] = None
    ) -> int:
        """Widest bag-op scratch one coloring needs on ``target``: the
        extend's neighbor sum runs the backend's gather over the flattened
        width ``n**(r_in - 1) * C(k, m_in)`` (not column-batched), and an
        extend's or join's term loop holds two gathered operands and the
        accumulator, three states of ``n**r_out * C(k, m_out)`` elements."""
        g = self.graph
        if target in ("edges", "custom"):
            per_col = g.num_directed + g.n
        elif target == "ell":
            per_col = g.n * max(g.max_degree(), 1) + g.n
        elif target == "sell":
            if sell_padded_slots is None:
                raise ValueError("sell transient needs the built SELL geometry")
            per_col = sell_padded_slots + g.n
        elif target in ("dense", "blocked"):
            per_col = g.n
        else:
            raise ValueError(f"unknown cost target {target!r}")
        worst = 0
        for cplan in self.plan.counting_plans:
            if cplan.partition is not None:
                continue
            ops = cplan.bag_program.ops
            for op in ops:
                if op.kind == "leaf":
                    continue
                if op.kind == "extend" and op.spmm_vertex is not None:
                    src = ops[op.inputs[0]]
                    flat = g.n ** (len(src.axes) - 1) * binom(cplan.k, src.m)
                    worst = max(worst, per_col * flat)
                r_out = len(op.axes) + len(op.forget_vertices)
                worst = max(worst, 3 * g.n**r_out * binom(cplan.k, op.m))
        return worst

    def bytes_per_coloring(self, transient_elements: int, resident_elements: int) -> int:
        """Live bytes one coloring contributes to a chunk."""
        raw = (transient_elements + resident_elements) * self.itemsize
        return int(math.ceil(raw / self.fusion_slack))

    def pick_chunk_size(
        self,
        bytes_per_coloring: int,
        memory_budget_bytes: int = DEFAULT_MEMORY_BUDGET_BYTES,
        max_chunk: int = MAX_CHUNK_SIZE,
    ) -> int:
        return pick_chunk_size(bytes_per_coloring, memory_budget_bytes, max_chunk)

    def describe(self) -> Dict:
        out = {
            "fusion_slack": self.fusion_slack,
            "itemsize": self.itemsize,
            "peak_columns": self.plan.peak_columns,
            "resident_elements": self.resident_elements(),
        }
        if self.plan.has_bag_stages:
            out["peak_elements"] = self.plan.peak_elements(self.graph.n)
            out["max_bag_axes"] = self.plan.max_bag_axes
        return out

    # -- tuning candidate lattice --------------------------------------------

    def feasible_backends(self, platform: Optional[str] = None) -> List[str]:
        """Local backends worth *probing* for this (graph, plan): the
        reference's set (no ELL whose hub-row padding blows up, no dense
        adjacency past 8192 vertices), with ``blocked`` on a CUDA card.  On
        the CPU the kernels' plain versions are a correctness path, not a
        candidate, as the reference's interpret mode is."""
        g = self.graph
        edges = max(g.num_directed, 1)
        out = ["edges"]
        if g.n * max(g.max_degree(), 1) <= 8 * edges:
            out.append("ell")
        out.append("sell")
        if g.n <= 8192:  # n^2 adjacency: 256 MB fp32 at 8k vertices
            out.append("dense")
        if platform == "cuda":
            out.append("blocked")
        return out

    def sell_padded_slots(self) -> int:
        """Host-built SELL geometry (memoized — the lattice prices the
        ``sell`` target per exec group, the probe engines rebuild it)."""
        cached = getattr(self, "_sell_padded_slots", None)
        if cached is None:
            from repro_torch.core.graph import build_sell  # local: cycle-free

            cached = build_sell(self.graph).padded_slots
            self._sell_padded_slots = cached
        return cached

    def spmm_work_elements(self, target: str) -> int:
        """Gathered/reduced elements per passive DP column on ``target``
        (the backend-dependent half of a stage's work)."""
        g = self.graph
        edges = max(g.num_directed, 1)
        if target in ("edges", "custom", "blocked"):
            return edges
        if target == "ell":
            return g.n * max(g.max_degree(), 1)
        if target == "sell":
            return self.sell_padded_slots()
        if target == "dense":
            # n^2 MACs at matmul throughput ~= n^2 / advantage gather-grade
            # element visits (the constant select_backend compares with)
            return max(1, g.n**2 // _dense_work_advantage())
        raise ValueError(f"unknown work target {target!r}")

    def group_cost_us(self, leader, backend: str, column_batch: Optional[int]) -> float:
        """Raw (uncalibrated) predicted us for one exec group.

        On the streamed backends one group is one passive column-batch
        sweep shared by every member stage: the backend's gather over
        ``C(k, m_p)`` passive columns, each member's eMA contraction
        (``n * n_out * n_splits`` FMAs) and a fixed cost per fused slice.
        On ``blocked`` each member stage is its own kernel launch, which
        gathers the passive state again and reads no ``column_batch``."""
        p_idx, i = leader
        cplan = self.plan.counting_plans[p_idx]
        sub = cplan.partition.subs[i]
        passive_cols = binom(cplan.k, cplan.partition.subs[sub.passive].size)
        gather = self.spmm_work_elements(backend) * passive_cols
        members = self.plan.exec_groups[leader]
        ema = 0
        for q, j in members:
            mplan = self.plan.counting_plans[q]
            msub = mplan.partition.subs[j]
            m = msub.size
            m_a = mplan.partition.subs[msub.active].size
            ema += self.graph.n * binom(mplan.k, m) * binom(m, m_a)
        if backend == "blocked":
            return (len(members) * gather + ema) * WORK_ELEMENT_US + len(members) * SWEEP_OVERHEAD_US
        cb = max(1, min(int(column_batch), passive_cols))
        sweeps = math.ceil(passive_cols / cb)
        return (gather + ema) * WORK_ELEMENT_US + sweeps * SWEEP_OVERHEAD_US

    def tree_group_leaders(self) -> list:
        """Exec-group leaders of *tree* stages — the addresses a mixed
        config can bind (bag programs run through the uniform default)."""
        return [
            leader
            for leader in sorted(self.plan.exec_groups)
            if self.plan.counting_plans[leader[0]].partition is not None
        ]

    def predict_config_us(
        self,
        config,
        *,
        chunk_size: int,
        calibration: Optional[Dict[str, float]] = None,
    ) -> Tuple[float, float]:
        """``(calibrated_us, raw_us)`` per coloring for one
        :class:`~repro_torch.tune.config.TuningConfig`.

        Calibration multiplies each group's cost by its backend's
        measured/predicted ratio; ``raw_us`` skips that (it is what new
        measurements are ratioed against).  Bag ops enter only through the
        launch term: the lattice ranks on the tree groups it can rebind.
        (The reference routes ``mesh`` configs through its comm model here;
        that waits for the mesh slice, ROADMAP queue 1 item 11.)"""
        calibration = calibration or {}
        bindings = config.bindings()
        cb = config.column_batch or self.pick_local_column_batch()
        raw = calibrated = LAUNCH_OVERHEAD_US / max(1, int(chunk_size))
        for leader in self.tree_group_leaders():
            backend = bindings.get(leader, config.default_backend)
            cost = self.group_cost_us(leader, backend, cb)
            raw += cost
            calibrated += cost * calibration.get(backend, 1.0)
        return calibrated, raw

    def candidate_lattice(
        self,
        *,
        platform: Optional[str] = None,
        calibration: Optional[Dict[str, float]] = None,
        memory_budget_bytes: int = DEFAULT_MEMORY_BUDGET_BYTES,
        chunk_size: Optional[int] = None,
        include_mixed: bool = True,
    ) -> List[RankedCandidate]:
        """Ranked tuning candidates, cheapest-predicted first.

        The reference's cross product of memory budgets (the given one and
        its half, floored at 1 MiB) x feasible backends x column batches
        (4, the picked width, 64, capped at the widest passive) x chunk
        sizes (each backend's own pick under the budget, and its half),
        plus (``include_mixed``) one greedy mixed candidate per (budget,
        column batch) binding each tree exec group to its cheapest backend.
        ``blocked`` candidates carry ``column_batch=None``, one per (budget,
        chunk).  Two budgets that land on the same runtime configuration
        keep only the better-ranked.  (The reference's ``mesh_shards`` axis
        waits for the mesh slice, ROADMAP queue 1 item 11.)"""
        from repro_torch.tune.config import TuningConfig  # local: cycle-free

        if calibration is None:
            calibration = load_backend_calibration()
        backends = self.feasible_backends(platform)
        resident = self.resident_elements()
        picked_cb = self.pick_local_column_batch()
        max_cb = max(1, self.plan.max_passive_columns)
        col_batches = sorted({min(4, max_cb), min(picked_cb, max_cb), min(64, max_cb)})
        budget = int(memory_budget_bytes)
        budgets = sorted({budget, max(budget // 2, 1 << 20)})
        leaders = self.tree_group_leaders()
        candidates = []
        seen = set()

        def _add(config):
            if config.key_fragment() in seen:
                return
            seen.add(config.key_fragment())
            calibrated, raw = self.predict_config_us(
                config, chunk_size=config.chunk_size, calibration=calibration
            )
            candidates.append(RankedCandidate(config=config, predicted_us=calibrated, raw_us=raw))

        for bud in budgets:
            for cb in col_batches:
                # per-backend chunk sets: each backend is probed at the
                # chunk its own byte model picks under this budget, and its
                # half
                chunks_by_backend = {}
                for b in backends:
                    if chunk_size:
                        chunks_by_backend[b] = {int(chunk_size)}
                        continue
                    per = self.bytes_per_coloring(
                        self.transient_elements(
                            b, cb,
                            sell_padded_slots=self.sell_padded_slots() if b == "sell" else None,
                        ),
                        resident,
                    )
                    picked = self.pick_chunk_size(per, bud)
                    chunks_by_backend[b] = {picked, max(1, picked // 2)}
                for b in backends:
                    for chunk in sorted(chunks_by_backend[b]):
                        _add(TuningConfig(
                            default_backend=b,
                            column_batch=None if b == "blocked" else cb,
                            chunk_size=chunk,
                            memory_budget_bytes=bud,
                        ))
                if include_mixed and len(backends) > 1 and leaders:
                    greedy = tuple(
                        (
                            leader,
                            min(
                                backends,
                                key=lambda b: self.group_cost_us(leader, b, cb)
                                * calibration.get(b, 1.0),
                            ),
                        )
                        for leader in leaders
                    )
                    names = {b for _, b in greedy}
                    if len(names) > 1:
                        # the default serves bag ops and plain spmm: the
                        # cheapest gather-per-column backend among the bound
                        # (ties broken by the feasible order, not set order)
                        default = min(
                            names, key=lambda b: (self.spmm_work_elements(b), backends.index(b))
                        )
                        for chunk in sorted(chunks_by_backend[default]):
                            _add(TuningConfig(
                                default_backend=default,
                                group_backends=greedy,
                                column_batch=cb,
                                chunk_size=chunk,
                                memory_budget_bytes=bud,
                            ))
        candidates.sort(key=lambda c: (c.predicted_us, repr(c.config.key_fragment())))
        unique, seen_runtime = [], set()
        for cand in candidates:
            cfg = cand.config
            runtime = (cfg.default_backend, cfg.group_backends, cfg.column_batch,
                       cfg.chunk_size, cfg.mesh_comm)
            if runtime in seen_runtime:
                continue
            seen_runtime.add(runtime)
            unique.append(cand)
        return unique
