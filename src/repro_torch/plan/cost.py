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
  retreat a memory failure walks).

Plans with bag stages (non-tree templates) hold states of ``n**r`` rows
over ``r`` vertex axes, so their resident figure is the plan's
element-level liveness peak and their transient takes the bag ops' scratch
into account (:meth:`CostModel.bag_transient_elements`).

The reference corrects its byte model by a fusion-slack factor read from
XLA:CPU ``memory_model`` rows in ``BENCH_counting.json``.  Those rows say
nothing about PyTorch on a GPU, so the port never reads them: the factor
is fixed at 1.0 until the port measures its own.  The mesh comm model
waits for the mesh slice (ROADMAP queue 1 item 11).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from repro_torch.core.colorsets import binom

__all__ = [
    "CostModel",
    "AdmissionEstimate",
    "admission_estimate",
    "LadderRung",
    "degradation_ladder",
    "pick_chunk_size",
    "DEFAULT_MEMORY_BUDGET_BYTES",
    "MAX_CHUNK_SIZE",
    "LOCAL_COLUMN_BATCH",
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
