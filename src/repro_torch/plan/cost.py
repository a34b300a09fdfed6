"""The cost model: resource predictions for the single-device targets.

The port of the local half of ``repro.plan.cost``.  One :class:`CostModel`
per (plan, graph, dtype) owns:

* the **resident** figure — ``n * TemplatePlan.peak_columns`` live M-matrix
  elements per coloring;
* the **transient** formulas per target — one fused ``column_batch``-wide
  slice of the backend's gather scratch (edge messages, padded rows, SELL
  groups), or one stage's staging width on the ``blocked`` target;
* **column-batch picking** and **chunk picking** — the largest coloring
  chunk whose live footprint fits the memory budget.

The reference corrects its byte model by a fusion-slack factor read from
XLA:CPU ``memory_model`` rows in ``BENCH_counting.json``.  Those rows say
nothing about PyTorch on a GPU, so the port never reads them: the factor
is fixed at 1.0 until the port measures its own.  The mesh comm model
waits for the mesh slice (ROADMAP queue 1 item 11).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

__all__ = [
    "CostModel",
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
        times the plan's liveness-aware peak columns (tree plans)."""
        self._require_tree_plan()
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
        ``(n, column_batch)`` slice — never the full passive width."""
        self._require_tree_plan()
        g = self.graph
        if target == "edges":
            return (g.num_directed + g.n) * column_batch
        if target == "ell":
            return (g.n * max(g.max_degree(), 1) + g.n) * column_batch
        if target == "sell":
            if sell_padded_slots is None:
                raise ValueError("sell transient needs the built SELL geometry")
            return (sell_padded_slots + g.n) * column_batch
        if target == "dense":
            return g.n * column_batch
        if target == "blocked":
            # one stage's operands + output; the fused kernel keeps the
            # aggregate in shared memory, so no (n, C_p) intermediate exists
            return g.n * self.plan.max_stage_columns
        raise ValueError(f"unknown cost target {target!r}")

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
        return {
            "fusion_slack": self.fusion_slack,
            "itemsize": self.itemsize,
            "peak_columns": self.plan.peak_columns,
            "resident_elements": self.resident_elements(),
        }

    def _require_tree_plan(self) -> None:
        if self.plan.has_bag_stages:
            raise NotImplementedError(
                "bag-stage (non-tree) templates are not ported yet "
                "(ROADMAP queue 1 item 7)"
            )
