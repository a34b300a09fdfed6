"""EngineBackend interface: how a TemplatePlan binds to a device and runs.

The port of ``repro.exec.base``.  A backend owns:

* **operand construction** — its device-resident graph representation,
  built once in ``__init__`` (edge lists, ELL/SELL tables, dense
  adjacency, the compact operand of the CUDA kernels);
* **the DP execution** — :meth:`EngineBackend.counts_for_colors` maps a
  ``(B, n)`` chunk of colorings to ``(B, T)`` raw colorful totals by
  walking the engine's :class:`~repro_torch.plan.ir.TemplatePlan`.  The
  per-stage primitive is :meth:`aggregate_ema`: one fused neighbor-aggregate
  + eMA step that never materialises the full ``A_G @ M_p`` product;
* **the memory-model geometry** — :meth:`transient_elements` /
  :meth:`resident_elements` feed the cost model's formulas.

The reference's ``make_run_fn`` (``jax.jit`` over ``lax.map``) becomes
:meth:`EngineBackend.make_chunk_fn`: PyTorch runs eagerly, so the chunk
function is a plain closure built once per engine.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.colorsets import bucketed_split_entries

__all__ = [
    "StageTables",
    "EngineBackend",
    "build_stage_tables",
    "make_backend",
]


def make_backend(engine) -> "EngineBackend":
    """Bind ``engine``'s resolved backend name to an implementation."""
    from .local import (
        BlockedEllBackend,
        CustomBackend,
        DenseBackend,
        EdgesBackend,
        EllBackend,
        MixedBackend,
        SellBackend,
    )

    name = engine.backend
    if name == "custom":
        return CustomBackend(engine)
    if name == "mixed":
        return MixedBackend(engine)
    if name == "edges":
        return EdgesBackend(engine)
    if name == "ell":
        return EllBackend(engine)
    if name == "sell":
        return SellBackend(engine)
    if name == "dense":
        return DenseBackend(engine)
    if name == "blocked":
        return BlockedEllBackend(engine)
    if name == "mesh":
        raise NotImplementedError(
            "the mesh backend is not ported yet (ROADMAP queue 1 item 11)"
        )
    raise ValueError(f"unknown backend {name!r}")


@dataclass(frozen=True)
class StageTables:
    """Split tables for one DP stage, in the shapes the executors need.

    ``idx_a_host`` / ``idx_p_host`` are the plain ``(n_out, n_splits)`` rank
    tables (host numpy).  ``batches`` are the same entries re-bucketed by
    passive-column batch on the device
    (:func:`repro_torch.core.colorsets.bucketed_split_entries`) for the
    streamed executor.  De-duplicated across stages by ``(k, m, m_a)``.
    """

    k: int
    m: int
    m_a: int
    n_out: int
    idx_a_host: np.ndarray
    idx_p_host: np.ndarray
    batches: Tuple[
        Tuple[int, int, torch.Tensor, torch.Tensor, Optional[torch.Tensor]], ...
    ]


def build_stage_tables(
    plan, column_batch: int, device
) -> Dict[Tuple[int, int], StageTables]:
    """Bind a :class:`~repro_torch.plan.ir.TemplatePlan`'s split tables to
    ``device`` at one fused-slice width.

    Returns ``(plan_idx, sub_idx) -> StageTables`` for every non-leaf stage
    of every tree counting plan (duplicates alias one table).
    """
    cache: Dict[Tuple[int, int, int], StageTables] = {}
    out: Dict[Tuple[int, int], StageTables] = {}
    for p_idx, cplan in enumerate(plan.counting_plans):
        if cplan.partition is None:
            continue
        for i, table in enumerate(cplan.tables):
            if table is None:
                continue
            key = (table.k, table.m, table.m_a)
            if key not in cache:
                cache[key] = StageTables(
                    k=table.k,
                    m=table.m,
                    m_a=table.m_a,
                    n_out=table.n_out,
                    idx_a_host=table.idx_a,
                    idx_p_host=table.idx_p,
                    batches=tuple(
                        (
                            lo,
                            width,
                            torch.as_tensor(ia, dtype=torch.long, device=device),
                            torch.as_tensor(ip, dtype=torch.long, device=device),
                            None if va is None else torch.as_tensor(va, device=device),
                        )
                        for lo, width, ia, ip, va in bucketed_split_entries(
                            table, column_batch
                        )
                    ),
                )
            out[(p_idx, i)] = cache[key]
    return out


class EngineBackend:
    """One fused SpMM+eMA execution strategy behind ``CountingEngine``.

    Backends keep a reference to the engine façade, which exposes the bound
    plan (``engine.plan_ir``), the cost model (``engine.cost``), the dtype
    policy, the device and the observability counters.
    """

    name: str = "abstract"

    def __init__(self, engine):
        self.engine = engine

    # -- execution ----------------------------------------------------------

    def aggregate_ema(
        self, m_p: torch.Tensor, m_a: torch.Tensor, tables: StageTables
    ) -> torch.Tensor:
        """Fused per-stage step: ``(n, B, C_p), (n, B, C_a) -> (n, B, n_out)``
        in accum dtype, without materialising ``A_G @ M_p``."""
        raise NotImplementedError

    def aggregate_ema_grouped(
        self, m_p: torch.Tensor, stage_inputs: Sequence[Tuple[torch.Tensor, StageTables]]
    ) -> List[torch.Tensor]:
        """Run several stages that share the passive state ``m_p`` (default:
        the unshared per-stage loop)."""
        return [self.aggregate_ema(m_p, m_a, tables) for m_a, tables in stage_inputs]

    def counts_for_colors(self, colors: torch.Tensor) -> torch.Tensor:
        """``(B, n)`` colorings -> ``(B, T)`` un-normalised colorful totals."""
        raise NotImplementedError

    def make_chunk_fn(self) -> Callable[[torch.Tensor], torch.Tensor]:
        """The per-chunk function: ``(B, n)`` colorings -> ``(B, T)``
        normalised estimates (fp32, on the engine's device).  Building it
        bumps the engine's ``trace_count``, so a warm engine shows that it
        built nothing again."""
        engine = self.engine
        engine.trace_count += 1
        norm = engine._norm_factors

        def chunk_fn(colors: torch.Tensor) -> torch.Tensor:
            return self.counts_for_colors(colors) * norm[None, :]

        return chunk_fn

    # -- memory-model geometry ----------------------------------------------

    def transient_elements(self) -> int:
        """Widest per-stage scratch one coloring needs, in store-dtype
        elements."""
        eng = self.engine
        return eng.cost.transient_elements(self.name, eng.column_batch)

    def resident_elements(self) -> int:
        """Live M-matrix elements one coloring keeps resident."""
        return self.engine.cost.resident_elements()

    def bytes_per_coloring(self) -> int:
        """Live bytes one coloring contributes to a chunk."""
        return self.engine.cost.bytes_per_coloring(
            self.transient_elements(), self.resident_elements()
        )
