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
from repro_torch.core.prng import randint

__all__ = [
    "StageTables",
    "BagStageTables",
    "EngineBackend",
    "build_stage_tables",
    "build_bag_tables",
    "make_backend",
]


def make_backend(
    engine, spmm_fn: Optional[Callable] = None, tuning=None
) -> "EngineBackend":
    """Bind ``engine``'s resolved backend name to an implementation
    (``spmm_fn``: the ``custom`` backend's neighbor sum; ``tuning``: the
    ``mixed`` backend's :class:`~repro_torch.tune.config.TuningConfig`)."""
    from .local import LOCAL_BACKEND_CLASSES, CustomBackend, MixedBackend

    name = engine.backend
    if name == "custom":
        return CustomBackend(engine, spmm_fn)
    if name == "mixed":
        return MixedBackend(engine, tuning)
    if name in LOCAL_BACKEND_CLASSES:
        return LOCAL_BACKEND_CLASSES[name](engine)
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


@dataclass(frozen=True)
class BagStageTables:
    """Color tables of one bag op, on the device.

    ``extend`` ops carry a :class:`~repro_torch.core.colorsets.SplitTable`
    with ``m_a = 1`` (the new vertex's one-hot color against the input's
    colorsets); ``join`` ops a
    :class:`~repro_torch.core.colorsets.UnionSplitTable`.  Both reduce to
    one gather-multiply-add per term, so the executor needs only the rank
    tables, stored term-major: ``idx_a[t]`` / ``idx_p[t]`` are the
    ``(n_out,)`` ranks of term ``t`` (the reference's ``(n_out, n_terms)``
    tables, transposed).
    """

    kind: str  # "extend" | "join"
    n_out: int
    n_terms: int
    idx_a: torch.Tensor  # (n_terms, n_out) int64
    idx_p: torch.Tensor  # (n_terms, n_out) int64


def build_bag_tables(plan, device) -> Dict[Tuple[int, int], BagStageTables]:
    """Bind every bag plan's extend/join tables to ``device``.

    Returns ``(plan_idx, op_idx) -> BagStageTables`` for every extend and
    join op of every bag counting plan, de-duplicated by table identity.
    """
    cache: Dict[Tuple, BagStageTables] = {}
    out: Dict[Tuple[int, int], BagStageTables] = {}
    for p_idx, cplan in enumerate(plan.counting_plans):
        if cplan.partition is not None:
            continue
        for i, op in enumerate(cplan.bag_program.ops):
            table = cplan.tables[i]
            if table is None:
                continue
            if op.kind == "extend":
                key = ("extend", table.k, table.m, table.m_a)
                n_terms = table.n_splits
            else:
                key = ("join", table.k, table.m1, table.m2, table.overlap)
                n_terms = table.n_pairs
            if key not in cache:

                def term_major(idx):
                    return torch.as_tensor(
                        np.ascontiguousarray(np.asarray(idx).T), dtype=torch.long, device=device
                    )

                cache[key] = BagStageTables(
                    kind=op.kind,
                    n_out=table.n_out,
                    n_terms=n_terms,
                    idx_a=term_major(table.idx_a),
                    idx_p=term_major(table.idx_p),
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

    def counts_for_keys_chunk(self, keys: torch.Tensor) -> torch.Tensor:
        """``(B, 2)`` PRNG keys -> ``(B, T)`` normalised estimates through the
        engine's chunk function.

        The coloring draw is the same on every backend: one ``randint`` per
        key over the original vertex ids, bit-equal to the reference's
        ``jax.random.randint(key, (n,), 0, k)``, on the engine's device.  So
        the same keys give the same colorings, and fp-tolerance-comparable
        estimates, on every backend and in the reference.
        """
        eng = self.engine
        colors = randint(keys.to(eng.device), (eng.graph.n,), 0, eng.k)
        return eng._get_chunk_fn()(colors)

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
