"""Single-device execution backends for the fused counting pipeline.

The port of ``repro.exec.local``.  Every local backend shares one DP
executor (:meth:`LocalBackend.counts_for_colors`) that walks the engine's
bound :class:`~repro_torch.plan.ir.TemplatePlan`; subclasses supply the
column-slice neighbor reduction :meth:`LocalBackend.spmm` or, for the CUDA
kernels, override :meth:`~repro_torch.exec.base.EngineBackend.aggregate_ema`.

Bag plans (non-tree templates) are not ported yet: building any local
backend for them raises ``NotImplementedError`` (ROADMAP queue 1 item 7).
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.colorsets import binom
from repro_torch.core.counting import fused_aggregate_ema_grouped
from repro_torch.core.graph import build_sell

from .base import EngineBackend, StageTables, build_stage_tables

__all__ = [
    "LocalBackend",
    "EdgesBackend",
    "EllBackend",
    "SellBackend",
    "DenseBackend",
    "BlockedEllBackend",
    "CustomBackend",
    "MixedBackend",
    "SELL_GROUP_SIZE",
]

#: Degree-sorted rows per SELL group (smaller = tighter padding).
SELL_GROUP_SIZE = 128


class LocalBackend(EngineBackend):
    """Shared single-device fused DP: subclasses only supply :meth:`spmm`.

    DP states are memoized by rooted canonical form in the fused
    ``(n, B, C)`` layout; each stage runs through the streamed
    :meth:`aggregate_ema` (passive column batches aggregated and consumed
    one at a time), and states are dropped at their liveness-scheduled last
    read — the aggregate product ``A_G @ M_p`` never exists.
    """

    def __init__(self, engine):
        super().__init__(engine)
        if engine.plan_ir.has_bag_stages:
            raise NotImplementedError(
                "bag-stage (non-tree) templates are not ported yet "
                "(ROADMAP queue 1 item 7)"
            )
        self.stage_tables: Dict = build_stage_tables(
            engine.plan_ir, engine.column_batch, engine.device
        )

    def spmm(self, m: torch.Tensor) -> torch.Tensor:
        """One neighbor reduction over a fused ``(n, B, c)`` column slice;
        returns accum dtype."""
        raise NotImplementedError

    def _spmm_counted(self, m: torch.Tensor) -> torch.Tensor:
        self.engine.counters["passive_aggregations"] += 1
        return self.spmm(m)

    def aggregate_ema(self, m_p, m_a, tables: StageTables):
        return LocalBackend.aggregate_ema_grouped(self, m_p, [(m_a, tables)])[0]

    def aggregate_ema_grouped(self, m_p, stage_inputs):
        return fused_aggregate_ema_grouped(
            m_p,
            [(m_a, tables.batches, tables.n_out) for m_a, tables in stage_inputs],
            self._spmm_counted,
            self.engine.policy.accum_dtype,
        )

    def counts_for_colors(self, colors: torch.Tensor) -> torch.Tensor:
        """(B, n) colorings -> (B, T) un-normalised colorful totals.

        The walk *is* the plan: sub-template states are memoized by
        canonical form, freed at the plan's liveness-scheduled last reads,
        and stages reading the same passive canonical form execute as one
        plan exec group over one column-batch sweep.
        """
        eng = self.engine
        ir = eng.plan_ir
        pol = eng.policy
        leaf = torch.nn.functional.one_hot(colors.t().long(), eng.k).to(pol.store_dtype)
        free_at = ir.free_at
        slots: Dict[str, torch.Tensor] = {}
        totals = []
        executed = set()
        pos = 0
        for p_idx, cplan in enumerate(ir.counting_plans):
            canons = ir.canons[p_idx]
            for i, sub in enumerate(cplan.partition.subs):
                key = canons[i]
                if key in executed:
                    continue
                executed.add(key)
                if sub.is_leaf:
                    slots[key] = leaf
                elif key not in slots:
                    # group leader: every stage sharing this passive canon
                    # runs over one column-batch sweep
                    members = ir.exec_groups[(p_idx, i)]
                    stage_inputs = []
                    for q, j in members:
                        sub_m = ir.counting_plans[q].partition.subs[j]
                        stage_inputs.append(
                            (slots[ir.canons[q][sub_m.active]], self.stage_tables[(q, j)])
                        )
                    outs = self.aggregate_ema_grouped(slots[canons[sub.passive]], stage_inputs)
                    for (q, j), m_s in zip(members, outs):
                        slots[ir.canons[q][j]] = m_s.to(pol.store_dtype)
                for dead in free_at.get(pos, ()):
                    slots.pop(dead, None)
                pos += 1
            root = slots[canons[cplan.partition.root_index]].to(pol.accum_dtype)
            # reduce color sets, then each coloring's vertices as one
            # contiguous row: the order does not depend on the chunk size
            totals.append(root.sum(dim=2).t().contiguous().sum(dim=1).to(torch.float32))
            for dead in free_at.get(pos, ()):
                slots.pop(dead, None)
            pos += 1
        return torch.stack(totals, dim=1)  # (B, T)


class EdgesBackend(LocalBackend):
    """Edge-list gather + ``index_add_`` (the skew-robust default)."""

    name = "edges"

    def __init__(self, engine):
        super().__init__(engine)
        g = engine.graph
        self._src = torch.as_tensor(g.src, dtype=torch.long, device=engine.device)
        self._dst = torch.as_tensor(g.dst, dtype=torch.long, device=engine.device)

    def spmm(self, m):
        accum = self.engine.policy.accum_dtype
        out = torch.zeros((self.engine.graph.n,) + tuple(m.shape[1:]), dtype=accum, device=m.device)
        return out.index_add_(0, self._dst, m[self._src].to(accum))


class EllBackend(LocalBackend):
    """Padded-row neighbor gather (flat degree distributions)."""

    name = "ell"

    def __init__(self, engine):
        super().__init__(engine)
        nbr, mask = engine.graph.ell()
        self._nbr = torch.as_tensor(nbr, dtype=torch.long, device=engine.device)
        self._ell_mask = torch.as_tensor(mask, device=engine.device)

    def spmm(self, m):
        accum = self.engine.policy.accum_dtype
        gathered = m[self._nbr].to(accum)  # (n, max_deg, B, c)
        return torch.einsum("ndbc,nd->nbc", gathered, self._ell_mask.to(accum))


class SellBackend(LocalBackend):
    """Degree-bucketed sliced-ELL gather: scatter-free, padding bounded on
    power-law degree distributions."""

    name = "sell"

    def __init__(self, engine, group_size: int = SELL_GROUP_SIZE):
        super().__init__(engine)
        dev = engine.device
        sell = build_sell(engine.graph, group_size=group_size)
        self._sell_padded_slots = sell.padded_slots
        self._groups = tuple(
            (
                torch.as_tensor(nbr, dtype=torch.long, device=dev),
                torch.as_tensor(mask, device=dev),
            )
            for nbr, mask in zip(sell.group_nbr, sell.group_mask)
        )
        self._inv_order = torch.as_tensor(sell.inv_order, dtype=torch.long, device=dev)

    def spmm(self, m):
        accum = self.engine.policy.accum_dtype
        parts = [
            torch.einsum("rdbc,rd->rbc", m[nbr].to(accum), mask.to(accum))
            for nbr, mask in self._groups
        ]
        return torch.cat(parts, dim=0)[self._inv_order]

    def transient_elements(self) -> int:
        eng = self.engine
        return eng.cost.transient_elements(
            self.name, eng.column_batch, sell_padded_slots=self._sell_padded_slots
        )


class DenseBackend(LocalBackend):
    """Dense-adjacency matmul (tiny graphs)."""

    name = "dense"

    def __init__(self, engine):
        super().__init__(engine)
        self._adj = torch.as_tensor(engine.graph.dense_adjacency(), device=engine.device)

    def spmm(self, m):
        accum = self.engine.policy.accum_dtype
        n, b, c = m.shape
        # 0/1 adjacency and store-dtype values are exact in the accum dtype
        out = torch.matmul(self._adj.to(accum), m.reshape(n, b * c).to(accum))
        return out.reshape(n, b, c)


class BlockedEllBackend(LocalBackend):
    """The CUDA kernels over the compact edge operand (large graphs on a card).

    Each stage is ONE :func:`repro_torch.kernels.spmm_ema.ops.spmm_ema`
    call.  The operand carries an edge-balanced partition, built once here on
    the host (``self.operand.partition``): hub rows are cut into segments
    whose aggregate the whole grid computes first, and the other rows are
    packed into short ranges whose whole passive aggregate lives only in one
    CTA's shared memory and is consumed there by the eMA, so the aggregate
    product of a light row never reaches device memory.  Every tree stage
    takes this path, the one-hot leaf's narrow passive included (a warp then
    loads several edges per instruction).  :meth:`spmm` is the blocked SpMM
    kernel (:func:`repro_torch.kernels.spmm_blocked.ops.spmm_blocked`) over
    the same partition; tree stages never call it.

    Both kernels take fp32; under the bf16 policy the states are cast to
    fp32 before each launch, as the reference's blocked path does.  On CPU
    tensors both wrappers run their plain PyTorch versions.
    """

    name = "blocked"

    def __init__(self, engine):
        super().__init__(engine)
        from repro_torch.kernels.spmm_blocked.ops import prepare_operand
        from repro_torch.kernels.spmm_ema.ops import prepare_stage_tables

        self.operand = prepare_operand(engine.graph, engine.device)
        self._fused_tables = {}
        for tables in self.stage_tables.values():
            key = (tables.k, tables.m, tables.m_a)
            if key not in self._fused_tables:
                self._fused_tables[key] = prepare_stage_tables(
                    tables.idx_a_host,
                    tables.idx_p_host,
                    binom(tables.k, tables.m - tables.m_a),
                    binom(tables.k, tables.m_a),
                    engine.device,
                )

    def spmm(self, m):
        from repro_torch.kernels.spmm_blocked.ops import spmm_blocked

        n, b, c = m.shape
        out = spmm_blocked(
            self.operand, m.reshape(n, b * c).to(torch.float32).contiguous()
        )
        return out.reshape(n, b, c).to(self.engine.policy.accum_dtype)

    def aggregate_ema(self, m_p, m_a, tables: StageTables):
        from repro_torch.kernels.spmm_ema.ops import spmm_ema

        self.engine.counters["passive_aggregations"] += 1
        out = spmm_ema(
            self.operand,
            m_p.to(torch.float32).contiguous(),
            m_a.to(torch.float32).contiguous(),
            self._fused_tables[(tables.k, tables.m, tables.m_a)],
        )
        return out.to(self.engine.policy.accum_dtype)

    def aggregate_ema_grouped(self, m_p, stage_inputs):
        # the fused kernel keeps each stage's aggregate in its own launch's
        # shared memory, so a group runs as the per-stage loop
        return [self.aggregate_ema(m_p, m_a, tables) for m_a, tables in stage_inputs]


class CustomBackend(LocalBackend):
    """Caller-supplied neighbor-sum kernel: not ported yet."""

    name = "custom"

    def __init__(self, engine):
        raise NotImplementedError(
            "the custom spmm_fn backend is not ported yet (ROADMAP queue 1 item 5)"
        )


class MixedBackend(LocalBackend):
    """Per-exec-group backends from a tuned configuration: not ported yet."""

    name = "mixed"

    def __init__(self, engine):
        raise NotImplementedError(
            "the mixed backend needs the tuning layer, not ported yet "
            "(ROADMAP queue 1 item 9)"
        )
