"""Single-device execution backends for the fused counting pipeline.

The port of ``repro.exec.local``.  Every local backend shares one DP
executor (:meth:`LocalBackend.counts_for_colors`) that walks the engine's
bound :class:`~repro_torch.plan.ir.TemplatePlan`; subclasses supply the
column-slice neighbor reduction :meth:`LocalBackend.spmm` or, for the CUDA
kernels, override :meth:`~repro_torch.exec.base.EngineBackend.aggregate_ema`.

Non-tree templates walk their bag programs (tree-decomposition lowering,
``repro_torch.core.templates.build_bag_program``) through the same slots
and liveness schedule.  A bag state over ``r`` template vertices is an
``(n,)*r + (B, C)`` tensor; an extend contracts one vertex axis through the
backend's :meth:`~LocalBackend.spmm` on the state flattened to ``(n,
n**(r-1) * B, C)``, so under ``blocked`` every bag extend with an
eliminated neighbor is one launch of the blocked SpMM kernel.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.core.colorsets import binom
from repro_torch.core.counting import fused_aggregate_ema_grouped
from repro_torch.core.graph import build_sell

from .base import (
    BagStageTables,
    EngineBackend,
    StageTables,
    build_bag_tables,
    build_stage_tables,
)

__all__ = [
    "LocalBackend",
    "EdgesBackend",
    "EllBackend",
    "SellBackend",
    "DenseBackend",
    "BlockedEllBackend",
    "CustomBackend",
    "MixedBackend",
    "LOCAL_BACKEND_CLASSES",
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

    def __init__(self, engine, shared: "LocalBackend" = None):
        super().__init__(engine)
        # A MixedBackend's sub-implementations pass ``shared=`` to alias the
        # owner's stage tables, bag tables and dense adjacency instead of
        # shipping a second copy of each to the device.
        if shared is not None:
            self.stage_tables: Dict = shared.stage_tables
            self.bag_tables: Dict = shared.bag_tables
            self._bag_adj = shared._bag_adj
            return
        self.stage_tables: Dict = build_stage_tables(
            engine.plan_ir, engine.column_batch, engine.device
        )
        self.bag_tables: Dict = build_bag_tables(engine.plan_ir, engine.device)
        self._bag_adj = None
        if engine.plan_ir.has_bag_stages:
            # bag-extend edge masks multiply by A[u_w, u_x]; the dense
            # adjacency broadcasts against a state of any rank
            self._bag_adj = torch.as_tensor(
                engine.graph.dense_adjacency(), dtype=engine.policy.store_dtype,
                device=engine.device,
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

    def _group_aggregate(self, leader, m_p, stage_inputs):
        """Per-exec-group dispatch seam: ``leader`` is the group's
        ``(plan_idx, sub_idx)`` address.  Uniform backends ignore it;
        :class:`MixedBackend` routes each group to its bound sub-impl."""
        return self.aggregate_ema_grouped(m_p, stage_inputs)

    def counts_for_colors(self, colors: torch.Tensor) -> torch.Tensor:
        """(B, n) colorings -> (B, T) un-normalised colorful totals.

        The walk *is* the plan: sub-template states are memoized by
        canonical form, freed at the plan's liveness-scheduled last reads,
        and stages reading the same passive canonical form execute as one
        plan exec group over one column-batch sweep.  Bag plans walk their
        bag programs through the same slots and liveness schedule.
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
            if cplan.partition is None:
                ops = cplan.bag_program.ops
                for i, op in enumerate(ops):
                    key = canons[i]
                    if key in executed:
                        continue
                    executed.add(key)
                    if op.kind == "leaf":
                        slots[key] = leaf
                    elif key not in slots:
                        slots[key] = self._run_bag_op(cplan, canons, p_idx, i, op, leaf, slots).to(
                            pol.store_dtype
                        )
                    for dead in free_at.get(pos, ()):
                        slots.pop(dead, None)
                    pos += 1
                # the last op has no vertex axes: its (B, 1) state holds the
                # single C(k, k) colorset column, the colorful total
                root = slots[canons[len(ops) - 1]].to(pol.accum_dtype)
                totals.append(root.sum(dim=-1).to(torch.float32))
                for dead in free_at.get(pos, ()):
                    slots.pop(dead, None)
                pos += 1
                continue
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
                    outs = self._group_aggregate(
                        (p_idx, i), slots[canons[sub.passive]], stage_inputs
                    )
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

    # -- bag-program execution ------------------------------------------------

    def _run_bag_op(self, cplan, canons, p_idx, i, op, leaf, slots) -> torch.Tensor:
        """One extend / forget / join bag op on ``(n,)*r + (B, C)`` states,
        vertex axes sorted by template vertex id."""
        if op.kind == "extend":
            return self._bag_extend(cplan, canons, p_idx, i, op, leaf, slots)
        if op.kind == "forget":
            in_op = cplan.bag_program.ops[op.inputs[0]]
            state = slots[canons[op.inputs[0]]]
            return self._bag_forget(state, list(in_op.axes), op.forget_vertices)[0]
        if op.kind == "join":
            return self._bag_join(op, self.bag_tables[(p_idx, i)], slots, canons)
        raise ValueError(f"unknown bag op kind {op.kind!r}")

    @staticmethod
    def _bag_forget(state, axes_now, forget_vertices):
        for x in forget_vertices:
            ax = axes_now.index(x)
            state = state.sum(dim=ax)
            axes_now.pop(ax)
        return state, axes_now

    def _bag_extend(self, cplan, canons, p_idx, i, op, leaf, slots) -> torch.Tensor:
        eng = self.engine
        accum = eng.policy.accum_dtype
        n = eng.graph.n
        tables: BagStageTables = self.bag_tables[(p_idx, i)]
        in_op = cplan.bag_program.ops[op.inputs[0]]
        state = slots[canons[op.inputs[0]]]
        axes_now = list(in_op.axes)
        if op.spmm_vertex is not None:
            # contract the eliminated axis through the adjacency (edge
            # (spmm_vertex, vertex)) with the backend's neighbor sum on the
            # (n, B', C) layout; moving the axis to the front copies the
            # state unless it is there already
            ax = axes_now.index(op.spmm_vertex)
            state = state.movedim(ax, 0)
            rest = state.shape[1:]
            flat = state.reshape(n, -1, state.shape[-1])
            state = self._spmm_counted(flat).reshape((n,) + rest)
            # a neighbor sum that handed back its input must not be masked
            # in place: the input may be a view of a live slot
            owned = state.untyped_storage().data_ptr() != flat.untyped_storage().data_ptr()
            axes_now.pop(ax)
        else:
            # broadcast introduction: the new vertex's edges arrive as masks
            state = state.unsqueeze(0).expand((n,) + tuple(state.shape))
            owned = False
        axes_now = [op.vertex] + axes_now
        for x in op.mask_vertices:
            ax = axes_now.index(x)
            mask = self._bag_adj.reshape((n,) + (1,) * (ax - 1) + (n,) + (1,) * (state.dim() - 1 - ax))
            # the first mask of a broadcast state materialises it; later
            # masks, and masks of an SpMM output, multiply in place
            state = state.mul_(mask) if owned else state * mask.to(state.dtype)
            owned = True
        # colorset update against the new vertex's one-hot leaf: the tree
        # eMA with a width-1 active, one gather-multiply-add per term
        r = state.dim()
        out = torch.zeros(tuple(state.shape[:-1]) + (tables.n_out,), dtype=accum, device=state.device)
        for t in range(tables.n_terms):
            la = leaf.index_select(2, tables.idx_a[t]).to(accum)  # (n, B, n_out)
            la = la.reshape((n,) + (1,) * (r - 3) + tuple(la.shape[1:]))
            out.addcmul_(la, state.index_select(r - 1, tables.idx_p[t]).to(accum))
        out, axes_now = self._bag_forget(out, axes_now, op.forget_vertices)
        # restore the sorted axis order (the new vertex's axis is in front)
        order = sorted(range(len(axes_now)), key=lambda idx: axes_now[idx])
        if order != list(range(len(axes_now))):
            out = out.permute(order + list(range(len(axes_now), out.dim())))
        return out

    def _bag_join(self, op, tables: BagStageTables, slots, canons) -> torch.Tensor:
        accum = self.engine.policy.accum_dtype
        s1 = slots[canons[op.inputs[0]]]
        s2 = slots[canons[op.inputs[1]]]
        last = s1.dim() - 1
        out = torch.zeros(tuple(s1.shape[:-1]) + (tables.n_out,), dtype=accum, device=s1.device)
        for t in range(tables.n_terms):
            out.addcmul_(
                s1.index_select(last, tables.idx_a[t]).to(accum),
                s2.index_select(last, tables.idx_p[t]).to(accum),
            )
        return out


class EdgesBackend(LocalBackend):
    """Edge-list gather + ``index_add_`` (the skew-robust default)."""

    name = "edges"

    def __init__(self, engine, shared=None):
        super().__init__(engine, shared=shared)
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

    def __init__(self, engine, shared=None):
        super().__init__(engine, shared=shared)
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

    def __init__(self, engine, group_size: int = SELL_GROUP_SIZE, shared=None):
        super().__init__(engine, shared=shared)
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

    def __init__(self, engine, shared=None):
        super().__init__(engine, shared=shared)
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

    def __init__(self, engine, shared=None):
        super().__init__(engine, shared=shared)
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
    """Caller-supplied ``(n, C) -> (n, C)`` neighbor-sum function."""

    name = "custom"

    def __init__(self, engine, spmm_fn: Callable[[torch.Tensor], torch.Tensor]):
        super().__init__(engine)
        if spmm_fn is None:
            raise ValueError("the custom backend needs an spmm_fn")
        self._spmm_fn = spmm_fn

    def spmm(self, m):
        n, b, c = m.shape
        out = self._spmm_fn(m.reshape(n, b * c))
        return out.reshape(n, b, c).to(self.engine.policy.accum_dtype)


#: name -> class for the uniform single-device strategies (what a
#: TuningConfig's per-group bindings may name).
LOCAL_BACKEND_CLASSES = {
    "edges": EdgesBackend,
    "ell": EllBackend,
    "sell": SellBackend,
    "dense": DenseBackend,
    "blocked": BlockedEllBackend,
}


class MixedBackend(LocalBackend):
    """Per-exec-group backend dispatch from a tuned configuration (the
    port of the reference's ``MixedBackend``).

    One sub-implementation per distinct backend the
    :class:`~repro_torch.tune.config.TuningConfig` names, all sharing this
    owner's stage tables, bag tables and dense adjacency (``shared=``); a
    ``blocked`` sub-impl still builds its own compact operand and fused
    tables once.  The DP walk stays the inherited one; only the
    :meth:`_group_aggregate` seam routes each shared-passive exec group to
    its bound sub-impl.  Bag ops and ungrouped :meth:`spmm` calls run on
    the config's ``default_backend``.
    """

    name = "mixed"

    def __init__(self, engine, tuning):
        super().__init__(engine)
        if tuning is None:
            raise ValueError("MixedBackend needs a TuningConfig (tuning=...)")
        self._tuning = tuning
        self._bindings = tuning.bindings()
        names = {tuning.default_backend, *self._bindings.values()}
        unknown = names - set(LOCAL_BACKEND_CLASSES)
        if unknown:
            raise ValueError(f"mixed backend binds unknown local backends {sorted(unknown)}")
        self._impls = {
            name: LOCAL_BACKEND_CLASSES[name](engine, shared=self) for name in sorted(names)
        }
        self._default = self._impls[tuning.default_backend]

    def spmm(self, m):
        return self._default.spmm(m)

    def _group_aggregate(self, leader, m_p, stage_inputs):
        name = self._bindings.get(leader, self._tuning.default_backend)
        return self._impls[name].aggregate_ema_grouped(m_p, stage_inputs)

    def transient_elements(self) -> int:
        # one chunk's scratch peaks at the widest sub-impl's slice
        return max(impl.transient_elements() for impl in self._impls.values())
