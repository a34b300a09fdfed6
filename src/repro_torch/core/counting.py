"""Color-coding DP in PyTorch: SUBGRAPH2VEC vectorized, traversal, brute force.

The port of ``repro.core.counting``.  Three implementations with one
contract:

* :func:`count_colorful_vectorized` — the paper's Algorithm 5 (SpMM + eMA)
  on torch tensors.  Per DP stage, ONE neighbor reduction over all passive
  color columns (the SpMM) followed by a vertex-local fused multiply-add over
  the split tables (the eMA).  The SpMM implementation is pluggable.
* :func:`count_colorful_traversal` — Algorithm 2, the FASCIA traversal
  model, in NumPy: the correctness reference and the paper's baseline.
* :func:`brute_force_embeddings` / :func:`brute_force_colorful` — exact
  backtracking counts for tiny graphs; anchor the whole chain.

JAX's functional updates become in-place updates here where that saves a
copy of a DP state (``_fused_batch_apply`` accumulates into ``m_s``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .colorsets import (
    SplitTable,
    UnionSplitTable,
    binom,
    build_split_table,
    build_union_split_table,
    colorful_probability,
)
from .graph import Graph
from .templates import (
    BagProgram,
    Template,
    TemplatePartition,
    build_bag_program,
    graph_automorphisms,
    partition_template,
    tree_automorphisms,
)

__all__ = [
    "CountingPlan",
    "build_counting_plan",
    "spmm_edges",
    "spmm_ell",
    "fused_aggregate_ema",
    "fused_aggregate_ema_grouped",
    "schedule_liveness",
    "liveness_peak_columns",
    "liveness_peak_elements",
    "count_colorful_vectorized",
    "count_colorful_traversal",
    "brute_force_embeddings",
    "brute_force_colorful",
    "normalize_count",
]


@dataclass(frozen=True)
class CountingPlan:
    """Static DP schedule for one template: stages + split tables.

    Tree templates carry a ``partition`` (binary sub-template recursion,
    paper §II-C) with one optional :class:`SplitTable` per sub-template;
    non-tree templates carry a ``bag_program`` (tree-decomposition lowering)
    with one optional :class:`SplitTable` (extend) or
    :class:`UnionSplitTable` (join) per bag op.  Exactly one of
    ``partition`` / ``bag_program`` is set; executors branch on
    ``partition is not None`` and the tree path is untouched by the bag
    generalization.
    """

    template: Template
    partition: Optional[TemplatePartition]
    k: int
    tables: Tuple[object, ...]  # SplitTable | UnionSplitTable | None per stage
    automorphisms: int
    bag_program: Optional[BagProgram] = None

    @property
    def is_tree_plan(self) -> bool:
        return self.partition is not None

    @property
    def num_subs(self) -> int:
        if self.partition is not None:
            return len(self.partition.subs)
        return len(self.bag_program.ops)

    def stage_canons(self) -> Tuple[str, ...]:
        """Canonical form per stage (sub-template or bag op), in DP order."""
        if self.partition is not None:
            from .templates import sub_template_canonical

            return tuple(
                sub_template_canonical(self.template, sub.vertices, sub.root)
                for sub in self.partition.subs
            )
        return tuple(op.canon for op in self.bag_program.ops)

    def table_arrays(self) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
        return {
            i: (t.idx_a, t.idx_p)
            for i, t in enumerate(self.tables)
            if t is not None
        }

    def peak_columns(self) -> int:
        """Max total live M columns — the memory planner's key figure.

        For bag plans this counts colorset columns of live states (the
        per-state vertex-axis factor ``n^len(axes)`` is accounted for by
        :func:`liveness_peak_elements`, which the cost model uses instead).
        """
        if self.partition is not None:
            live: Dict[int, int] = {}
            peak = 0
            for i, sub in enumerate(self.partition.subs):
                live[i] = binom(self.k, sub.size)
                peak = max(peak, sum(live.values()))
                if not sub.is_leaf:
                    live.pop(sub.active, None)
                    live.pop(sub.passive, None)
            return peak
        ops = self.bag_program.ops
        last_read: Dict[int, int] = {}
        for i, op in enumerate(ops):
            for inp in op.inputs:
                last_read[inp] = i
        last_read[len(ops) - 1] = len(ops)
        live: Dict[int, int] = {}
        peak = 0
        for i, op in enumerate(ops):
            live[i] = binom(self.k, op.m)
            peak = max(peak, sum(live.values()))
            for j in list(live):
                if last_read.get(j, -1) <= i:
                    live.pop(j)
        return peak


def build_counting_plan(template: Template, root: Optional[int] = None) -> CountingPlan:
    k = template.k
    if template.is_tree:
        part = partition_template(template, root)
        tables: List[object] = []
        for sub in part.subs:
            if sub.is_leaf:
                tables.append(None)
            else:
                m = sub.size
                m_a = part.subs[sub.active].size
                tables.append(build_split_table(k, m, m_a))
        return CountingPlan(
            template=template,
            partition=part,
            k=k,
            tables=tuple(tables),
            automorphisms=tree_automorphisms(template),
        )
    prog = build_bag_program(template)
    tables = []
    for op in prog.ops:
        if op.kind == "extend":
            tables.append(build_split_table(k, op.m, 1))
        elif op.kind == "join":
            o1, o2 = (prog.ops[i] for i in op.inputs)
            overlap = len(set(o1.covered) & set(o2.covered))
            tables.append(build_union_split_table(k, o1.m, o2.m, overlap))
        else:  # leaf / forget
            tables.append(None)
    return CountingPlan(
        template=template,
        partition=None,
        k=k,
        tables=tuple(tables),
        automorphisms=graph_automorphisms(template),
        bag_program=prog,
    )


# ---------------------------------------------------------------------------
# SpMM implementations (plain torch; the CUDA kernels live in
# repro_torch.kernels).
# ---------------------------------------------------------------------------


def spmm_edges(src: torch.Tensor, dst: torch.Tensor, n: int, m: torch.Tensor) -> torch.Tensor:
    """``B[i] = sum_{j in N(i)} M[j]`` via edge-list gather + ``index_add_``.

    Edges are sorted by ``dst`` (Graph canonical form).  On CPU the sum runs
    in edge order; on CUDA ``index_add_`` sums with atomics, in no fixed
    order.
    """
    out = torch.zeros((n,) + tuple(m.shape[1:]), dtype=m.dtype, device=m.device)
    return out.index_add_(0, dst, m[src])


def spmm_ell(nbr: torch.Tensor, mask: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``B[i] = sum_d mask[i,d] * M[nbr[i,d]]`` — padded row-gather reduction."""
    gathered = m[nbr]  # (n, max_deg, C)
    return torch.einsum("ndc,nd->nc", gathered, mask.to(m.dtype))


def _ema_apply(
    m_a: torch.Tensor,
    b: torch.Tensor,
    idx_a: torch.Tensor,
    idx_p: torch.Tensor,
    init: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Vertex-local eMA: ``M_s[:, o] = sum_t M_a[:, idx_a[o,t]] * B[:, idx_p[o,t]]``.

    Loops over the (small) split axis; each step is a column gather + FMA with
    vector length |V| (the paper's column-major vectorization).
    """
    n = m_a.shape[0]
    n_out, n_splits = idx_a.shape
    acc = (
        torch.zeros((n, n_out), dtype=m_a.dtype, device=m_a.device)
        if init is None
        else init.clone()
    )
    for t in range(n_splits):
        acc += m_a.index_select(1, idx_a[:, t]) * b.index_select(1, idx_p[:, t])
    return acc


def _ema_apply_fused(
    m_a: torch.Tensor,
    b: torch.Tensor,
    idx_a: torch.Tensor,
    idx_p: torch.Tensor,
    init: torch.Tensor,
) -> torch.Tensor:
    """:func:`_ema_apply` on the engine's fused ``(n, B, C)`` layout.

    Column gathers run on axis 2; ``init`` fixes the accumulator shape and
    dtype.
    """
    accum = init.dtype
    acc = init.clone()
    for t in range(idx_a.shape[1]):
        ga = m_a.index_select(2, idx_a[:, t]).to(accum)
        gp = b.index_select(2, idx_p[:, t]).to(accum)
        acc += ga * gp
    return acc


def _fused_batch_apply(
    m_s: torch.Tensor,
    m_a: torch.Tensor,
    bcol: torch.Tensor,
    idx_a: torch.Tensor,
    idx_p: torch.Tensor,
    valid: Optional[torch.Tensor],
    accum_dtype: torch.dtype,
) -> torch.Tensor:
    """Fold one bucketed batch's eMA entries into the accumulator ``m_s``
    (in place; returns ``m_s``)."""
    for j in range(idx_a.shape[1]):
        ga = m_a.index_select(2, idx_a[:, j]).to(accum_dtype)
        gb = bcol.index_select(2, idx_p[:, j]).to(accum_dtype)
        prod = ga.mul_(gb)  # ga is a fresh gather: reuse it for the product
        if valid is not None:  # mask padded entry slots (ragged buckets)
            prod.mul_(valid[:, j].to(accum_dtype))
        m_s.add_(prod)
    return m_s


def fused_aggregate_ema(
    m_p: torch.Tensor,
    m_a: torch.Tensor,
    batches: Sequence[Tuple[int, int, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]],
    n_out: int,
    spmm_fn: Callable[[torch.Tensor], torch.Tensor],
    accum_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Fused SpMM+eMA over the engine's ``(n, B, C)`` fused state.

    The aggregate product ``A_G @ M_p`` is never materialized: per
    passive-column batch, only that batch's aggregate columns are computed
    (``spmm_fn`` on an ``(n, B, width)`` slice) and immediately consumed by
    the gather-FMA updates whose split's passive column falls in the batch
    (:func:`repro_torch.core.colorsets.bucketed_split_entries`).

    Returns ``(n, B, n_out)`` in ``accum_dtype``.  Batch order and per-batch
    entry order are static, so results are independent of the chunk size.
    """
    return fused_aggregate_ema_grouped(
        m_p, [(m_a, batches, n_out)], spmm_fn, accum_dtype
    )[0]


def fused_aggregate_ema_grouped(
    m_p: torch.Tensor,
    stages: Sequence[Tuple[torch.Tensor, Sequence[Tuple], int]],
    spmm_fn: Callable[[torch.Tensor], torch.Tensor],
    accum_dtype: torch.dtype = torch.float32,
) -> List[torch.Tensor]:
    """Shared-passive fusion: several stages consume one column-batch sweep.

    All ``stages`` read the same passive state ``m_p``, so each batch's
    aggregate ``spmm_fn(slice)`` is computed ONCE and consumed by every
    stage's eMA entries for that batch.  Per stage, batch order and entry
    order are identical to the ungrouped execution, so results are
    bit-exact with it.  Returns one ``(n, B, n_out)`` tensor per stage.
    """
    n, bsz = m_p.shape[0], m_p.shape[1]
    outs = [
        torch.zeros((n, bsz, n_out), dtype=accum_dtype, device=m_p.device)
        for _, _, n_out in stages
    ]
    # Union of the stages' bucketed batches, keyed by batch start column.
    # Stages share C_p and the bucketing width, so equal `lo` => equal slice.
    sweep: Dict[int, Tuple[int, List[Tuple[int, Tuple]]]] = {}
    for s_idx, (_, batches, _) in enumerate(stages):
        for lo, width, idx_a, idx_p, valid in batches:
            prev = sweep.get(lo)
            if prev is not None and prev[0] != width:
                raise ValueError(
                    f"grouped stages disagree on batch width at column {lo}: "
                    f"{prev[0]} vs {width} (passive states not identical?)"
                )
            users = prev[1] if prev is not None else []
            users.append((s_idx, (idx_a, idx_p, valid)))
            sweep[lo] = (width, users)
    for lo in sorted(sweep):
        width, users = sweep[lo]
        bcol = spmm_fn(m_p[:, :, lo : lo + width])  # the only aggregate transient
        for s_idx, (idx_a, idx_p, valid) in users:
            _fused_batch_apply(
                outs[s_idx], stages[s_idx][0], bcol, idx_a, idx_p, valid, accum_dtype
            )
        del bcol
    return outs


def schedule_liveness(plans, canons, track_products: bool = False):
    """Last-read position for every shared DP state (and SpMM product).

    The multi-template schedule executes each canonical sub-template once
    (first occurrence across plans) and reads each plan's root at the end of
    that plan.  Returns ``free_at``: position -> list of keys (canonical
    strings, or ``("prod", canon)`` for memoized aggregate products when
    ``track_products``) that are dead after that position, so executors can
    drop them and peak memory matches Algorithm 5's in-place storage instead
    of growing with the number of stages.
    """
    executed = set()
    last_read = {}
    pos = 0
    for p_idx, plan in enumerate(plans):
        pc = canons[p_idx]
        if plan.partition is not None:
            for i, sub in enumerate(plan.partition.subs):
                if pc[i] in executed:
                    continue
                executed.add(pc[i])
                if not sub.is_leaf:
                    last_read[pc[sub.active]] = pos
                    last_read[pc[sub.passive]] = pos
                    if track_products:
                        last_read[("prod", pc[sub.passive])] = pos
                pos += 1
            last_read[pc[plan.partition.root_index]] = pos
            pos += 1
        else:
            # Bag plans: same first-occurrence / position discipline; bag ops
            # have no memoized aggregate products (extend SpMMs consume their
            # input directly), so track_products adds nothing here.
            for i, op in enumerate(plan.bag_program.ops):
                if pc[i] in executed:
                    continue
                executed.add(pc[i])
                for inp in op.inputs:
                    last_read[pc[inp]] = pos
                pos += 1
            last_read[pc[len(plan.bag_program.ops) - 1]] = pos
            pos += 1
    free_at = {}
    for key, p in last_read.items():
        free_at.setdefault(p, []).append(key)
    return free_at


def liveness_peak_columns(
    plans,
    canons,
    pad_unit: int = 1,
    track_products: bool = False,
) -> int:
    """Peak live M columns per coloring under the liveness-aware schedule.

    Simulates the multi-template DP with eager freeing: per executed stage
    the live set holds every not-yet-dead canonical state (columns padded up
    to ``pad_unit``), plus — when ``track_products`` — the memoized
    aggregate product of the stage's passive state.  ``track_products=False``
    models the fused pipeline, where no aggregate product ever exists.
    """
    def pad_cols(c: int) -> int:
        return ((c + pad_unit - 1) // pad_unit) * pad_unit

    k = plans[0].k
    free_at = schedule_liveness(plans, canons, track_products=track_products)
    executed = set()
    live = {}
    peak = 0
    pos = 0
    for p_idx, plan in enumerate(plans):
        pc = canons[p_idx]
        if plan.partition is not None:
            stage_widths = [binom(k, sub.size) for sub in plan.partition.subs]
            stage_prod = [
                (pc[sub.passive], binom(k, plan.partition.subs[sub.passive].size))
                if (not sub.is_leaf and track_products)
                else None
                for sub in plan.partition.subs
            ]
        else:
            stage_widths = [binom(k, op.m) for op in plan.bag_program.ops]
            stage_prod = [None] * len(stage_widths)
        for i, width in enumerate(stage_widths):
            if pc[i] in executed:
                continue
            executed.add(pc[i])
            live[pc[i]] = pad_cols(width)
            if stage_prod[i] is not None:
                prod_canon, prod_width = stage_prod[i]
                live.setdefault(("prod", prod_canon), pad_cols(prod_width))
            peak = max(peak, sum(live.values()))
            for key in free_at.get(pos, ()):
                live.pop(key, None)
            pos += 1
        peak = max(peak, sum(live.values()))
        for key in free_at.get(pos, ()):
            live.pop(key, None)
        pos += 1
    return peak


def liveness_peak_elements(plans, canons, n: int) -> int:
    """Peak live DP-state *elements* per coloring (vertex axes included).

    Generalizes :func:`liveness_peak_columns` to bag plans, where a state
    with ``r`` vertex axes holds ``n**r * C(k, m)`` elements per coloring.
    Tree states are the ``r = 1`` case, so for pure-tree plan lists this is
    exactly ``n * liveness_peak_columns(plans, canons)``.
    """
    k = plans[0].k
    free_at = schedule_liveness(plans, canons)
    executed = set()
    live = {}
    peak = 0
    pos = 0
    for p_idx, plan in enumerate(plans):
        pc = canons[p_idx]
        if plan.partition is not None:
            stage_elems = [n * binom(k, sub.size) for sub in plan.partition.subs]
        else:
            stage_elems = [
                (n ** len(op.axes)) * binom(k, op.m) for op in plan.bag_program.ops
            ]
        for i, elems in enumerate(stage_elems):
            if pc[i] in executed:
                continue
            executed.add(pc[i])
            live[pc[i]] = elems
            peak = max(peak, sum(live.values()))
            for key in free_at.get(pos, ()):
                live.pop(key, None)
            pos += 1
        peak = max(peak, sum(live.values()))
        for key in free_at.get(pos, ()):
            live.pop(key, None)
        pos += 1
    return peak


def count_colorful_vectorized(
    plan: CountingPlan,
    colors: torch.Tensor,
    spmm_fn: Callable[[torch.Tensor], torch.Tensor],
    ema_fn: Optional[Callable[..., torch.Tensor]] = None,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Algorithm 5: one coloring's colorful-embedding rooted-count total.

    Args:
      plan: static DP schedule.
      colors: ``(n,)`` int tensor of vertex colors in ``[0, k)``.
      spmm_fn: ``M -> A_G @ M`` — the pluggable neighbor-sum kernel.
      ema_fn: optional override of the eMA (defaults to the column-gather
        FMA :func:`_ema_apply`).

    Returns the scalar ``sum_i M_0(i, I_full)`` (un-normalized; see
    :func:`normalize_count`).
    """
    ema = ema_fn or _ema_apply
    if plan.partition is None:
        raise ValueError(
            f"count_colorful_vectorized is tree-only; template "
            f"{plan.template.name} has a bag program — use a CountingEngine"
        )
    colors = torch.as_tensor(colors)
    k = plan.k
    leaf = torch.nn.functional.one_hot(colors.long(), k).to(dtype)  # rank({c}) == c

    slots: Dict[int, torch.Tensor] = {}
    for i, sub in enumerate(plan.partition.subs):
        if sub.is_leaf:
            slots[i] = leaf
            continue
        table = plan.tables[i]
        m_a = slots[sub.active]
        m_p = slots[sub.passive]
        b = spmm_fn(m_p)  # SpMM over ALL passive columns at once
        idx_a = torch.as_tensor(table.idx_a, dtype=torch.long, device=leaf.device)
        idx_p = torch.as_tensor(table.idx_p, dtype=torch.long, device=leaf.device)
        slots[i] = ema(m_a, b, idx_a, idx_p)
        # Free children eagerly (Algorithm 5's in-place storage).
        del slots[sub.active], slots[sub.passive]

    root = plan.partition.root_index
    return slots[root].sum()


def count_colorful_traversal(plan: CountingPlan, graph: Graph, colors: np.ndarray) -> float:
    """Algorithm 2 (FASCIA traversal model), NumPy reference.

    The neighbor reduction ``sum_{j in N(i)} M_p(j, I_p)`` is recomputed for
    every (output color set, split) pair — the redundancy Figure 3 points at.
    """
    if plan.partition is None:
        raise ValueError(
            f"count_colorful_traversal is tree-only; template "
            f"{plan.template.name} has a bag program — use a CountingEngine"
        )
    n, k = graph.n, plan.k
    src, dst = graph.src, graph.dst
    leaf = np.zeros((n, k), dtype=np.float64)
    leaf[np.arange(n), colors] = 1.0

    slots: Dict[int, np.ndarray] = {}
    for i, sub in enumerate(plan.partition.subs):
        if sub.is_leaf:
            slots[i] = leaf
            continue
        table = plan.tables[i]
        m_a, m_p = slots[sub.active], slots[sub.passive]
        m_s = np.zeros((n, table.n_out), dtype=np.float64)
        for out in range(table.n_out):
            for t in range(table.n_splits):
                ia = int(table.idx_a[out, t])
                ip = int(table.idx_p[out, t])
                # The redundant per-split neighbor traversal:
                b_col = np.zeros(n, dtype=np.float64)
                np.add.at(b_col, dst, m_p[src, ip])
                m_s[:, out] += m_a[:, ia] * b_col
        slots[i] = m_s
        del slots[sub.active], slots[sub.passive]
    return float(slots[plan.partition.root_index].sum())


# ---------------------------------------------------------------------------
# Exact brute-force oracles (tiny graphs only).
# ---------------------------------------------------------------------------


def _injective_hom_count(
    graph: Graph,
    template: Template,
    accept: Callable[[np.ndarray], bool],
) -> int:
    """Count injective homomorphisms T -> G whose image satisfies ``accept``."""
    adj_g: List[np.ndarray] = []
    row_ptr, col_idx = graph.csr()
    for i in range(graph.n):
        adj_g.append(col_idx[row_ptr[i] : row_ptr[i + 1]])
    adj_t = template.adjacency()
    k = template.k
    # BFS order from vertex 0; each vertex after the first has a mapped parent.
    order = [0]
    parent = {0: -1}
    seen = {0}
    qi = 0
    while qi < len(order):
        u = order[qi]
        qi += 1
        for v in adj_t[u]:
            if v not in seen:
                seen.add(v)
                parent[v] = u
                order.append(v)
    pos = {v: i for i, v in enumerate(order)}

    count = 0
    mapping = np.full(k, -1, dtype=np.int64)
    used = np.zeros(graph.n, dtype=bool)

    def rec(depth: int) -> None:
        nonlocal count
        if depth == k:
            img = mapping[np.array(order)]
            if accept(img):
                count += 1
            return
        tv = order[depth]
        # Candidates: neighbors of the mapped parent's image.
        if depth == 0:
            candidates = range(graph.n)
        else:
            candidates = adj_g[mapping[parent[tv]]]
        # All already-mapped template-neighbors must be graph-neighbors.
        mapped_nbrs = [mapping[u] for u in adj_t[tv] if pos[u] < depth]
        for gv in candidates:
            gv = int(gv)
            if used[gv]:
                continue
            ok = all(np.any(adj_g[gv] == mn) for mn in mapped_nbrs)
            if not ok:
                continue
            mapping[tv] = gv
            used[gv] = True
            rec(depth + 1)
            used[gv] = False
            mapping[tv] = -1

    rec(0)
    return count


def brute_force_embeddings(graph: Graph, template: Template) -> float:
    """Exact count of non-induced embeddings of T in G (any template)."""
    homs = _injective_hom_count(graph, template, lambda img: True)
    return homs / graph_automorphisms(template)


def brute_force_colorful(graph: Graph, template: Template, colors: np.ndarray) -> float:
    """Exact count of *colorful* embeddings under a fixed coloring."""
    colors = np.asarray(colors)
    k = template.k

    def accept(img: np.ndarray) -> bool:
        return len(set(colors[img].tolist())) == k

    homs = _injective_hom_count(graph, template, accept)
    return homs / graph_automorphisms(template)


def normalize_count(raw_total, plan: CountingPlan):
    """``emb_estimate = raw / (P * |Aut(T)|)`` (Algorithm 1, line 8)."""
    p = colorful_probability(plan.k)
    return raw_total / (p * plan.automorphisms)
