"""The TemplatePlan IR: one backend-agnostic compilation of a template set.

A :class:`TemplatePlan` is everything about a counting run that can be
decided *before* touching a graph or a device: the shared multi-template DP
schedule (stages de-duplicated by rooted canonical form), the
shared-passive execution groups, the liveness schedule that lets executors
free DP states at their last read, and per-stage column-width annotations.
It is built once per template set by the pure planner
:func:`build_template_plan` and consumed unchanged by every execution
backend (:mod:`repro_torch.exec`) and by the cost model
(:mod:`repro_torch.plan.cost`).  A copy of ``repro.plan.ir``: the plan is
pure Python, and equal to the reference's for every template set.

Two plans with equal :meth:`TemplatePlan.schedule_key` run the same DP
schedule (in the reference the key is the template half of the engine
cache key; the port's cache key comes with the serving slice).

Position numbering (shared with the liveness schedule): the schedule walks
each plan's sub-templates in topological order, skipping canonical forms
already executed by an earlier plan; every *first occurrence* takes one
position, and each plan's root read takes one more.  ``free_at[pos]`` lists
the canonical states that are dead after position ``pos``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

from repro_torch.core.colorsets import binom
from repro_torch.core.counting import (
    CountingPlan,
    build_counting_plan,
    liveness_peak_columns,
    liveness_peak_elements,
    schedule_liveness,
)
from repro_torch.core.templates import (
    Template,
    build_bag_program,
    partition_template,
    sub_template_canonical,
)

__all__ = [
    "PlanStage",
    "TemplatePlan",
    "build_template_plan",
    "template_canon_sequence",
    "template_set_canons",
]


def template_canon_sequence(template: Template) -> Tuple[str, ...]:
    """Canonical form per DP stage of one template's default compilation.

    Trees: the rooted AHU canon of every partition sub-template.  Non-trees:
    the bag-state canon of every bag-program op.  Matches the per-stage
    canons :func:`build_template_plan` derives for default plans.
    """
    if template.is_tree:
        return tuple(
            sub_template_canonical(template, sub.vertices, sub.root)
            for sub in partition_template(template).subs
        )
    return tuple(op.canon for op in build_bag_program(template).ops)


def template_set_canons(
    templates: Sequence[Template],
) -> Tuple[Tuple[str, ...], ...]:
    """Per-template tuple of canonical forms of the DP stages.

    This is the template half of the engine cache key: two template sets
    with equal canon tuples produce identical DP schedules (same stages,
    same split tables, same sharing), so a compiled engine built for one
    serves the other.  Computable without building plans or split tables.
    Covers both families — tree canons are AHU strings, bag canons carry a
    ``"bag:"`` prefix, so the two can never alias.
    """
    return tuple(template_canon_sequence(t) for t in templates)


@dataclass(frozen=True)
class PlanStage:
    """One first-occurrence DP stage in the shared schedule.

    ``(plan_idx, sub_idx)`` addresses the stage in the per-template
    :class:`~repro_torch.core.counting.CountingPlan`; ``position`` is its slot in
    the shared schedule (the key into :attr:`TemplatePlan.free_at`).  Width
    annotations are in M-matrix *columns* (``binom(k, size)``); leaves have
    no children, no table, and width ``k``.
    """

    plan_idx: int
    sub_idx: int
    position: int
    canon: str
    is_leaf: bool
    size: int
    columns: int
    active_canon: Optional[str] = None
    passive_canon: Optional[str] = None
    active_columns: int = 0
    passive_columns: int = 0
    table_key: Optional[Tuple[int, int, int]] = None  # (k, m, m_a)
    # Bag-stage annotations (tree stages leave these at their defaults, so
    # tree-only plans are byte-identical to the pre-bag IR):
    bag_kind: Optional[str] = None  # "leaf" | "extend" | "forget" | "join"
    bag_axes: Tuple[int, ...] = ()
    input_canons: Tuple[str, ...] = ()
    join_table_key: Optional[Tuple[int, int, int, int]] = None  # (k, m1, m2, overlap)

    @property
    def is_bag(self) -> bool:
        return self.bag_kind is not None

    @property
    def stage_columns(self) -> int:
        """Columns this stage holds live at once: children + output (the
        fused Pallas kernel's per-stage staging width)."""
        return self.columns + self.active_columns + self.passive_columns


@dataclass(frozen=True, eq=False)
class TemplatePlan:
    """The complete static schedule for one set of same-``k`` templates.

    Field reference (see ``docs/planning.md`` for the narrative):

    * ``k`` / ``templates`` — the template set (all share one ``k``).
    * ``counting_plans`` — per-template stage order + split tables
      (:class:`~repro_torch.core.counting.CountingPlan`).
    * ``canons`` — per plan, per sub-template: the rooted AHU canonical
      form.  Equal strings share ONE DP state across the whole set.
    * ``stages`` — the shared schedule: every canonical form's first
      occurrence, in execution order, with width annotations.
    * ``free_at`` — liveness: position -> canonical states dead after it
      (the fused pipeline's schedule — no aggregate products exist).
    * ``free_at_products`` — the same schedule when memoized SpMM products
      are also tracked (the mesh backend's loop/vectorized eMA modes);
      product keys are ``("prod", canon)`` tuples.
    * ``exec_groups`` — shared-passive execution groups: leader
      ``(plan_idx, sub_idx)`` -> members (leader first).  All members read
      the same passive canonical form and their actives are live before
      the leader, so one passive column-batch sweep serves the group.
    * ``peak_columns`` — the liveness-aware peak of live M columns per
      coloring (the cost model's resident figure).
    * ``max_passive_columns`` / ``max_stage_columns`` — widest passive
      state / widest single stage (column-batch and Pallas staging bounds).

    Equality is *schedule identity*: two plans compare equal iff their
    ``(k, canons)`` agree — the invariant that makes plan equality imply
    engine-cache-key equality.
    """

    k: int
    templates: Tuple[Template, ...]
    counting_plans: Tuple[CountingPlan, ...]
    canons: Tuple[Tuple[str, ...], ...]
    stages: Tuple[PlanStage, ...]
    free_at: Mapping[int, Tuple[str, ...]]
    free_at_products: Mapping[int, Tuple] = field(repr=False)
    exec_groups: Mapping[Tuple[int, int], Tuple[Tuple[int, int], ...]]
    peak_columns: int
    max_passive_columns: int
    max_stage_columns: int
    # Bag-family annotations (defaults = the tree-only values, so tree-only
    # plans are unchanged by the generalization):
    has_bag_stages: bool = False
    max_bag_axes: int = 1
    decomposition_widths: Tuple[Optional[int], ...] = ()

    # -- identity ------------------------------------------------------------

    def schedule_key(self) -> Tuple:
        """Hashable schedule identity — the template half of the engine
        cache key.  Everything else in the IR derives deterministically
        from it."""
        return (self.k, self.canons)

    def __eq__(self, other) -> bool:
        if not isinstance(other, TemplatePlan):
            return NotImplemented
        return self.schedule_key() == other.schedule_key()

    def __ne__(self, other) -> bool:
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    def __hash__(self) -> int:
        return hash(self.schedule_key())

    # -- derived views -------------------------------------------------------

    @property
    def num_templates(self) -> int:
        return len(self.templates)

    @property
    def num_positions(self) -> int:
        """Schedule length: first-occurrence stages + one root read per
        plan (the domain of ``free_at`` keys)."""
        return len(self.stages) + len(self.counting_plans)

    def stage_at(self, plan_idx: int, sub_idx: int) -> Optional[PlanStage]:
        """The first-occurrence stage addressed ``(plan_idx, sub_idx)``
        (``None`` when that sub is a duplicate of an earlier canon)."""
        for s in self.stages:
            if (s.plan_idx, s.sub_idx) == (plan_idx, sub_idx):
                return s
        return None

    def liveness(self, track_products: bool = False) -> Mapping[int, Tuple]:
        """The liveness schedule an executor should free against."""
        return self.free_at_products if track_products else self.free_at

    def padded_peak_columns(self, pad_unit: int, track_products: bool = False) -> int:
        """Liveness peak with every state's columns padded up to
        ``pad_unit`` (the mesh backend pads to its all-gather batch)."""
        return liveness_peak_columns(
            self.counting_plans,
            self.canons,
            pad_unit=pad_unit,
            track_products=track_products,
        )

    def peak_elements(self, n: int) -> int:
        """Liveness peak of live DP-state *elements* per coloring on an
        ``n``-vertex graph.  For tree-only plans this is exactly
        ``n * peak_columns``; bag states contribute ``n**axes * columns``."""
        return liveness_peak_elements(self.counting_plans, self.canons, n)

    def table_keys(self) -> Tuple[Tuple[int, int, int], ...]:
        """Distinct split-table identities ``(k, m, m_a)`` the plan needs."""
        seen: List[Tuple[int, int, int]] = []
        for s in self.stages:
            if s.table_key is not None and s.table_key not in seen:
                seen.append(s.table_key)
        return tuple(seen)

    def join_table_keys(self) -> Tuple[Tuple[int, int, int, int], ...]:
        """Distinct union-table identities ``(k, m1, m2, overlap)`` needed
        by bag-join stages (empty for tree-only plans)."""
        seen: List[Tuple[int, int, int, int]] = []
        for s in self.stages:
            if s.join_table_key is not None and s.join_table_key not in seen:
                seen.append(s.join_table_key)
        return tuple(seen)

    def describe(self) -> Dict:
        """Structured summary (the CLI and ``CountingEngine.describe()``
        both render from this)."""
        out = {
            "k": self.k,
            "templates": [t.name for t in self.templates],
            "stages": len(self.stages),
            "positions": self.num_positions,
            "unique_canons": len({c for cs in self.canons for c in cs}),
            "total_subs": sum(len(cs) for cs in self.canons),
            "shared_passive_groups": sum(
                1 for m in self.exec_groups.values() if len(m) > 1
            ),
            "peak_columns": self.peak_columns,
            "naive_peak_columns": sum(p.peak_columns() for p in self.counting_plans),
            "max_passive_columns": self.max_passive_columns,
            "max_stage_columns": self.max_stage_columns,
            "table_keys": [list(tk) for tk in self.table_keys()],
        }
        if self.has_bag_stages:
            out["bag_stages"] = sum(1 for s in self.stages if s.is_bag)
            out["max_bag_axes"] = self.max_bag_axes
            out["decomposition_widths"] = {
                t.name: w
                for t, w in zip(self.templates, self.decomposition_widths)
                if w is not None
            }
            out["join_table_keys"] = [list(tk) for tk in self.join_table_keys()]
        return out


def _build_shared_passive_groups(
    counting_plans: Sequence[CountingPlan],
    canons: Sequence[Sequence[str]],
) -> Dict[Tuple[int, int], Tuple[Tuple[int, int], ...]]:
    """Static schedule of shared-passive stage groups.

    Walks the first-occurrence stages in execution order; each non-leaf
    stage either leads a group or was claimed by an earlier leader.  A
    later stage joins a leader's group when (a) it reads the same passive
    canonical form and (b) its active state is already computed before the
    leader's position (group members execute at the leader's position, so
    inputs produced between leader and member cannot be used).  Pulling a
    member earlier only moves its reads/writes forward, so the sequential
    liveness schedule stays valid: nothing a group reads can have been
    freed yet, and outputs are never freed before their sequential last
    read.

    Returns ``leader (plan_idx, stage_idx) -> members`` (leader first;
    singleton groups for unshared stages).
    """
    seq: List[Tuple[int, int, str]] = []  # first occurrences, exec order
    seen = set()
    for p_idx, plan in enumerate(counting_plans):
        n_stages = (
            len(plan.partition.subs)
            if plan.partition is not None
            else len(plan.bag_program.ops)
        )
        for i in range(n_stages):
            c = canons[p_idx][i]
            if c in seen:
                continue
            seen.add(c)
            seq.append((p_idx, i, c))
    # canons computed strictly before each seq position
    avail_before: List[frozenset] = []
    acc: set = set()
    for _, _, c in seq:
        avail_before.append(frozenset(acc))
        acc.add(c)
    groups: Dict[Tuple[int, int], Tuple[Tuple[int, int], ...]] = {}
    member: set = set()
    for idx, (p_idx, i, _) in enumerate(seq):
        if counting_plans[p_idx].partition is None:
            # Bag ops never lead a shared-passive group (their SpMM runs on
            # one axis of a multi-axis state, not a passive column sweep);
            # they still occupy `seq` so their canons gate availability.
            continue
        sub = counting_plans[p_idx].partition.subs[i]
        if sub.is_leaf or (p_idx, i) in member:
            continue
        passive_canon = canons[p_idx][sub.passive]
        members = [(p_idx, i)]
        for jdx in range(idx + 1, len(seq)):
            q, j, _ = seq[jdx]
            if counting_plans[q].partition is None:
                continue
            sub2 = counting_plans[q].partition.subs[j]
            if sub2.is_leaf or (q, j) in member:
                continue
            if canons[q][sub2.passive] != passive_canon:
                continue
            if canons[q][sub2.active] not in avail_before[idx]:
                continue
            members.append((q, j))
            member.add((q, j))
        groups[(p_idx, i)] = tuple(members)
    return groups


def build_template_plan(
    templates: Union[Template, Sequence[Template]],
    plans: Optional[Sequence[CountingPlan]] = None,
) -> TemplatePlan:
    """The pure planner: template set -> :class:`TemplatePlan`.

    Builds (or adopts) one :class:`~repro_torch.core.counting.CountingPlan` per
    template, derives the canonical-form sharing, the first-occurrence
    schedule with width annotations, both liveness schedules, and the
    shared-passive execution groups.  No graph, no device, no side effects
    — the same template set always yields an equal plan.
    """
    if isinstance(templates, Template):
        templates = [templates]
    templates = tuple(templates)
    if not templates:
        raise ValueError("build_template_plan needs at least one template")
    ks = {t.k for t in templates}
    if len(ks) != 1:
        raise ValueError(
            f"all templates must share one k to share colorings, got k={sorted(ks)}"
        )
    k = ks.pop()

    if plans is None:
        counting_plans = tuple(build_counting_plan(t) for t in templates)
    else:
        if len(plans) != len(templates):
            raise ValueError("plans must align with templates")
        counting_plans = tuple(plans)

    canons: Tuple[Tuple[str, ...], ...] = tuple(
        plan.stage_canons() for plan in counting_plans
    )

    # first-occurrence schedule with width annotations (positions shared
    # with schedule_liveness: stages and root reads both advance `pos`)
    stages: List[PlanStage] = []
    executed = set()
    max_passive = 1
    max_stage = 1
    max_bag_axes = 1
    pos = 0
    for p_idx, plan in enumerate(counting_plans):
        pc = canons[p_idx]
        if plan.partition is not None:
            for i, sub in enumerate(plan.partition.subs):
                if pc[i] in executed:
                    continue
                executed.add(pc[i])
                if sub.is_leaf:
                    stages.append(
                        PlanStage(
                            plan_idx=p_idx,
                            sub_idx=i,
                            position=pos,
                            canon=pc[i],
                            is_leaf=True,
                            size=1,
                            columns=k,
                        )
                    )
                else:
                    active = plan.partition.subs[sub.active]
                    passive = plan.partition.subs[sub.passive]
                    c_a = binom(k, active.size)
                    c_p = binom(k, passive.size)
                    stage = PlanStage(
                        plan_idx=p_idx,
                        sub_idx=i,
                        position=pos,
                        canon=pc[i],
                        is_leaf=False,
                        size=sub.size,
                        columns=binom(k, sub.size),
                        active_canon=pc[sub.active],
                        passive_canon=pc[sub.passive],
                        active_columns=c_a,
                        passive_columns=c_p,
                        table_key=(k, sub.size, active.size),
                    )
                    stages.append(stage)
                    max_passive = max(max_passive, c_p)
                    max_stage = max(max_stage, stage.stage_columns)
                pos += 1
            pos += 1  # the plan's root read
        else:
            prog = plan.bag_program
            for i, op in enumerate(prog.ops):
                if pc[i] in executed:
                    continue
                executed.add(pc[i])
                table_key = (k, op.m, 1) if op.kind == "extend" else None
                join_key = None
                if op.kind == "join":
                    o1, o2 = prog.ops[op.inputs[0]], prog.ops[op.inputs[1]]
                    overlap = len(set(o1.covered) & set(o2.covered))
                    join_key = (k, o1.m, o2.m, overlap)
                stages.append(
                    PlanStage(
                        plan_idx=p_idx,
                        sub_idx=i,
                        position=pos,
                        canon=pc[i],
                        is_leaf=op.kind == "leaf",
                        size=op.m,
                        columns=k if op.kind == "leaf" else binom(k, op.m),
                        table_key=table_key,
                        bag_kind=op.kind,
                        bag_axes=op.axes,
                        input_canons=tuple(pc[j] for j in op.inputs),
                        join_table_key=join_key,
                    )
                )
                max_bag_axes = max(
                    max_bag_axes, len(op.axes) + len(op.forget_vertices)
                )
                pos += 1
            pos += 1  # the plan's root read

    free_at = {
        p: tuple(keys)
        for p, keys in schedule_liveness(counting_plans, canons).items()
    }
    free_at_products = {
        p: tuple(keys)
        for p, keys in schedule_liveness(
            counting_plans, canons, track_products=True
        ).items()
    }

    return TemplatePlan(
        k=k,
        templates=templates,
        counting_plans=counting_plans,
        canons=canons,
        stages=tuple(stages),
        free_at=free_at,
        free_at_products=free_at_products,
        exec_groups=_build_shared_passive_groups(counting_plans, canons),
        peak_columns=liveness_peak_columns(counting_plans, canons),
        max_passive_columns=max_passive,
        max_stage_columns=max_stage,
        has_bag_stages=any(p.partition is None for p in counting_plans),
        max_bag_axes=max_bag_axes,
        decomposition_widths=tuple(
            p.bag_program.width if p.partition is None else None
            for p in counting_plans
        ),
    )
