"""CountingEngine: the façade over the plan -> cost -> exec pipeline.

The port of ``repro.core.engine``.  One construction is::

    plan   = repro_torch.plan.build_template_plan(templates)
    cost   = repro_torch.plan.cost.CostModel(plan, graph, store dtype)
    select = repro_torch.exec.select.resolve_backend_config(graph, ...)
    impl   = repro_torch.exec.make_backend(engine)
    chunk  = cost.pick_chunk_size(impl.bytes_per_coloring(), budget)

The engine runs on one device: ``device=None`` means the CUDA card, and
construction raises when there is none (it never falls back to the CPU;
callers that want the CPU pass ``device="cpu"``).  A chunk of ``B``
colorings rides the fused ``(n, B, C)`` layout of every DP state.

Colorings come from threefry PRNG keys drawn exactly as the reference draws
them (:mod:`repro_torch.core.prng`): :meth:`CountingEngine.estimate`,
:meth:`~CountingEngine.count_keys` and
:meth:`~CountingEngine.count_keys_chunk` give the reference's estimates for
the same seed or keys.  :meth:`CountingEngine.count_colorings` takes
explicit ``(iters, n)`` colorings.  :func:`engine_cache_key` is the
engine's identity, which the counting service caches warm engines under.
The fault-injection seams (``engine_build``, ``launch``, and on the mesh
backend ``collective``) are the reference's
(:mod:`repro_torch.testing.faults`).

With ``mesh=`` (a 1-D ``DeviceMesh`` or a ``ProcessGroup`` the caller
initialised) the engine is one rank of the ``mesh`` backend
(:mod:`repro_torch.exec.mesh`): every rank builds it with the same
arguments and calls it with the same keys, and every rank gets the same
totals.  Its memory model is per shard.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import resolve_device
from repro_torch.exec.base import EngineBackend, make_backend
from repro_torch.exec.select import ENGINE_BACKENDS, resolve_backend_config
from repro_torch.plan.cost import DEFAULT_MEMORY_BUDGET_BYTES, CostModel
from repro_torch.plan.ir import TemplatePlan, build_template_plan, template_set_canons
from repro_torch.testing import faults as _faults

from .colorsets import colorful_probability
from .prng import as_keys, prng_key, split
from .counting import CountingPlan
from .graph import Graph
from .templates import Template

__all__ = [
    "DtypePolicy",
    "EstimateResult",
    "CountingEngine",
    "RangeShift",
    "RANGE_MARGIN_LOG2",
    "engine_cache_key",
    "rooted_homomorphisms",
    "homomorphism_bounds",
    "choose_range_shift",
    "resolve_device",
]

logger = logging.getLogger("repro_torch.engine")

#: log2 of what every count of a shifted tree walk is held under: each
#: stage's aggregate and output entries, the root's sum over vertices, and
#: that sum times the normaliser.  fp32's largest finite value is just under
#: 2^128; the 2^18 between is room for what rounding adds to an exact count
#: (at most a relative 2^-8 per bf16-stored state over a template's stages,
#: far less in fp32) many times over.
RANGE_MARGIN_LOG2 = 110
#: log2 of fp32's (and bf16's) smallest normal magnitude: a count of one in
#: a ``k``-vertex state, ``2^(-s k)``, and the smallest estimate may not
#: fall below it, or the shift would cost precision.
RANGE_FLOOR_LOG2 = -126


@dataclass(frozen=True)
class DtypePolicy:
    """Storage vs accumulation dtypes for the DP state.

    ``fp32`` keeps both at float32; ``bf16`` stores M matrices in bfloat16
    (halving state and gather bytes) while accumulating in float32.
    """

    store_dtype: torch.dtype
    accum_dtype: torch.dtype

    @staticmethod
    def resolve(policy: Union[str, "DtypePolicy", torch.dtype, None]) -> "DtypePolicy":
        """Coerce ``"fp32"`` | ``"bf16"`` | a dtype | a policy | None."""
        if policy is None:
            return DtypePolicy(torch.float32, torch.float32)
        if isinstance(policy, DtypePolicy):
            return policy
        if isinstance(policy, str):
            if policy in ("fp32", "float32"):
                return DtypePolicy(torch.float32, torch.float32)
            if policy in ("bf16", "bfloat16"):
                return DtypePolicy(torch.bfloat16, torch.float32)
            raise ValueError(f"unknown dtype policy {policy!r} (fp32 | bf16)")
        if not isinstance(policy, torch.dtype):
            raise ValueError(f"unknown dtype policy {policy!r}")
        accum = torch.float32 if policy in (torch.bfloat16, torch.float16) else policy
        return DtypePolicy(policy, accum)


@dataclass
class EstimateResult:
    """Per-template estimation summary."""

    mean: float
    std: float
    per_iteration: np.ndarray
    iterations: int


@dataclass(frozen=True)
class RangeShift:
    """The tree walk's exact range shift: the leaf is scaled by
    ``2^-shift``, so an ``m``-vertex state holds its counts times
    ``2^(-shift m)`` and each total comes back times ``2^(-shift k)``.

    ``bound_log2`` is log2 of the largest bound before the shift and
    ``shifted_log2`` the largest after it (each bound less ``shift`` times
    its vertices), both ``None`` where no bound was computed; ``why`` says
    how the shift was chosen."""

    shift: int
    bound_log2: Optional[float]
    shifted_log2: Optional[float]
    margin_log2: int
    why: str

    def describe(self) -> Dict:
        return dataclasses.asdict(self)


def rooted_homomorphisms(
    plan: TemplatePlan, graph: Graph, device
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """``(hom, agg)``, canon -> ``(n,)`` float64, for the rooted
    sub-templates of ``plan``'s tree plans: ``hom[s][v]`` counts the
    homomorphisms of ``s`` that send its root to ``v`` (the leaf's is one,
    a stage's ``H_active * agg``), and ``agg[s]`` is a stage's passive
    aggregate ``A_G @ H_passive``, one sparse product each."""
    n = graph.n
    src = torch.as_tensor(graph.src, device=device)
    dst = torch.as_tensor(graph.dst, device=device)
    hom: Dict[str, torch.Tensor] = {}
    agg: Dict[str, torch.Tensor] = {}
    for p_idx, cplan in enumerate(plan.counting_plans):
        canons = plan.canons[p_idx]
        for i, sub in enumerate(cplan.partition.subs):
            if canons[i] in hom:
                continue
            if sub.is_leaf:
                hom[canons[i]] = torch.ones(n, dtype=torch.float64, device=device)
                continue
            passive = hom[canons[sub.passive]]
            agg[canons[i]] = torch.zeros_like(passive).index_add_(0, dst, passive[src])
            hom[canons[i]] = hom[canons[sub.active]] * agg[canons[i]]
    return hom, agg


def homomorphism_bounds(
    plan: TemplatePlan, graph: Graph, norms: Sequence[float], device
) -> List[Tuple[float, int]]:
    """``(log2 bound, vertices)`` of every count a tree plan's walk holds.

    A colorful entry of a sub-template's state, and each partial sum over
    splits that makes it, counts a subset of the homomorphisms
    :func:`rooted_homomorphisms` counts, so ``max_v hom`` bounds a stage's
    outputs and ``max_v agg`` its aggregate (of the passive's vertices).
    The root adds its sum over vertices and that sum times each template's
    normaliser ``norms[t]``."""
    hom, agg = rooted_homomorphisms(plan, graph, device)
    values: List[torch.Tensor] = []
    sizes: List[int] = []
    for p_idx, cplan in enumerate(plan.counting_plans):
        subs, canons = cplan.partition.subs, plan.canons[p_idx]
        for i, sub in enumerate(subs):
            if not sub.is_leaf:
                values += [agg[canons[i]].max(), hom[canons[i]].max()]
                sizes += [subs[sub.passive].size, sub.size]
        total = hom[canons[cplan.partition.root_index]].sum()
        values += [total, total * norms[p_idx]]
        sizes += [cplan.k, cplan.k]
    logs = torch.stack(values).log2().cpu().tolist()
    return list(zip(logs, sizes))


def choose_range_shift(
    bounds: Sequence[Tuple[float, int]], k: int, norms: Sequence[float], margin_log2: int
) -> RangeShift:
    """The smallest ``s >= 0`` with every ``log2 bound - s * vertices``
    under ``margin_log2``.  Raises ``ValueError`` where that ``s`` would
    put a count of one in a ``k``-vertex state, or the smallest estimate,
    below fp32's smallest normal magnitude."""
    finite = [(b, m) for b, m in bounds if b != -math.inf]
    if not finite:
        return RangeShift(0, None, None, margin_log2, "no count to bound")
    shift = max(0, max(math.ceil((b - margin_log2) / m) for b, m in finite))
    top = max(b for b, _ in finite)
    shifted = max(b - shift * m for b, m in finite)
    floor = -shift * k + min(0.0, math.log2(min(norms)))
    if shift and floor < RANGE_FLOOR_LOG2:
        raise ValueError(
            f"the tree walk's largest count is bounded by 2^{top:.1f}: holding every count "
            f"under 2^{margin_log2} takes a shift of {shift} per template vertex, and a "
            f"{k}-vertex count of one would then read 2^{floor:.1f}, below fp32's smallest "
            f"normal 2^{RANGE_FLOOR_LOG2}; the graph is too large for these templates in fp32"
        )
    why = ("bounds under the margin" if shift == 0
           else f"largest bound 2^{top:.1f} over the margin 2^{margin_log2}")
    return RangeShift(shift, top, shifted, margin_log2, why)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _assemble_cache_key(
    signature: str,
    canons: Tuple[Tuple[str, ...], ...],
    backend: str,
    policy: DtypePolicy,
    chunk_spec: Tuple,
    column_batch: Optional[int],
    tuning_fragment: Optional[Tuple] = None,
) -> Tuple:
    """The one place the cache-key tuple is laid out, shared by
    :func:`engine_cache_key` and :meth:`CountingEngine.cache_key`.  Its
    positions are the reference's: the serving layer's degradation ladder
    reads backend, chunk spec and column batch at [3], [6] and [7]; the
    tuning fragment (``TuningConfig.key_fragment()``, or ``None``) rides
    last."""
    return (
        "counting-engine",
        signature,
        canons,
        backend,
        _dtype_name(policy.store_dtype),
        _dtype_name(policy.accum_dtype),
        chunk_spec,
        None if column_batch is None else int(column_batch),
        tuning_fragment,
    )


def engine_cache_key(
    graph: Graph,
    templates: Sequence[Template],
    *,
    device=None,
    backend: str = "auto",
    dtype_policy: Union[str, "DtypePolicy", torch.dtype, None] = "fp32",
    chunk_size: Optional[int] = None,
    memory_budget_bytes: Optional[int] = None,
    column_batch: Optional[int] = None,
    tuning=None,
) -> Tuple:
    """Hashable identity of a :class:`CountingEngine`, computable without
    building one.  Anatomy (the reference's)::

        ("counting-engine",
         graph signature,           # content hash of (n, src, dst)
         template-set canons,       # DP-schedule identity, label-free
         resolved backend name,     # the resolution ladder folded in
         store dtype, accum dtype,  # dtype policy
         chunk spec,                # ("chunk", c), or ("budget", bytes)
         column_batch,              # fused-slice width override, or None
         tuning fragment)           # TuningConfig.key_fragment(), or None

    Backend resolution runs the constructor's ladder (explicit >
    ``REPRO_ENGINE_BACKEND`` > tuned cache entry for ``device``'s kind >
    heuristic) on ``device``, and a tuned config's chunk, column batch and
    budget are folded in as construction folds them, so the key equals the
    built engine's :meth:`CountingEngine.cache_key`; equal plans give equal
    keys."""
    signature = graph.signature()
    canons = template_set_canons(templates)
    name, _source, _reason, cfg = resolve_backend_config(
        graph, backend=backend, canons=canons, tuning=tuning,
        device=resolve_device(device), signature=signature,
    )
    if cfg is not None:
        if chunk_size is None and cfg.chunk_size is not None:
            chunk_size = cfg.chunk_size
        if column_batch is None and cfg.column_batch is not None:
            column_batch = cfg.column_batch
        if memory_budget_bytes is None and cfg.memory_budget_bytes is not None:
            memory_budget_bytes = cfg.memory_budget_bytes
    budget = DEFAULT_MEMORY_BUDGET_BYTES if memory_budget_bytes is None else memory_budget_bytes
    return _assemble_cache_key(
        signature,
        canons,
        name,
        DtypePolicy.resolve(dtype_policy),
        ("chunk", int(chunk_size)) if chunk_size else ("budget", int(budget)),
        column_batch,
        None if cfg is None else cfg.key_fragment(),
    )


class CountingEngine:
    """Batched color-coding counting runs over one graph on one device.

    Args:
      graph: the network (a :class:`repro_torch.core.graph.Graph`).
      templates: one :class:`Template` or a sequence of same-``k`` tree
        templates counted together per coloring.
      device: ``None`` (the CUDA card; raises without one), ``"cuda"``,
        ``"cuda:N"`` or ``"cpu"``.
      backend: ``auto`` | ``edges`` | ``ell`` | ``sell`` | ``dense`` |
        ``blocked`` | ``mixed`` | ``mesh``.  ``auto`` resolves to ``mesh``
        when ``mesh=`` is given, else ``REPRO_ENGINE_BACKEND``, then a tuned
        config (``tuning=``, or the tuning cache's entry for this graph,
        template set and device kind under ``REPRO_TUNE``), then the
        graph-statistics heuristic (``blocked`` on a card for large
        graphs).  ``mixed`` requires ``tuning=``.  Ignored when ``spmm_fn``
        is given.
      spmm_fn: optional ``(n, C) -> (n, C)`` neighbor-sum function (the
        ``custom`` backend).
      dtype_policy: ``fp32`` | ``bf16`` | a :class:`DtypePolicy` | a dtype.
      memory_budget_bytes: live-footprint budget steering the chunk picker
        (per device; on the mesh backend the model is per shard).
      chunk_size: explicit colorings-per-chunk override (skips the picker).
      column_batch: passive columns per fused slice of the streamed
        backends (on ``mesh``, per collective); ``None``: the cost model's
        pick (``min(16, ...)`` locally, ``min(128, ...)`` on ``mesh``).
      mesh / ema_mode / gather_dtype / balance_degrees / mesh_comm: the
        mesh backend's knobs (:class:`repro_torch.exec.mesh.MeshBackend`);
        ``mesh_comm`` forces ``blocking`` | ``pipelined`` collectives,
        ``None`` lets ``REPRO_MESH_COMM`` or the cost model decide (a tuned
        config may carry it).
      tuning: optional :class:`repro_torch.tune.config.TuningConfig` (what
        ``python -m repro_torch.tune`` / ``CountingService.tune`` produce):
        binds per-group backends and supplies ``column_batch``,
        ``chunk_size`` and ``memory_budget_bytes`` wherever the caller left
        them ``None``.  Beaten by an explicit ``backend=`` or the env
        override; ``describe()["backend"]["source"]`` records who won.
    """

    def __init__(
        self,
        graph: Graph,
        templates: Union[Template, Sequence[Template]],
        *,
        device=None,
        backend: str = "auto",
        spmm_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        dtype_policy: Union[str, DtypePolicy, torch.dtype, None] = "fp32",
        memory_budget_bytes: Optional[int] = None,
        chunk_size: Optional[int] = None,
        column_batch: Optional[int] = None,
        tuning=None,
        mesh=None,
        ema_mode: str = "streamed",
        gather_dtype: Optional[torch.dtype] = None,
        balance_degrees: bool = True,
        mesh_comm: Optional[str] = None,
    ):
        if isinstance(templates, Template):
            templates = [templates]
        if not templates:
            raise ValueError("CountingEngine needs at least one template")
        # fault-injection seam: construction is the first failure surface a
        # serving deployment meets, before any operand binds
        _faults.maybe_fail("engine_build", ctx=f"backend={backend}")
        self.device = resolve_device(device)

        # --- layer 1: the backend-agnostic plan.
        self.plan_ir: TemplatePlan = build_template_plan(templates)
        self.graph = graph
        self.templates: Tuple[Template, ...] = self.plan_ir.templates
        self.plans: Tuple[CountingPlan, ...] = self.plan_ir.counting_plans
        self.k = self.plan_ir.k
        self.policy = DtypePolicy.resolve(dtype_policy)

        # --- layer 2: the cost model, calibrated by this device's rows.
        self.cost = CostModel(self.plan_ir, graph, self.policy.store_dtype, device=self.device)

        # backend resolution runs before the chunk, column-batch and budget
        # knobs are read: a tuned config supplies those the caller left None
        self._tuning = None
        if spmm_fn is not None:
            name, source, reason = "custom", "custom", "caller-supplied spmm_fn"
        elif backend == "auto" and mesh is not None:
            name, source, reason = "mesh", "mesh", "mesh= given"
        else:
            if backend != "auto" and backend not in ENGINE_BACKENDS:
                raise ValueError(f"unknown backend {backend!r} (one of {ENGINE_BACKENDS})")
            name, source, reason, cfg = resolve_backend_config(
                graph, backend=backend, canons=self.plan_ir.canons, tuning=tuning,
                device=self.device,
            )
            self._tuning = cfg
            if cfg is None and tuning is not None:
                logger.info("tuned config ignored: backend resolved by %s (%s)", source, reason)
            if cfg is not None:
                if column_batch is None and cfg.column_batch is not None:
                    column_batch = cfg.column_batch
                if chunk_size is None and cfg.chunk_size is not None:
                    chunk_size = cfg.chunk_size
                if memory_budget_bytes is None:
                    memory_budget_bytes = cfg.memory_budget_bytes
                if mesh_comm is None:
                    mesh_comm = cfg.mesh_comm
        self.backend = name
        self.backend_source = source
        self.backend_reason = reason

        self.memory_budget_bytes = int(
            DEFAULT_MEMORY_BUDGET_BYTES if memory_budget_bytes is None else memory_budget_bytes
        )
        self._column_batch_arg = column_batch
        self.column_batch = (
            int(column_batch) if column_batch else self.cost.pick_local_column_batch()
        )

        norm = colorful_probability(self.k)
        self._norms = [1.0 / (norm * plan.automorphisms) for plan in self.plans]
        self._norm_factors = torch.tensor(self._norms, dtype=torch.float32, device=self.device)

        # ``trace_count`` counts chunk-function builds (the reference counts
        # jit traces); ``passive_aggregations`` counts aggregation launches;
        # ``bag_fused`` / ``bag_loop`` the bag extends and joins whose update
        # ran in the bag eMA kernel / in the executor's per-term loop.
        self.trace_count = 0
        self.counters: Dict[str, int] = {
            "passive_aggregations": 0, "bag_fused": 0, "bag_loop": 0,
        }

        # --- layer 3: bind the plan to the device.
        self.backend_impl: EngineBackend = make_backend(
            self, spmm_fn=spmm_fn, tuning=self._tuning, mesh=mesh,
            column_batch=column_batch, ema_mode=ema_mode, gather_dtype=gather_dtype,
            balance_degrees=balance_degrees, mesh_comm=mesh_comm,
        )
        self.range = self._choose_range()
        self.range_shift = self.range.shift
        self.counters["range_shift"] = self.range_shift

        self._chunk_explicit = bool(chunk_size)
        self._graph_signature: Optional[str] = None
        self.chunk_size = (
            int(chunk_size)
            if chunk_size
            else self.cost.pick_chunk_size(self.bytes_per_coloring(), self.memory_budget_bytes)
        )
        self._chunk_fn = None
        logger.info(
            "CountingEngine backend=%s (%s: %s) device=%s n=%d edges=%d k=%d "
            "column_batch=%d chunk=%d",
            self.backend, source, reason, self.device, graph.n,
            graph.num_directed, self.k, self.column_batch, self.chunk_size,
        )

    def _choose_range(self) -> RangeShift:
        """The range shift for this engine's graph and templates: 0 on a
        backend that builds its own leaf (``mesh``) and for any bag plan;
        else from :func:`homomorphism_bounds`."""
        if not self.backend_impl.scales_leaf:
            return RangeShift(0, None, None, RANGE_MARGIN_LOG2,
                              f"the {self.backend} backend builds its own leaf")
        if any(plan.partition is None for plan in self.plans):
            return RangeShift(0, None, None, RANGE_MARGIN_LOG2, "a bag plan")
        with obs.span("repro_torch.engine.range_bound"):
            bounds = homomorphism_bounds(self.plan_ir, self.graph, self._norms, self.device)
        return choose_range_shift(bounds, self.k, self._norms, RANGE_MARGIN_LOG2)

    def _unshift(self, values: torch.Tensor) -> torch.Tensor:
        """fp32 counts of a shifted walk -> float64 counts: times
        ``2^(shift k)``, exact.  At shift 0, the values as they are."""
        if not self.range_shift:
            return values
        with obs.span("repro_torch.engine.range", self.device):
            return values.to(torch.float64) * 2.0 ** (self.range_shift * self.k)

    # ------------------------------------------------------------------
    # Plan-derived views
    # ------------------------------------------------------------------

    def peak_columns(self) -> int:
        """Peak live M columns per coloring across the shared DP."""
        return self.plan_ir.peak_columns

    def bytes_per_coloring(self) -> int:
        """Live bytes one coloring contributes to a chunk (cost model fed
        with the bound backend's operand geometry)."""
        return self.backend_impl.bytes_per_coloring()

    def predicted_peak_bytes(self) -> int:
        """The chunk picker's live-footprint prediction for one chunk."""
        return self.chunk_size * self.bytes_per_coloring()

    def compiled_memory_analysis(self, iterations: Optional[int] = None) -> Dict[str, Optional[float]]:
        """Measure one chunk's temporary device memory against the chunk
        picker's prediction: the fusion-slack calibration data (the
        ``memory_model`` rows that :func:`repro_torch.plan.cost.
        load_fusion_slack` folds back into the picker,
        :func:`repro_torch.plan.cost.memory_model_row`).

        On a card: synchronise, note ``memory_allocated()``, reset the
        peak statistics, run one :meth:`count_keys_chunk` of
        ``min(chunk_size, iterations)`` keys (padded to the chunk, as every
        launch is), and take ``max_memory_allocated()`` less the noted
        figure: the bytes the run allocated beyond what was live before, the
        counterpart of XLA's ``temp_size_in_bytes``, which leaves out the
        arguments.  A failing chunk raises.  On the CPU, which keeps no
        allocation statistics, ``actual_temp_bytes`` and ``ratio`` are
        ``None``, as the reference's are on a backend without
        ``memory_analysis()``.  On the mesh backend the figures are per
        shard, and every rank must call this together (it runs a chunk).

        Returns ``{"predicted_bytes", "actual_temp_bytes", "ratio"}``
        (``ratio`` = predicted / actual)."""
        iters = int(iterations) if iterations else self.chunk_size
        predicted = float(self.predicted_peak_bytes())
        actual: Optional[float] = None
        if self.device.type == "cuda":
            keys = split(prng_key(0, self.device), max(1, min(self.chunk_size, iters)))
            torch.cuda.synchronize(self.device)
            before = torch.cuda.memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
            self.count_keys_chunk(keys)  # returns on the host: synchronised
            actual = float(torch.cuda.max_memory_allocated(self.device) - before)
        return {
            "predicted_bytes": predicted,
            "actual_temp_bytes": actual,
            "ratio": (predicted / actual) if actual else None,
        }

    def graph_signature(self) -> str:
        """Content hash of the graph (memoised; :meth:`Graph.signature`)."""
        if self._graph_signature is None:
            self._graph_signature = self.graph.signature()
        return self._graph_signature

    def cache_key(self) -> Tuple:
        """This engine's :func:`engine_cache_key` (resolved values), equal to
        what a caller computes before construction with the same arguments.
        A ``custom`` ``spmm_fn``'s identity is not part of it."""
        return _assemble_cache_key(
            self.graph_signature(),
            self.plan_ir.canons,
            self.backend,
            self.policy,
            ("chunk", self.chunk_size) if self._chunk_explicit
            else ("budget", self.memory_budget_bytes),
            self._column_batch_arg,
            None if self._tuning is None else self._tuning.key_fragment(),
        )

    def describe(self) -> Dict:
        """Structured construction record: backend decision and reason,
        device, shapes, dtype policy, chunk plan, memory model and plan."""
        itemsize = self.policy.store_dtype.itemsize
        return {
            "backend": {
                "name": self.backend,
                "source": self.backend_source,
                "reason": self.backend_reason,
                "tuning": None if self._tuning is None else self._tuning.describe(),
            },
            "device": str(self.device),
            "n": self.graph.n,
            "num_directed": self.graph.num_directed,
            "k": self.k,
            "templates": [t.name for t in self.templates],
            "dtype_policy": {
                "store": _dtype_name(self.policy.store_dtype),
                "accum": _dtype_name(self.policy.accum_dtype),
            },
            # the mesh backend aggregates at its own all-gather batch width
            "column_batch": getattr(self.backend_impl, "column_batch", self.column_batch),
            "chunk_size": self.chunk_size,
            # the mesh backend's resolved collective scheme and per-stage
            # comm schedule (None on the local backends)
            "comm": (self.backend_impl.describe_comm()
                     if hasattr(self.backend_impl, "describe_comm") else None),
            "plan": self.plan_ir.describe(),
            "range": self.range.describe(),
            "bag_ops": {"fused": self.counters["bag_fused"], "loop": self.counters["bag_loop"]},
            "memory": {
                "budget_bytes": self.memory_budget_bytes,
                "fusion_slack": self.cost.fusion_slack,
                "predicted_transient_bytes": self.backend_impl.transient_elements() * itemsize,
                "predicted_resident_bytes": self.backend_impl.resident_elements() * itemsize,
                "bytes_per_coloring": self.bytes_per_coloring(),
            },
            "graph_signature": self.graph_signature(),
            "cache_key": self.cache_key(),
        }

    # ------------------------------------------------------------------
    # Public API
    # ------------------------------------------------------------------

    def _colors_tensor(self, colors) -> torch.Tensor:
        colors = torch.as_tensor(colors)
        if colors.dtype.is_floating_point or colors.dtype == torch.bool:
            raise TypeError(f"colorings must be integers, got {colors.dtype}")
        if colors.shape[-1] != self.graph.n:
            raise ValueError(
                f"colorings have {colors.shape[-1]} vertices, the graph {self.graph.n}"
            )
        return colors.to(device=self.device, dtype=torch.long)

    def raw_counts(self, colors) -> torch.Tensor:
        """(n,) coloring -> (T,) raw colorful totals (float64, on the device;
        the fp32 walk's, times ``2^(shift k)``)."""
        colors = self._colors_tensor(colors)
        raw = self.backend_impl.counts_for_colors(colors[None, :])[0]
        return self._unshift(raw).to(torch.float64)

    def _get_chunk_fn(self):
        if self._chunk_fn is None:
            self._chunk_fn = self.backend_impl.make_chunk_fn()
        return self._chunk_fn

    def count_colorings(self, colors) -> np.ndarray:
        """``(iters, n)`` integer colorings -> ``(iters, T)`` normalised
        estimates (float64 host array), in chunks of ``chunk_size``."""
        colors = self._colors_tensor(colors)
        if colors.dim() != 2:
            raise ValueError("count_colorings takes (iters, n) colorings")
        fn = self._get_chunk_fn()
        outs = [
            fn(colors[lo : lo + self.chunk_size])
            for lo in range(0, colors.shape[0], self.chunk_size)
        ]
        if not outs:
            return np.zeros((0, len(self.templates)), np.float64)
        return torch.cat(outs, dim=0).cpu().numpy().astype(np.float64)

    def count_keys_chunk(self, keys) -> np.ndarray:
        """Streaming increment: ``(m, 2)`` PRNG keys, ``m <= chunk_size``, ->
        ``(m, T)`` normalised estimates (float64 host array), one chunk.

        The serving path: callers stream iterations through repeated calls.
        A short increment is padded with its last key up to ``chunk_size``,
        as in the reference, so every launch has the chunk's shape whatever
        the increment.  The fault seams fire here, at the launch boundary:
        ``launch`` on every backend, ``collective`` on the backends that
        declare it (``EngineBackend.fault_sites``).
        """
        keys = as_keys(keys, self.device)
        m = int(keys.shape[0])
        if m == 0:
            return np.zeros((0, len(self.templates)), np.float64)
        if m > self.chunk_size:
            raise ValueError(
                f"increment of {m} keys exceeds chunk_size={self.chunk_size}; "
                "split it (count_keys handles multi-chunk runs)"
            )
        _faults.maybe_fail("launch", ctx=f"backend={self.backend}")
        if "collective" in self.backend_impl.fault_sites:
            # the pipelined mesh path crosses the collective seam once per
            # ring step (blocking: once per launch), so a seeded fault plan
            # sees every dispatch
            for step in range(self.backend_impl.collective_dispatches):
                _faults.maybe_fail("collective", ctx=f"backend={self.backend} step={step}")
        pad = self.chunk_size - m
        if pad:
            keys = torch.cat([keys, keys[-1:].expand(pad, 2)])
        vals = self.backend_impl.counts_for_keys_chunk(keys)
        with obs.span("repro_torch.engine.copy_back"):
            out = vals.cpu().numpy().astype(np.float64)[:m]
        return _faults.corrupt_result("launch", out, ctx=f"backend={self.backend}")

    def count_keys(self, keys) -> np.ndarray:
        """``(iters, 2)`` PRNG keys (``split`` output, or the reference's
        ``jax.random.split`` as a numpy array) -> ``(iters, T)`` normalised
        estimates (float64 host array).  Chunks of ``min(chunk_size,
        iters)`` keys, the last padded with its last key, as the reference
        runs them."""
        keys = as_keys(keys, self.device)
        if keys.dim() != 2:
            raise ValueError("count_keys takes (iters, 2) keys")
        iters = int(keys.shape[0])
        if iters == 0:
            return np.zeros((0, len(self.templates)), np.float64)
        chunk = min(self.chunk_size, iters)
        pad = -iters % chunk
        if pad:
            keys = torch.cat([keys, keys[-1:].expand(pad, 2)])
        run = self.backend_impl.counts_for_keys_chunk
        outs = [run(keys[lo : lo + chunk]) for lo in range(0, keys.shape[0], chunk)]
        with obs.span("repro_torch.engine.copy_back"):
            return torch.cat(outs, dim=0).cpu().numpy().astype(np.float64)[:iters]

    def estimate(self, iterations: int = 32, seed: int = 0) -> List[EstimateResult]:
        """Run ``iterations`` random colorings from ``split(prng_key(seed),
        iterations)``, the reference's keys; one :class:`EstimateResult` per
        template (paper Algorithm 1, batched)."""
        vals = self.count_keys(split(prng_key(seed, self.device), iterations))
        return [
            EstimateResult(
                mean=float(vals[:, t].mean()),
                std=float(vals[:, t].std()),
                per_iteration=vals[:, t],
                iterations=iterations,
            )
            for t in range(len(self.templates))
        ]
