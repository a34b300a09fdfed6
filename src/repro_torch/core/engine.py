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
The fault-injection seams (``engine_build``, ``launch``) are the
reference's (:mod:`repro_torch.testing.faults`).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

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
    "engine_cache_key",
    "resolve_device",
]

logger = logging.getLogger("repro_torch.engine")


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
        ``blocked`` | ``mixed``.  ``auto`` resolves ``REPRO_ENGINE_BACKEND``,
        then a tuned config (``tuning=``, or the tuning cache's entry for
        this graph, template set and device kind under ``REPRO_TUNE``), then
        the graph-statistics heuristic (``blocked`` on a card for large
        graphs).  ``mixed`` requires ``tuning=``.  Ignored when ``spmm_fn``
        is given.
      spmm_fn: optional ``(n, C) -> (n, C)`` neighbor-sum function (the
        ``custom`` backend).
      dtype_policy: ``fp32`` | ``bf16`` | a :class:`DtypePolicy` | a dtype.
      memory_budget_bytes: live-footprint budget steering the chunk picker.
      chunk_size: explicit colorings-per-chunk override (skips the picker).
      column_batch: passive columns per fused slice of the streamed
        backends; ``None``: the cost model's pick.
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

        # --- layer 2: the cost model (fusion slack stays at 1.0).
        self.cost = CostModel(self.plan_ir, graph, self.policy.store_dtype)

        # backend resolution runs before the chunk, column-batch and budget
        # knobs are read: a tuned config supplies those the caller left None
        self._tuning = None
        if spmm_fn is not None:
            name, source, reason = "custom", "custom", "caller-supplied spmm_fn"
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
        self._norm_factors = torch.tensor(
            [1.0 / (norm * plan.automorphisms) for plan in self.plans],
            dtype=torch.float32,
            device=self.device,
        )

        # ``trace_count`` counts chunk-function builds (the reference counts
        # jit traces); ``passive_aggregations`` counts aggregation launches.
        self.trace_count = 0
        self.counters: Dict[str, int] = {"passive_aggregations": 0}

        # --- layer 3: bind the plan to the device.
        self.backend_impl: EngineBackend = make_backend(
            self, spmm_fn=spmm_fn, tuning=self._tuning
        )

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
            "column_batch": self.column_batch,
            "chunk_size": self.chunk_size,
            "plan": self.plan_ir.describe(),
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
        """(n,) coloring -> (T,) raw colorful totals (fp32, on the device)."""
        colors = self._colors_tensor(colors)
        return self.backend_impl.counts_for_colors(colors[None, :])[0]

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
        the increment.  The fault seams fire here, at the launch boundary.
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
        pad = self.chunk_size - m
        if pad:
            keys = torch.cat([keys, keys[-1:].expand(pad, 2)])
        vals = self.backend_impl.counts_for_keys_chunk(keys)
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
