"""CountingService: a multi-tenant query layer over cached CountingEngines.

The port of ``repro.serve.counting``.  The engine
(:mod:`repro_torch.core.engine`) answers ONE (graph, template-set) workload
well; a serving deployment faces many tenants asking overlapping questions —
many templates x many graphs x accuracy targets (the motif/graphlet query
workload of the subgraph-counting literature).  ``CountingService`` serves
them with three pieces:

* **Engine cache** (:mod:`repro_torch.serve.cache`): engines are shared
  behind :func:`repro_torch.core.engine.engine_cache_key` with LRU
  eviction.  A repeat query — same graph signature, template canons,
  backend, dtype policy, chunk spec — reuses the warm engine, its device
  operands and its chunk function: no new chunk-function build
  (``engine.trace_count`` holds still).  Iteration counts never enter the
  key: every launch is padded to the engine's ``chunk_size``.
* **Cross-query batching**: pending queries that resolve to the same engine
  key are merged into ONE ``count_keys_chunk`` launch — their colorings ride
  the same fused column dimension of the DP state (the engine's B axis), and
  results are scattered back per query.  Per-query colorings are drawn with
  ``fold_in(prng_key(query.seed), iteration)``, bit-equal to the
  reference's, so the values each query receives are independent of who
  shared its launch, and equal to the reference's for the same query.
* **Adaptive (epsilon, delta) stopping** (:mod:`repro_torch.serve.stopping`):
  each query folds its per-coloring estimates into a running mean/variance
  and stops at its relative CI target instead of a blind fixed N.

Scheduling is a round-robin **admission loop over engine keys**: one launch
per eligible key per cycle, so a hot graph with a deep queue cannot starve
other tenants.  The loop is single-threaded and deterministic: a fixed
submission order and fixed seeds reproduce every launch, estimate, and
stopping decision exactly.  Failures are classified (transient: retry with
backoff; memory: walk the degradation ladder, which never leaves the
configured backend; deterministic: fail, and quarantine the key on repeat,
which also drops the key's tuned cache entry), and deadlines resolve armed
queries with their running estimate.

Autotuning hooks: :meth:`CountingService.tune` runs the port's tuner
(:func:`repro_torch.tune.search.tune`) on the service's device and drops
the cached engines it makes stale; under ``REPRO_TUNE=full`` a submission
of an un-tuned workload queues a background tune, which the asynchronous
front-end (:mod:`repro_torch.serve.frontend`) drains through
:meth:`CountingService.pop_pending_tune`.
"""

from __future__ import annotations

import logging
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.engine import CountingEngine, DtypePolicy, engine_cache_key
from repro_torch.core.estimator import required_iterations
from repro_torch.core.graph import Graph
from repro_torch.core.prng import fold_in, prng_key
from repro_torch.core.templates import Template, connected_graphlets, get_template
from repro_torch.device import resolve_device
from repro_torch.exec.select import tune_mode
from repro_torch.plan.cost import DEFAULT_MEMORY_BUDGET_BYTES, admission_estimate, degradation_ladder

from .cache import EngineCache
from .qos import Clock, SystemClock
from .resilience import (
    DEFAULT_QUARANTINE_BASE_S,
    DEFAULT_RETRY_POLICY,
    FailState,
    QuarantinedError,
    RetryPolicy,
    ServiceError,
    classify_failure,
)
from .stopping import DEFAULT_MIN_ITERATIONS, AdaptiveStopper, TemplateCI

__all__ = ["CountingService", "Query", "QueryEstimate"]

logger = logging.getLogger("repro_torch.serve")

#: Iterations for a query that names neither an (epsilon, delta) target nor
#: an explicit iteration count (the engine-layer fixed-N default).
DEFAULT_FIXED_ITERATIONS = 32

#: Iteration budget cap for adaptive queries that don't pass their own.
DEFAULT_ADAPTIVE_BUDGET = 1024


@dataclass
class QueryEstimate:
    """Final per-template answer of a completed query.

    ``degraded=True`` marks a deadline-resolved best-effort estimate: the
    query's deadline passed with the stopper still running, so the answer
    is the running mean with BOTH CI halfwidths attached (normal and
    empirical-Bernstein — always populated once two samples exist, degraded
    or not) instead of a converged result.
    """

    template: str
    mean: float
    std: float
    halfwidth: float  # CI halfwidth at stop time (0.0 for fixed-N queries)
    converged: bool  # CI target met (False when the budget ran out / fixed-N)
    halfwidth_normal: float = 0.0  # CLT z-interval at resolve time
    halfwidth_bernstein: float = 0.0  # empirical-Bernstein at resolve time
    degraded: bool = False  # resolved at deadline with the running estimate


@dataclass
class Query:
    """One submitted counting question and its lifecycle state.

    ``status`` walks ``pending -> running -> done`` (or ``-> cancelled``
    via :meth:`CountingService.cancel`, or ``-> failed`` with a structured
    :class:`~repro_torch.serve.resilience.ServiceError` on ``error``);
    ``iterations`` is the number of colorings actually spent (== the fixed
    target for fixed-N queries, <= budget for adaptive ones).  ``tenant``
    is opaque caller metadata (the front-end stamps its tenant name here
    for observability).  ``retries`` counts launch attempts this query
    paid for through transient failures; ``degraded`` marks a
    deadline-resolved best-effort result (status still ``done``).
    """

    qid: int
    graph_ref: str
    templates: Tuple[Template, ...]
    epsilon: Optional[float]
    delta: float
    budget: int
    seed: int
    engine_key: Tuple
    stopper: AdaptiveStopper
    status: str = "pending"
    tenant: Optional[str] = None
    estimates: Optional[List[QueryEstimate]] = None
    record_rows: bool = False
    rows: Optional[List[np.ndarray]] = None  # (m, T) blocks when recording
    deadline_at: Optional[float] = None  # absolute, on the service clock
    retry_policy: Optional[RetryPolicy] = None  # None = service default
    retries: int = 0
    error: Optional[ServiceError] = None
    degraded: bool = False
    _base_key: torch.Tensor = field(default=None, repr=False)
    _drawn: int = 0  # next coloring iteration index to draw

    def per_iteration(self) -> np.ndarray:
        """``(iterations, T)`` per-coloring estimates (``record_rows`` only)."""
        if not self.record_rows:
            raise RuntimeError("submit(..., record_rows=True) to keep rows")
        if not self.rows:
            return np.zeros((0, len(self.templates)), np.float64)
        return np.concatenate(self.rows, axis=0)

    @property
    def done(self) -> bool:
        return self.status == "done"

    @property
    def cancelled(self) -> bool:
        return self.status == "cancelled"

    @property
    def failed(self) -> bool:
        return self.status == "failed"

    @property
    def finished(self) -> bool:
        """Terminal any way — done with a result, cancelled, or failed."""
        return self.status in ("done", "cancelled", "failed")

    @property
    def iterations(self) -> int:
        return self.stopper.iterations

    def progress(self) -> List[TemplateCI]:
        """Streaming partial results: the stopper's live per-template view.

        Valid at any point in the lifecycle — running mean, sample std,
        and BOTH CI halfwidths (normal and empirical-Bernstein) plus the
        ``lower``/``upper`` interval edges under the query's configured
        bound (see :class:`repro_torch.serve.stopping.TemplateCI`).  Callers can
        act on a converging estimate before the stopping rule fires.
        """
        return self.stopper.estimates()

    def result(self) -> List[QueryEstimate]:
        if self.failed:
            raise self.error
        if not self.done:
            raise RuntimeError(f"query {self.qid} is {self.status}, not done")
        return self.estimates


class CountingService:
    """Shared serving front-end; see the module docstring for the design.

    Args:
      device: where every engine runs: ``None`` (the CUDA card; raises
        without one), ``"cuda"``, ``"cuda:N"`` or ``"cpu"``.
      max_engines: LRU capacity of the engine cache.
      backend / dtype_policy / chunk_size / memory_budget_bytes: forwarded
        to every engine the service builds (and folded into cache keys).
      default_budget: iteration cap for adaptive queries without their own.
      min_iterations: CI arming threshold (see ``AdaptiveStopper``).
      clock: time source for deadlines, retry backoff, and quarantine
        windows (``SystemClock`` by default).
      retry_policy: default transient-failure policy for queries that
        don't pass their own ``retry_policy=`` at submit.
      quarantine_base_s: first quarantine window for an engine key that
        keeps failing deterministically (doubles per re-quarantine).
    """

    def __init__(
        self,
        *,
        device=None,
        max_engines: int = 8,
        backend: str = "auto",
        dtype_policy: Union[str, None] = "fp32",
        chunk_size: Optional[int] = None,
        memory_budget_bytes: int = DEFAULT_MEMORY_BUDGET_BYTES,
        default_budget: int = DEFAULT_ADAPTIVE_BUDGET,
        min_iterations: int = DEFAULT_MIN_ITERATIONS,
        clock: Optional[Clock] = None,
        retry_policy: Optional[RetryPolicy] = None,
        quarantine_base_s: float = DEFAULT_QUARANTINE_BASE_S,
    ):
        self.device = resolve_device(device)
        self.backend = backend
        self.dtype_policy = dtype_policy
        self.chunk_size = chunk_size
        self.memory_budget_bytes = int(memory_budget_bytes)
        self.default_budget = int(default_budget)
        self.min_iterations = int(min_iterations)
        self.clock = clock if clock is not None else SystemClock()
        self.default_retry_policy = (
            retry_policy if retry_policy is not None else DEFAULT_RETRY_POLICY
        )
        self.quarantine_base_s = float(quarantine_base_s)
        self._graphs: Dict[str, Graph] = {}
        self._signatures: Dict[str, str] = {}
        self._cache = EngineCache(capacity=max_engines)
        self._next_qid = 0
        self._active: Dict[Tuple, List[Query]] = {}  # engine key -> live queries
        self._rr: Deque[Tuple] = deque()  # round-robin ring of keys with work
        self.launch_log: List[Tuple] = []  # engine key per launch, in order
        self.queries_completed = 0
        self.queries_cancelled = 0
        self.queries_failed = 0
        self.queries_degraded = 0
        # failure semantics: per-key retry/quarantine state, ladder config
        # overrides, fault counters
        self._fail: Dict[Tuple, FailState] = {}
        self._overrides: Dict[Tuple, Dict] = {}  # ladder-rung engine kwargs
        self._ladders: Dict[Tuple, List] = {}  # key -> its degradation rungs
        self.fault_counters: Dict[str, int] = {
            "transient": 0,
            "memory": 0,
            "deterministic": 0,
            "invalid": 0,
            "non_finite": 0,
        }
        # autotuning: ``REPRO_TUNE=full`` records un-tuned engine keys
        # here; a front-end drains them one per scheduler round
        self._tune_pending: Deque[Tuple[str, Tuple[Template, ...]]] = deque()
        self._tune_requested: set = set()  # engine keys ever queued/tuned
        self.tunes_completed = 0

    # ------------------------------------------------------------------
    # Registration & submission
    # ------------------------------------------------------------------

    def register_graph(self, name: str, graph: Graph) -> str:
        """Register ``graph`` under ``name``; returns its content signature.

        Re-registering a name with an identical signature is a no-op;
        re-registering with different content is an error (queries in
        flight reference the old content).
        """
        sig = graph.signature()
        if name in self._signatures and self._signatures[name] != sig:
            raise ValueError(
                f"graph {name!r} already registered with different content"
            )
        self._graphs[name] = graph
        self._signatures[name] = sig
        return sig

    def graph(self, name: str) -> Graph:
        if name not in self._graphs:
            raise KeyError(
                f"unknown graph {name!r} — register_graph() it first "
                f"(known: {sorted(self._graphs)})"
            )
        return self._graphs[name]

    def _resolve_templates(
        self, templates: Union[str, Template, Sequence[Union[str, Template]]]
    ) -> Tuple[Template, ...]:
        if isinstance(templates, (str, Template)):
            templates = [templates]
        out = tuple(get_template(t) if isinstance(t, str) else t for t in templates)
        if not out:
            raise ValueError("query needs at least one template")
        return out

    def engine_key_for(self, graph_ref: str, templates) -> Tuple:
        """The engine cache key a query of this shape resolves to."""
        return engine_cache_key(
            self.graph(graph_ref),
            self._resolve_templates(templates),
            device=self.device,
            backend=self.backend,
            dtype_policy=self.dtype_policy,
            chunk_size=self.chunk_size,
            memory_budget_bytes=self.memory_budget_bytes,
        )

    def submit(
        self,
        graph_ref: str,
        templates: Union[str, Template, Sequence[Union[str, Template]]],
        *,
        epsilon: Optional[float] = None,
        delta: float = 0.05,
        iterations: Optional[int] = None,
        seed: int = 0,
        record_rows: bool = False,
        bound: str = "normal",
        tenant: Optional[str] = None,
        deadline: Optional[float] = None,
        retry_policy: Optional[RetryPolicy] = None,
    ) -> Query:
        """Queue a query; returns its handle (drive it with :meth:`run`).

        ``epsilon``/``delta``: relative CI target — the query stops as soon
        as every template's halfwidth is within ``epsilon * |mean|`` at
        confidence ``1 - delta`` (``iterations`` then caps the budget,
        default ``default_budget``).  Without ``epsilon`` the query runs a
        fixed ``iterations`` colorings (default ``32``).  ``record_rows``
        keeps the per-coloring estimates on the handle
        (:meth:`Query.per_iteration`) instead of just the running moments.
        ``bound`` picks the CI the stopper tests: ``"normal"`` (default)
        or the more conservative ``"bernstein"`` for heavy-tailed
        per-coloring counts (see :mod:`repro_torch.serve.stopping`).

        ``deadline``: seconds from now (service clock).  When it passes, a
        query with >= 2 iterations resolves ``done`` with its running
        estimate, both CI halfwidths, and ``degraded=True``; with fewer it
        fails with a ``deadline`` :class:`ServiceError`.  ``retry_policy``
        overrides the service default for transient launch failures.

        Raises :class:`~repro_torch.serve.resilience.QuarantinedError`
        immediately while the query's engine key is quarantined — no queue
        slot is taken for work the scheduler would refuse to run.
        """
        graph = self.graph(graph_ref)
        tset = self._resolve_templates(templates)
        if epsilon is not None:
            if iterations:
                budget = int(iterations)
            else:
                # never budget past the a-priori Alon bound — it is generic
                # over k-vertex templates (k!/k^k colorful-hit probability),
                # so non-tree graphlet queries get the same default cap
                blind = required_iterations(
                    max(t.k for t in tset), epsilon, delta
                )
                budget = min(self.default_budget, blind)
        else:
            budget = int(iterations) if iterations else DEFAULT_FIXED_ITERATIONS
        key = self.engine_key_for(graph_ref, tset)
        self._maybe_queue_tune(key, graph_ref, tset)
        now = self.clock.now()
        fs = self._fail.get(key)
        if fs is not None and now < fs.quarantined_until:
            raise QuarantinedError(
                f"engine key quarantined for another "
                f"{fs.quarantined_until - now:.3f}s (quarantine "
                f"#{fs.quarantines} after repeated deterministic failures)",
                engine_key=key,
                retry_at=fs.quarantined_until,
            )
        stopper = AdaptiveStopper(
            len(tset),
            epsilon=epsilon,
            delta=delta,
            budget=budget,
            min_iterations=self.min_iterations,
            bound=bound,
        )
        query = Query(
            qid=self._next_qid,
            graph_ref=graph_ref,
            templates=tset,
            epsilon=epsilon,
            delta=delta,
            budget=budget,
            seed=seed,
            engine_key=key,
            stopper=stopper,
            tenant=tenant,
            record_rows=record_rows,
            rows=[] if record_rows else None,
            deadline_at=None if deadline is None else now + float(deadline),
            retry_policy=retry_policy,
            _base_key=prng_key(seed),
        )
        self._next_qid += 1
        if key not in self._active:
            self._active[key] = []
            self._rr.append(key)
        self._active[key].append(query)
        return query

    # ------------------------------------------------------------------
    # The admission loop
    # ------------------------------------------------------------------

    def _engine_for(self, key: Tuple, query: Query) -> CountingEngine:
        overrides = self._overrides.get(key, {})

        def build():
            kwargs = dict(
                backend=self.backend,
                dtype_policy=self.dtype_policy,
                chunk_size=overrides.get("chunk_size", self.chunk_size),
                memory_budget_bytes=self.memory_budget_bytes,
            )
            if "column_batch" in overrides:
                kwargs["column_batch"] = overrides["column_batch"]
            return CountingEngine(
                self.graph(query.graph_ref), list(query.templates), device=self.device,
                **kwargs,
            )

        return self._cache.get(key, build)

    def step(self) -> Optional[Tuple]:
        """Serve ONE launch attempt to the next engine key in round-robin
        order.

        Merges that key's live queries into one chunk: slots are dealt one
        coloring at a time, cycling the queries, so concurrent tenants of a
        hot engine split each launch fairly; unfilled slots are padded
        (same compiled shape either way).  Returns the engine key served,
        or ``None`` when no query is runnable *now* (queue empty, or every
        key with work is parked behind retry backoff / quarantine —
        :meth:`run` sleeps or advances the clock to the next timer in that
        case).

        Failure semantics: expired deadlines are swept
        first (degrading armed queries instead of failing them); a build
        or launch exception is classified ``transient`` (per-query retry
        accounting + exponential key backoff), ``memory`` (walk one
        degradation-ladder rung and rebuild), or ``deterministic`` (fail
        the attempt's queries; quarantine the key on repeat).  A failed
        attempt still returns the key — failure bookkeeping is progress.
        """
        now = self.clock.now()
        self._sweep_deadlines(now)

        skipped: List[Tuple] = []
        key: Optional[Tuple] = None
        queries: List[Query] = []
        while self._rr:
            cand = self._rr.popleft()
            live = [q for q in self._active.get(cand, []) if not q.finished]
            if not live:
                self._active.pop(cand, None)  # drained key leaves the ring
                continue
            fs = self._fail.get(cand)
            if fs is not None and fs.blocked_until(now) is not None:
                skipped.append(cand)  # parked: backoff or quarantine
                continue
            key, queries = cand, live
            break
        self._rr.extend(skipped)
        if key is None:
            return None

        try:
            engine = self._engine_for(key, queries[0])
        except Exception as exc:
            self._handle_failure(key, queries, exc, now, phase="build")
            self._requeue(key)
            return key
        chunk = engine.chunk_size

        # deal slots round-robin across this key's queries (iteration order
        # per query is preserved: each deal hands out its next index)
        alloc: List[Tuple[Query, int]] = []
        dealt: Dict[int, int] = {}
        ring = deque(queries)
        while ring and len(alloc) < chunk:
            q = ring.popleft()
            d = dealt.get(q.qid, 0)
            if q.stopper.remaining_budget() > d:
                alloc.append((q, q._drawn + d))
                dealt[q.qid] = d + 1
                ring.append(q)

        # one batched fold_in for the whole launch's keys, bit-equal to the
        # per-query draws
        bases = torch.stack([q._base_key for q, _ in alloc])
        keys = fold_in(bases, torch.as_tensor([idx for _, idx in alloc], dtype=torch.int64))
        try:
            rows = engine.count_keys_chunk(keys)  # (len(alloc), T) float64
        except Exception as exc:
            # nothing was scattered and no ``_drawn`` advanced, so a retry
            # re-draws the exact same fold_in colorings — surviving queries
            # stay bit-exact vs an unfailed run (the cancel mechanism)
            self._handle_failure(key, queries, exc, now, phase="launch")
            self._requeue(key)
            return key
        self.launch_log.append(key)
        fs = self._fail.get(key)
        if fs is not None:
            fs.note_success()

        # scatter results back per query, in iteration order, and advance
        per_query: Dict[int, List[np.ndarray]] = {}
        by_qid = {q.qid: q for q, _ in alloc}
        for (q, _), row in zip(alloc, rows):
            per_query.setdefault(q.qid, []).append(row)
        for qid, qrows in per_query.items():
            q = by_qid[qid]
            block = np.stack(qrows)
            q._drawn += block.shape[0]
            if not np.isfinite(block).all():
                # catch NaN/Inf BEFORE the stopper folds it into Welford
                # state — only the query whose colorings produced the bad
                # rows fails; launch-mates keep their (finite) blocks
                self.fault_counters["non_finite"] += 1
                self._fail_query(
                    q,
                    ServiceError(
                        "non_finite",
                        "chunk produced NaN/Inf estimates for this query's "
                        "colorings",
                        engine_key=key,
                        qid=q.qid,
                    ),
                )
                continue
            q.status = "running"
            if q.record_rows:
                q.rows.append(block)
            q.stopper.update(block)
            if q.stopper.done:
                self._finalize(q)

        self._requeue(key)
        return key

    def _requeue(self, key: Tuple) -> None:
        still_live = [q for q in self._active.get(key, []) if not q.finished]
        if still_live:
            self._active[key] = still_live
            self._rr.append(key)
        else:
            self._active.pop(key, None)

    def _finalize(self, query: Query, *, degraded: bool = False) -> None:
        cis: List[TemplateCI] = query.stopper.estimates()
        query.estimates = [
            QueryEstimate(
                template=t.name,
                mean=ci.mean,
                std=ci.std,
                halfwidth=0.0 if query.epsilon is None else ci.halfwidth,
                converged=ci.converged,
                halfwidth_normal=ci.halfwidth_normal,
                halfwidth_bernstein=ci.halfwidth_bernstein,
                degraded=degraded,
            )
            for t, ci in zip(query.templates, cis)
        ]
        query.degraded = degraded
        query.status = "done"
        self.queries_completed += 1
        if degraded:
            self.queries_degraded += 1

    def _fail_query(self, query: Query, error: ServiceError) -> None:
        query.error = error
        query.status = "failed"
        self.queries_failed += 1

    def _sweep_deadlines(self, now: float) -> None:
        """Resolve every live query whose deadline has passed.

        Accuracy/latency degradation, not an error: a query with an armed
        stopper (>= 2 iterations, so both CI halfwidths exist) finalizes
        ``done`` with its running estimate and ``degraded=True``; one that
        never accumulated two samples fails with a ``deadline`` error.
        """
        for key in list(self._active):
            for q in self._active.get(key, []):
                if q.finished or q.deadline_at is None or now < q.deadline_at:
                    continue
                if q.stopper.count >= 2:
                    self._finalize(q, degraded=True)
                else:
                    self._fail_query(
                        q,
                        ServiceError(
                            "deadline",
                            f"deadline passed after {q.stopper.count} "
                            f"iterations — too few for a running estimate",
                            engine_key=key,
                            qid=q.qid,
                        ),
                    )

    def _ladder_for(self, key: Tuple, query: Query) -> List:
        """This key's degradation rungs (memoized; base config from the
        cache key itself, so it is stable however the engine is rebuilt)."""
        if key not in self._ladders:
            backend = key[3]
            chunk_spec, column_batch = key[6], key[7]
            if chunk_spec[0] == "chunk":
                base_chunk = int(chunk_spec[1])
            else:
                base_chunk = admission_estimate(
                    self.graph(query.graph_ref),
                    query.templates,
                    store_dtype=DtypePolicy.resolve(self.dtype_policy).store_dtype,
                    memory_budget_bytes=self.memory_budget_bytes,
                ).chunk_size
            self._ladders[key] = degradation_ladder(
                base_chunk, column_batch, backend
            )
        return self._ladders[key]

    def _handle_failure(
        self,
        key: Tuple,
        queries: List[Query],
        exc: Exception,
        now: float,
        *,
        phase: str,
    ) -> None:
        """Classify one failed build/launch attempt and apply its policy."""
        kind = classify_failure(exc)
        self.fault_counters[kind] += 1
        fs = self._fail.setdefault(key, FailState())

        if kind == "transient":
            policy = queries[0].retry_policy or self.default_retry_policy
            fs.note_transient(now, policy)
            for q in queries:
                pol = q.retry_policy or self.default_retry_policy
                q.retries += 1
                fs.retries_total += 1
                if q.retries > pol.max_retries:
                    self._fail_query(
                        q,
                        ServiceError(
                            "retries_exhausted",
                            f"{pol.max_retries} retries spent at {phase}",
                            engine_key=key,
                            qid=q.qid,
                            cause=exc,
                        ),
                    )
            return

        if kind == "memory":
            fs.note_memory()
            rungs = self._ladder_for(key, queries[0])
            if fs.ladder_rung >= len(rungs):
                for q in queries:
                    self._fail_query(
                        q,
                        ServiceError(
                            "memory_exhausted",
                            f"degradation ladder exhausted after "
                            f"{len(rungs)} rungs at {phase}",
                            engine_key=key,
                            qid=q.qid,
                            cause=exc,
                        ),
                    )
                return
            rung = rungs[fs.ladder_rung]
            fs.ladder_rung += 1
            overrides = {"chunk_size": rung.chunk_size}
            if rung.column_batch is not None:
                overrides["column_batch"] = rung.column_batch
            self._overrides[key] = overrides
            self._cache.invalidate(key)  # next step rebuilds at the rung
            fs.ladder_log.append(
                {
                    "rung": fs.ladder_rung,
                    "action": rung.action,
                    "phase": phase,
                    **overrides,
                    "repriced_chunk_bytes": self._reprice_rung(
                        key, queries[0], rung
                    ),
                }
            )
            return

        if kind == "invalid":
            # the QUERY is malformed, not the engine key poisoned — fail the
            # queries with the structured error and leave the FailState
            # untouched, so resubmitting the same impossible query never
            # walks the key into quarantine
            for q in queries:
                self._fail_query(
                    q,
                    ServiceError(
                        "invalid",
                        f"{type(exc).__name__} at {phase}: {exc}",
                        engine_key=key,
                        qid=q.qid,
                        cause=exc,
                    ),
                )
            return

        # deterministic: retries will never clear it — fail the attempt's
        # queries now, and after repeat strikes quarantine the key so the
        # poisoned (graph, template) pair stops consuming its ring slot
        until = fs.note_deterministic(now, self.quarantine_base_s)
        for q in queries:
            self._fail_query(
                q,
                ServiceError(
                    "deterministic",
                    f"{type(exc).__name__} at {phase}: {exc}",
                    engine_key=key,
                    qid=q.qid,
                    cause=exc,
                ),
            )
        if until is not None:
            self._cache.invalidate(key)  # a fresh build gets a clean slate
            # the ladder must not fight a poisoned tuned config: quarantine
            # drops the key's tuned cache entry so the post-quarantine
            # rebuild re-resolves from the heuristic
            self._drop_tuned_entry(key)

    def _reprice_rung(self, key: Tuple, query: Query, rung) -> int:
        """``admission_estimate`` re-prices the rung's launch residency
        (recorded in the ladder log and used by ``admission_bytes`` until
        the rebuilt engine answers exactly)."""
        return admission_estimate(
            self.graph(query.graph_ref),
            query.templates,
            store_dtype=DtypePolicy.resolve(self.dtype_policy).store_dtype,
            chunk_size=rung.chunk_size,
            memory_budget_bytes=self.memory_budget_bytes,
        ).chunk_bytes

    def _next_event_at(self) -> Optional[float]:
        """Earliest instant parked/deadlined work becomes actionable
        (None when nothing is waiting on a timer)."""
        now = self.clock.now()
        times: List[float] = []
        for key, qs in self._active.items():
            live = [q for q in qs if not q.finished]
            if not live:
                continue
            fs = self._fail.get(key)
            until = fs.blocked_until(now) if fs is not None else None
            if until is None:
                return now  # a key is schedulable right now
            times.append(until)
            times.extend(
                q.deadline_at for q in live if q.deadline_at is not None
            )
        return min(times) if times else None

    def _wait_until(self, target: float) -> None:
        """Advance a manual clock, or sleep a bounded slice of wall time."""
        now = self.clock.now()
        if target <= now:
            return
        advance = getattr(self.clock, "advance", None)
        if advance is not None:
            advance(target - now)
        else:
            time.sleep(min(target - now, 0.05))

    def run(self, max_launches: Optional[int] = None) -> None:
        """Drive the admission loop until every submitted query resolves.

        When every key with pending work is parked (retry backoff /
        quarantine), waits for the next timer — advancing a manual clock
        deterministically, or sleeping in bounded slices on a system clock
        — instead of spinning or returning early.
        """
        launches = 0
        while True:
            served = self.step()
            if served is not None:
                launches += 1
                if max_launches is not None and launches >= max_launches:
                    return
                continue
            if not self.has_pending():
                return
            target = self._next_event_at()
            if target is None:  # pragma: no cover - defensive
                raise RuntimeError(
                    "pending work but no schedulable key and no armed timer"
                )
            self._wait_until(target)

    def has_pending(self) -> bool:
        """True while any admitted query still needs launches."""
        return any(
            not q.finished for qs in self._active.values() for q in qs
        )

    def cancel(self, query: Query) -> bool:
        """Cancel a live query; True if it was still cancellable.

        The query flips to ``cancelled`` and is dropped from its engine
        key's merge list — colorings already spent are simply discarded
        (its launch slots are re-dealt to surviving queries from the next
        launch on).  Cancelling a finished query is a no-op returning
        False.  Other queries are untouched: their colorings are seed-
        folded per query, so counts never depend on who shared a launch.
        """
        if query.finished:
            return False
        query.status = "cancelled"
        live = self._active.get(query.engine_key)
        if live is not None:
            remaining = [q for q in live if q.qid != query.qid]
            if remaining:
                self._active[query.engine_key] = remaining
            # an emptied key stays in the ring; step() retires it lazily
        self.queries_cancelled += 1
        return True

    def admission_bytes(self, graph_ref: str, templates) -> int:
        """Predicted live bytes one launch of this query would hold.

        The front-end's load-shedding currency.  A warm cached engine
        answers exactly (``predicted_peak_bytes()``); otherwise the plan
        layer prices the query without building anything
        (:func:`repro_torch.plan.cost.admission_estimate` — the resident
        formula the engine's chunk picker uses, microseconds of host work).
        """
        graph = self.graph(graph_ref)
        tset = self._resolve_templates(templates)
        engine = self._cache.peek(self.engine_key_for(graph_ref, tset))
        if engine is not None:
            return engine.predicted_peak_bytes()
        est = admission_estimate(
            graph,
            tset,
            store_dtype=DtypePolicy.resolve(self.dtype_policy).store_dtype,
            chunk_size=self.chunk_size,
            memory_budget_bytes=self.memory_budget_bytes,
        )
        return est.chunk_bytes

    def _maybe_queue_tune(self, key: Tuple, graph_ref: str, tset) -> None:
        """``REPRO_TUNE=full``: record an un-tuned workload for background
        tuning (drained by a front-end scheduler via :meth:`pop_pending_tune`
        -> :meth:`tune`, one per round — off the query path).

        ``key[-1]`` is the tuning fragment: non-``None`` means a tuned
        config already resolved, so there is nothing to schedule.  Only
        auto-resolved services tune — an explicit service ``backend=`` is
        an operator decision the tuner must not fight.
        """
        if (
            self.backend != "auto"
            or key[-1] is not None
            or key in self._tune_requested
            or tune_mode() != "full"
        ):
            return
        self._tune_requested.add(key)
        self._tune_pending.append((graph_ref, tset))
        logger.debug("queued background tune for %s (%d templates)", graph_ref, len(tset))

    def pop_pending_tune(self) -> Optional[Tuple[str, Tuple[Template, ...]]]:
        """Next ``(graph_ref, templates)`` awaiting a background tune, or
        ``None`` (``REPRO_TUNE=full`` submissions queue them)."""
        return self._tune_pending.popleft() if self._tune_pending else None

    def tune(self, graph_ref: str, templates, **tune_kwargs):
        """Tune ``(graph_ref, templates)`` now on the service's device;
        returns the :class:`~repro_torch.tune.search.TuneResult`.

        Runs :func:`repro_torch.tune.search.tune` with this service's
        device, dtype policy and memory budget, persists the winner in the
        tuning cache, then invalidates every cached engine (and memoized
        degradation ladder) for that ``(graph, canons)`` pair so the next
        build re-resolves — with ``REPRO_TUNE`` at its default ``cached``,
        that build binds the freshly tuned config.  Probe launches run
        inline on the calling thread; a probe that fails raises.
        """
        from repro_torch.plan.ir import template_set_canons
        from repro_torch.tune.search import tune as run_tune

        graph = self.graph(graph_ref)
        tset = self._resolve_templates(templates)
        tune_kwargs.setdefault("device", self.device)
        tune_kwargs.setdefault("dtype_policy", self.dtype_policy)
        tune_kwargs.setdefault("memory_budget_bytes", self.memory_budget_bytes)
        result = run_tune(graph, list(tset), **tune_kwargs)
        canons = template_set_canons(tset)
        dropped = 0
        for k in list(self._cache.keys()):
            if k[1] == result.graph_signature and k[2] == canons:
                self._cache.invalidate(k)
                self._ladders.pop(k, None)
                dropped += 1
        self._tune_requested.add(self.engine_key_for(graph_ref, tset))
        self.tunes_completed += 1
        logger.info(
            "tuned %s: winner=%s (%d stale cached engines dropped)",
            graph_ref, result.config.describe(), dropped,
        )
        return result

    def _drop_tuned_entry(self, key: Tuple) -> None:
        """Quarantine interop: a deterministically-failing engine key must
        not be re-picked from the tuning cache, so its tuned entry (the
        ``key[-1]`` fragment marks one) is removed from the cache file.

        Except on a CUDA card for a config that binds ``blocked`` (as its
        default or for any group): dropping it would rebuild the key on the
        heuristic's pick, below ``BLOCKED_MIN_VERTICES`` the plain ``edges``
        path, so a failing kernel A/B would be hidden behind a plain
        version.  That entry stays; the key stays quarantined and keeps
        failing loudly, as a spent ladder ends in ``memory_exhausted``."""
        if len(key) < 9 or key[-1] is None:
            return
        _tag, default_backend, group_backends = key[-1][:3]
        binds_blocked = default_backend == "blocked" or any(
            b == "blocked" for _, b in group_backends
        )
        if self.device.type == "cuda" and binds_blocked:
            logger.warning(
                "quarantined engine key %s keeps its tuned entry: it binds "
                "the blocked kernels, and no plain path stands in for them",
                key[3],
            )
            return
        try:
            from repro_torch.tune.cache import invalidate_entry

            if invalidate_entry(key[1], key[2], device=self.device):
                logger.info("quarantine invalidated tuned entry for engine key %s", key[3])
        except Exception as exc:  # pragma: no cover - defensive
            logger.debug("tuned-entry invalidation failed: %s", exc)

    def prewarm(self, graph_ref: str, templates) -> Tuple:
        """Build the engine a query shape will need and run one padded dummy
        launch through ``count_keys_chunk`` (operands shipped, chunk function
        built, kernels loaded), off the query path; returns its engine key.
        Later queries behind the same key build nothing.  Idempotent."""
        graph = self.graph(graph_ref)
        tset = self._resolve_templates(templates)
        key = self.engine_key_for(graph_ref, tset)

        def build():
            return CountingEngine(
                graph,
                list(tset),
                device=self.device,
                backend=self.backend,
                dtype_policy=self.dtype_policy,
                chunk_size=self.chunk_size,
                memory_budget_bytes=self.memory_budget_bytes,
            )

        engine = self._cache.get(key, build)
        engine.count_keys_chunk(prng_key(0)[None])
        return key

    def query(
        self,
        graph_ref: str,
        templates,
        **submit_kwargs,
    ) -> List[QueryEstimate]:
        """Synchronous convenience: submit + drain + result."""
        q = self.submit(graph_ref, templates, **submit_kwargs)
        self.run()
        return q.result()

    def graphlet_profile(
        self,
        graph_ref: str,
        max_size: int = 5,
        *,
        min_size: int = 3,
        run: bool = True,
        **submit_kwargs,
    ) -> Union[Dict[str, QueryEstimate], List[Query]]:
        """Estimate counts of EVERY connected graphlet up to ``max_size``.

        First-class motif/graphlet-profile queries: one submission covers
        all connected templates of each size ``min_size <= k <= max_size``
        (:func:`repro_torch.core.templates.connected_graphlets` — 2, 6, and 21
        shapes for k = 3, 4, 5).  Templates of one size share one query —
        and therefore one engine, one set of colorings, and the plan
        layer's canonical sub-plan sharing (trees ride the fused tree
        pipeline, non-trees the bag pipeline, duplicated stage canons
        de-duplicated within the shared schedule).  Different sizes need
        different colorings, so they become separate queries served
        round-robin by the same admission loop.

        With ``run=True`` (default) drains the loop and returns
        ``{template name: QueryEstimate}``; with ``run=False`` returns the
        queued :class:`Query` handles (drive them with :meth:`run`, e.g.
        to interleave with other tenants).  ``submit_kwargs`` are forwarded
        to every :meth:`submit` (epsilon/delta/iterations/seed/...).
        """
        if min_size > max_size:
            raise ValueError(f"min_size {min_size} > max_size {max_size}")
        queries = [
            self.submit(graph_ref, connected_graphlets(k), **submit_kwargs)
            for k in range(min_size, max_size + 1)
        ]
        if not run:
            return queries
        self.run()
        return {est.template: est for q in queries for est in q.result()}

    # ------------------------------------------------------------------
    # Observability
    # ------------------------------------------------------------------

    def engine(self, key: Tuple) -> Optional[CountingEngine]:
        """The warm engine behind a query's ``engine_key`` (None if evicted)."""
        return self._cache.peek(key)

    def stats(self) -> Dict:
        """Service counters: cache hit/miss/evict, launches, completions,
        and the failure-semantics block (``faults``: classified failure
        counts, total retries, currently-quarantined keys, per-key failure
        state, and each key's degradation-ladder walk)."""
        by_key: Dict[Tuple, int] = {}
        for key in self.launch_log:
            by_key[key] = by_key.get(key, 0) + 1
        now = self.clock.now()
        return {
            "tuning": {
                "mode": tune_mode(),
                "tunes_completed": self.tunes_completed,
                "pending": len(self._tune_pending),
                "tuned_cached_engines": sum(
                    1 for k in self._cache.keys() if len(k) >= 9 and k[-1] is not None
                ),
            },
            "cache": self._cache.counters(),
            "launches": len(self.launch_log),
            "launches_by_key": by_key,
            "queries_submitted": self._next_qid,
            "queries_completed": self.queries_completed,
            "queries_cancelled": self.queries_cancelled,
            "queries_failed": self.queries_failed,
            "queries_degraded": self.queries_degraded,
            "faults": {
                **self.fault_counters,
                "retries": sum(fs.retries_total for fs in self._fail.values()),
                "quarantined_keys": [
                    k for k, fs in self._fail.items()
                    if fs.quarantined_until > now
                ],
                "keys": {k: fs.describe(now) for k, fs in self._fail.items()},
                "ladder": {
                    k: list(fs.ladder_log)
                    for k, fs in self._fail.items()
                    if fs.ladder_log
                },
            },
            "engines": [
                self._cache.peek(k).describe()
                for k in self._cache.keys()
                if self._cache.peek(k) is not None
            ],
        }
