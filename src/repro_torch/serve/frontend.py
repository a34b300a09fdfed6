"""Async serving front-end: futures, per-tenant QoS, backpressure, warming.

The port of ``repro.serve.frontend``.
:class:`~repro_torch.serve.counting.CountingService` answers queries correctly
and fairly — but synchronously: ``run()`` drains the queue on the caller's
thread.  :class:`ServiceFrontend` is the production loop above it:

* **Futures.** ``submit()`` enqueues and returns a :class:`QueryFuture`
  immediately; callers ``result(timeout=...)`` when they need the answer
  and ``progress()`` any time for streaming partials (running mean, sample
  std, and BOTH CI halfwidths — normal and empirical-Bernstein — plus the
  lower/upper interval edges from the query's ``AdaptiveStopper``).
* **Per-tenant QoS** (:mod:`repro_torch.serve.qos`): priority tiers (higher
  tiers are offered admission first each round; within a tier tenants
  round-robin, so a flooding tenant cannot starve a peer), and token-
  bucket rate limits that *delay* admission rather than reject it.  These
  layer on top of the service's round-robin engine-key ring — the frontend
  decides *which query enters the service*, the service decides *which
  engine key launches next*.
* **Backpressure / load shedding** priced by the plan-layer cost model
  (:meth:`CountingService.admission_bytes`): a query whose predicted
  launch residency can never fit ``admission_budget_bytes`` is rejected at
  submit (``over_budget``), a tenant past its ``max_pending`` queue cap is
  rejected at submit (``queue_full``), and an admissible query simply
  waits until enough in-flight bytes retire.
* **Background pre-warming and tuning** keyed by the engine key (graph
  signature + the plan IR's template canons): ``prewarm()`` queues an
  engine build and one dummy launch (operands shipped, kernels loaded),
  ``tune()`` a measurement sweep of the port's tuner on the service's
  device; both run inside a scheduler round, off every caller's submit
  path, at most one per round.  Requests de-duplicate by key.

**The determinism seam.**  All scheduler state advances only inside
:meth:`step` — one *round* = (at most one warm task) + (one admission
sweep) + (one service launch) + (completion sweep) — and the only clock is
the injected :class:`~repro_torch.serve.qos.Clock`.  Tests construct the
frontend with a :class:`~repro_torch.serve.qos.ManualClock` and call
``step()`` / ``clock.advance()`` explicitly: every rate-limit decision,
admission order, launch, and completion is reproducible with zero
wall-clock sleeps (``tests/test_torch_frontend.py`` runs each scenario
through this front-end and the reference's).  Production calls
``start()``, which runs the *same* ``step()`` from one daemon scheduler
thread; ``submit``/``cancel``/``progress`` are thread-safe entry points
that only touch frontend queues under the lock, so the underlying service
still sees strictly single-threaded access — its bit-exactness guarantee
(same (graph, templates, seed) => same counts, however queries are batched
or interleaved) survives concurrency untouched.
"""

from __future__ import annotations

import threading
from collections import deque
from concurrent.futures import CancelledError
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Set, Tuple

from repro_torch import obs
from repro_torch.testing import faults as _faults

from .counting import CountingService, Query
from .qos import (
    DEFAULT_MAX_PENDING,
    Clock,
    ManualClock,
    SystemClock,
    TenantPolicy,
    TenantState,
)
from .resilience import ServiceError

__all__ = [
    "ServiceFrontend",
    "QueryFuture",
    "TemplateProgress",
    "QoSRejected",
    "make_frontend",
    "DEFAULT_ADMISSION_BUDGET_FACTOR",
    "DEFAULT_WATCHDOG_INTERVAL_S",
]

#: Scheduler-staleness threshold for :meth:`ServiceFrontend.health`: a
#: started frontend whose last round is older than this (with work
#: pending) is reported unhealthy.
DEFAULT_WATCHDOG_INTERVAL_S = 1.0

#: Default admission budget = this factor x the service's per-engine memory
#: budget — i.e. "at most N full-budget launches resident at once".
DEFAULT_ADMISSION_BUDGET_FACTOR = 4


class QoSRejected(RuntimeError):
    """Backpressure rejection at submit time.

    ``reason`` is machine-readable: ``"queue_full"`` (tenant past its
    ``max_pending`` cap) or ``"over_budget"`` (the cost model prices one
    launch of this query above the whole admission budget — it could
    never be admitted, so it is shed immediately).
    """

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(f"{reason}: {detail}" if detail else reason)
        self.reason = reason


@dataclass(frozen=True)
class TemplateProgress:
    """One template's streaming partial result (see ``QueryFuture.progress``)."""

    template: str
    status: str  # queued | pending | running | done | cancelled
    iterations: int
    mean: float
    std: float
    halfwidth: float  # the stopping rule's halfwidth (0.0 for fixed-N)
    halfwidth_normal: float  # CLT z-interval, always computed once n >= 2
    halfwidth_bernstein: float  # empirical-Bernstein, always computed once n >= 2
    lower: float  # mean - halfwidth under the query's configured bound
    upper: float  # mean + halfwidth under the query's configured bound
    converged: bool


class QueryFuture:
    """Handle returned by :meth:`ServiceFrontend.submit`.

    Thread-safe; resolves exactly once — with a result (``result()``
    returns the service's per-template ``QueryEstimate`` list) or as
    cancelled (``result()`` raises :class:`concurrent.futures.CancelledError`).
    ``progress()`` never blocks and is monotone: ``iterations`` only grows,
    and a terminal status stays terminal.
    """

    def __init__(
        self,
        frontend: "ServiceFrontend",
        tenant: str,
        graph_ref: str,
        templates,
        submit_kwargs: Dict,
        admission_bytes: int,
        deadline_at: Optional[float] = None,
        submitted_ns: Optional[int] = None,
    ):
        self._frontend = frontend
        self.tenant = tenant
        self.graph_ref = graph_ref
        self.templates = templates  # resolved Template tuple
        self.submit_kwargs = submit_kwargs
        self.admission_bytes = int(admission_bytes)
        self.deadline_at = deadline_at  # frontend-clock absolute deadline
        self._event = threading.Event()
        self._query: Optional[Query] = None
        self._error: Optional[ServiceError] = None
        self._state = "queued"  # queued -> admitted -> done | cancelled | failed
        # clock timestamps + scheduler-round indices (fairness accounting)
        self.submitted_at: float = frontend._clock.now()
        self.admitted_at: Optional[float] = None
        self.resolved_at: Optional[float] = None
        self.admitted_round: Optional[int] = None
        self.resolved_round: Optional[int] = None
        # its life on the profiler's clock, while tracing is on; submitted
        # when ``submit`` was called, before pricing and the lock
        self._record: Optional[obs.Request] = obs.request(tenant, submitted_ns)

    # -- inspection (any thread) --------------------------------------------

    def done(self) -> bool:
        """Resolved either way (result ready or cancelled)."""
        return self._event.is_set()

    def cancelled(self) -> bool:
        return self._event.is_set() and self._state == "cancelled"

    def failed(self) -> bool:
        return self._event.is_set() and self._state == "failed"

    def exception(self) -> Optional[ServiceError]:
        """The structured failure, or ``None`` (does not block)."""
        return self._error

    @property
    def state(self) -> str:
        return self._state

    @property
    def iterations(self) -> int:
        q = self._query
        return 0 if q is None else q.iterations

    def progress(self) -> List[TemplateProgress]:
        """Streaming partial results; valid at every lifecycle point."""
        return self._frontend._progress(self)

    def result(self, timeout: Optional[float] = None):
        """Block until resolved; the per-template ``QueryEstimate`` list.

        Raises ``TimeoutError`` if ``timeout`` elapses first,
        :class:`concurrent.futures.CancelledError` if the query was
        cancelled, and the structured
        :class:`~repro_torch.serve.resilience.ServiceError` if it failed
        (retries exhausted, ladder exhausted, deadline with no samples,
        quarantined key, or a tripped scheduler).  In manual-clock test
        mode drive the scheduler with ``frontend.step()``/``drain()``
        before calling.
        """
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"query for tenant {self.tenant!r} unresolved after {timeout}s"
            )
        if self._state == "cancelled":
            raise CancelledError(f"query for tenant {self.tenant!r} was cancelled")
        if self._state == "failed":
            raise self._error
        return self._query.result()

    def cancel(self) -> bool:
        """Cancel if not yet resolved; True when this call cancelled it."""
        return self._frontend._cancel(self)


class ServiceFrontend:
    """The async, QoS-aware front door of a :class:`CountingService`.

    Two driving modes over the same scheduler:

    * **manual** (default): nothing runs until :meth:`step` (one round) or
      :meth:`drain` — fully deterministic with a
      :class:`~repro_torch.serve.qos.ManualClock`.
    * **threaded**: :meth:`start` spawns one daemon scheduler thread that
      loops ``step()`` whenever work is pending (also via ``with
      frontend: ...``).  ``submit()`` stays non-blocking either way.

    Args:
      service: the synchronous service to drive (exclusively owned — do
        not call its ``run()``/``step()`` directly while a frontend is
        attached).
      clock: time source for rate limits and latency stamps.
      admission_budget_bytes: total predicted launch residency allowed in
        flight (cost-model priced); ``None`` derives
        ``DEFAULT_ADMISSION_BUDGET_FACTOR x service.memory_budget_bytes``.
      default_max_pending: queue cap for auto-registered tenants.
      poll_interval: scheduler-thread idle/parked wait (threaded mode only).
      watchdog_interval: staleness threshold for :meth:`health` — a
        started frontend with pending work whose last completed round is
        older than this reports ``healthy=False``.
    """

    def __init__(
        self,
        service: CountingService,
        *,
        clock: Optional[Clock] = None,
        admission_budget_bytes: Optional[int] = None,
        default_max_pending: int = DEFAULT_MAX_PENDING,
        poll_interval: float = 0.005,
        watchdog_interval: float = DEFAULT_WATCHDOG_INTERVAL_S,
    ):
        self._svc = service
        self._clock = clock if clock is not None else SystemClock()
        # one clock for the whole stack: deadlines stamped here are swept
        # by the service, so a manual frontend clock must drive the
        # service's timers too (explicitly configured clocks are kept)
        if isinstance(service.clock, SystemClock) and not isinstance(
            self._clock, SystemClock
        ):
            service.clock = self._clock
        self._lock = threading.RLock()
        self._work = threading.Condition(self._lock)
        self.admission_budget_bytes = (
            int(admission_budget_bytes)
            if admission_budget_bytes is not None
            else DEFAULT_ADMISSION_BUDGET_FACTOR * service.memory_budget_bytes
        )
        self.default_max_pending = int(default_max_pending)
        self.poll_interval = float(poll_interval)
        self._tenants: Dict[str, TenantState] = {}
        self._tier_rings: Dict[int, Deque[str]] = {}  # priority -> tenant ring
        self._admitted: List[QueryFuture] = []  # in flight, unresolved
        self._inflight_bytes = 0
        self._rounds = 0
        self._warm_queue: Deque[Tuple[Tuple, str, tuple]] = deque()
        self._warm_done: Set[Tuple] = set()
        self._tune_queue: Deque[Tuple[str, tuple]] = deque()
        self._tune_done: Set[Tuple] = set()
        self.tunes_run = 0
        self.rejections: Dict[str, int] = {
            "queue_full": 0,
            "over_budget": 0,
            "draining": 0,
        }
        self._thread: Optional[threading.Thread] = None
        self._stop_flag = False
        self.watchdog_interval = float(watchdog_interval)
        self._state = "running"  # running -> draining (watchdog tripped)
        self._last_error: Optional[ServiceError] = None
        self._last_round_at: Optional[float] = None
        self.queries_failed = 0

    @property
    def service(self) -> CountingService:
        return self._svc

    @property
    def clock(self) -> Clock:
        return self._clock

    # ------------------------------------------------------------------
    # Tenants
    # ------------------------------------------------------------------

    def register_tenant(
        self,
        name: str,
        *,
        priority: int = 0,
        rate_qps: Optional[float] = None,
        burst: Optional[float] = None,
        max_pending: Optional[int] = None,
    ) -> TenantPolicy:
        """Declare a tenant's QoS policy (idempotent only for new names)."""
        policy = TenantPolicy(
            name=name,
            priority=int(priority),
            rate_qps=rate_qps,
            burst=burst,
            max_pending=(
                self.default_max_pending if max_pending is None else int(max_pending)
            ),
        )
        with self._lock:
            if name in self._tenants:
                raise ValueError(f"tenant {name!r} already registered")
            self._tenants[name] = TenantState(
                policy=policy, bucket=policy.make_bucket(self._clock)
            )
            self._tier_rings.setdefault(policy.priority, deque()).append(name)
        return policy

    def _tenant(self, name: str) -> TenantState:
        if name not in self._tenants:
            # unknown tenants get the default policy — submit stays one call
            self.register_tenant(name)
        return self._tenants[name]

    # ------------------------------------------------------------------
    # Submission / cancellation / warming (any thread)
    # ------------------------------------------------------------------

    def submit(
        self, tenant: str, graph_ref: str, templates, **submit_kwargs
    ) -> QueryFuture:
        """Enqueue a query for ``tenant``; returns its future immediately.

        ``submit_kwargs`` go verbatim to :meth:`CountingService.submit`
        (epsilon / delta / iterations / seed / bound / record_rows /
        retry_policy) — except ``deadline=`` (seconds from now), which the
        frontend owns: the clock starts at *this* call, covering queue
        wait as well as execution, and a future whose deadline expires
        while still queued fails with a structured ``kind="deadline"``
        :class:`~repro_torch.serve.resilience.ServiceError` without ever
        entering the service.  Raises :class:`QoSRejected` instead of
        queuing when backpressure applies (see the class docstring) or
        the frontend is draining after a watchdog trip; otherwise never
        blocks on the scheduler.
        """
        with obs.span("repro_torch.serve.submit") as call:
            return self._submit(tenant, graph_ref, templates, submit_kwargs, call.start_ns)

    def _submit(self, tenant: str, graph_ref: str, templates, submit_kwargs,
                called_ns: Optional[int]) -> QueryFuture:
        submit_kwargs.pop("tenant", None)  # stamped by the scheduler
        deadline = submit_kwargs.pop("deadline", None)
        # price the query BEFORE taking the queue slot: resolving templates
        # and planning are pure host work, safe outside the lock
        with obs.span("repro_torch.serve.price"):
            tset = self._svc._resolve_templates(templates)
            est = self._svc.admission_bytes(graph_ref, tset)
        # a round holds the lock through its launch
        with obs.span("repro_torch.serve.lock_wait"):
            self._work.acquire()
        try:
            if self._state == "draining":
                self.rejections["draining"] += 1
                raise QoSRejected(
                    "draining",
                    f"frontend is draining after a scheduler failure: "
                    f"{self._last_error}",
                )
            state = self._tenant(tenant)
            if est > self.admission_budget_bytes:
                self.rejections["over_budget"] += 1
                state.counters["rejected"] += 1
                raise QoSRejected(
                    "over_budget",
                    f"predicted launch residency {est}b exceeds the "
                    f"admission budget {self.admission_budget_bytes}b",
                )
            if state.pending >= state.policy.max_pending:
                self.rejections["queue_full"] += 1
                state.counters["rejected"] += 1
                raise QoSRejected(
                    "queue_full",
                    f"tenant {tenant!r} at max_pending="
                    f"{state.policy.max_pending}",
                )
            fut = QueryFuture(
                self,
                tenant,
                graph_ref,
                tset,
                dict(submit_kwargs),
                est,
                deadline_at=(
                    None if deadline is None else self._clock.now() + float(deadline)
                ),
                submitted_ns=called_ns,
            )
            state.queue.append(fut)
            state.counters["submitted"] += 1
            self._work.notify_all()
        finally:
            self._work.release()
        return fut

    def prewarm(self, graph_ref: str, templates) -> Tuple:
        """Queue a background engine build and warm-up launch; returns the
        engine key.

        De-duplicated by key (graph signature + plan-IR template canons +
        backend/dtype/chunk config): re-warming a warm or already-queued
        key is a no-op.  The work itself runs inside a scheduler round —
        never on this caller's thread.
        """
        tset = self._svc._resolve_templates(templates)
        key = self._svc.engine_key_for(graph_ref, tset)
        with self._work:
            queued = {k for k, _, _ in self._warm_queue}
            if key not in self._warm_done and key not in queued:
                self._warm_queue.append((key, graph_ref, tset))
                self._work.notify_all()
        return key

    def tune(self, graph_ref: str, templates) -> Tuple[str, tuple]:
        """Queue a background autotune for ``(graph_ref, templates)``.

        Like :meth:`prewarm`, the measurement work itself runs inside a
        scheduler round (at most one warm *or* tune task per round), never
        on this caller's thread.  De-duplicated against already-queued and
        already-completed tune tasks.  The service also self-queues tunes
        for unseen workloads when ``REPRO_TUNE=full`` — those drain
        through the same per-round slot.
        """
        tset = self._svc._resolve_templates(templates)
        task = (graph_ref, tset)
        with self._work:
            if task not in self._tune_done and task not in self._tune_queue:
                self._tune_queue.append(task)
                self._work.notify_all()
        return task

    def _cancel(self, fut: QueryFuture) -> bool:
        with self._lock:
            if fut.done():
                return False
            state = self._tenants[fut.tenant]
            if fut._state == "queued":
                try:
                    state.queue.remove(fut)
                except ValueError:  # pragma: no cover - defensive
                    return False
            else:  # admitted: drop it from the service's merge lists
                self._svc.cancel(fut._query)
                self._admitted.remove(fut)
                state.inflight -= 1
                self._inflight_bytes -= fut.admission_bytes
            state.counters["cancelled"] += 1
            self._resolve(fut, "cancelled")
            return True

    # ------------------------------------------------------------------
    # The scheduler (one round per step; single-stepped in tests)
    # ------------------------------------------------------------------

    def step(self) -> Dict:
        """Run ONE scheduler round; returns what it did.

        A round, in order: (1) at most one queued warm task (engine build
        and warm-up launch) OR — when no warm task ran — one queued tune
        task (the port's tuner, from :meth:`tune` or the service's
        ``REPRO_TUNE=full`` self-queue); (2) one admission sweep — priority
        tiers high to low, one query per tenant per round, gated by the
        token bucket and the admission-budget headroom; (3) one service
        launch (``CountingService.step()`` — the engine-key round-robin);
        (4) a completion sweep resolving futures whose queries finished.
        The returned dict (``warmed`` / ``tuned`` / ``admitted`` /
        ``launched`` / ``completed`` / ``failed`` / ``progressed``) is the
        observability record the deterministic tests assert on.

        **Supervision.**  Per-query failures (retries exhausted, ladder
        exhausted, quarantined key, deadline) resolve just that future
        with its structured error — the round continues.  An exception
        that escapes the round itself is a scheduler fault: the watchdog
        fails *every* queued and in-flight future with a
        ``kind="scheduler"`` :class:`ServiceError` (cause + round index),
        transitions the frontend to ``draining`` (submits rejected), and
        re-raises the structured error to the caller / scheduler thread.
        A tune that raises (a probe whose kernel fails to build or launch)
        is such a fault: it trips the scheduler, it is never swallowed.
        """
        with self._lock:
            if self._state == "draining":
                raise ServiceError(
                    "scheduler",
                    "frontend is draining after a scheduler failure",
                    round_index=self._rounds,
                    cause=self._last_error,
                )
            self._rounds += 1
            try:
                with obs.span("repro_torch.serve.round"):
                    return self._step_round()
            except ServiceError:
                raise  # a prior trip re-surfacing; already handled
            except BaseException as exc:
                raise self._trip(exc) from exc

    def _step_round(self) -> Dict:
        """One round's body; runs under the lock, supervised by step()."""
        # ONE fault-checkable clock read per round: the injected-fault
        # harness can skew it (deadline chaos) or raise through it
        # (watchdog-trip drills).  submit()/cancel() timestamps stay on
        # the plain clock — only the scheduler is supervised.
        now = _faults.clock_read(self._clock.now())
        info = {
            "round": self._rounds,
            "warmed": None,
            "tuned": None,
            "admitted": [],
            "launched": None,
            "completed": [],
            "failed": [],
            "progressed": False,
        }

        # deadline sweep over *queued* futures: a query whose deadline
        # passed while waiting for admission fails here, before it can
        # take a service slot it can no longer use
        for state in self._tenants.values():
            expired = [
                f
                for f in state.queue
                if f.deadline_at is not None and now >= f.deadline_at
            ]
            for fut in expired:
                state.queue.remove(fut)
                self._fail_future(
                    fut,
                    ServiceError(
                        "deadline",
                        f"deadline expired before admission "
                        f"(queued {now - fut.submitted_at:.3f}s)",
                        round_index=self._rounds,
                    ),
                )
                info["failed"].append((fut.tenant, "deadline"))

        if self._warm_queue:
            key, graph_ref, tset = self._warm_queue.popleft()
            if key not in self._warm_done:
                with obs.span("repro_torch.serve.warm"):
                    self._svc.prewarm(graph_ref, tset)
                self._warm_done.add(key)
                info["warmed"] = key

        # background autotuning shares the warm slot: at most one heavy
        # off-path task (engine build OR measurement sweep) per round, so
        # admission latency stays bounded while tuning drains
        if info["warmed"] is None:
            if not self._tune_queue:
                pending = self._svc.pop_pending_tune()
                if pending is not None:
                    self._tune_queue.append(pending)
            while self._tune_queue:
                task = self._tune_queue.popleft()
                if task in self._tune_done:
                    continue
                graph_ref, tset = task
                with obs.span("repro_torch.serve.tune"):
                    self._svc.tune(graph_ref, tset)
                self._tune_done.add(task)
                self.tunes_run += 1
                info["tuned"] = (graph_ref, tuple(t.name for t in tset))
                break

        with obs.span("repro_torch.serve.admit"):
            self._admit(now, info)
        with obs.span("repro_torch.serve.launch") as launch:
            info["launched"] = self._svc.step()
        with obs.span("repro_torch.serve.complete"):
            self._complete(info, launch.start_ns)

        self._last_round_at = self._clock.now()
        info["progressed"] = bool(
            info["warmed"] is not None
            or info["tuned"] is not None
            or info["admitted"]
            or info["launched"] is not None
            or info["completed"]
            or info["failed"]
        )
        return info

    def _admit(self, now: float, info: Dict) -> None:
        """The round's admission sweep (caller holds the lock)."""
        for tier in sorted(self._tier_rings, reverse=True):
            ring = self._tier_rings[tier]
            for _ in range(len(ring)):
                name = ring[0]
                ring.rotate(-1)
                state = self._tenants[name]
                if not state.queue:
                    continue
                fut = state.queue[0]
                if (
                    self._inflight_bytes + fut.admission_bytes
                    > self.admission_budget_bytes
                ):
                    continue  # waits for in-flight bytes to retire
                if state.bucket is not None and not state.bucket.try_acquire():
                    continue  # rate-limited: try again next round
                state.queue.popleft()
                kwargs = dict(fut.submit_kwargs)
                if fut.deadline_at is not None:
                    # clocks are aligned (see __init__), so the remaining
                    # frontend budget is the service-relative deadline
                    kwargs["deadline"] = fut.deadline_at - now
                try:
                    fut._query = self._svc.submit(
                        fut.graph_ref,
                        fut.templates,
                        tenant=name,
                        **kwargs,
                    )
                except ServiceError as exc:
                    # per-query rejection (e.g. a quarantined engine key):
                    # fail THIS future; the scheduler itself is healthy
                    self._fail_future(fut, exc)
                    info["failed"].append((name, exc.kind))
                    continue
                fut._state = "admitted"
                fut.admitted_at = self._clock.now()
                fut.admitted_round = self._rounds
                state.inflight += 1
                state.counters["admitted"] += 1
                self._inflight_bytes += fut.admission_bytes
                self._admitted.append(fut)
                info["admitted"].append((name, fut._query.qid))
                if fut._record is not None:
                    fut._record.admit(fut._query.qid)

    def _complete(self, info: Dict, launch_ns: Optional[int]) -> None:
        """The round's completion sweep (caller holds the lock);
        ``launch_ns``: the start of the round's launch, on the profiler's
        clock while tracing is on, the first-launch stamp of each query it
        dealt colorings to for the first time."""
        dealt = self._svc.last_dealt
        still = []
        for fut in self._admitted:
            rec = fut._record
            if rec is not None and rec.launched_ns is None and fut._query.qid in dealt:
                rec.launched_ns = launch_ns
            if fut._query.finished:
                state = self._tenants[fut.tenant]
                state.inflight -= 1
                self._inflight_bytes -= fut.admission_bytes
                if fut._query.failed:
                    state.counters["failed"] += 1
                    fut._error = fut._query.error
                    self.queries_failed += 1
                    self._resolve(fut, "failed")
                    info["failed"].append((fut.tenant, fut._query.error.kind))
                else:
                    state.counters["completed"] += 1
                    self._resolve(fut, "done")
                    info["completed"].append((fut.tenant, fut._query.qid))
            else:
                still.append(fut)
        self._admitted = still

    def _fail_future(self, fut: QueryFuture, error: ServiceError) -> None:
        """Resolve one future as failed (caller holds the lock)."""
        fut._error = error
        self.queries_failed += 1
        state = self._tenants.get(fut.tenant)
        if state is not None:
            state.counters["failed"] += 1
        self._resolve(fut, "failed")

    def _trip(self, exc: BaseException) -> ServiceError:
        """Watchdog: a scheduler-fatal exception escaped a round.

        Every queued and in-flight future is failed with a structured
        ``kind="scheduler"`` error carrying the cause, the engine key (if
        the failure identified one), and the round index; the frontend
        transitions to ``draining`` (submits rejected, rounds refused)
        and the scheduler thread — if any — exits its loop.  Returns the
        error for step() to raise.
        """
        engine_key = getattr(exc, "engine_key", None)
        err = ServiceError(
            "scheduler",
            f"scheduler round {self._rounds} failed: {exc}",
            engine_key=engine_key,
            round_index=self._rounds,
            cause=exc,
        )
        self._last_error = err
        self._state = "draining"
        self._stop_flag = True  # a threaded scheduler exits its loop
        for state in self._tenants.values():
            while state.queue:
                self._fail_future(state.queue.popleft(), err)
        for fut in self._admitted:
            if fut._query is not None and not fut._query.finished:
                self._svc.cancel(fut._query)
            state = self._tenants[fut.tenant]
            state.inflight -= 1
            self._fail_future(fut, err)
        self._admitted = []
        self._inflight_bytes = 0
        self._work.notify_all()
        return err

    def _resolve(self, fut: QueryFuture, state: str) -> None:
        fut._state = state
        fut.resolved_at = self._clock.now()
        fut.resolved_round = self._rounds
        if fut._record is not None:
            fut._record.resolve(state)
        fut._event.set()

    def _unresolved(self) -> int:
        with self._lock:
            queued = sum(len(s.queue) for s in self._tenants.values())
            return queued + len(self._admitted)

    def drain(self, max_rounds: int = 10_000) -> int:
        """Step until every submitted future resolves; returns rounds used.

        Raises ``RuntimeError`` past ``max_rounds`` — with a
        ``ManualClock``, work parked behind a rate limit needs the test to
        ``clock.advance()`` between rounds, and this cap turns a would-be
        hang into a diagnosable failure (the no-deadlock guarantee the
        stress tests lean on).
        """
        rounds = 0
        while self._unresolved():
            self.step()
            rounds += 1
            if rounds >= max_rounds:
                raise RuntimeError(
                    f"drain() still has {self._unresolved()} unresolved "
                    f"futures after {rounds} rounds — rate-limited work "
                    f"with a frozen clock, or a scheduler bug"
                )
        return rounds

    # ------------------------------------------------------------------
    # Threaded mode
    # ------------------------------------------------------------------

    def start(self) -> "ServiceFrontend":
        """Spawn the daemon scheduler thread (idempotent)."""
        with self._lock:
            if self._thread is not None:
                return self
            self._stop_flag = False
            self._thread = threading.Thread(
                target=self._loop, name="repro-torch-serve-frontend", daemon=True
            )
            self._thread.start()
        return self

    def stop(self, timeout: Optional[float] = 10.0) -> None:
        """Stop the scheduler thread (pending work stays queued)."""
        with self._work:
            if self._thread is None:
                return
            self._stop_flag = True
            self._work.notify_all()
        self._thread.join(timeout)
        self._thread = None

    def __enter__(self) -> "ServiceFrontend":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _has_work_locked(self) -> bool:
        return bool(
            self._warm_queue
            or self._tune_queue
            or self._svc._tune_pending
            or self._admitted
            or any(s.queue for s in self._tenants.values())
        )

    def _loop(self) -> None:
        while True:
            with self._work:
                if self._stop_flag:
                    return
                if not self._has_work_locked():
                    self._work.wait(self.poll_interval)
                    continue
            try:
                info = self.step()
            except ServiceError:
                # the watchdog already failed every future and moved the
                # frontend to draining — the thread's job is done; exit
                # cleanly so health() can report thread_alive=False
                return
            if not info["progressed"]:
                # only rate-/budget-parked work: let buckets refill
                with self._work:
                    if self._stop_flag:
                        return
                    self._work.wait(self.poll_interval)

    # ------------------------------------------------------------------
    # Progress & observability
    # ------------------------------------------------------------------

    def _progress(self, fut: QueryFuture) -> List[TemplateProgress]:
        with self._lock:
            q = fut._query
            if q is None:  # not admitted yet: an empty-but-typed snapshot
                status = fut._state  # queued (or cancelled pre-admission)
                return [
                    TemplateProgress(
                        template=t.name,
                        status=status,
                        iterations=0,
                        mean=0.0,
                        std=0.0,
                        halfwidth=float("inf"),
                        halfwidth_normal=float("inf"),
                        halfwidth_bernstein=float("inf"),
                        lower=float("-inf"),
                        upper=float("inf"),
                        converged=False,
                    )
                    for t in fut.templates
                ]
            status = "cancelled" if fut._state == "cancelled" else q.status
            return [
                TemplateProgress(
                    template=t.name,
                    status=status,
                    iterations=q.stopper.iterations,
                    mean=ci.mean,
                    std=ci.std,
                    halfwidth=ci.halfwidth,
                    halfwidth_normal=ci.halfwidth_normal,
                    halfwidth_bernstein=ci.halfwidth_bernstein,
                    lower=ci.lower,
                    upper=ci.upper,
                    converged=ci.converged,
                )
                for t, ci in zip(q.templates, q.progress())
            ]

    def health(self) -> Dict:
        """Liveness + failure snapshot for external supervision.

        ``healthy`` means: not draining, and — when started with pending
        work — the scheduler thread is alive and its last completed round
        is no staler than ``watchdog_interval``.  The rest is the failure
        surface: the last scheduler error, the service's quarantined
        engine keys, and cumulative retry / fault counters.
        """
        with self._lock:
            thread_alive = self._thread is not None and self._thread.is_alive()
            pending = self._unresolved()
            now = self._clock.now()
            stale = bool(
                self._thread is not None
                and pending
                and (
                    self._last_round_at is None
                    or now - self._last_round_at > self.watchdog_interval
                )
            )
            svc_faults = self._svc.stats()["faults"]
            return {
                "state": self._state,
                "healthy": (
                    self._state == "running"
                    and not stale
                    and (self._thread is None or thread_alive)
                ),
                "thread_alive": thread_alive,
                "scheduler_stale": stale,
                "rounds": self._rounds,
                "last_round_at": self._last_round_at,
                "unresolved": pending,
                "queries_failed": self.queries_failed,
                "last_error": (
                    None if self._last_error is None else self._last_error.describe()
                ),
                "quarantined_keys": svc_faults["quarantined_keys"],
                "retries": svc_faults["retries"],
                "fault_counters": {
                    k: svc_faults[k]
                    for k in ("transient", "memory", "deterministic", "non_finite")
                },
            }

    def stats(self) -> Dict:
        """Scheduler + per-tenant + service counters, one snapshot."""
        with self._lock:
            return {
                "rounds": self._rounds,
                "state": self._state,
                "inflight_bytes": self._inflight_bytes,
                "admission_budget_bytes": self.admission_budget_bytes,
                "queries_failed": self.queries_failed,
                "rejections": dict(self.rejections),
                "warm": {
                    "queued": len(self._warm_queue),
                    "completed": len(self._warm_done),
                },
                "tune": {
                    "queued": len(self._tune_queue),
                    "completed": self.tunes_run,
                },
                "tenants": {
                    name: state.describe() for name, state in self._tenants.items()
                },
                "service": self._svc.stats(),
            }


def make_frontend(
    service: Optional[CountingService] = None,
    *,
    manual: bool = False,
    **frontend_kwargs,
) -> ServiceFrontend:
    """Convenience constructor: ``manual=True`` wires a ManualClock.

    With no ``service`` a default :class:`CountingService` is built —
    register graphs via ``frontend.service.register_graph``.
    """
    svc = service if service is not None else CountingService()
    if manual and "clock" not in frontend_kwargs:
        frontend_kwargs["clock"] = ManualClock()
    return ServiceFrontend(svc, **frontend_kwargs)
