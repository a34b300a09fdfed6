"""Failure semantics for the serving layer: structured errors, retry
policies, failure classification, and per-engine-key failure state.

The port of ``repro.serve.resilience``; the pieces (consumed by
:mod:`repro_torch.serve.counting`):

* :class:`ServiceError` — the ONE structured error shape every failed
  query resolves with: a machine-readable ``kind``, the engine key, the
  query id, the scheduler round, and the underlying cause.  Futures raise
  it from ``result()``; ``Query.error`` holds it on the handle.
* :class:`QuarantinedError` — a :class:`ServiceError` subclass raised at
  *submit* time while an engine key is quarantined (fast-fail: no queue
  slot is taken for work that cannot run).
* :class:`RetryPolicy` — per-query knobs for the transient-failure path:
  how many retries, and the exponential backoff the key parks under
  between attempts.
* :func:`classify_failure` — maps an arbitrary exception from the build /
  launch path onto the four failure families the scheduler distinguishes:
  ``transient`` (retry with backoff), ``memory`` (walk the degradation
  ladder), ``invalid`` (the *query* is malformed — fail it, never strike
  the engine key), ``deterministic`` (fail fast, quarantine on repeat).
* :class:`FailState` — the scheduler's per-engine-key bookkeeping:
  consecutive-transient count (drives the backoff exponent), backoff
  parking, deterministic strike count, and the quarantine window with its
  exponential reset.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.testing.faults import DeterministicFault, MemoryFault, TransientFault

__all__ = [
    "ServiceError",
    "QuarantinedError",
    "RetryPolicy",
    "DEFAULT_RETRY_POLICY",
    "classify_failure",
    "FailState",
    "QUARANTINE_STRIKES",
    "DEFAULT_QUARANTINE_BASE_S",
]

#: Consecutive deterministic failures on one engine key before it is
#: quarantined (the first one already fails its queries; the threshold is
#: about protecting the *ring slot*, not the queries).
QUARANTINE_STRIKES = 2

#: First quarantine window (seconds); doubles on every re-quarantine and
#: resets to this base after a clean launch.
DEFAULT_QUARANTINE_BASE_S = 1.0


class ServiceError(RuntimeError):
    """Structured terminal error of a failed query (or a tripped scheduler).

    ``kind`` is machine-readable::

        retries_exhausted | memory_exhausted | deterministic | invalid
        | non_finite | deadline | quarantined | scheduler

    ``engine_key`` / ``qid`` / ``round_index`` locate the failure;
    ``cause`` (also chained as ``__cause__``) is the underlying exception.
    """

    def __init__(
        self,
        kind: str,
        detail: str = "",
        *,
        engine_key: Optional[Tuple] = None,
        qid: Optional[int] = None,
        round_index: Optional[int] = None,
        cause: Optional[BaseException] = None,
    ):
        super().__init__(f"{kind}: {detail}" if detail else kind)
        self.kind = kind
        self.detail = detail
        self.engine_key = engine_key
        self.qid = qid
        self.round_index = round_index
        self.cause = cause
        if cause is not None:
            self.__cause__ = cause

    def describe(self) -> Dict:
        return {
            "kind": self.kind,
            "detail": self.detail,
            "engine_key": self.engine_key,
            "qid": self.qid,
            "round_index": self.round_index,
            "cause": None if self.cause is None else repr(self.cause),
        }


class QuarantinedError(ServiceError):
    """Submit-time fast-fail: the engine key is inside its quarantine
    window (see :class:`FailState`); retry after ``retry_at``."""

    def __init__(self, detail: str, *, engine_key: Tuple, retry_at: float):
        super().__init__("quarantined", detail, engine_key=engine_key)
        self.retry_at = retry_at


@dataclass(frozen=True)
class RetryPolicy:
    """Per-query transient-failure policy.

    A failed launch counts one retry against EVERY query merged into it
    (they all re-run); a query past ``max_retries`` fails with
    ``retries_exhausted`` while its launch-mates keep retrying.  Between
    attempts the engine key parks for ``backoff_base *
    backoff_factor**(consecutive_failures - 1)`` seconds, capped at
    ``max_backoff`` — exponential backoff on the key, so a flapping device
    is not hammered at ring speed.
    """

    max_retries: int = 3
    backoff_base: float = 0.05
    backoff_factor: float = 2.0
    max_backoff: float = 2.0

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {self.max_retries}")
        if self.backoff_base < 0:
            raise ValueError(f"backoff_base must be >= 0, got {self.backoff_base}")
        if self.backoff_factor < 1.0:
            raise ValueError(
                f"backoff_factor must be >= 1, got {self.backoff_factor}"
            )

    def backoff(self, consecutive_failures: int) -> float:
        """Park duration after the ``consecutive_failures``-th failure."""
        if consecutive_failures <= 0:
            return 0.0
        return min(
            self.backoff_base * self.backoff_factor ** (consecutive_failures - 1),
            self.max_backoff,
        )


DEFAULT_RETRY_POLICY = RetryPolicy()

#: Message fragments mapping foreign exceptions (runtime errors that carry
#: their status as text) onto the failure families.
_MEMORY_MARKERS = ("resource_exhausted", "out of memory", "oom", "allocation fail")
_TRANSIENT_MARKERS = ("unavailable", "deadline_exceeded", "connection reset",
                      "transient", "temporarily")


def classify_failure(exc: BaseException) -> str:
    """``transient`` | ``memory`` | ``invalid`` | ``deterministic`` for a
    build/launch exception.

    The injected fault types classify by isinstance, and so does the
    card's allocator failure, ``torch.cuda.OutOfMemoryError`` (memory);
    exceptions carrying a truthy ``invalid_request`` attribute classify as
    ``invalid`` — the *query* can never run, but the engine key is
    healthy, so the scheduler fails it without a deterministic strike and
    quarantine never trips.  Other exceptions classify by status-text
    markers (RESOURCE_EXHAUSTED / UNAVAILABLE in the message).  Anything
    unrecognized is ``deterministic`` — the safe default: fail fast and
    quarantine on repeat rather than retry a failure that will never
    clear.
    """
    if isinstance(exc, TransientFault):
        return "transient"
    if isinstance(exc, MemoryFault):
        return "memory"
    if isinstance(exc, DeterministicFault):
        return "deterministic"
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return "memory"
    if getattr(exc, "invalid_request", False):
        return "invalid"
    msg = str(exc).lower()
    if isinstance(exc, MemoryError) or any(m in msg for m in _MEMORY_MARKERS):
        return "memory"
    if any(m in msg for m in _TRANSIENT_MARKERS):
        return "transient"
    return "deterministic"


@dataclass
class FailState:
    """Per-engine-key failure bookkeeping (scheduler-thread-owned).

    ``consecutive_transient`` drives the backoff exponent and clears on any
    clean launch.  ``strikes`` counts consecutive deterministic failures;
    at :data:`QUARANTINE_STRIKES` the key enters a quarantine window that
    doubles on every re-quarantine (``quarantines`` is the exponent) and
    resets after a clean launch.  Cumulative counters (``retries_total``,
    ``failures_total``) survive resets — they feed ``stats()``/``health()``.
    """

    consecutive_transient: int = 0
    parked_until: float = 0.0
    strikes: int = 0
    quarantines: int = 0
    quarantined_until: float = 0.0
    ladder_rung: int = 0
    ladder_log: List[Dict] = field(default_factory=list)
    retries_total: int = 0
    failures_total: int = 0

    def blocked_until(self, now: float) -> Optional[float]:
        """The time this key becomes schedulable again, or None if it
        already is."""
        until = max(self.parked_until, self.quarantined_until)
        return until if until > now else None

    def note_transient(self, now: float, policy: RetryPolicy) -> float:
        """Record a transient failure; returns when the key unparks."""
        self.consecutive_transient += 1
        self.failures_total += 1
        self.parked_until = now + policy.backoff(self.consecutive_transient)
        return self.parked_until

    def note_deterministic(
        self, now: float, base_s: float = DEFAULT_QUARANTINE_BASE_S
    ) -> Optional[float]:
        """Record a deterministic failure; returns the quarantine deadline
        when this strike triggers one (else None)."""
        self.strikes += 1
        self.failures_total += 1
        if self.strikes < QUARANTINE_STRIKES:
            return None
        self.strikes = 0
        self.quarantines += 1
        self.quarantined_until = now + base_s * 2.0 ** (self.quarantines - 1)
        return self.quarantined_until

    def note_memory(self) -> None:
        self.failures_total += 1

    def note_success(self) -> None:
        """A clean launch clears every *consecutive* counter (the ladder
        rung is deliberately sticky — a config that fit stays)."""
        self.consecutive_transient = 0
        self.strikes = 0
        self.quarantines = 0
        self.parked_until = 0.0
        self.quarantined_until = 0.0

    def describe(self, now: float) -> Dict:
        return {
            "consecutive_transient": self.consecutive_transient,
            "parked_for_s": max(0.0, self.parked_until - now),
            "strikes": self.strikes,
            "quarantines": self.quarantines,
            "quarantined_for_s": max(0.0, self.quarantined_until - now),
            "ladder_rung": self.ladder_rung,
            "retries_total": self.retries_total,
            "failures_total": self.failures_total,
        }
