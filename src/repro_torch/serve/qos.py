"""Clock seam and per-tenant QoS primitives of the serving layer.

The port of ``repro.serve.qos``.  Everything here is *clock-injected*: the
counting service and the front-end scheduler
(:mod:`repro_torch.serve.frontend`) never read wall time directly — they
ask the :class:`Clock` they were constructed with.  Production uses
:class:`SystemClock` (monotonic); the deterministic test harness uses
:class:`ManualClock` and advances time explicitly, so deadlines, retry
backoff, quarantine windows, rate limits and bucket refills are all
single-steppable with zero sleeps.

The QoS layers above the clock:

* :class:`TokenBucket` — ``rate_qps`` tokens per second refill up to
  ``burst`` capacity; an admission consumes one token.  Refill is lazy
  (computed from the clock on each inspection), so the bucket has no
  thread of its own.
* :class:`TenantPolicy` — the declarative per-tenant knobs: ``priority``
  tier (higher tiers admit first each scheduler round), ``rate_qps`` /
  ``burst`` (token bucket; ``None`` = unlimited), and ``max_pending``
  (queue cap — submissions beyond it are rejected with backpressure).
* :class:`TenantState` — the scheduler's live bookkeeping for one tenant:
  the FIFO of not-yet-admitted submissions, the bucket, and counters
  (submitted / admitted / completed / cancelled / failed / rejected)
  surfaced by ``frontend.stats()``.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, Optional

__all__ = [
    "Clock",
    "SystemClock",
    "ManualClock",
    "TokenBucket",
    "TenantPolicy",
    "TenantState",
    "DEFAULT_MAX_PENDING",
]

#: Default per-tenant queue cap (queued + in-flight) before submissions are
#: rejected with ``queue_full`` backpressure.
DEFAULT_MAX_PENDING = 64


class Clock:
    """Time source seam: the service only ever calls :meth:`now`."""

    def now(self) -> float:  # pragma: no cover - interface
        raise NotImplementedError


class SystemClock(Clock):
    """Monotonic wall clock (production default)."""

    def now(self) -> float:
        return time.monotonic()


class ManualClock(Clock):
    """Explicitly-advanced clock for deterministic service tests.

    ``now()`` returns the last value set; nothing moves until the test
    calls :meth:`advance`.  Never sleeps, never drifts.
    """

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def now(self) -> float:
        return self._now

    def advance(self, seconds: float) -> float:
        if seconds < 0:
            raise ValueError(f"cannot advance time backwards ({seconds})")
        self._now += float(seconds)
        return self._now


class TokenBucket:
    """Lazy-refill token bucket driven by an injected clock.

    ``rate`` tokens accrue per clock-second up to ``burst`` capacity; the
    bucket starts full (a fresh tenant can burst immediately).  All state
    changes happen inside the caller's lock — the bucket itself is not
    thread-safe and does not need to be.
    """

    def __init__(self, rate: float, burst: float, clock: Clock):
        if rate <= 0:
            raise ValueError(f"rate must be positive, got {rate}")
        if burst < 1:
            raise ValueError(f"burst must be >= 1, got {burst}")
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self._tokens = float(burst)
        self._last = clock.now()

    def _refill(self) -> None:
        now = self._clock.now()
        if now > self._last:
            self._tokens = min(self.burst, self._tokens + (now - self._last) * self.rate)
        self._last = now

    def available(self) -> float:
        """Current token balance (after lazy refill)."""
        self._refill()
        return self._tokens

    def try_acquire(self, tokens: float = 1.0) -> bool:
        """Consume ``tokens`` if the balance allows; never blocks."""
        self._refill()
        if self._tokens + 1e-9 >= tokens:
            self._tokens -= tokens
            return True
        return False


@dataclass(frozen=True)
class TenantPolicy:
    """Declarative QoS knobs for one tenant.

    ``priority``: higher tiers are offered admission first every scheduler
    round (within a tier tenants round-robin, so a flooding tenant cannot
    starve its peers).  ``rate_qps``/``burst``: token-bucket admission rate
    (``None`` disables the bucket).  ``max_pending``: hard cap on queued +
    in-flight queries; beyond it :meth:`ServiceFrontend.submit` rejects
    with ``queue_full``.
    """

    name: str
    priority: int = 0
    rate_qps: Optional[float] = None
    burst: Optional[float] = None
    max_pending: int = DEFAULT_MAX_PENDING

    def make_bucket(self, clock: Clock) -> Optional[TokenBucket]:
        if self.rate_qps is None:
            return None
        burst = self.burst if self.burst is not None else max(1.0, self.rate_qps)
        return TokenBucket(self.rate_qps, burst, clock)


@dataclass
class TenantState:
    """Live scheduler bookkeeping for one tenant (guarded by the
    front-end lock)."""

    policy: TenantPolicy
    bucket: Optional[TokenBucket]
    queue: Deque = field(default_factory=deque)  # not-yet-admitted futures
    inflight: int = 0  # admitted, not yet resolved
    counters: Dict[str, int] = field(
        default_factory=lambda: {
            "submitted": 0,
            "admitted": 0,
            "completed": 0,
            "cancelled": 0,
            "failed": 0,
            "rejected": 0,
        }
    )

    @property
    def pending(self) -> int:
        """Queued + in-flight load counted against ``max_pending``."""
        return len(self.queue) + self.inflight

    def describe(self) -> Dict:
        return {
            "priority": self.policy.priority,
            "rate_qps": self.policy.rate_qps,
            "max_pending": self.policy.max_pending,
            "queued": len(self.queue),
            "inflight": self.inflight,
            "tokens": None if self.bucket is None else self.bucket.available(),
            **self.counters,
        }
