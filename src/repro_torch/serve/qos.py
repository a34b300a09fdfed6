"""Clock seam of the serving layer.

The clock classes of ``repro.serve.qos``.  The counting service reads time
through the :class:`Clock` it was constructed with and never reads wall
time directly.  Production uses :class:`SystemClock` (monotonic); the
deterministic test harness uses :class:`ManualClock` and advances time
explicitly, so deadlines, retry backoff and quarantine windows are
single-steppable with zero sleeps.  The reference module's per-tenant
token buckets and policies come with the asynchronous front-end that uses
them (ROADMAP queue 1 item 8).
"""

from __future__ import annotations

import time

__all__ = [
    "Clock",
    "SystemClock",
    "ManualClock",
]


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
