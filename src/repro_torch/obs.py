"""Spans and per-query records inside the port, on the profiler's clock.

Tracing is on exactly while a ``torch.profiler`` session records anywhere in
the process, on every thread, those started before the session included
(the service front-end's scheduler thread).  Nothing turns it on but the
profiler.  While it is off, :func:`span` and :func:`request` read one flag
and return: no ``record_function``, no clock read, no record.

While it is on:

* a :class:`Span` records its name, start and end, the span open on its
  thread when it began (``parent``), and a plan address where the caller
  has one.  On a thread whose host ops the profiler records, it
  also enters ``record_function``, so its name shows in the profiler's own
  trace.  A span given a CUDA ``device`` also records a pair of timing
  events on that device's current stream; its :attr:`Span.device_ms` is
  worked out when read, after the traced window.
* a :class:`Request` is one query's life: submitted, admitted (with its
  ``qid``), first launched, resolved.  Spans carry no ``qid``: a service
  launch serves every query its chunk was dealt to.

Every stamp is ``time.time_ns()``: the profiler converts its own clock to
Unix-epoch nanoseconds, so a record lines up with the trace's host and
device events (``KinetoEvent.start_ns()``).  Records live in memory, in the
buffer of the session that was recording when they began: one buffer per
process, as the profiler's session is one per process.  Each session starts
a fresh one, and :func:`spans` / :func:`requests` read the latest, also
after it has stopped.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import List, Optional, Tuple

import torch
import torch.autograd.profiler as _profiler

__all__ = ["Span", "Request", "span", "request", "spans", "requests"]


class _Session:
    """What one profiling session recorded: spans as they closed, queries
    as they were submitted."""

    def __init__(self):
        self.spans: List[Span] = []
        self.requests: List[Request] = []


_session = _Session()
_ids = itertools.count(1)
_local = threading.local()


def _start_session(start=_profiler._run_on_profiler_start):
    """Runs as every profiling session starts (torch calls it, on the thread
    that starts the session, just before the profiler records)."""
    global _session
    _session = _Session()
    start()


# torch calls its start hook by the module's name for it at every session
# start; wrap it once, however often this module is imported
if not getattr(_profiler._run_on_profiler_start, "_repro_torch_obs", False):
    _start_session._repro_torch_obs = True
    _profiler._run_on_profiler_start = _start_session


class Span:
    """One timed piece of work; a context manager, made by :func:`span`."""

    __slots__ = ("name", "id", "parent", "address", "start_ns", "end_ns", "_events", "_rf",
                 "_buffer")

    def __init__(self, name: str, address: Optional[Tuple[int, int]] = None, events=None):
        self.name = name
        self.id = next(_ids)
        self.address = address
        self.parent: Optional[int] = None
        self.start_ns: Optional[int] = None
        self.end_ns: Optional[int] = None
        self._events = events
        self._rf = None
        self._buffer = _session

    def __enter__(self) -> "Span":
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1].id if stack else None
        stack.append(self)
        if torch._C._autograd._profiler_enabled():  # this thread's host ops are traced
            self._rf = _profiler.record_function(self.name)
            self._rf.__enter__()
        if self._events is not None:
            self._events[0].record(self._events[2])
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.time_ns()
        if self._events is not None:
            self._events[1].record(self._events[2])
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        _local.stack.pop()
        self._buffer.spans.append(self)
        return False

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    @property
    def device_ms(self) -> Optional[float]:
        """Milliseconds between the span's two events on its stream; waits
        for the second.  ``None`` for a span that timed no device."""
        if self._events is None or self.end_ns is None:
            return None
        self._events[1].synchronize()
        return self._events[0].elapsed_time(self._events[1])


class _Off:
    """The span handed out while tracing is off: it does nothing."""

    start_ns = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, device: Optional[torch.device] = None,
         address: Optional[Tuple[int, int]] = None):
    """A span named ``name`` (``repro_torch.<layer>.<what>``), for ``with``.
    ``device``: time the work queued inside it on that device too (CUDA
    only).  ``address``: its ``(plan, sub)`` place in an engine's plan."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    events = None
    if device is not None and device.type == "cuda":
        events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True),
                  torch.cuda.current_stream(device))
    return Span(name, address, events)


class Request:
    """One query's stamps, made by :func:`request` when it is submitted."""

    __slots__ = ("tenant", "qid", "submitted_ns", "admitted_ns", "launched_ns",
                 "resolved_ns", "state")

    def __init__(self, tenant: str, submitted_ns: Optional[int] = None):
        self.tenant = tenant
        self.qid: Optional[int] = None
        self.submitted_ns = time.time_ns() if submitted_ns is None else submitted_ns
        self.admitted_ns: Optional[int] = None
        self.launched_ns: Optional[int] = None  # the start of its first launch
        self.resolved_ns: Optional[int] = None
        self.state: Optional[str] = None  # done | failed | cancelled

    def admit(self, qid: int) -> None:
        self.qid = qid
        self.admitted_ns = time.time_ns()

    def resolve(self, state: str) -> None:
        self.state = state
        self.resolved_ns = time.time_ns()


def request(tenant: str, submitted_ns: Optional[int] = None) -> Optional[Request]:
    """A new query's record, or ``None`` while tracing is off.
    ``submitted_ns``: when the query was handed in, if not now."""
    if not _profiler._is_profiler_enabled:
        return None
    rec = Request(tenant, submitted_ns)
    _session.requests.append(rec)
    return rec


def spans(name: Optional[str] = None) -> List[Span]:
    """The latest session's closed spans, those named ``name`` alone if
    given."""
    return [s for s in _session.spans if name is None or s.name == name]


def requests() -> List[Request]:
    """The latest session's query records."""
    return list(_session.requests)
