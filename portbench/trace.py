"""The device trace of a measured window, and what the readers take from it.

``torch.profiler`` with CPU and CUDA activities over the window; the
benchmark's own ``record_function`` spans name what the host was doing
(``portbench.window`` brackets the window).  From the raw events: the
device's busy seconds (the union of its kernels, copies and sets inside the
window), device seconds by operation name, and the window's idle gaps,
labelled by the innermost host event that covers each gap.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

WINDOW_SPAN = "portbench.window"

#: gaps labelled for the breakdown, longest first
LABELLED_GAPS = 2000
#: host events walked back from a gap before it is called unlabelled
LABEL_WALK = 4000


@dataclass
class DeviceEvent:
    name: str
    start_ns: int
    end_ns: int


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    device_events: List[DeviceEvent]  # inside the window, in start order
    seconds_by_name: Dict[str, float]
    idle_by_host: List[Tuple[str, float]] = field(default_factory=list)

    def top_ops(self, count: int = 10) -> List[List]:
        ops = sorted(self.seconds_by_name.items(), key=lambda kv: kv[1], reverse=True)
        return [[name, sec] for name, sec in ops[:count]]


#: host events of the profiler itself, which name no work of the run
PROFILER_EVENTS = ("Activity Buffer Request",)


def _events(prof):
    """``(name, is_device, start_ns, end_ns)`` for every event but the
    profiler's own and the device-side copies of host spans (user
    annotations, which cover the span's whole length and no work)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        is_device = str(e.device_type()).endswith("CUDA")
        annotation = getattr(e, "is_user_annotation", None)  # not in every release
        if name in PROFILER_EVENTS or (is_device and (
                name.startswith("portbench.") or (annotation is not None and annotation()))):
            continue
        start = e.start_ns()
        out.append((name, is_device, start, start + e.duration_ns()))
    return out


def summarize(prof) -> Optional[TraceSummary]:
    """The window's summary, or ``None`` when the trace has no window span."""
    events = _events(prof)
    spans = [(s, t) for name, dev, s, t in events if not dev and name == WINDOW_SPAN]
    if not spans:
        return None
    w0, w1 = spans[0]
    device = sorted(
        (DeviceEvent(name, max(s, w0), min(t, w1))
         for name, dev, s, t in events if dev and t > w0 and s < w1),
        key=lambda d: d.start_ns)
    by_name: Dict[str, float] = {}
    busy_ns, gaps = 0, []
    cursor = w0
    for d in device:
        by_name[d.name] = by_name.get(d.name, 0.0) + (d.end_ns - d.start_ns) / 1e9
        if d.start_ns > cursor:
            gaps.append((cursor, d.start_ns))
        if d.end_ns > cursor:
            busy_ns += d.end_ns - max(cursor, d.start_ns)
            cursor = d.end_ns
    if w1 > cursor:
        gaps.append((cursor, w1))
    host = sorted(((s, t, name) for name, dev, s, t in events
                   if not dev and name != WINDOW_SPAN), key=lambda h: h[0])
    starts = [h[0] for h in host]
    idle: Dict[str, float] = {}
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:LABELLED_GAPS]:
        mid = (g0 + g1) // 2
        label = "host outside any traced op"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(-1, i - LABEL_WALK), -1):
            if host[j][1] >= mid:
                label = host[j][2]
                break
        idle[label] = idle.get(label, 0.0) + (g1 - g0) / 1e9
    return TraceSummary(
        window_s=(w1 - w0) / 1e9,
        busy_s=busy_ns / 1e9,
        device_events=device,
        seconds_by_name=by_name,
        idle_by_host=sorted(idle.items(), key=lambda kv: kv[1], reverse=True),
    )


#: kernel A (``spmm_ema``) and kernel B (``spmm_blocked``) by device kernel
#: name; both libraries carry the heavy-row kernels of ``edge_walk.cuh``
KERNEL_A_NAMES = ("spmm_ema_kernel", "wide_aggregate_kernel", "wide_ema_kernel")
KERNEL_B_NAMES = ("spmm_blocked_kernel",)


def counting_kernel_seconds(events: List[DeviceEvent]) -> Dict[str, float]:
    """Device seconds of kernels A and B.  Kernel A issues its heavy rows'
    segments and reduction before its main kernel; kernel B issues its
    reduction right after its main kernel, so a reduction belongs to B when
    the event before it on the device is B's."""
    out = {"A": 0.0, "B": 0.0}
    previous = None
    for ev in events:
        owner = None
        if any(k in ev.name for k in KERNEL_A_NAMES) or "heavy_segments_kernel" in ev.name:
            owner = "A"
        elif any(k in ev.name for k in KERNEL_B_NAMES):
            owner = "B"
        elif "heavy_reduce_kernel" in ev.name:
            owner = "B" if previous == "B" else "A"
        if owner is not None:
            out[owner] += (ev.end_ns - ev.start_ns) / 1e9
        previous = owner
    return out


def profiler():
    """A profiler of host ops and device activity, started by ``with``."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
