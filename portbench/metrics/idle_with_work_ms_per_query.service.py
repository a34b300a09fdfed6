"""Milliseconds per completed query in which the device was idle while at
least one query was in the service: the window's device gaps (between the
kernels, copies and sets of the trace, ``ctx.trace.device_events``)
intersected with the union of the queries' lives, from submitted to
resolved (the program's own records, ``repro_torch.obs.requests()``, on the
trace's clock), summed, over the queries the window completed.  Idle time
with no query in the service is the wait for arrivals and is left out.
Nothing where the program keeps no such record."""

import bisect


def _union(intervals):
    out = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def read(ctx):
    try:
        from repro_torch import obs
    except ImportError:
        return None
    done = ctx.counters.get("queries_completed")
    lives = [(r.submitted_ns, r.resolved_ns) for r in obs.requests() if r.resolved_ns is not None]
    if ctx.trace is None or ctx.trace.busy_s <= 0 or not done or not lives:
        return None
    busy = _union((d.start_ns, d.end_ns) for d in ctx.trace.device_events)
    ends = [b1 for _, b1 in busy]
    idle_ns = 0
    for s, t in _union(lives):
        idle_ns += t - s
        i = bisect.bisect_right(ends, s)  # the first busy stretch that ends after s
        while i < len(busy) and busy[i][0] < t:
            idle_ns -= min(t, busy[i][1]) - max(s, busy[i][0])
            i += 1
    return idle_ns / 1e6 / done
