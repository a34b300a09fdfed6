"""Device seconds per query: the window's device busy time (the union of
its kernels, copies and sets, from the trace) over the queries the service
completed there.  At a fixed open-loop rate the idle share mostly measures
the wait for arrivals; this falls when the device does less per query."""


def read(ctx):
    done = ctx.counters.get("queries_completed")
    if ctx.trace is None or ctx.trace.busy_s <= 0 or not done:
        return None
    return ctx.trace.busy_s / done
