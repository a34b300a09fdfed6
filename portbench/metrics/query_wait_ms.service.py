"""Milliseconds a query waits before its first launch: over the window's
completed queries, the mean of first launch less submitted, from the
program's own record of each query (``repro_torch.obs.requests()``, stamped
while the profiler records).  Submitted is when ``submit`` was called, so
the wait holds pricing and the wait for the scheduler's lock
(``submit_lock_wait_ms.service``) as well as the queue.  Nothing where the
program keeps no such record."""


def read(ctx):
    try:
        from repro_torch import obs
    except ImportError:
        return None
    waits = [r.launched_ns - r.submitted_ns for r in obs.requests()
             if r.state == "done" and r.launched_ns is not None]
    if not waits:
        return None
    return sum(waits) / len(waits) / 1e6
