"""Kernel A's wide route against its roofline.

The least time for the wide stages of every chunk the window launched (the
stages of :func:`portbench.shapes.tree_stages` whose row, ``C_p + C_a``
floats, passes the shared-memory path's budget, each priced by
:func:`portbench.roofline.fused_stage_work` at the chunk's colorings) over
the device seconds of what the wide route launches (:func:`wide_seconds`).
The budget is frozen here at 112 KiB of floats, the program's when this
metric was made, so that a change to the program's budget cannot move the
stages this yardstick prices.
"""

from portbench.roofline import bound_s, fused_stage_work
from portbench.shapes import tree_stages

#: a row's floats past which a stage takes kernel A's wide route (112 KiB)
WIDE_ROW_FLOATS = 28_672
#: the wide route's fill and eMA kernels
WIDE_NAMES = ("wide_aggregate_kernel", "wide_ema_kernel")
#: what kernel A issues for its heavy rows before its main kernels
HEAVY_NAMES = ("heavy_segments_kernel", "heavy_reduce_kernel")
#: the main kernels of kernel A's shared-memory route and of kernel B
OTHER_NAMES = ("spmm_ema_kernel", "spmm_blocked_kernel")


def wide_seconds(events) -> float:
    """Device seconds of the wide route's launches: every fill and eMA
    kernel, and the heavy rows' segments and reduction that a launch issues
    before them.  Heavy kernels before a shared-route or kernel B launch,
    and the reduction kernel B issues right after its main kernel, are not
    the wide route's."""
    total, pending, previous = 0.0, 0.0, None
    for ev in events:
        seconds = (ev.end_ns - ev.start_ns) / 1e9
        if any(k in ev.name for k in WIDE_NAMES):
            total += pending + seconds
            pending, previous = 0.0, "wide"
        elif any(k in ev.name for k in OTHER_NAMES):
            pending = 0.0
            previous = "B" if "spmm_blocked_kernel" in ev.name else "A"
        elif any(k in ev.name for k in HEAVY_NAMES):
            if not ("heavy_reduce_kernel" in ev.name and previous == "B"):
                pending += seconds
            previous = "heavy"
    return total


def read(ctx):
    if ctx.trace is None or not ctx.chunks:
        return None
    stages = [st for st in tree_stages(ctx.templates) if st.c_p + st.c_a > WIDE_ROW_FLOATS]
    seconds = wide_seconds(ctx.trace.device_events)
    if seconds <= 0 or not stages:
        return None
    least = sum(bound_s(*fused_stage_work(st, ctx.n, ctx.e, ctx.chunk_size))[0] for st in stages)
    return 100.0 * ctx.chunks * least / seconds
