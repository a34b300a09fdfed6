"""Kernel A's share of its roofline over the window's tree stages.

The least time for the fused stages of every chunk the window launched (the
stages of :func:`portbench.shapes.tree_stages`, priced by
:func:`portbench.roofline.tree_chunk_bound_s` at the chunk's colorings) over
kernel A's device seconds in the trace (:func:`portbench.trace.
counting_kernel_seconds`).
"""

from portbench.roofline import tree_chunk_bound_s
from portbench.shapes import tree_stages
from portbench.trace import counting_kernel_seconds


def read(ctx):
    if ctx.trace is None or not ctx.chunks:
        return None
    seconds = counting_kernel_seconds(ctx.trace.device_events)["A"]
    stages = tree_stages(ctx.templates)
    if seconds <= 0 or not stages:
        return None
    least = ctx.chunks * tree_chunk_bound_s(stages, ctx.n, ctx.e, ctx.chunk_size)
    return 100.0 * least / seconds
