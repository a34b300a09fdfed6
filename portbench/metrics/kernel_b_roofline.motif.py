"""Kernel B's share of its roofline over the window's bag-stage products.

The least time for the adjacency products of every chunk the window launched
(one per distinct bag extend with an eliminated neighbour,
:func:`portbench.shapes.bag_product_widths`, priced by
:func:`portbench.roofline.bag_chunk_bound_s` at the chunk's colorings) over
kernel B's device seconds in the trace.
"""

from portbench.roofline import bag_chunk_bound_s
from portbench.shapes import bag_product_widths
from portbench.trace import counting_kernel_seconds


def read(ctx):
    if ctx.trace is None or not ctx.chunks:
        return None
    seconds = counting_kernel_seconds(ctx.trace.device_events)["B"]
    widths = bag_product_widths(ctx.templates, ctx.n)
    if seconds <= 0 or not widths:
        return None
    least = ctx.chunks * bag_chunk_bound_s(widths, ctx.n, ctx.e, ctx.chunk_size)
    return 100.0 * least / seconds
