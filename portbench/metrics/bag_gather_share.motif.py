"""The share of the window's device busy time in gathers (``index_select``
and gather kernels, by device kernel name), the bag stages' per-term
operand reads."""

from portbench.trace import KERNEL_A_NAMES, KERNEL_B_NAMES


def is_gather(name):
    low = name.lower()
    if any(k in name for k in KERNEL_A_NAMES + KERNEL_B_NAMES) or "heavy_" in low:
        return False
    return "index" in low or "gather" in low


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    seconds = sum(s for name, s in ctx.trace.seconds_by_name.items() if is_gather(name))
    if seconds <= 0:
        return None
    return 100.0 * seconds / ctx.trace.busy_s
