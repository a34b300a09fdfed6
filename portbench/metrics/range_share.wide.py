"""The range shift's share of the device's busy time: the device seconds
of the program's ``repro_torch.engine.range`` spans (a pair of CUDA events
around each chunk's leaf scale and its float64 assembly,
``repro_torch.obs``) over the window's device busy seconds
(``ctx.trace.busy_s``).  Nothing where the program records no such spans or
they timed no device."""


def read(ctx):
    try:
        from repro_torch import obs
    except ImportError:
        return None
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    ms = [s.device_ms for s in obs.spans("repro_torch.engine.range")]
    ms = [m for m in ms if m is not None]
    if not ms:
        return None
    return 100.0 * sum(ms) / 1e3 / ctx.trace.busy_s
