"""Milliseconds the client's ``ServiceFrontend.submit`` call blocks, on
average over the window's queries (the host's clock around each call): a
submit waits for the lock that a service round holds through its launch."""


def read(ctx):
    mean_s = ctx.counters.get("submit_s_mean")
    if mean_s is None:
        return None
    return 1e3 * mean_s
