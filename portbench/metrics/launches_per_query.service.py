"""Engine launches the service made in the window
(``CountingService.stats()["launches"]``) per query it completed there
(``queries_completed``)."""


def read(ctx):
    done = ctx.counters.get("queries_completed")
    if not done:
        return None
    return ctx.counters["service_launches"] / done
