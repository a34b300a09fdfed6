"""Colorings launched for padding per completed query: every service launch
carries its engine's whole chunk, so the slots launched in the window (its
launches by engine key, ``CountingService.stats()["launches_by_key"]``,
times each engine's ``chunk_size``) less the colorings the completed
queries asked for, over those queries.  Nothing where an engine that
launched was evicted before it could be read."""


def read(ctx):
    done = ctx.counters.get("queries_completed")
    padded = ctx.counters.get("padded_colorings")
    if not done or padded is None:
        return None
    return padded / done
