"""The memory model's error: the engine's predicted bytes of one chunk
(``CountingEngine.predicted_peak_bytes``) over what the window allocated
beyond the bytes live when it began (the allocator's peak in the window
less ``memory_allocated`` at its start)."""


def read(ctx):
    measured = ctx.counters.get("window_temp_bytes")
    predicted = ctx.counters.get("predicted_peak_bytes")
    if not measured or not predicted:
        return None
    return predicted / measured
