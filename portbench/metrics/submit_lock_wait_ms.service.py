"""Milliseconds a ``ServiceFrontend.submit`` call waits for the scheduler's
lock, which a round holds through its launch: the program's
``repro_torch.serve.lock_wait`` spans summed over its
``repro_torch.serve.submit`` spans, on average per submit.  The rest of
``submit_block_ms.service`` is pricing (``repro_torch.serve.price``) and
queueing.  Nothing where the program records no such spans."""


def read(ctx):
    try:
        from repro_torch import obs
    except ImportError:
        return None
    submits = obs.spans("repro_torch.serve.submit")
    if not submits:
        return None
    return sum(s.host_ms for s in obs.spans("repro_torch.serve.lock_wait")) / len(submits)
