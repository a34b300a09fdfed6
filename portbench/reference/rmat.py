"""R-MAT graphs from a seed, made on the device in a few large calls.

The recursive-matrix generator of Chakrabarti et al. (2004) with Graph500's
Kronecker initiator by default: each of ``num_edges`` sampled edges descends
``ceil(log2 n)`` levels, at each level taking the quadrant ``(0, 0)`` with
probability ``a``, ``(1, 0)`` with ``b``, ``(0, 1)`` with ``c`` and
``(1, 1)`` with the rest.  Self-loops go, duplicates merge, and both
directions of every undirected edge are kept, sorted by ``(dst, src)``: the
canonical edge list the counting engine takes.  The same seed gives the same
graph on the same device.
"""

from __future__ import annotations

import math

import torch


def rmat_edges(n: int, num_edges: int, seed: int, a: float = 0.57, b: float = 0.19,
               c: float = 0.19, device=None):
    """``(src, dst)`` int32 tensors on ``device``, both directions of every
    undirected edge, sorted by ``(dst, src)``."""
    device = torch.device(device) if device is not None else torch.device("cpu")
    scale = max(1, math.ceil(math.log2(max(n, 2))))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2**63))
    r = torch.rand((scale, num_edges), generator=gen, device=device, dtype=torch.float64)
    down = ((r >= a) & (r < a + b)) | (r >= a + b + c)
    right = r >= a + b
    weights = (1 << torch.arange(scale - 1, -1, -1, device=device, dtype=torch.int64))[:, None]
    u = (down.to(torch.int64) * weights).sum(0) % n
    v = (right.to(torch.int64) * weights).sum(0) % n
    del r, down, right
    keep = u != v
    u, v = u[keep], v[keep]
    lo, hi = torch.minimum(u, v), torch.maximum(u, v)
    und = torch.unique(lo * n + hi)
    lo, hi = und // n, und % n
    src = torch.cat([lo, hi])
    dst = torch.cat([hi, lo])
    order = torch.argsort(dst * n + src)
    return src[order].to(torch.int32), dst[order].to(torch.int32)
