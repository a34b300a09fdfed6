"""Plain PyTorch version of the blocked SpMM kernel."""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["spmm_ref"]


def spmm_ref(
    src: torch.Tensor,
    dst: torch.Tensor,
    n: int,
    m: torch.Tensor,
    col_chunk: Optional[int] = None,
) -> torch.Tensor:
    """``B[i] = sum_{j in N(i)} M[j]`` for ``M`` of shape ``(n, C)``.

    Gather + ``index_add_`` over the edge list, in fp32.  ``col_chunk``
    bounds the ``(|E|, col_chunk)`` gather transient: on a large graph the
    whole ``(|E|, C)`` gather would not fit on the card.
    """
    m = m.to(torch.float32)
    c = m.shape[1]
    out = torch.zeros((n, c), dtype=torch.float32, device=m.device)
    step = c if not col_chunk else int(col_chunk)
    for lo in range(0, c, max(step, 1)):
        hi = min(c, lo + step)
        out[:, lo:hi].index_add_(0, dst, m[src, lo:hi])
    return out
