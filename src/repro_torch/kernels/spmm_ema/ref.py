"""Plain PyTorch version of the fused SpMM+eMA kernel (two-pass)."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.spmm_blocked.ref import spmm_ref

__all__ = ["spmm_ema_ref"]


def spmm_ema_ref(
    src: torch.Tensor,
    dst: torch.Tensor,
    n: int,
    m_p: torch.Tensor,
    m_a: torch.Tensor,
    idx_a: torch.Tensor,
    idx_p: torch.Tensor,
    col_chunk: Optional[int] = None,
) -> torch.Tensor:
    """Two-pass reference over the fused ``(n, B, C)`` layout.

    Materialises ``Bagg = A_G @ M_p`` (``(n, B, C_p)`` fp32), then
    ``out[:, :, o] = sum_t M_a[:, :, idx_a[o, t]] * Bagg[:, :, idx_p[o, t]]``.
    Per coloring this is ``repro.kernels.spmm_ema.ref.spmm_ema_ref``.
    ``col_chunk`` bounds the SpMM's gather transient (see :func:`spmm_ref`).
    """
    n_, bsz, c_p = m_p.shape
    agg = spmm_ref(src, dst, n, m_p.reshape(n_, bsz * c_p), col_chunk)
    agg = agg.reshape(n_, bsz, c_p)
    m_a = m_a.to(torch.float32)
    idx_a = idx_a.to(device=m_a.device, dtype=torch.long)
    idx_p = idx_p.to(device=m_a.device, dtype=torch.long)
    out = torch.zeros((n_, bsz, idx_a.shape[0]), dtype=torch.float32, device=m_a.device)
    for t in range(idx_a.shape[1]):
        out += m_a.index_select(2, idx_a[:, t]) * agg.index_select(2, idx_p[:, t])
    return out
