"""Plain PyTorch version of the flash-attention kernels (the CPU path and the
card's yardstick)."""

from __future__ import annotations

import math

import torch

__all__ = ["attention_ref", "flash_attention_ref", "to_bh"]


def attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True, q_chunk: int = 1024
) -> torch.Tensor:
    """(bh, sq, d) x (bh, sk, d) x (bh, sk, dv) -> (bh, sq, dv), fp32 softmax.

    Causal masking is top-left aligned (query ``i`` sees keys ``j <= i``).
    Queries go ``q_chunk`` rows at a time, so the fp32 scores of a chunk
    are ``(bh, q_chunk, sk)``; a causal chunk reads only the keys its last
    row can see (the others would carry weight exactly 0).
    """
    bh, sq, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    kf, vf = k.float(), v.float()
    out = torch.empty((bh, sq, v.shape[-1]), dtype=q.dtype, device=q.device)
    for r0 in range(0, sq, q_chunk):
        r1 = min(sq, r0 + q_chunk)
        kk = min(sk, r1) if causal else sk
        s = torch.matmul(q[:, r0:r1].float(), kf[:, :kk].transpose(1, 2)) * scale
        if causal:
            rows = torch.arange(r0, r1, device=q.device)[:, None]
            s = s.masked_fill(rows < torch.arange(kk, device=q.device)[None, :], -1e30)
        out[:, r0:r1] = torch.matmul(torch.softmax(s, dim=-1), vf[:, :kk]).to(q.dtype)
    return out


def to_bh(x: torch.Tensor, group: int) -> torch.Tensor:
    """(b, s, n, d) -> (b·n·group, s, d) in one copy: head ``j`` of the
    result is head ``j // group`` of ``x`` (the GQA repeat)."""
    b, s, n, d = x.shape
    return x.transpose(1, 2).unsqueeze(2).expand(b, n, group, s, d).reshape(b * n * group, s, d)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """The plain version in the wrapper's layout: ``q (b, sq, h, d)``, ``k, v
    (b, sk, h_kv, d)`` -> ``(b, sq, h, d)``."""
    b, sq, h, d = q.shape
    sk, h_kv = k.shape[1], k.shape[2]
    group = h // h_kv
    out = attention_ref(to_bh(q, 1), to_bh(k, group), to_bh(v, group), causal=causal)
    return out.view(b, h, sq, v.shape[-1]).transpose(1, 2)
