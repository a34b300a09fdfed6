"""A plain per-expert loop for the MoE feed-forward, to hold
:func:`repro_torch.models.layers.moe_apply` against.

:func:`moe_loop` takes the routing as given (the gates and expert indices
of :func:`~repro_torch.models.layers.moe_route`, so that both sides serve
the same pairs) and computes the layer without a dispatch buffer: for each
expert, the (token, slot) pairs routed to it, in token-major, slot-minor
order, the first ``capacity`` of them served and the rest dropped; each
served pair adds its gate times the expert's FFN of its token to that
token.  ``chip_smoke.py`` runs it on the card, and
``tests/test_torch_moe.py`` holds it against the reference's ``moe_apply``.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import LMConfig
from repro_torch.models.layers import EXPERT_WEIGHTS, ffn_apply

__all__ = ["moe_loop"]


def moe_loop(params, cfg: LMConfig, x: torch.Tensor, gates: torch.Tensor,
             experts: torch.Tensor):
    """``(out (b, s, d), dropped pairs)`` for one MoE layer on ``x`` under
    the routing ``gates, experts`` (both ``(b * s, k)``)."""
    b, s, d = x.shape
    tokens = x.reshape(-1, d)
    n_tok, k = experts.shape
    capacity = max(int(n_tok * k * cfg.capacity_factor / cfg.n_experts), 4)
    flat_e, flat_g = experts.reshape(-1), gates.reshape(-1)
    out = torch.zeros_like(tokens)
    dropped = 0
    for j in range(cfg.n_experts):
        pairs = torch.nonzero(flat_e == j)[:, 0]  # ascending: token-major, slot-minor
        dropped += max(0, pairs.numel() - capacity)
        pairs = pairs[:capacity]
        tok = pairs // k
        expert = {name: params[name][j] for name in EXPERT_WEIGHTS if name in params}
        y = ffn_apply(expert, cfg.ffn_activation, tokens[tok])
        out.index_add_(0, tok, y * flat_g[pairs, None].to(x.dtype))
    if cfg.n_shared_experts:
        out = out + ffn_apply(params["shared"], cfg.ffn_activation, tokens)
    return out.view(b, s, d), dropped
