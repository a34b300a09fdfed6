"""Transformer building blocks of the dense-GQA LMs: RMSNorm, RoPE, GQA/MQA
attention and the dense feed-forward, as plain functions on tensors.

Parameters are dicts of fp32 tensors in the reference's layouts (``w_q:
(d, h, e)``, ``w_o: (h, e, d)``, ``w_up: (d, d_ff)``); every product casts
them to the activations' dtype at use, and softmax and norms run in fp32.
MLA attention and the MoE feed-forward are not ported yet (ROADMAP queue 1
item 13) and raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import LMConfig

__all__ = [
    "rmsnorm",
    "rope_frequencies",
    "apply_rope",
    "init_attention",
    "attention_apply",
    "init_ffn",
    "ffn_apply",
    "moe_apply",
]

Params = Dict[str, torch.Tensor]

_NOT_PORTED = "is not ported yet (ROADMAP queue 1 item 13: MLA and MoE inference)"


def _normal(gen: Optional[torch.Generator], shape, device: torch.device) -> torch.Tensor:
    """Standard normal draws; on the ``meta`` device, shapes only."""
    if device.type == "meta":
        return torch.empty(shape, device=device)
    return torch.randn(shape, generator=gen, device=device)


def _dense_init(gen, shape, device, scale_axis=0) -> torch.Tensor:
    return _normal(gen, shape, device) / math.sqrt(shape[scale_axis])


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    rms = torch.sqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return ((xf / rms) * gamma).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_frequencies(dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, n_heads, d); positions: (..., seq)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)  # (d/2,)
    angles = positions[..., :, None].float() * freqs  # (..., seq, d/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA / MQA)
# ---------------------------------------------------------------------------


def init_attention(gen: Optional[torch.Generator], cfg: LMConfig, device=None) -> Params:
    """One layer's attention weights, drawn from ``gen`` on its device
    (``device="meta"`` gives the shapes only)."""
    if cfg.attention == "mla":
        raise NotImplementedError(f"MLA attention {_NOT_PORTED}")
    device = torch.device(device) if device is not None else gen.device
    d, h, kv, e = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    return {
        "w_q": _dense_init(gen, (d, h, e), device),
        "w_k": _dense_init(gen, (d, kv, e), device),
        "w_v": _dense_init(gen, (d, kv, e), device),
        "w_o": _dense_init(gen, (h, e, d), device, scale_axis=1),
    }


def _sdpa_chunked(
    q: torch.Tensor,  # (b, sq, h, d)
    k: torch.Tensor,  # (b, sk, h_kv, d)
    v: torch.Tensor,  # (b, sk, h_kv, dv)
    q_positions: torch.Tensor,  # (sq,) absolute positions of queries
    kv_len,  # valid kv length (int or 0-d tensor; decode) or None (= sk)
    causal: bool,
    q_chunk: int,
) -> torch.Tensor:
    """Query-chunked attention with fp32 softmax: the fp32 scores of one
    chunk are ``(b, q_chunk, h, sk)``, never ``(b, sq, h, sk)``."""
    b, sq, h, d = q.shape
    h_kv = k.shape[2]
    group = h // h_kv
    scale = 1.0 / math.sqrt(d)
    kv_pos = torch.arange(k.shape[1], device=q.device)
    kf, vf = k.float(), v.float()
    qg = q.reshape(b, sq, h_kv, group, d)
    q_positions = q_positions.to(q.device)
    out = torch.empty((b, sq, h_kv, group, v.shape[-1]), dtype=torch.float32, device=q.device)
    for r0 in range(0, sq, q_chunk):
        r1 = min(sq, r0 + q_chunk)
        logits = torch.einsum("bchgd,bshd->bchgs", qg[:, r0:r1].float(), kf) * scale
        mask = torch.ones((r1 - r0, k.shape[1]), dtype=torch.bool, device=q.device)
        if causal:
            mask = q_positions[r0:r1, None] >= kv_pos[None, :]
        if kv_len is not None:
            mask = mask & (kv_pos[None, :] < kv_len)
        logits = torch.where(mask[None, :, None, None, :], logits, -1e30)
        p = torch.softmax(logits, dim=-1)
        out[:, r0:r1] = torch.einsum("bchgs,bshe->bchge", p, vf)
    return out.reshape(b, sq, h, v.shape[-1]).to(q.dtype)


def attention_apply(
    params: Params,
    cfg: LMConfig,
    x: torch.Tensor,  # (b, s, d)
    positions: torch.Tensor,  # (s,)
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_index=None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Causal self-attention.  With ``cache`` (decode), ``x`` is the new-token
    slice and ``cache_index`` the write offset.  Unlike the reference, the
    cache is updated in place (it is the serving engine's largest buffer);
    the updated cache is returned as in the reference."""
    if cfg.attention == "mla":
        raise NotImplementedError(f"MLA attention {_NOT_PORTED}")
    b, s, d = x.shape
    e = cfg.d_head

    def project(w):  # (b, s, d) @ (d, n, e) -> (b, s, n, e)
        return (x @ w.to(x.dtype).reshape(d, -1)).view(b, s, -1, e)

    q = apply_rope(project(params["w_q"]), positions, cfg.rope_theta)
    k = apply_rope(project(params["w_k"]), positions, cfg.rope_theta)
    v = project(params["w_v"])

    new_cache = None
    if cache is not None:
        idx = int(cache_index)
        cache["k"][:, idx: idx + s] = k.to(cache["k"].dtype)
        cache["v"][:, idx: idx + s] = v.to(cache["v"].dtype)
        new_cache = cache
        out = _sdpa_chunked(q, cache["k"], cache["v"], positions, idx + s, causal=True,
                            q_chunk=cfg.attn_q_chunk)
    elif cfg.attn_impl == "flash":
        from repro_torch.kernels.flash_attention.ops import flash_attention

        out = flash_attention(q, k, v, causal=True)
    else:
        out = _sdpa_chunked(q, k, v, positions, None, causal=True, q_chunk=cfg.attn_q_chunk)
    out = out.reshape(b, s, -1) @ params["w_o"].to(x.dtype).reshape(-1, d)
    return out, new_cache


# ---------------------------------------------------------------------------
# Feed-forward
# ---------------------------------------------------------------------------


def init_ffn(gen: Optional[torch.Generator], d_model: int, d_ff: int, activation: str,
             device=None) -> Params:
    device = torch.device(device) if device is not None else gen.device
    if activation in ("swiglu", "geglu"):
        return {
            "w_gate": _dense_init(gen, (d_model, d_ff), device),
            "w_up": _dense_init(gen, (d_model, d_ff), device),
            "w_down": _dense_init(gen, (d_ff, d_model), device),
        }
    return {
        "w_up": _dense_init(gen, (d_model, d_ff), device),
        "w_down": _dense_init(gen, (d_ff, d_model), device),
    }


def _activate(gate: torch.Tensor, up: Optional[torch.Tensor], activation: str) -> torch.Tensor:
    if activation == "swiglu":
        return F.silu(gate) * up
    if activation == "geglu":
        return F.gelu(gate, approximate="tanh") * up
    if activation == "squared_relu":  # Primer / Nemotron-4
        r = F.relu(gate)
        return r * r
    if activation == "gelu":  # GPT-BigCode / Granite-20B
        return F.gelu(gate, approximate="tanh")
    raise ValueError(f"unknown activation {activation!r}")


def ffn_apply(params: Params, activation: str, x: torch.Tensor) -> torch.Tensor:
    if activation in ("swiglu", "geglu"):
        h = _activate(x @ params["w_gate"].to(x.dtype), x @ params["w_up"].to(x.dtype), activation)
    else:
        h = _activate(x @ params["w_up"].to(x.dtype), None, activation)
    return h @ params["w_down"].to(x.dtype)


def moe_apply(params: Params, cfg: LMConfig, x: torch.Tensor):
    raise NotImplementedError(f"the MoE feed-forward {_NOT_PORTED}")
