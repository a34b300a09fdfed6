"""Transformer building blocks of the LMs: RMSNorm, RoPE, GQA/MQA and
DeepSeek-V2 MLA attention, the dense and the top-k MoE feed-forward, as
plain functions on tensors.

Parameters are dicts of fp32 tensors in the reference's layouts (``w_q:
(d, h, e)``, ``w_o: (h, e, d)``, ``w_up: (d, d_ff)``, experts ``(e, d,
f)``); every product casts them to the activations' dtype at use, and
softmax, norms and the router run in fp32.  ``moe_apply(..., group=)``
is the expert-parallel form over a ``torch.distributed`` group.
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
    "init_moe",
    "moe_route",
    "moe_apply",
    "moe_shard",
]

Params = Dict[str, torch.Tensor]

#: expert weights, stacked on a leading expert axis
EXPERT_WEIGHTS = ("w_up", "w_gate", "w_down")


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
# Attention (GQA / MQA / MLA)
# ---------------------------------------------------------------------------


def init_attention(gen: Optional[torch.Generator], cfg: LMConfig, device=None) -> Params:
    """One layer's attention weights, drawn from ``gen`` on its device
    (``device="meta"`` gives the shapes only)."""
    device = torch.device(device) if device is not None else gen.device
    if cfg.attention == "mla":
        d, h, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        return {
            "w_q": _dense_init(gen, (d, h, dn + dr), device),
            "w_dkv": _dense_init(gen, (d, r), device),
            "w_krope": _dense_init(gen, (d, dr), device),
            "w_uk": _dense_init(gen, (r, h, dn), device),
            "w_uv": _dense_init(gen, (r, h, dv), device),
            "w_o": _dense_init(gen, (h, dv, d), device, scale_axis=1),
            "kv_norm": torch.ones((r,), device=device),
        }
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
    seq_gather=None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Causal self-attention.  With ``cache`` (decode), ``x`` is the new-token
    slice and ``cache_index`` the write offset.  Unlike the reference, the
    cache is updated in place (it is the serving engine's largest buffer);
    the updated cache is returned as in the reference.  MLA ignores
    ``cfg.attn_impl``, as the reference does.

    ``seq_gather`` is sequence parallelism (``repro_torch.launch.sharded``):
    ``x`` is this device's slice of the sequence at global ``positions``,
    and ``seq_gather(t)`` returns the whole sequence of a ``(b, s_local,
    ...)`` tensor.  Keys and values (MLA: the latents), or with a cache the
    cache as long as the prompt, are gathered before attention; every
    gathered position is valid, and the causal mask compares global
    positions."""
    if cfg.attention == "mla":
        return _mla_apply(params, cfg, x, positions, cache, cache_index, seq_gather)
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
        if seq_gather is None:
            out = _sdpa_chunked(q, cache["k"], cache["v"], positions, idx + s, causal=True,
                                q_chunk=cfg.attn_q_chunk)
        else:
            out = _sdpa_chunked(q, seq_gather(cache["k"]), seq_gather(cache["v"]), positions, None,
                                causal=True, q_chunk=cfg.attn_q_chunk)
    elif seq_gather is not None:
        out = _sdpa_chunked(q, seq_gather(k), seq_gather(v), positions, None, causal=True,
                            q_chunk=cfg.attn_q_chunk)
    elif cfg.attn_impl == "flash":
        from repro_torch.kernels.flash_attention.ops import flash_attention

        out = flash_attention(q, k, v, causal=True)
    else:
        out = _sdpa_chunked(q, k, v, positions, None, causal=True, q_chunk=cfg.attn_q_chunk)
    out = out.reshape(b, s, -1) @ params["w_o"].to(x.dtype).reshape(-1, d)
    return out, new_cache


def _mla_apply(params: Params, cfg: LMConfig, x, positions, cache, cache_index, seq_gather=None):
    """DeepSeek-V2 Multi-head Latent Attention.

    Only the latent ``c_kv`` (kv_lora_rank) and one rope key shared by the
    heads are cached, written in place at ``cache_index``.  A one-token step
    with a cache runs the absorbed form (``w_uk`` folded into the query,
    ``w_uv`` into the output, attention in the latent space); every other
    call decompresses per-head K/V from the latent and runs
    ``_sdpa_chunked`` at q/k head dim ``dn + dr`` and v head dim ``dv``.
    """
    b, s, d = x.shape
    h, dn, dr = cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    dt = x.dtype

    q = (x @ params["w_q"].to(dt).reshape(d, -1)).view(b, s, h, dn + dr)
    q_nope = q[..., :dn]
    q_rope = apply_rope(q[..., dn:], positions, cfg.rope_theta)
    c_kv = rmsnorm(x @ params["w_dkv"].to(dt), params["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope((x @ params["w_krope"].to(dt))[:, :, None], positions,
                        cfg.rope_theta)[:, :, 0]

    new_cache, kv_len, c_all, r_all = None, None, c_kv, k_rope
    if cache is not None:
        idx = int(cache_index)
        cache["c_kv"][:, idx: idx + s] = c_kv.to(cache["c_kv"].dtype)
        cache["k_rope"][:, idx: idx + s] = k_rope.to(cache["k_rope"].dtype)
        new_cache, kv_len, c_all, r_all = cache, idx + s, cache["c_kv"], cache["k_rope"]
    if seq_gather is not None:
        kv_len, c_all, r_all = None, seq_gather(c_all), seq_gather(r_all)
    # products with the cache run in the promoted dtype, as the reference's
    # mixed-dtype einsums do (the same dtype unless the cache was made in
    # another)
    ct = torch.promote_types(dt, c_all.dtype)
    c_all, r_all = c_all.to(ct), r_all.to(ct)
    w_uk = params["w_uk"].to(dt).to(ct)
    w_uv = params["w_uv"].to(dt).to(ct)
    w_o = params["w_o"].to(dt).reshape(-1, d)

    if cache is not None and s == 1:
        # absorbed decode (DeepSeek-V2 section 2.1.3): no per-head K/V
        q_lat = torch.einsum("bhe,rhe->bhr", q_nope[:, 0].to(ct), w_uk)
        logits = q_lat @ c_all.transpose(1, 2) + q_rope[:, 0].to(ct) @ r_all.transpose(1, 2)
        logits = logits.float() * (1.0 / math.sqrt(dn + dr))  # (b, h, t)
        valid = torch.arange(c_all.shape[1], device=x.device) < kv_len
        p = torch.softmax(torch.where(valid, logits, -1e30), dim=-1)
        out_lat = p.to(dt).to(ct) @ c_all  # (b, h, r)
        out = torch.einsum("bhr,rhe->bhe", out_lat, w_uv)
        return out.reshape(b, 1, -1) @ w_o.to(ct), new_cache

    t = c_all.shape[1]
    k_nope = (c_all @ w_uk.reshape(w_uk.shape[0], -1)).view(b, t, h, dn)
    v = (c_all @ w_uv.reshape(w_uv.shape[0], -1)).view(b, t, h, -1)
    k = torch.cat([k_nope, r_all[:, :, None].expand(b, t, h, dr)], dim=-1)
    out = _sdpa_chunked(torch.cat([q_nope, q_rope], dim=-1), k, v, positions, kv_len,
                        causal=True, q_chunk=cfg.attn_q_chunk)
    return out.reshape(b, s, -1) @ w_o, new_cache


# ---------------------------------------------------------------------------
# Feed-forward: dense and MoE
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


def init_moe(gen: Optional[torch.Generator], cfg: LMConfig, device=None) -> Params:
    """One MoE layer: the router, the routed experts stacked on a leading
    axis (scaled as the reference scales them, by the square root of their
    leading dim) and, with ``n_shared_experts``, one dense FFN as wide as
    the shared experts together."""
    device = torch.device(device) if device is not None else gen.device
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    params = {
        "router": _dense_init(gen, (d, e), device),
        "w_up": _dense_init(gen, (e, d, f), device),
        "w_down": _dense_init(gen, (e, f, d), device),
    }
    if cfg.ffn_activation in ("swiglu", "geglu"):
        params["w_gate"] = _dense_init(gen, (e, d, f), device)
    if cfg.n_shared_experts:
        params["shared"] = init_ffn(gen, d, f * cfg.n_shared_experts, cfg.ffn_activation, device)
    return params


def moe_shard(params: Params, rank: int, world: int) -> Params:
    """Rank ``rank``'s expert-parallel share of a whole :func:`init_moe`
    tree: experts ``[rank * e / world, (rank + 1) * e / world)``, the router
    and the shared experts whole (views, no copy)."""
    e = params["router"].shape[1]
    if world < 1 or e % world:
        raise ValueError(f"{e} experts do not split over {world} ranks")
    lo = rank * (e // world)
    return {name: (p[lo: lo + e // world] if name in EXPERT_WEIGHTS else p)
            for name, p in params.items()}


def moe_route(router: torch.Tensor, tokens: torch.Tensor, k: int):
    """Router probabilities ``(t, e)`` (fp32 softmax) and each token's top-k
    experts in descending order of probability, ties to the lower index
    (``jax.lax.top_k``'s order), with their gates renormalised to sum to
    one.  Returns ``(probs, gates (t, k) fp32, experts (t, k) int64)``."""
    probs = torch.softmax(tokens.float() @ router.float(), dim=-1)
    top, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = top[:, :k]
    return probs, gates / (gates.sum(-1, keepdim=True) + 1e-9), experts[:, :k]


def _experts(params: Params, cfg: LMConfig, xin: torch.Tensor) -> torch.Tensor:
    """The routed experts' FFN on ``(experts, rows, d)``: batched products
    over the expert axis of ``params``."""
    up = torch.bmm(xin, params["w_up"].to(xin.dtype))
    if cfg.ffn_activation in ("swiglu", "geglu"):
        h = _activate(torch.bmm(xin, params["w_gate"].to(xin.dtype)), up, cfg.ffn_activation)
    else:
        h = _activate(up, None, cfg.ffn_activation)
    return torch.bmm(h, params["w_down"].to(xin.dtype))


def _experts_ep(params: Params, cfg: LMConfig, xin: torch.Tensor, group) -> torch.Tensor:
    """:func:`_experts` with the experts spread over ``group``: one
    ``all_to_all_single`` sends each rank's rows of ``(e, cap, d)`` to the
    rank holding their experts, which runs its ``e / m`` experts on ``(e /
    m, m * cap, d)`` (source ranks in rank order, as the reference's tiled
    ``all_to_all``), and one more brings the rows back."""
    import torch.distributed as dist

    m = dist.get_world_size(group)
    e, cap, d = xin.shape
    if params["w_up"].shape[0] * m != e:
        raise ValueError(f"{params['w_up'].shape[0]} local experts x {m} ranks != {e} experts")
    recv = torch.empty_like(xin)
    dist.all_to_all_single(recv, xin, group=group)  # (m sources, e / m, cap, d)
    out = _experts(params, cfg, recv.view(m, e // m, cap, d).transpose(0, 1).reshape(e // m, m * cap, d))
    send = out.view(e // m, m, cap, d).transpose(0, 1).contiguous()
    back = torch.empty_like(send)
    dist.all_to_all_single(back, send, group=group)  # (m owners, e / m, cap, d)
    return back.view(e, cap, d)


def moe_apply(params: Params, cfg: LMConfig, x: torch.Tensor, group=None):
    """Top-k MoE with capacity and scatter/gather dispatch; returns ``(out,
    aux)``, aux the Switch load-balancing loss (fp32).

    Each (token, slot) pair takes the next free row of its expert in
    token-major, slot-minor order; pairs past ``capacity`` are dropped
    (their gate is zeroed).  Tokens are scattered into ``(e, capacity, d)``
    rows in ``x``'s dtype, the experts run as batched products, and each
    token sums its ``k`` gated rows.

    With ``group`` (a ``torch.distributed`` group of ``m`` ranks): expert
    parallelism.  ``params`` then hold this rank's ``e / m`` experts
    (:func:`moe_shard`), ``x`` is this rank's tokens, of the same shape on
    every rank; routing and capacity are local to the rank, the rows travel
    by :func:`_experts_ep`, and ``aux`` is averaged over the group.
    """
    b, s, d = x.shape
    tokens = x.reshape(-1, d)
    n_tok = tokens.shape[0]
    e, k = cfg.n_experts, cfg.moe_top_k
    probs, gates, experts = moe_route(params["router"], tokens, k)
    flat_e = experts.reshape(-1)  # token-major, slot-minor
    # each pair's queue position: an expert-major one-hot scanned flat (one
    # 1-D scan; on CUDA a scan down the pair axis of a (t*k, e) one-hot walks
    # each column serially), less the pairs of the experts before its own
    onehot = (torch.arange(e, device=x.device)[:, None] == flat_e).int()  # (e, t*k)
    counts = onehot.sum(1)
    aux = e * torch.sum(counts / (n_tok * k) * probs.mean(0)) * cfg.router_aux_coef
    run = torch.cumsum(onehot.view(-1), 0, dtype=torch.int32).view(e, -1)
    pos = run.gather(0, flat_e[None])[0] - 1 - (torch.cumsum(counts, 0) - counts)[flat_e]

    capacity = max(int(n_tok * k * cfg.capacity_factor / e), 4)
    keep = pos < capacity
    # e * capacity expert rows, then one scratch row that every dropped pair
    # writes (the reference's per-expert scratch slot)
    buf = tokens.new_zeros((e * capacity + 1, d))
    buf.index_copy_(0, torch.where(keep, flat_e * capacity + pos, e * capacity),
                    tokens[:, None].expand(n_tok, k, d).reshape(-1, d))
    xin = buf[:-1].view(e, capacity, d)
    if group is None:
        out_rows = _experts(params, cfg, xin)
    else:
        import torch.distributed as dist

        out_rows = _experts_ep(params, cfg, xin, group)
        aux = aux.reshape(1)
        dist.all_reduce(aux, group=group)
        aux = aux[0] / dist.get_world_size(group)
    back = out_rows.reshape(-1, d)[flat_e * capacity + pos.clamp(max=capacity - 1)]
    gate = (gates.reshape(-1) * keep).to(x.dtype)
    out = (back * gate[:, None]).view(n_tok, k, d).sum(1)
    if cfg.n_shared_experts:
        out = out + ffn_apply(params["shared"], cfg.ffn_activation, tokens)
    return out.view(b, s, d), aux
