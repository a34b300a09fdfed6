"""Decoder-only transformer LM: the inference path of the port.

Covers the five LM archs of the reference: GQA / MQA (granite-8b,
granite-20b, nemotron-4-15b, dbrx-132b) and DeepSeek-V2 MLA
(deepseek-v2-lite-16b); dense SwiGLU / GELU / squared-ReLU and top-k MoE
feed-forward (dbrx-132b, deepseek-v2-lite-16b after its dense first
layer); the cache-free forward (whose GQA attention is the flash kernel
when ``cfg.attn_impl == "flash"``; that kernel has no backward, as in the
reference), the next-token loss with per-layer activation checkpointing
(``cfg.remat``), and cache prefill / decode; the partition specs of the
parameters and caches on a ``(data, model)`` mesh (``param_pspecs``,
``kv_cache_pspecs``), which the launch tooling's sharded steps
(``repro_torch.launch.sharded``) place them at.

Parameters keep the reference's layout: a dict with ``embed``,
``final_norm``, ``unembed`` and ``groups``, a list with one dict per
homogeneous layer group whose leaves are the group's layers stacked on a
leading axis.  They are fp32 and cast to ``cfg.dtype`` at use.  The
layers of a group run as a Python loop (the reference scans them).

Entry points:
  * ``init_params(cfg, seed, device)`` / ``param_shapes(cfg)`` (no storage)
  * ``forward(params, cfg, tokens)``            -> (logits, aux, caches)
  * ``loss_fn(params, cfg, tokens, labels)``
  * ``init_kv_cache(cfg, batch, max_len)`` / ``kv_cache_shapes``
  * ``prefill`` / ``decode_step`` (update the caches in place)
  * ``param_pspecs(cfg, model_size)`` / ``kv_cache_pspecs(cfg, dp_axes)``
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LMConfig
from repro_torch.core.sharding import P
from repro_torch.device import resolve_device
from repro_torch.models import layers as L

__all__ = [
    "init_params",
    "param_shapes",
    "forward",
    "loss_fn",
    "init_kv_cache",
    "kv_cache_shapes",
    "prefill",
    "decode_step",
    "layer_groups",
    "param_pspecs",
    "kv_cache_pspecs",
]

Params = Dict


def layer_groups(cfg: LMConfig) -> List[Tuple[int, bool]]:
    """[(n_layers_in_group, is_moe_group)] — homogeneous layer groups."""
    if cfg.moe and cfg.first_k_dense > 0:
        return [(cfg.first_k_dense, False), (cfg.n_layers - cfg.first_k_dense, True)]
    return [(cfg.n_layers, cfg.moe)]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _zip_map(fn, a, b):
    if isinstance(a, dict):
        return {k: _zip_map(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def _init_layer(gen, cfg: LMConfig, moe: bool, device: torch.device) -> Params:
    layer = {
        "attn_norm": torch.ones((cfg.d_model,), device=device),
        "ffn_norm": torch.ones((cfg.d_model,), device=device),
        "attn": L.init_attention(gen, cfg, device),
    }
    if moe:
        layer["moe"] = L.init_moe(gen, cfg, device)
    else:
        layer["ffn"] = L.init_ffn(gen, cfg.d_model, cfg.d_ff, cfg.ffn_activation, device)
    return layer


def init_params(cfg: LMConfig, seed: int = 0, device=None) -> Params:
    """fp32 parameters drawn from a ``torch.Generator`` seeded with ``seed``
    on ``device`` (``None``: the card; ``"meta"``: shapes only).

    Scales follow the reference: dense weights N(0, 1/fan_in), the
    embedding N(0, 0.02^2), the unembedding N(0, 1/d_model), norms 1.  The
    draws are not JAX's; tests carry the reference's weights across with
    :func:`repro_torch.interop.lm_params_from_numpy` instead.  Each layer is
    drawn into its slot of the stacked group, so at most one layer exists
    twice at a time.
    """
    device = resolve_device(device)
    gen = None if device.type == "meta" else torch.Generator(device=device).manual_seed(seed)
    groups = []
    for n, moe in layer_groups(cfg):
        stacked = None
        for i in range(n):
            layer = _init_layer(gen, cfg, moe, device)
            if stacked is None:
                stacked = _map(lambda t: t.new_empty((n,) + tuple(t.shape)), layer)
            _zip_map(lambda dst, src: dst[i].copy_(src), stacked, layer)
            del layer
        groups.append(stacked)
    params = {
        "embed": L._normal(gen, (cfg.vocab_size, cfg.d_model), device) * 0.02,
        "final_norm": torch.ones((cfg.d_model,), device=device),
        "groups": groups,
    }
    if not cfg.tie_embeddings:
        params["unembed"] = L._normal(gen, (cfg.d_model, cfg.vocab_size), device) / math.sqrt(cfg.d_model)
    return params


def param_shapes(cfg: LMConfig) -> Params:
    """The parameter tree as ``meta`` tensors (shape and dtype, no storage)."""
    return init_params(cfg, device="meta")


def _layer_apply(cfg: LMConfig, moe: bool, layer: Params, x, positions, cache, cache_index,
                 seq_gather=None):
    h, new_cache = L.attention_apply(
        layer["attn"], cfg, L.rmsnorm(x, layer["attn_norm"], cfg.norm_eps), positions, cache,
        cache_index, seq_gather=seq_gather,
    )
    x = x + h
    hn = L.rmsnorm(x, layer["ffn_norm"], cfg.norm_eps)
    if moe:
        h, aux = L.moe_apply(layer["moe"], cfg, hn)
    else:
        h, aux = L.ffn_apply(layer["ffn"], cfg.ffn_activation, hn), 0.0
    return x + h, aux, new_cache


def forward(
    params: Params,
    cfg: LMConfig,
    tokens,  # (b, s) integer tensor or array
    caches: Optional[list] = None,
    cache_index=None,
    positions: Optional[torch.Tensor] = None,
    return_hidden: bool = False,
):
    """Returns (logits, aux_loss, caches); the final hidden states instead of
    logits when ``return_hidden``.  aux_loss sums the MoE layers' router
    losses.  With ``caches``, the new keys and values (MLA: latents) are
    written into them in place at ``cache_index``.

    With ``cfg.remat``, no cache and grad enabled, each layer runs under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``): only
    its input is saved, and its forward runs again in the backward, with
    the same values (MoE routing is a stable sort, so it routes alike)."""
    dtype = getattr(torch, cfg.dtype)
    embed = params["embed"]
    tokens = torch.as_tensor(tokens, device=embed.device).long()
    # F.embedding's backward sums rows in a fixed order on the card; the
    # backward of indexing adds them with atomics
    x = F.embedding(tokens, embed).to(dtype)
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=embed.device)
    remat = cfg.remat and caches is None and torch.is_grad_enabled()

    aux_total = torch.zeros((), dtype=torch.float32, device=embed.device)
    for g, (n, moe) in enumerate(layer_groups(cfg)):
        # unbind: the backward stacks the layers' gradients once, where one
        # index per layer would add a zero-filled copy of the group per layer
        layers = _map(lambda p: p.unbind(0), params["groups"][g])
        for i in range(n):
            layer = _map(lambda ps: ps[i], layers)
            if remat:
                x, aux, _ = checkpoint(_layer_apply, cfg, moe, layer, x, positions, None, None,
                                       use_reentrant=False)
            else:
                cache_l = None if caches is None else {k: c[i] for k, c in caches[g].items()}
                x, aux, _ = _layer_apply(cfg, moe, layer, x, positions, cache_l, cache_index)
            aux_total = aux_total + aux

    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if return_hidden:
        return x, aux_total, caches
    return x @ _unembed(params).to(dtype), aux_total, caches


def _unembed(params: Params) -> torch.Tensor:
    unembed = params.get("unembed")
    return params["embed"].T if unembed is None else unembed


def _nll(x: torch.Tensor, unembed: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-token negative log-likelihood ``(b, s)`` of ``labels`` under the
    logits ``x @ unembed`` (in ``x``'s dtype), log-softmax in fp32."""
    logp = torch.log_softmax((x @ unembed.to(x.dtype)).float(), dim=-1)
    return -torch.gather(logp, -1, labels[..., None])[..., 0]


def loss_fn(params: Params, cfg: LMConfig, tokens, labels, loss_chunk: int = 0) -> torch.Tensor:
    """Next-token cross entropy (the mean NLL) plus the MoE aux loss, an fp32
    scalar.

    ``loss_chunk > 0`` that divides the sequence and is shorter than it
    computes the unembedding and log-softmax one sequence chunk at a time,
    each chunk under ``torch.utils.checkpoint``: autograd keeps only the
    chunk's hidden states, never the fp32 ``(b, s, vocab)`` logits (the
    reference's ``lax.map`` over chunks)."""
    labels = torch.as_tensor(labels, device=params["embed"].device).long()
    x, aux, _ = forward(params, cfg, tokens, return_hidden=True)
    return _mean_nll(x, _unembed(params), labels, loss_chunk) + aux


def _mean_nll(x: torch.Tensor, unembed: torch.Tensor, labels: torch.Tensor, loss_chunk: int):
    """The mean NLL of ``labels`` under ``x @ unembed``, by sequence chunks
    of ``loss_chunk`` (see :func:`loss_fn`)."""
    s = labels.shape[1]
    if loss_chunk and s > loss_chunk and s % loss_chunk == 0:
        nll = torch.stack([
            checkpoint(_nll, x[:, c0:c0 + loss_chunk], unembed, labels[:, c0:c0 + loss_chunk],
                       use_reentrant=False)
            for c0 in range(0, s, loss_chunk)])
    else:
        nll = _nll(x, unembed, labels)
    return nll.mean()


# ---------------------------------------------------------------------------
# KV cache / serving
# ---------------------------------------------------------------------------


def _cache_layer_shape(cfg: LMConfig, batch: int, max_len: int):
    if cfg.attention == "mla":
        return {
            "c_kv": (batch, max_len, cfg.kv_lora_rank),
            "k_rope": (batch, max_len, cfg.qk_rope_head_dim),
        }
    return {
        "k": (batch, max_len, cfg.n_kv_heads, cfg.d_head),
        "v": (batch, max_len, cfg.n_kv_heads, cfg.d_head),
    }


def init_kv_cache(cfg: LMConfig, batch: int, max_len: int, dtype=None, device=None) -> list:
    """Zeroed caches, one dict per layer group, in ``dtype`` (default
    ``cfg.dtype``): ``k`` and ``v`` of ``(n_layers, batch, max_len, h_kv,
    d_head)``, or for MLA the latent ``c_kv`` of ``(n_layers, batch,
    max_len, kv_lora_rank)`` and ``k_rope`` of ``(..., qk_rope_head_dim)``."""
    dtype = dtype or getattr(torch, cfg.dtype)
    device = resolve_device(device)
    shapes = _cache_layer_shape(cfg, batch, max_len)
    return [
        {k: torch.zeros((n,) + s, dtype=dtype, device=device) for k, s in shapes.items()}
        for (n, _) in layer_groups(cfg)
    ]


def kv_cache_shapes(cfg: LMConfig, batch: int, max_len: int, dtype=None) -> list:
    """The cache tree as ``meta`` tensors."""
    return init_kv_cache(cfg, batch, max_len, dtype=dtype, device="meta")


def prefill(params: Params, cfg: LMConfig, tokens, caches: list):
    logits, _, new_caches = forward(params, cfg, tokens, caches=caches, cache_index=0)
    return logits, new_caches


def decode_step(params: Params, cfg: LMConfig, token, caches: list, index: int):
    positions = torch.tensor([int(index)], device=params["embed"].device)
    logits, _, new_caches = forward(
        params, cfg, token, caches=caches, cache_index=index, positions=positions
    )
    return logits[:, -1], new_caches


# ---------------------------------------------------------------------------
# Sharding rules
# ---------------------------------------------------------------------------


def _attn_specs(cfg: LMConfig, l: Optional[str], model_size: int):
    """l is the stacked-layer leading axis (None entry prepended)."""
    mp = "model"

    def s(*axes):
        return P(l, *axes)

    if cfg.attention == "mla":
        return {
            "w_q": s(None, mp, None),
            "w_dkv": s(None, None),
            "w_krope": s(None, None),
            "w_uk": s(None, mp, None),
            "w_uv": s(None, mp, None),
            "w_o": s(mp, None, None),
            "kv_norm": s(None),
        }
    kv_shardable = cfg.n_kv_heads % model_size == 0
    # GQA with few kv heads: shard K/V projections on d_model instead
    return {
        "w_q": s(None, mp, None),
        "w_k": s(None, mp, None) if kv_shardable else s(mp, None, None),
        "w_v": s(None, mp, None) if kv_shardable else s(mp, None, None),
        "w_o": s(mp, None, None),
    }


def _ffn_specs(cfg: LMConfig, l: Optional[str]):
    gated = cfg.ffn_activation in ("swiglu", "geglu")
    specs = {"w_up": P(l, None, "model"), "w_down": P(l, "model", None)}
    if gated:
        specs["w_gate"] = P(l, None, "model")
    return specs


def _moe_specs(cfg: LMConfig, l: Optional[str]):
    gated = cfg.ffn_activation in ("swiglu", "geglu")
    moe = {
        "router": P(l, None, None),
        "w_up": P(l, "model", None, None),
        "w_down": P(l, "model", None, None),
    }
    if gated:
        moe["w_gate"] = P(l, "model", None, None)
    if cfg.n_shared_experts:
        moe["shared"] = _ffn_specs(cfg, l)
    return moe


def param_pspecs(cfg: LMConfig, model_size: int = 16) -> Params:
    """The reference's tensor-parallel specs over ``"model"``: attention
    heads, the FFN hidden dim and the vocabulary; experts over ``"model"``;
    the stacked layer axis replicated.  A tree of
    :class:`~repro_torch.core.sharding.P` matching :func:`init_params`."""
    l = None  # stacked leading axis: replicated
    groups = []
    for (n, moe) in layer_groups(cfg):
        g = {
            "attn_norm": P(l, None),
            "ffn_norm": P(l, None),
            "attn": _attn_specs(cfg, l, model_size),
        }
        if moe:
            g["moe"] = _moe_specs(cfg, l)
        else:
            g["ffn"] = _ffn_specs(cfg, l)
        groups.append(g)
    specs = {"embed": P("model", None), "final_norm": P(None), "groups": groups}
    if not cfg.tie_embeddings:
        specs["unembed"] = P(None, "model")
    return specs


def kv_cache_pspecs(cfg: LMConfig, dp_axes: Tuple[str, ...], shard_seq: bool = False,
                    model_size: int = 16) -> list:
    """Cache specs (stacked: leading layer axis), as the reference's.

    * default: batch over the data axes; GQA kv heads over ``"model"`` when
      they divide it, else the sequence over ``"model"`` (MLA: always).
    * ``shard_seq=True``: the sequence over every mesh axis, the split-K
      layout of ``long_500k`` (batch 1).
    """
    dp = dp_axes
    seq_axes = tuple(dp) + ("model",)
    specs = []
    for _ in layer_groups(cfg):
        if cfg.attention == "mla":
            if shard_seq:
                specs.append({"c_kv": P(None, None, seq_axes, None), "k_rope": P(None, None, seq_axes, None)})
            else:
                specs.append({"c_kv": P(None, dp, "model", None), "k_rope": P(None, dp, "model", None)})
        else:
            if shard_seq:
                specs.append(
                    {"k": P(None, None, seq_axes, None, None), "v": P(None, None, seq_axes, None, None)}
                )
            elif cfg.n_kv_heads % model_size == 0:
                specs.append(
                    {"k": P(None, dp, None, "model", None), "v": P(None, dp, None, "model", None)}
                )
            else:  # few kv heads (GQA/MQA): the sequence over model
                specs.append(
                    {"k": P(None, dp, "model", None, None), "v": P(None, dp, "model", None, None)}
                )
    return specs
