"""Two-tower retrieval model (Yi et al., RecSys'19 / Covington RecSys'16).

The hot path is the **EmbeddingBag** over huge sparse tables (10^6..10^8 rows
per field): a ragged gather-reduce, the paper's SpMM regime applied to
recommendation.  As in the reference, it is built from a row gather and a
sum over the bag; no kernel of the port runs on this path.  The gather is
``F.embedding``; its backward adds each row's gradients in a fixed order (a
stable sort of the indices, then ``torch.segment_reduce``: the GNN path's
``Segments``), so a training step repeats bit for bit on the card, where
``F.embedding``'s own backward does not for rows that repeat often.

Components:
  * ``embedding_bag``      — multi-hot sum/mean lookup per field, with
    ``jnp.take``'s semantics for indices out of range.
  * ``tower_apply``        — field embeddings -> MLP -> L2-normalized vector.
  * ``loss_fn``            — in-batch sampled softmax with logQ correction.
  * ``serve_scores``       — pointwise user-item scores.
  * ``retrieval_scores``   — one query against N candidates (batched dot).
  * ``retrieval_topk``     — ``lax.top_k``: ties go to the lower index.

``param_pspecs`` gives the reference's placement on a mesh: tables
row-sharded over every axis, towers replicated (the launch tooling's
recsys cells, ``repro_torch.launch.cells``).
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from repro_torch.configs.base import RecsysConfig
from repro_torch.core.sharding import P
from repro_torch.device import resolve_device
from repro_torch.models.gnn.message import Segments

__all__ = [
    "init_params",
    "param_shapes",
    "embedding_bag",
    "tower_apply",
    "forward",
    "loss_fn",
    "serve_scores",
    "retrieval_scores",
    "retrieval_topk",
    "param_pspecs",
]


def _pad_vocab(v: int, multiple: int = 512) -> int:
    return ((v + multiple - 1) // multiple) * multiple


def init_params(cfg: RecsysConfig, seed: int = 0, device=None, vocab_scale: float = 1.0) -> Dict:
    """fp32 parameters drawn from a ``torch.Generator`` seeded with ``seed``
    on ``device`` (``None``: the card; ``"meta"``: shapes only), at the
    reference's shapes and scales: field ``i``'s table has
    ``_pad_vocab(max(int(v_i * vocab_scale), 8))`` rows of ``N(0, 1) *
    0.01``, tower weights ``N(0, 1) / sqrt(d_in)``, zero biases.
    ``vocab_scale`` < 1 shrinks the tables.  The draws are not JAX's; tests
    carry the reference's parameters across with
    :func:`repro_torch.interop.recsys_params_from_numpy`."""
    device = resolve_device(device)
    gen = None if device.type == "meta" else torch.Generator(device=device).manual_seed(seed)

    def normal(shape):
        return torch.randn(shape, generator=gen, device=device)

    def tables(sizes):
        return [normal((_pad_vocab(max(int(v * vocab_scale), 8)), cfg.embed_dim)).mul_(0.01)
                for v in sizes]

    def tower(d_in):
        dims = [d_in] + list(cfg.tower_mlp)
        return [{"w": normal((dims[i], dims[i + 1])).div_(dims[i] ** 0.5),
                 "b": torch.zeros((dims[i + 1],), device=device)}
                for i in range(len(dims) - 1)]

    return {
        "user_tables": tables(cfg.user_vocab_sizes),
        "item_tables": tables(cfg.item_vocab_sizes),
        "user_tower": tower(cfg.embed_dim * cfg.n_user_fields),
        "item_tower": tower(cfg.embed_dim * cfg.n_item_fields),
    }


def param_shapes(cfg: RecsysConfig, vocab_scale: float = 1.0) -> Dict:
    """The parameter tree as ``meta`` tensors (shape and dtype, no storage)."""
    return init_params(cfg, device="meta", vocab_scale=vocab_scale)


class _Gather(torch.autograd.Function):
    """``table[idx]`` (``F.embedding``) whose backward sums each table row's
    gradients in a fixed order."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return F.embedding(idx, table)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        return Segments(idx.reshape(-1), ctx.rows).sum(grad.reshape(-1, grad.shape[-1])), None


def embedding_bag(
    table: torch.Tensor,  # (vocab, d)
    indices: torch.Tensor,  # (batch, bag) integers
    weights: torch.Tensor = None,  # (batch, bag) or None
    combiner: str = "mean",
) -> torch.Tensor:
    """EmbeddingBag(sum/mean): the bag's rows gathered, weighted and summed;
    ``mean`` divides by ``max(sum of weights, 1)``.

    Indices follow ``jnp.take``'s default mode, as the reference's: a
    negative index ``>= -rows`` counts from the end, and a bag holding any
    index outside ``[-rows, rows)`` is NaN.  They are read in range (so the
    gather never faults on the card) and the bag's output is filled after.
    """
    rows = table.shape[0]
    indices = torch.where(indices < 0, indices + rows, indices)
    bad = ((indices < 0) | (indices >= rows)).any(-1, keepdim=True)
    gathered = _Gather.apply(table, indices.clamp(0, rows - 1))  # (batch, bag, d)
    if weights is None:
        out, denom = gathered.sum(1), float(max(indices.shape[1], 1))
    else:
        weights = weights.to(table.dtype)
        out = torch.einsum("bkd,bk->bd", gathered, weights)
        denom = weights.sum(-1, keepdim=True).clamp(min=1.0)
    if combiner == "mean":
        out = out / denom
    return out.masked_fill(bad, float("nan"))


def tower_apply(layers: List[Dict], fields: torch.Tensor) -> torch.Tensor:
    """fields: (batch, n_fields * d) concat of bag outputs -> unit vector."""
    h = fields
    for i, layer in enumerate(layers):
        h = torch.addmm(layer["b"], h, layer["w"])
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h / torch.linalg.vector_norm(h, dim=-1, keepdim=True).clamp(min=1e-9)


def _encode(tables, tower, idx, weights=None):
    bags = [
        embedding_bag(t, idx[:, f], None if weights is None else weights[:, f])
        for f, t in enumerate(tables)
    ]
    return tower_apply(tower, torch.cat(bags, dim=-1))


def forward(params: Dict, cfg: RecsysConfig, user_idx: torch.Tensor, item_idx: torch.Tensor):
    """user_idx: (b, n_user_fields, bag); item_idx: (b, n_item_fields, bag).
    Returns (user_vec, item_vec) each (b, tower_out)."""
    u = _encode(params["user_tables"], params["user_tower"], user_idx)
    i = _encode(params["item_tables"], params["item_tower"], item_idx)
    return u, i


def loss_fn(
    params: Dict,
    cfg: RecsysConfig,
    user_idx: torch.Tensor,
    item_idx: torch.Tensor,
    log_q: torch.Tensor = None,  # (b,) sampling log-probabilities of items
) -> torch.Tensor:
    """In-batch sampled softmax with logQ correction (Yi et al. 2019)."""
    u, i = forward(params, cfg, user_idx, item_idx)
    return _sampled_softmax(u, i, cfg, log_q)


def _sampled_softmax(u, i, cfg: RecsysConfig, log_q=None) -> torch.Tensor:
    """The loss head: row ``r``'s positive is item ``r``, the batch's other
    items its negatives."""
    return _InBatchSoftmax.apply(u, i, cfg.temperature, log_q)


class _InBatchSoftmax(torch.autograd.Function):
    """``mean_r(logsumexp(z_r) - z_rr)`` over the logits ``z = u i^T /
    temperature - log_q``, the reference's log-softmax NLL, and its gradient
    ``(softmax(z) - I) / b``.  At the published batch (65,536) each (b, b)
    fp32 tensor is 17.2 GB, and autograd's log-softmax and NLL ran out of
    the card's 80 GB there: the forward makes the softmax in place of the
    logits and keeps only it, and the backward makes the gradient in one
    copy, so at most two are live."""

    @staticmethod
    def forward(ctx, u, i, temperature, log_q):
        z = torch.mm(u, i.T).div_(temperature)
        if log_q is not None:
            z.sub_(log_q[None, :])
        positive = z.diagonal().clone()
        peak = z.amax(-1, keepdim=True)
        probs = z.sub_(peak).exp_()
        total = probs.sum(-1, keepdim=True)
        probs.div_(total)
        ctx.save_for_backward(u, i, probs)
        ctx.temperature = temperature
        return (peak[:, 0] + total[:, 0].log() - positive).mean()

    @staticmethod
    def backward(ctx, grad):
        u, i, probs = ctx.saved_tensors
        dz = probs.clone()
        dz.diagonal().sub_(1.0)
        dz.mul_(grad / (dz.shape[0] * ctx.temperature))
        return dz @ i, dz.T @ u, None, None


def serve_scores(params: Dict, cfg: RecsysConfig, user_idx, item_idx) -> torch.Tensor:
    """Pointwise user-item scores for a serving batch (dot interaction)."""
    u, i = forward(params, cfg, user_idx, item_idx)
    return torch.sum(u * i, dim=-1) / cfg.temperature


def retrieval_scores(
    params: Dict,
    cfg: RecsysConfig,
    user_idx: torch.Tensor,  # (1, n_user_fields, bag)
    candidate_vecs: torch.Tensor,  # (n_candidates, d) — precomputed item vecs
) -> torch.Tensor:
    """Score one query against the full candidate corpus: a (1,d)x(d,N) GEMV."""
    u = _encode(params["user_tables"], params["user_tower"], user_idx)
    return (u @ candidate_vecs.T)[0]


def retrieval_topk(scores: torch.Tensor, k: int = 100):
    """``(values, indices)`` of the ``k`` largest scores along the last axis,
    in descending order, as ``lax.top_k`` gives them: equal scores in
    ascending index order.  Indices are int64.

    ``torch.topk`` promises no order among ties, so it ranks unique int64
    keys instead: the score's bits mapped to an integer of the same order
    (IEEE total order: -0.0 below +0.0, NaN above +inf), times 2^32, plus
    ``n - 1 - index``, so scores must be float32."""
    if scores.dtype != torch.float32:
        raise TypeError(f"retrieval_topk ranks float32 scores, got {scores.dtype}")
    n = scores.shape[-1]
    bits = scores.contiguous().view(torch.int32).to(torch.int64)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    position = torch.arange(n, device=scores.device, dtype=torch.int64)
    _, idx = torch.topk(ordered * (1 << 32) + (n - 1 - position), k)
    return torch.gather(scores, -1, idx), idx


def param_pspecs(cfg: RecsysConfig, dp=()) -> Dict:
    """Vocabulary (row) sharded tables over every mesh axis, model-major
    (``("model",) + dp``); towers replicated."""
    rows = ("model",) + tuple(dp)

    def tower_specs(layers):
        return [{"w": P(None, None), "b": P(None)} for _ in layers]

    return {
        "user_tables": [P(rows, None) for _ in cfg.user_vocab_sizes],
        "item_tables": [P(rows, None) for _ in cfg.item_vocab_sizes],
        "user_tower": tower_specs(cfg.tower_mlp),
        "item_tower": tower_specs(cfg.tower_mlp),
    }
