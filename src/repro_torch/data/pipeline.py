"""Deterministic synthetic data: the LM token stream, the recsys click
stream and the GNN graphs.

Every batch is a pure function of its seed (and step), so a restarted job
resumes the exact stream position, as bit-exact checkpoint/restart needs.
The draws are the reference's numpy streams, in its order, so both
packages see the same tokens, clicks and graphs.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch

from repro_torch.configs.base import LMConfig, RecsysConfig
from repro_torch.core.graph import Graph, erdos_renyi_graph
from repro_torch.device import resolve_device
from repro_torch.models.gnn.message import GraphBatch

__all__ = ["token_batches", "click_batches", "graph_batch_from_shape", "synthetic_cora"]


def token_batches(cfg: LMConfig, batch: int, seq_len: int, seed: int = 0, start_step: int = 0,
                  device=None) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Zipf-ish synthetic token stream: ``(tokens, labels)`` per step, int64
    tensors of ``(batch, seq_len)`` on ``device`` (``None``: the card; raises
    here, not at the first batch, without one), labels the tokens shifted
    by one."""
    device = resolve_device(device)

    def stream():
        step = start_step
        while True:
            rng = np.random.default_rng((seed, step))
            # skewed unigram distribution ~ real text token frequencies
            u = rng.random((batch, seq_len + 1))
            toks = torch.as_tensor(np.minimum((u ** -0.7 - 1.0) * 20, cfg.vocab_size - 1)
                                   .astype(np.int64))
            yield toks[:, :-1].to(device), toks[:, 1:].to(device)
            step += 1

    return stream()


def click_batches(cfg: RecsysConfig, batch: int, seed: int = 0, start_step: int = 0,
                  device=None) -> Iterator[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """``(user_idx, item_idx, log_q)`` per step with power-law item
    popularity: int64 tensors of ``(batch, n_user_fields, bag)`` and
    ``(batch, n_item_fields, bag)`` drawn over the config's vocab sizes, and
    fp32 ``log_q`` (computed in float64), on ``device`` (``None``: the card;
    raises here, not at the first batch, without one)."""
    device = resolve_device(device)
    n_uf, n_if, bag = cfg.n_user_fields, cfg.n_item_fields, cfg.multi_hot_per_field

    def fields(u, sizes):
        return np.stack([np.minimum((u[:, f] ** 2) * v, v - 1).astype(np.int64)
                         for f, v in enumerate(sizes)], axis=1)

    def stream():
        step = start_step
        while True:
            rng = np.random.default_rng((seed, step))
            u = rng.random((batch, n_uf, bag))
            i = rng.random((batch, n_if, bag))
            user_idx = fields(u, cfg.user_vocab_sizes[:n_uf])
            item_idx = fields(i, cfg.item_vocab_sizes[:n_if])
            log_q = np.log(1.0 / (1.0 + item_idx[:, 0, 0].astype(np.float64) + 1e-6)).astype(np.float32)
            yield tuple(torch.as_tensor(a).to(device) for a in (user_idx, item_idx, log_q))
            step += 1

    return stream()


def synthetic_cora(n: int = 2708, e: int = 5278, d: int = 1433, classes: int = 7, seed: int = 0,
                   device=None) -> Tuple[Graph, torch.Tensor, torch.Tensor]:
    """Cora-shaped citation graph: the host :class:`Graph`, and the
    ``(n, d)`` float32 features and int64 labels on ``device`` (``None``:
    the card)."""
    device = resolve_device(device)
    g = erdos_renyi_graph(n, e, seed=seed)
    rng = np.random.default_rng(seed)
    feat = (rng.random((n, d)) < 0.012).astype(np.float32)  # sparse bag-of-words
    labels = rng.integers(0, classes, size=n).astype(np.int64)
    return g, torch.as_tensor(feat, device=device), torch.as_tensor(labels, device=device)


def graph_batch_from_shape(
    n_nodes: int,
    n_edges: int,
    d_feat: int,
    seed: int = 0,
    batch_graphs: int = 1,
    with_positions: bool = True,
    device=None,
) -> Tuple[GraphBatch, torch.Tensor]:
    """GraphBatch (+ int64 labels) for a shape cell on ``device`` (``None``:
    the card); block-diagonal when ``batch_graphs > 1`` (molecule cells).
    Edge endpoints are int64."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_total = n_nodes * batch_graphs
    e_total = n_edges * batch_graphs
    src = rng.integers(0, n_nodes, size=e_total).astype(np.int32)
    dst = rng.integers(0, n_nodes, size=e_total).astype(np.int32)
    offs = np.repeat(np.arange(batch_graphs, dtype=np.int32) * n_nodes, n_edges)
    src, dst = src + offs, dst + offs

    def put(a):
        return torch.as_tensor(a, device=device)

    node_feat = put(rng.standard_normal((n_total, d_feat)).astype(np.float32))
    positions = (put(rng.standard_normal((n_total, 3)).astype(np.float32) * 2.0)
                 if with_positions else None)
    batch = GraphBatch(
        node_feat=node_feat,
        positions=positions,
        src=put(src).to(torch.int64),
        dst=put(dst).to(torch.int64),
        edge_mask=torch.ones((e_total,), dtype=torch.float32, device=device),
        node_mask=torch.ones((n_total,), dtype=torch.float32, device=device),
        graph_id=torch.arange(batch_graphs, device=device).repeat_interleave(n_nodes),
        n_graphs=batch_graphs,
    )
    labels = put(rng.integers(0, 7, size=n_total).astype(np.int64))
    return batch, labels
