"""GraphSAGE-style layered fanout neighbor sampler.

``minibatch_lg`` cells train on node-flows sampled with fanouts (15, 10):
layer 0 = ``batch_nodes`` seeds, layer l+1 = ``fanout_l`` uniformly sampled
neighbors per layer-l node (with replacement, masked for isolated nodes).
The sampled subgraph's shape depends only on the fanouts.

Sampling runs over a flat CSR (row_ptr, col_idx): per frontier node draw a
position in ``[0, deg)`` and gather ``col_idx[row_ptr + pos]``.  The draws
are ``repro_torch.core.prng``'s threefry ``split`` and ``randint``,
bit-equal to ``jax.random``'s, so a key samples the neighbours the
reference samples, on the CPU and on a card alike.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.prng import as_keys, randint, split

from .message import GraphBatch

__all__ = ["NodeFlow", "sample_node_flow", "node_flow_to_batch"]


@dataclass(frozen=True)
class NodeFlow:
    """Layered sampling forest.  ``layer_nodes[l]`` are global node ids; layer
    l+1 has ``len(layer_nodes[l]) * fanout_l`` entries; ``layer_valid`` masks
    slots whose source node had no neighbors."""

    layer_nodes: Tuple[torch.Tensor, ...]
    layer_valid: Tuple[torch.Tensor, ...]
    fanouts: Tuple[int, ...]


def sample_node_flow(
    key,                    # (2,) threefry key (a tensor, or numpy words)
    row_ptr: torch.Tensor,  # (n+1,) int
    col_idx: torch.Tensor,  # (2E,) int
    seeds: torch.Tensor,    # (batch_nodes,) int
    fanouts: Sequence[int],
) -> NodeFlow:
    """Draws on ``row_ptr``'s device; node ids come back as int64."""
    device = row_ptr.device
    key = as_keys(key, device=device)
    row_ptr, col_idx = row_ptr.to(torch.int64), col_idx.to(torch.int64)
    seeds = seeds.to(device=device, dtype=torch.int64)
    # an isolated last node reads one past col_idx's end; the reference's
    # gather clamps that index, and so does this one
    last = max(col_idx.numel() - 1, 0)
    layer_nodes = [seeds]
    layer_valid = [torch.ones(seeds.shape, dtype=torch.float32, device=device)]
    frontier = seeds
    fvalid = layer_valid[0]
    for fanout in fanouts:
        key, sub = split(key, 2).unbind(-2)
        start = row_ptr[frontier]
        deg = row_ptr[frontier + 1] - start
        pos = randint(sub, (frontier.shape[0], fanout), 0, 1 << 30)
        pos = pos % deg.clamp(min=1)[:, None]
        nbrs = col_idx[(start[:, None] + pos).clamp(max=last)]  # (m, fanout)
        valid = ((deg > 0).to(torch.float32) * fvalid)[:, None].expand(nbrs.shape)
        frontier = nbrs.reshape(-1)
        fvalid = valid.reshape(-1)
        layer_nodes.append(frontier)
        layer_valid.append(fvalid)
    return NodeFlow(tuple(layer_nodes), tuple(layer_valid), tuple(fanouts))


def node_flow_to_batch(
    flow: NodeFlow,
    features: torch.Tensor,        # (n_global, d) — gathered per sampled node
    positions: torch.Tensor = None,  # (n_global, 3) optional
) -> GraphBatch:
    """Flatten a node-flow into a block GraphBatch.

    Edges point child -> parent (messages flow toward the seeds), plus the
    reverse direction so symmetric models (GCN norm) behave; local node ids
    are layer-major.
    """
    device = flow.layer_nodes[0].device
    sizes = [int(x.shape[0]) for x in flow.layer_nodes]
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    n_local = int(offsets[-1])

    src_parts, dst_parts, mask_parts = [], [], []
    for l, fanout in enumerate(flow.fanouts):
        parents = torch.arange(sizes[l], dtype=torch.int64, device=device) + int(offsets[l])
        children = torch.arange(sizes[l + 1], dtype=torch.int64, device=device) + int(offsets[l + 1])
        par_rep = parents.repeat_interleave(fanout)
        src_parts += [children, par_rep]
        dst_parts += [par_rep, children]
        m = flow.layer_valid[l + 1]
        mask_parts += [m, m]

    all_nodes = torch.cat(flow.layer_nodes)
    return GraphBatch(
        node_feat=features[all_nodes],
        positions=None if positions is None else positions[all_nodes],
        src=torch.cat(src_parts),
        dst=torch.cat(dst_parts),
        edge_mask=torch.cat(mask_parts),
        node_mask=torch.cat(flow.layer_valid),
        graph_id=torch.zeros((n_local,), dtype=torch.int64, device=device),
        n_graphs=1,
    )
