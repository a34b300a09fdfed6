"""GCN (Kipf & Welling 2017) and GAT (Velickovic et al. 2018).

Both run on the shared segment-sum message-passing primitives, the same
SpMM regime as the paper's counting kernel (SpMM / SDDMM family).  Each
forward takes the batch's edges sorted by destination
(:meth:`GraphBatch.by_dst`), so messages come out in the order the
segment sums read them; the per-node results are those of the batch's
own edge order.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import GNNConfig

from .equivariant import _normal
from .message import GraphBatch, aggregate_sum, edge_softmax, sym_norm_coeffs

__all__ = ["init_gcn", "gcn_forward", "init_gat", "gat_forward"]


def _glorot(gen: Optional[torch.Generator], shape, device: torch.device) -> torch.Tensor:
    fan_in, fan_out = shape[0], shape[-1]
    return _normal(gen, shape, device) * math.sqrt(2.0 / (fan_in + fan_out))


# ---------------------------------------------------------------------------
# GCN
# ---------------------------------------------------------------------------


def init_gcn(gen, cfg: GNNConfig, d_in: int, device: torch.device) -> Dict:
    dims = [d_in] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
    return {
        "layers": [
            {"w": _glorot(gen, (dims[i], dims[i + 1]), device),
             "b": torch.zeros((dims[i + 1],), device=device)}
            for i in range(cfg.n_layers)
        ]
    }


def gcn_forward(params: Dict, cfg: GNNConfig, batch: GraphBatch) -> torch.Tensor:
    """Returns (n, n_classes) logits.  ``Ã X W`` with symmetric normalization
    and implicit self-loops (added via the normalized self term)."""
    batch = batch.by_dst()
    h = batch.node_feat
    n = batch.n_nodes
    dst, src = batch.dst_segments, batch.src_segments
    # the edge mask is applied to the (e,) coefficients rather than to the
    # (e, d) messages: a 0/1 factor, so the same values with one copy less
    coef = sym_norm_coeffs(batch.src, dst, n, batch.edge_mask) * batch.edge_mask
    deg_inv = 1.0 / (dst.sum(batch.edge_mask) + 1.0).clamp(min=1.0)
    for i, layer in enumerate(params["layers"]):
        hw = h @ layer["w"]
        msg = src.gather(hw) * coef[:, None]
        agg = aggregate_sum(msg, dst, n)
        # self-loop term of the renormalized adjacency
        agg = agg + hw * deg_inv[:, None]
        h = agg + layer["b"]
        if i < cfg.n_layers - 1:
            h = F.relu(h)
    return h * batch.node_mask[:, None]


# ---------------------------------------------------------------------------
# GAT
# ---------------------------------------------------------------------------


def init_gat(gen, cfg: GNNConfig, d_in: int, device: torch.device) -> Dict:
    layers = []
    d_prev = d_in
    for i in range(cfg.n_layers):
        last = i == cfg.n_layers - 1
        heads = 1 if last else cfg.n_heads
        d_out = cfg.n_classes if last else cfg.d_hidden
        layers.append(
            {
                "w": _glorot(gen, (d_prev, heads, d_out), device),
                "a_src": _glorot(gen, (heads, d_out), device),
                "a_dst": _glorot(gen, (heads, d_out), device),
            }
        )
        d_prev = heads * d_out if not last else d_out
    return {"layers": layers}


def gat_forward(params: Dict, cfg: GNNConfig, batch: GraphBatch) -> torch.Tensor:
    """SDDMM (edge scores) -> edge softmax -> SpMM, per head."""
    batch = batch.by_dst()
    h = batch.node_feat
    n = batch.n_nodes
    dst, src = batch.dst_segments, batch.src_segments
    for i, layer in enumerate(params["layers"]):
        last = i == len(params["layers"]) - 1
        hw = torch.einsum("nd,dhe->nhe", h, layer["w"])  # (n, heads, d_out)
        # attention logits per edge (GATv1 split form)
        alpha_src = torch.einsum("nhe,he->nh", hw, layer["a_src"])
        alpha_dst = torch.einsum("nhe,he->nh", hw, layer["a_dst"])
        logits = F.leaky_relu(src.gather(alpha_src) + dst.gather(alpha_dst), 0.2)
        att = edge_softmax(logits, dst, n, batch.edge_mask)  # (e, heads)
        # as in GCN, the edge mask goes on the (e, heads) weights
        att = att * batch.edge_mask[:, None]
        agg = aggregate_sum(src.gather(hw) * att[..., None], dst, n)  # (n, heads, d_out)
        if last:
            h = agg.mean(dim=1)
        else:
            h = F.elu(agg).reshape(n, -1)
    return h * batch.node_mask[:, None]
