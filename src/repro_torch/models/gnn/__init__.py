"""GNN model zoo: GCN, GAT (SpMM/SDDMM regime) and NequIP, MACE (equivariant
tensor-product regime) with one init/forward/loss interface.

The reference's ``node_spec`` / ``chan_spec`` arguments are pjit sharding
hints; the forwards here take no layout argument.  The launch tooling's GNN
cells (``repro_torch.launch.cells``) carry the reference's layout choice as
data in their ``meta``, and the dry run prices it analytically.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import GNNConfig
from repro_torch.device import resolve_device

from .equivariant import Irreps
from .message import GraphBatch, Segments, aggregate_max, aggregate_mean, aggregate_sum, edge_softmax
from .potentials import init_mace, init_nequip, mace_forward, nequip_forward
from .sampler import NodeFlow, node_flow_to_batch, sample_node_flow
from .spectral import gat_forward, gcn_forward, init_gat, init_gcn

__all__ = [
    "GraphBatch",
    "Irreps",
    "NodeFlow",
    "Segments",
    "aggregate_sum",
    "aggregate_mean",
    "aggregate_max",
    "edge_softmax",
    "sample_node_flow",
    "node_flow_to_batch",
    "init_model",
    "param_shapes",
    "forward",
    "loss_fn",
]

_INITS = {"gcn": init_gcn, "gat": init_gat, "nequip": init_nequip, "mace": init_mace}
_FWDS = {"gcn": gcn_forward, "gat": gat_forward, "nequip": nequip_forward, "mace": mace_forward}


def init_model(cfg: GNNConfig, d_in: int, seed: int = 0, device=None) -> Dict:
    """fp32 parameters drawn from a ``torch.Generator`` seeded with ``seed``
    on ``device`` (``None``: the card; ``"meta"``: shapes only), at the
    reference's scales.  The draws are not JAX's; tests carry the
    reference's parameters across with
    :func:`repro_torch.interop.gnn_params_from_numpy`."""
    device = resolve_device(device)
    gen = None if device.type == "meta" else torch.Generator(device=device).manual_seed(seed)
    return _INITS[cfg.model](gen, cfg, d_in, device)


def param_shapes(cfg: GNNConfig, d_in: int) -> Dict:
    """The parameter tree as ``meta`` tensors (shape and dtype, no storage)."""
    return init_model(cfg, d_in, device="meta")


def forward(params: Dict, cfg: GNNConfig, batch: GraphBatch) -> torch.Tensor:
    """Node logits (gcn/gat) or per-graph energies (nequip/mace)."""
    return _FWDS[cfg.model](params, cfg, batch)


def loss_fn(params: Dict, cfg: GNNConfig, batch: GraphBatch, labels: torch.Tensor) -> torch.Tensor:
    """gcn/gat: the fp32 log-softmax NLL of ``labels`` (class ids) averaged
    over ``node_mask``; nequip/mace: the mean squared error of the per-graph
    energies against ``labels``."""
    out = forward(params, cfg, batch)
    if cfg.model in ("gcn", "gat"):
        logp = F.log_softmax(out.to(torch.float32), dim=-1)
        nll = -logp.gather(-1, labels.to(torch.int64)[:, None])[:, 0]
        denom = batch.node_mask.sum().clamp(min=1.0)
        return (nll * batch.node_mask).sum() / denom
    # energy regression (labels: per-graph energies)
    err = out.to(torch.float32) - labels.to(torch.float32)
    return torch.mean(err * err)
