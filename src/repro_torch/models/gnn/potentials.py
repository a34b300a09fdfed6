"""NequIP (arXiv:2101.03164) and MACE (arXiv:2206.07697) interatomic
potentials on the Cartesian l<=2 irrep stack.

* **NequIP**: ``n_layers`` interaction blocks.  Each block builds edge
  messages as (radial-MLP-weighted) tensor products of neighbor features with
  the edge spherical harmonics, segment-sums them, then applies an
  equivariant linear + gate.  Energy readout from final scalars.
* **MACE**: 2 layers; each builds the one-particle basis ``A_i`` (same
  message as NequIP), then the higher-order ACE basis ``B_i`` via repeated
  tensor products of ``A_i`` with itself up to ``correlation_order`` (=3),
  linearly mixed.  Per-layer energy readouts are summed.

Inputs are a ``GraphBatch`` with ``positions``; node features seed the l=0
channels.  Predicts per-graph energies.  The reference's ``node_spec`` /
``chan_spec`` sharding hints have no counterpart on one device.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import GNNConfig

from .equivariant import (
    Irreps,
    _normal,
    bessel_basis,
    cutoff_envelope,
    gate,
    init_linear_mix,
    linear_mix,
    spherical_l1,
    spherical_l2,
    tp_paths_order2,
)
from .message import GraphBatch, Segments, aggregate_sum

__all__ = ["init_nequip", "nequip_forward", "init_mace", "mace_forward"]


def _mlp_init(gen, dims, device):
    return [
        {
            "w": _normal(gen, (dims[i], dims[i + 1]), device) / math.sqrt(dims[i]),
            "b": torch.zeros((dims[i + 1],), device=device),
        }
        for i in range(len(dims) - 1)
    ]


def _mlp_apply(layers, x):
    for i, l in enumerate(layers):
        x = x @ l["w"] + l["b"]
        if i < len(layers) - 1:
            x = F.silu(x)
    return x


def _edge_messages(params, cfg: GNNConfig, feats: Irreps, positions, src: Segments, dst: Segments,
                   edge_mask):
    """Per-edge tensor-product messages for one edge (chunk); ``src`` and
    ``dst`` are the edges' endpoint :class:`Segments`."""
    rel = dst.gather(positions) - src.gather(positions)
    r = torch.sqrt(torch.sum(rel * rel, dim=-1) + 1e-18)
    unit = rel / r[:, None]
    rbf = bessel_basis(r, cfg.n_rbf, cfg.cutoff)
    env = cutoff_envelope(r, cfg.cutoff) * edge_mask
    rbf = rbf * env[:, None]
    y1 = spherical_l1(unit)
    y2 = spherical_l2(unit)
    rw = _mlp_apply(params["radial"], rbf)  # (e, 3*c)
    w0, w1, w2 = rw.chunk(3, dim=-1)
    h_src = Irreps(s=src.gather(feats.s), v=src.gather(feats.v), t=src.gather(feats.t))
    edge = Irreps(
        s=w0,
        v=w1[..., None] * y1[:, None, :],
        t=w2[..., None, None] * y2[:, None, :, :],
    )
    return tp_paths_order2(h_src, edge)


def _aggregate(msg: Irreps, dst: Segments, n: int, edge_mask) -> Irreps:
    return Irreps(
        s=aggregate_sum(msg.s, dst, n, edge_mask),
        v=aggregate_sum(msg.v, dst, n, edge_mask),
        t=aggregate_sum(msg.t, dst, n, edge_mask),
    )


def _chunk_aggregate(params, cfg: GNNConfig, feats: Irreps, positions, src, dst, edge_mask, n: int) -> Irreps:
    """One edge chunk's aggregate; its sorts are made here, so that they,
    like the messages, live only while the chunk runs (and again when the
    backward recomputes it)."""
    src, dst = Segments(src, n), Segments(dst, n)
    return _aggregate(_edge_messages(params, cfg, feats, positions, src, dst, edge_mask), dst, n,
                      edge_mask)


def _message_block(params, cfg: GNNConfig, batch: GraphBatch, feats: Irreps) -> Irreps:
    """One-particle basis: A_i = sum_j R(r_ij) * (Y(r_ij) (x) h_j).

    With ``cfg.edge_chunk > 0`` (dividing the edge count, and below it) the
    per-edge messages are built and reduced one chunk at a time, each chunk
    under ``torch.utils.checkpoint``: peak edge-message memory is one
    chunk's, and the backward recomputes each chunk's messages.  ``batch``
    has its edges sorted by destination.
    """
    n = batch.n_nodes
    e_total = batch.n_edges
    chunk = cfg.edge_chunk
    if chunk <= 0 or e_total <= chunk or e_total % chunk != 0:
        msg = _edge_messages(params, cfg, feats, batch.positions, batch.src_segments,
                             batch.dst_segments, batch.edge_mask)
        return _aggregate(msg, batch.dst_segments, n, batch.edge_mask)

    agg = None
    for src_i, dst_i, mask_i in zip(batch.src.split(chunk), batch.dst.split(chunk),
                                    batch.edge_mask.split(chunk)):
        part = checkpoint(_chunk_aggregate, params, cfg, feats, batch.positions, src_i, dst_i,
                          mask_i, n, use_reentrant=False)
        agg = part if agg is None else Irreps(s=agg.s + part.s, v=agg.v + part.v, t=agg.t + part.t)
    return agg


def _tp_out_channels(c: int) -> Tuple[int, int, int]:
    """Channel counts produced by tp_paths_order2 on equal-width inputs."""
    return (3 * c, 5 * c, 4 * c)


def _initial_feats(params, cfg: GNNConfig, batch: GraphBatch) -> Irreps:
    n, c = batch.n_nodes, cfg.d_hidden
    dev = batch.node_feat.device
    return Irreps(
        s=_mlp_apply(params["embed"], batch.node_feat),
        v=torch.zeros((n, c, 3), dtype=torch.float32, device=dev),
        t=torch.zeros((n, c, 3, 3), dtype=torch.float32, device=dev),
    )


def _graph_energy(readout, feats: Irreps, batch: GraphBatch) -> torch.Tensor:
    node_e = _mlp_apply(readout, feats.s)[:, 0] * batch.node_mask
    return batch.graph_segments.sum(node_e)


# ---------------------------------------------------------------------------
# NequIP
# ---------------------------------------------------------------------------


def init_nequip(gen, cfg: GNNConfig, d_in: int, device: torch.device) -> Dict:
    c = cfg.d_hidden
    params: Dict = {
        "embed": _mlp_init(gen, [d_in, c], device),
        "blocks": [],
        "readout": _mlp_init(gen, [c, c, 1], device),
    }
    for _ in range(cfg.n_layers):
        params["blocks"].append({
            "radial": _mlp_init(gen, [cfg.n_rbf, c, 3 * c], device),
            # scalar output width 3c: c features + c vector gates + c tensor gates
            "mix": init_linear_mix(gen, _tp_out_channels(c), (3 * c, c, c), device),
            "self": init_linear_mix(gen, (c, c, c), (3 * c, c, c), device),
        })
    return params


def nequip_forward(params: Dict, cfg: GNNConfig, batch: GraphBatch) -> torch.Tensor:
    """Per-graph energies (n_graphs,)."""
    batch = batch.by_dst()
    feats = _initial_feats(params, cfg, batch)
    for block in params["blocks"]:
        agg = _message_block(block, cfg, batch, feats)
        mixed = linear_mix(block["mix"], agg)
        res = linear_mix(block["self"], feats)
        feats = gate(Irreps(s=mixed.s + res.s, v=mixed.v + res.v, t=mixed.t + res.t))
    return _graph_energy(params["readout"], feats, batch)


# ---------------------------------------------------------------------------
# MACE
# ---------------------------------------------------------------------------


def init_mace(gen, cfg: GNNConfig, d_in: int, device: torch.device) -> Dict:
    c = cfg.d_hidden
    params: Dict = {"embed": _mlp_init(gen, [d_in, c], device), "blocks": []}
    for _ in range(cfg.n_layers):
        params["blocks"].append({
            "radial": _mlp_init(gen, [cfg.n_rbf, c, 3 * c], device),
            "mix_a": init_linear_mix(gen, _tp_out_channels(c), (c, c, c), device),
            # symmetric contractions: A^2 and A^3 mixed back to width c
            "mix_b2": init_linear_mix(gen, _tp_out_channels(c), (c, c, c), device),
            "mix_b3": init_linear_mix(gen, _tp_out_channels(c), (c, c, c), device),
            # scalar width 3c for the gate (c features + c + c gates)
            "update": init_linear_mix(gen, (3 * c, 3 * c, 3 * c), (3 * c, c, c), device),
            "readout": _mlp_init(gen, [c, 1], device),
        })
    return params


def mace_forward(params: Dict, cfg: GNNConfig, batch: GraphBatch) -> torch.Tensor:
    """Per-graph energies; higher-order ACE basis up to correlation order."""
    batch = batch.by_dst()
    feats = _initial_feats(params, cfg, batch)
    energy = None
    for block in params["blocks"]:
        a = linear_mix(block["mix_a"], _message_block(block, cfg, batch, feats))
        # ACE product basis: B1 = A, B2 = mix(A (x) A), B3 = mix(B2 (x) A)
        basis = [a]
        if cfg.correlation_order >= 2:
            basis.append(linear_mix(block["mix_b2"], tp_paths_order2(a, a)))
        if cfg.correlation_order >= 3:
            basis.append(linear_mix(block["mix_b3"], tp_paths_order2(basis[-1], a)))
        while len(basis) < 3:
            basis.append(basis[-1])
        stacked = Irreps(
            s=torch.cat([b.s for b in basis], dim=-1),
            v=torch.cat([b.v for b in basis], dim=-2),
            t=torch.cat([b.t for b in basis], dim=-3),
        )
        feats = gate(linear_mix(block["update"], stacked))
        e = _graph_energy(block["readout"], feats, batch)
        energy = e if energy is None else energy + e
    return energy
