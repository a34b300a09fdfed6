"""Depth and edge-count probes: an affine fit from two reduced cells.

The reference probes because XLA's ``cost_analysis`` counts a ``scan``
body once.  The port's ``meta`` trace is eager and sees every layer, so
that reason does not hold; the probes keep the reference's method and
surface for two other uses:

* on the CPU, they check that a full-depth count is affine in the depth
  (two reduced depths fit the full one);
* on a card, they extrapolate a measured step time and peak memory from
  runs that fit one card to the full depth (``chip_smoke.py``
  ``[launch]``).

* **LM**: two depths L1 < L2 (``fk + 1``, ``fk + 2``; ``fk`` the dense
  layers before an MoE stack), the whole batch as one microbatch;
  ``cost(L) = a + b * L`` evaluated at the real depth.
* **GNN (equivariant, edge-chunked)**: two edge counts, 2^20 and 2^21.
* **subgraph2vec**: one probe cell (no column batch, the ``vectorized``
  eMA).
* **recsys / other GNN cells**: no loop, no probe (``None``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

from repro_torch.configs.base import ShapeCell
from repro_torch.configs.registry import get_arch

__all__ = ["probe_costs", "affine_fit"]


def _affine_extrapolate(c1, c2, x1: float, x2: float, x_full: float):
    out = []
    for v1, v2 in zip(c1, c2):
        b = (v2 - v1) / (x2 - x1)
        a = v1 - b * x1
        out.append(max(a + b * x_full, 0.0))
    return tuple(out)


def affine_fit(x1: float, y1: float, x2: float, y2: float, x: float) -> float:
    """The line through ``(x1, y1)`` and ``(x2, y2)`` at ``x``."""
    return _affine_extrapolate((y1,), (y2,), x1, x2, x)[0]


def _costs(cell, mesh) -> Sequence[float]:
    from repro_torch.launch.dryrun import cell_counts
    from repro_torch.launch.roofline import collective_seconds, collective_wire_bytes

    c = cell_counts(cell, mesh)
    return (c["flops"], c["bytes"], collective_wire_bytes(c["log"])[0],
            collective_seconds(c["log"], mesh))


def _result(costs, method: str) -> Dict[str, float]:
    flops, byts, coll, coll_s = costs
    return {"flops": flops, "bytes": byts, "collective_bytes": coll, "collective_s": coll_s,
            "method": method}


def probe_costs(arch: str, shape: ShapeCell, mesh, cfg=None) -> Optional[Dict[str, float]]:
    """Per-device ``flops``, ``bytes``, ``collective_bytes`` (and
    ``collective_s``) fitted to the full size, or ``None`` for a loop-free
    cell.  ``cfg`` replaces the arch's published config."""
    from repro_torch.launch.cells import build_cell

    family, module = get_arch(arch)
    cfg = cfg if cfg is not None else module.CONFIG

    if family == "lm":
        fk = cfg.first_k_dense if cfg.moe else 0
        l1, l2 = fk + 1, fk + 2
        c1 = _costs(build_cell(arch, shape, mesh, cfg_override=dataclasses.replace(cfg, n_layers=l1)), mesh)
        c2 = _costs(build_cell(arch, shape, mesh, cfg_override=dataclasses.replace(cfg, n_layers=l2)), mesh)
        # the probes run the whole batch as one microbatch: the same total
        # work as the n_micro-accumulated step
        return _result(_affine_extrapolate(c1, c2, l1, l2, cfg.n_layers), f"lm-depth L={l1},{l2}")

    if family == "gnn" and cfg.model in ("nequip", "mace"):
        if shape.kind != "full_graph" or build_cell(arch, shape, mesh).meta["n_edges"] <= (1 << 22):
            return None
        e1, e2 = 1 << 20, 1 << 21

        def with_edges(e):
            return ShapeCell(shape.name, shape.kind, dict(shape.params, n_edges=e))

        cell1, cell2 = build_cell(arch, with_edges(e1), mesh), build_cell(arch, with_edges(e2), mesh)
        e1p, e2p = cell1.meta["n_edges"], cell2.meta["n_edges"]
        e_target = build_cell(arch, shape, mesh).meta["n_edges"]
        costs = _affine_extrapolate(_costs(cell1, mesh), _costs(cell2, mesh), e1p, e2p, e_target)
        return _result(costs, f"gnn-edges e={e1p},{e2p}")

    if family == "subgraph":
        return _result(_costs(build_cell(arch, shape, mesh, subgraph_probe=True), mesh),
                       "subgraph-unbatched")

    return None  # recsys, gcn/gat: loop-free
