"""--arch registry of the port: architecture ids -> config modules and shape
grids.

Every architecture of the reference's registry is ported: the LMs (dense
GQA, MLA, MoE), the GNNs (GCN, GAT, NequIP, MACE), the two-tower
recommender and the paper's own workload (``subgraph2vec``, family
``"subgraph"``); an id the reference does not know raises ``KeyError``.
``shapes_for`` and ``all_cells`` are the reference's (arch x shape) grid,
in its order, the cells ``python -m repro_torch.launch.dryrun`` analyses.
"""

from __future__ import annotations

import importlib
from typing import Dict, List, Tuple

from repro_torch.configs.base import GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES, ShapeCell

__all__ = ["ARCHS", "get_arch", "shapes_for", "all_cells", "SUBGRAPH_SHAPES"]

# arch id -> (family, config module), in the reference's order
ARCHS: Dict[str, Tuple[str, str]] = {
    "deepseek-v2-lite-16b": ("lm", "repro_torch.configs.deepseek_v2_lite_16b"),
    "dbrx-132b": ("lm", "repro_torch.configs.dbrx_132b"),
    "nemotron-4-15b": ("lm", "repro_torch.configs.nemotron_4_15b"),
    "granite-8b": ("lm", "repro_torch.configs.granite_8b"),
    "granite-20b": ("lm", "repro_torch.configs.granite_20b"),
    "gat-cora": ("gnn", "repro_torch.configs.gat_cora"),
    "nequip": ("gnn", "repro_torch.configs.nequip"),
    "gcn-cora": ("gnn", "repro_torch.configs.gcn_cora"),
    "mace": ("gnn", "repro_torch.configs.mace"),
    "two-tower-retrieval": ("recsys", "repro_torch.configs.two_tower_retrieval"),
    # the paper's own workload (extra cells beyond the assigned 40)
    "subgraph2vec": ("subgraph", "repro_torch.configs.subgraph2vec"),
}

# paper workloads: dataset x template (Table II / III / Fig 12 analogues)
SUBGRAPH_SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("rmat1m_u12", "count", {"n_vertices": 1_000_000, "n_edges": 200_000_000, "k": 12}),
    ShapeCell("rmat1m_u17", "count", {"n_vertices": 1_000_000, "n_edges": 200_000_000, "k": 17}),
    ShapeCell("rmat1m_u20", "count", {"n_vertices": 1_000_000, "n_edges": 200_000_000, "k": 20}),
    ShapeCell("gs22_u14", "count", {"n_vertices": 2_000_000, "n_edges": 128_000_000, "k": 14}),
)

_SHAPES = {"lm": LM_SHAPES, "gnn": GNN_SHAPES, "recsys": RECSYS_SHAPES, "subgraph": SUBGRAPH_SHAPES}


def get_arch(arch: str):
    """Returns (family, config module)."""
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    family, module = ARCHS[arch]
    return family, importlib.import_module(module)


def shapes_for(arch: str) -> Tuple[ShapeCell, ...]:
    family, _ = ARCHS[arch]
    return _SHAPES[family]


def all_cells(include_subgraph: bool = False) -> List[Tuple[str, ShapeCell]]:
    """The (arch x shape) dry-run grid: 40 assigned cells (+ paper cells)."""
    cells = []
    for arch, (family, _) in ARCHS.items():
        if family == "subgraph" and not include_subgraph:
            continue
        for shape in _SHAPES[family]:
            cells.append((arch, shape))
    return cells
