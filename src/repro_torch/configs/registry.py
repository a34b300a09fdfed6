"""--arch registry of the port: architecture ids -> config modules.

The LMs (dense GQA, MLA, MoE), the GNNs (GCN, GAT, NequIP, MACE) and the
paper's own workload (``subgraph2vec``, family ``"subgraph"``) are ported.  Asking for any other architecture of the
reference's registry raises ``NotImplementedError`` naming the ROADMAP item
that ports it; an id the reference does not know raises ``KeyError``.  The
reference's shape grids (``SUBGRAPH_SHAPES``, ``shapes_for``,
``all_cells``) serve its launch dry-run and come with the launch tooling
(ROADMAP queue 1 item 14b).
"""

from __future__ import annotations

import importlib
from typing import Dict, Tuple

__all__ = ["ARCHS", "get_arch"]

# arch id -> (family, config module)
ARCHS: Dict[str, Tuple[str, str]] = {
    "nemotron-4-15b": ("lm", "repro_torch.configs.nemotron_4_15b"),
    "granite-8b": ("lm", "repro_torch.configs.granite_8b"),
    "granite-20b": ("lm", "repro_torch.configs.granite_20b"),
    "deepseek-v2-lite-16b": ("lm", "repro_torch.configs.deepseek_v2_lite_16b"),
    "dbrx-132b": ("lm", "repro_torch.configs.dbrx_132b"),
    "gat-cora": ("gnn", "repro_torch.configs.gat_cora"),
    "nequip": ("gnn", "repro_torch.configs.nequip"),
    "gcn-cora": ("gnn", "repro_torch.configs.gcn_cora"),
    "mace": ("gnn", "repro_torch.configs.mace"),
    # the paper's own workload
    "subgraph2vec": ("subgraph", "repro_torch.configs.subgraph2vec"),
}

# arch id of the reference's registry -> the ROADMAP item that ports it
_NOT_PORTED: Dict[str, str] = {
    "two-tower-retrieval": "ROADMAP queue 1 item 15b (recsys)",
}


def get_arch(arch: str):
    """Returns (family, config module)."""
    if arch in _NOT_PORTED:
        raise NotImplementedError(f"arch {arch!r} is not ported yet: {_NOT_PORTED[arch]}")
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    family, module = ARCHS[arch]
    return family, importlib.import_module(module)
