"""The paper's own workload configs (RMAT-1M and Graph500-scale datasets).

``CONFIG`` (u17 on one million vertices and 200 million edges) needs about
198 GB of fp32 DP state per coloring, more than one card holds; it runs
with the mesh backend (ROADMAP queue 1 item 11).  ``SMOKE_CONFIG`` runs
anywhere.
"""

from repro_torch.configs.base import SubgraphConfig

CONFIG = SubgraphConfig(
    name="subgraph2vec",
    n_vertices=1_000_000,
    n_edges=200_000_000,
    template="u17",
)

SMOKE_CONFIG = SubgraphConfig(
    name="subgraph2vec-smoke",
    n_vertices=512,
    n_edges=2_000,
    template="u5-2",
)
