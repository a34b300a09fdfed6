"""GCN on Cora (Kipf & Welling) [arXiv:1609.02907]."""

from repro_torch.configs.base import GNNConfig

CONFIG = GNNConfig(
    name="gcn-cora", model="gcn", n_layers=2, d_hidden=16,
    aggregator="mean", sym_norm=True, n_classes=7,
)
SMOKE_CONFIG = CONFIG  # already CPU-sized
