"""GAT on Cora (Velickovic et al.) [arXiv:1710.10903]."""

from repro_torch.configs.base import GNNConfig

CONFIG = GNNConfig(
    name="gat-cora", model="gat", n_layers=2, d_hidden=8, n_heads=8,
    aggregator="attn", n_classes=7,
)
SMOKE_CONFIG = CONFIG
