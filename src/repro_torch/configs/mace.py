"""MACE (Batatia et al.) [arXiv:2206.07697] — correlation order 3, l_max=2."""

from repro_torch.configs.base import GNNConfig

CONFIG = GNNConfig(
    name="mace", model="mace", n_layers=2, d_hidden=128,
    l_max=2, n_rbf=8, cutoff=5.0, correlation_order=3, n_classes=1,
)
SMOKE_CONFIG = GNNConfig(
    name="mace-smoke", model="mace", n_layers=2, d_hidden=8,
    l_max=2, n_rbf=4, cutoff=5.0, correlation_order=3, n_classes=1,
)
