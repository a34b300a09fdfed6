"""NequIP (Batzner et al.) [arXiv:2101.03164] — l_max=2 in Cartesian form."""

from repro_torch.configs.base import GNNConfig

CONFIG = GNNConfig(
    name="nequip", model="nequip", n_layers=5, d_hidden=32,
    l_max=2, n_rbf=8, cutoff=5.0, n_classes=1,
)
SMOKE_CONFIG = GNNConfig(
    name="nequip-smoke", model="nequip", n_layers=2, d_hidden=8,
    l_max=2, n_rbf=4, cutoff=5.0, n_classes=1,
)
