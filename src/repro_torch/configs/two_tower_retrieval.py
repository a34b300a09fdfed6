"""Two-tower retrieval (YouTube, RecSys'19): embed_dim 256, towers
1024-512-256, dot interaction, in-batch sampled softmax."""

from repro_torch.configs.base import RecsysConfig

CONFIG = RecsysConfig(
    name="two-tower-retrieval",
    embed_dim=256,
    tower_mlp=(1024, 512, 256),
)

SMOKE_CONFIG = RecsysConfig(
    name="two-tower-smoke",
    embed_dim=16,
    tower_mlp=(64, 32, 16),
    n_user_fields=3,
    n_item_fields=3,
    user_vocab_sizes=(1000, 500, 100),
    item_vocab_sizes=(2000, 500, 100),
    multi_hot_per_field=2,
)
