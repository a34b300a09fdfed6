"""Nemotron-4 15B (dense, GQA kv=8, squared-ReLU) [arXiv:2402.16819]."""

from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="nemotron-4-15b",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=24576,
    vocab_size=256000,
    ffn_activation="squared_relu",
    rope_theta=10000.0,
)

SMOKE_CONFIG = LMConfig(
    name="nemotron-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=256,
    vocab_size=128,
    ffn_activation="squared_relu",
    remat=False,
    attn_q_chunk=16,
    dtype="float32",
    scan_layers=False,
)
