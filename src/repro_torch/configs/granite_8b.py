"""Granite 8B code (llama-arch, GQA kv=8) [arXiv:2405.04324; hf]."""

from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="granite-8b",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab_size=49152,
    ffn_activation="swiglu",
    rope_theta=10000000.0,
)

SMOKE_CONFIG = LMConfig(
    name="granite-8b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab_size=128,
    ffn_activation="swiglu",
    remat=False,
    attn_q_chunk=16,
    dtype="float32",
    scan_layers=False,
)
