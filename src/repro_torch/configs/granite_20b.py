"""Granite 20B code (llama-arch, MQA kv=1) [arXiv:2405.04324; hf]."""

from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="granite-20b",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_head=128,
    d_ff=24576,
    vocab_size=49152,
    ffn_activation="gelu",  # GPT-BigCode lineage; matches 20B param count
    rope_theta=10000.0,
)

SMOKE_CONFIG = LMConfig(
    name="granite-20b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    d_head=16,
    d_ff=128,
    vocab_size=128,
    ffn_activation="swiglu",
    remat=False,
    attn_q_chunk=16,
    dtype="float32",
    scan_layers=False,
)
