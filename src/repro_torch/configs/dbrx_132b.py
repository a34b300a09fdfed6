"""DBRX 132B (16-expert top-4 MoE, GQA kv=8) [hf:databricks/dbrx-base]."""

from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="dbrx-132b",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=10752,
    vocab_size=100352,
    ffn_activation="swiglu",
    moe=True,
    n_experts=16,
    n_shared_experts=0,
    moe_top_k=4,
    moe_d_ff=10752,
    first_k_dense=0,
    rope_theta=500000.0,
)

SMOKE_CONFIG = LMConfig(
    name="dbrx-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab_size=128,
    ffn_activation="swiglu",
    moe=True,
    n_experts=4,
    n_shared_experts=0,
    moe_top_k=2,
    moe_d_ff=128,
    remat=False,
    attn_q_chunk=16,
    dtype="float32",
    scan_layers=False,
)
