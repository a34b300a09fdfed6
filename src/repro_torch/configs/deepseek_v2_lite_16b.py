"""DeepSeek-V2-Lite 16B (MLA + fine-grained MoE) [arXiv:2405.04434; hf].

64 routed + 2 shared experts, top-6 (the full V2 has 160 routed).
"""

from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="deepseek-v2-lite-16b",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,            # first dense layer
    vocab_size=102400,
    attention="mla",
    kv_lora_rank=512,
    qk_rope_head_dim=64,
    qk_nope_head_dim=128,
    v_head_dim=128,
    ffn_activation="swiglu",
    moe=True,
    n_experts=64,
    n_shared_experts=2,
    moe_top_k=6,
    moe_d_ff=1408,
    first_k_dense=1,
    rope_theta=10000.0,
)

SMOKE_CONFIG = LMConfig(
    name="deepseek-v2-lite-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=128,
    attention="mla",
    kv_lora_rank=32,
    qk_rope_head_dim=8,
    qk_nope_head_dim=16,
    v_head_dim=16,
    ffn_activation="swiglu",
    moe=True,
    n_experts=4,
    n_shared_experts=1,
    moe_top_k=2,
    moe_d_ff=32,
    first_k_dense=1,
    remat=False,
    attn_q_chunk=16,
    dtype="float32",
    scan_layers=False,
)
