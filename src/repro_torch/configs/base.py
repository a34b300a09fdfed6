"""Config dataclasses and the LM, GNN and recsys shape cells (copies of
``repro.configs.base``).

Each ported architecture is a module in ``repro_torch.configs`` exporting
``CONFIG`` (the published configuration) and ``SMOKE_CONFIG`` (a reduced
same-family config for CPU tests): the LMs' :class:`LMConfig`, the GNNs'
:class:`GNNConfig`, the two-tower recommender's :class:`RecsysConfig` and
the paper's own workload, :class:`SubgraphConfig`.  The shape grids are
the cells the launch dry run analyses (``repro_torch.launch.cells`` and
``python -m repro_torch.launch.dryrun``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

__all__ = [
    "LMConfig",
    "GNNConfig",
    "RecsysConfig",
    "SubgraphConfig",
    "ShapeCell",
    "LM_SHAPES",
    "GNN_SHAPES",
    "RECSYS_SHAPES",
]


@dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 128
    ffn_activation: str = "swiglu"  # swiglu | squared_relu | geglu | gelu
    attention: str = "gqa"  # gqa | mla
    # MLA (DeepSeek-V2) parameters
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128
    # MoE
    moe: bool = False
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    first_k_dense: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001
    # misc
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: bool = True
    attn_q_chunk: int = 1024  # query-chunked attention (memory)
    attn_impl: str = "sdpa"  # sdpa | flash (CUDA kernel; cache-free GQA path)
    scan_layers: bool = True

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + layers)."""
        d, h, kv, dh = self.d_model, self.n_heads, self.n_kv_heads, self.d_head
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.attention == "mla":
            attn = d * self.kv_lora_rank + d * h * self.qk_rope_head_dim // h
            attn += self.kv_lora_rank * h * (self.qk_nope_head_dim + self.v_head_dim)
            attn += d * h * (self.qk_nope_head_dim + self.qk_rope_head_dim)
            attn += h * self.v_head_dim * d
        else:
            attn = d * h * dh + 2 * d * kv * dh + h * dh * d
        ff_mult = 3 if self.ffn_activation in ("swiglu", "geglu") else 2
        dense_ffn = ff_mult * d * self.d_ff
        total = emb
        for layer in range(self.n_layers):
            total += attn
            if self.moe and layer >= self.first_k_dense:
                total += (self.n_experts + self.n_shared_experts) * ff_mult * d * self.moe_d_ff
                total += d * self.n_experts  # router
            else:
                total += dense_ffn
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed top-k + shared)."""
        if not self.moe:
            return self.param_count()
        d = self.d_model
        ff_mult = 3 if self.ffn_activation in ("swiglu", "geglu") else 2
        full = self.param_count()
        moe_layers = self.n_layers - self.first_k_dense
        inactive = (self.n_experts - self.moe_top_k) * ff_mult * d * self.moe_d_ff * moe_layers
        return full - inactive


@dataclass(frozen=True)
class GNNConfig:
    name: str
    model: str  # gcn | gat | nequip | mace
    n_layers: int
    d_hidden: int
    n_heads: int = 1
    aggregator: str = "sum"  # sum | mean | attn
    sym_norm: bool = False
    # equivariant params
    l_max: int = 0
    n_rbf: int = 0
    cutoff: float = 0.0
    correlation_order: int = 1
    n_classes: int = 16
    edge_chunk: int = 0  # >0: edge aggregation in chunks, each recomputed in the backward (memory)
    dtype: str = "float32"


@dataclass(frozen=True)
class RecsysConfig:
    name: str
    embed_dim: int
    tower_mlp: Tuple[int, ...]
    interaction: str = "dot"
    n_user_fields: int = 8
    n_item_fields: int = 8
    # per-field vocab sizes (huge sparse tables — the hot path)
    user_vocab_sizes: Tuple[int, ...] = (50_000_000, 10_000_000, 1_000_000, 1_000_000, 100_000, 100_000, 10_000, 1_000)
    item_vocab_sizes: Tuple[int, ...] = (100_000_000, 10_000_000, 1_000_000, 100_000, 100_000, 10_000, 10_000, 1_000)
    multi_hot_per_field: int = 4  # EmbeddingBag bag size
    temperature: float = 0.05
    dtype: str = "float32"


@dataclass(frozen=True)
class SubgraphConfig:
    """The paper's own workload: a graph of ``n_vertices`` / ``n_edges`` and
    one tree template (``repro_torch.core.templates.get_template`` name)."""

    name: str
    n_vertices: int
    n_edges: int
    template: str
    iterations: int = 1
    block_size: int = 256
    colorset_batch: int = 0  # 0 = no batching (paper's batch-size knob)
    dtype: str = "float32"


@dataclass(frozen=True)
class ShapeCell:
    """One (input-shape) column of the dry-run grid."""

    name: str
    kind: str  # train | prefill | decode | serve | retrieval | full_graph | minibatch | molecule
    params: Dict[str, int] = field(default_factory=dict)


LM_SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", "train", {"seq_len": 4096, "global_batch": 256}),
    ShapeCell("prefill_32k", "prefill", {"seq_len": 32768, "global_batch": 32}),
    ShapeCell("decode_32k", "decode", {"seq_len": 32768, "global_batch": 128}),
    ShapeCell("long_500k", "decode", {"seq_len": 524288, "global_batch": 1}),
)

GNN_SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("full_graph_sm", "full_graph", {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433}),
    ShapeCell(
        "minibatch_lg",
        "minibatch",
        {"n_nodes": 232965, "n_edges": 114615892, "batch_nodes": 1024, "fanout0": 15, "fanout1": 10},
    ),
    ShapeCell("ogb_products", "full_graph", {"n_nodes": 2449029, "n_edges": 61859140, "d_feat": 100}),
    ShapeCell("molecule", "molecule", {"n_nodes": 30, "n_edges": 64, "batch": 128}),
)

RECSYS_SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("train_batch", "train", {"batch": 65536}),
    ShapeCell("serve_p99", "serve", {"batch": 512}),
    ShapeCell("serve_bulk", "serve", {"batch": 262144}),
    ShapeCell("retrieval_cand", "retrieval", {"batch": 1, "n_candidates": 1_000_000}),
)
