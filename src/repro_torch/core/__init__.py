"""repro_torch.core: color-coding tree subgraph counting as SpMM + eMA.

Host-side modules (``graph``, ``colorsets``, ``templates``) are NumPy
copies of the reference's; ``counting`` and ``engine`` run on torch tensors.
"""

from .colorsets import (
    SplitTable,
    binom,
    bucketed_split_entries,
    build_split_table,
    colorful_probability,
    enumerate_subsets,
    rank_subsets,
    unrank_subsets,
)
from .counting import (
    CountingPlan,
    brute_force_colorful,
    brute_force_embeddings,
    build_counting_plan,
    count_colorful_traversal,
    count_colorful_vectorized,
    fused_aggregate_ema,
    fused_aggregate_ema_grouped,
    liveness_peak_columns,
    liveness_peak_elements,
    normalize_count,
    schedule_liveness,
    spmm_edges,
    spmm_ell,
)
from .engine import CountingEngine, DtypePolicy, EstimateResult, engine_cache_key, resolve_device
from .estimator import estimate_embeddings, required_iterations
from .graph import (
    BlockedELL,
    Graph,
    SellGraph,
    build_blocked_ell,
    build_sell,
    erdos_renyi_graph,
    grid_graph,
    rmat_graph,
)
from .templates import (
    Template,
    TemplatePartition,
    get_template,
    graph_automorphisms,
    partition_template,
    path_template,
    random_tree_template,
    star_template,
    binary_tree_template,
    sub_template_canonical,
    tree_automorphisms,
)

__all__ = [name for name in dir() if not name.startswith("_")]
