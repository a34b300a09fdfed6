"""Dry-run cells: (arch x shape x mesh) -> a step, its arguments and
their placement.

``build_cell`` returns what the dry run (``launch.dryrun``) analyses and a
mesh of ranks can run: the step, its arguments as ``meta`` tensors of the
whole arrays, their partition specs (the reference's ``in_shardings``, as
trees of :class:`~repro_torch.core.sharding.P`), the arguments the step
updates in place, and the analytic MODEL_FLOPS of the roofline's useful
ratio.  Specs, formulas and ``meta`` are the reference's
(``repro.launch.cells``); the step is the port's own.

Per family:

* LM: TP specs from the model plus FSDP over the data axes on a free,
  divisible dimension (skipping the stacked layer axis).  ``fn(comm,
  *args)`` is one device's share of the step (``launch.sharded``): train
  (AdamW, or Adafactor above 60 B parameters; ``n_micro`` gradient
  accumulation), prefill and decode against a sequence-sharded cache
  (``long_500k``: batch 1, the sequence over every axis).  Attention is
  the chunked form, as the reference's cells run it.
* GNN: nodes over the data axes, edges over every axis; the layout choice
  (``node_spec``, ``chan_spec``) rides in ``meta``, as the port's forwards
  take no layout argument.  Equivariant cells past 2^22 edges aggregate
  in chunks of 2^18.
* recsys: tables row-sharded over every axis (model-major), towers
  replicated, the batch over the data axes.
* subgraph2vec: the paper's distributed DP (vertex 1-D partition,
  batched all-gather SpMM) over every rank (``core.distributed``).

GNN and recsys cells have no sharded executor in the port: their ``fn``
runs the single-device step on a one-device mesh and refuses a larger
one, and the dry run counts them analytically (:func:`analytic_counts`).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import GNNConfig, LMConfig, RecsysConfig, ShapeCell
from repro_torch.configs.registry import get_arch
from repro_torch.core.sharding import P, shard_shape, spec_map
from repro_torch.launch.mesh import dp_axes

__all__ = ["CellSpec", "build_cell", "local_args", "analytic_counts"]


@dataclass
class CellSpec:
    arch: str
    shape: str
    fn: Callable          # fn(comm, *local_args): one device's share of the step
    args: Tuple           # trees of meta tensors (whole arrays); ints stay ints
    in_shardings: Tuple   # matching trees of P
    donate_argnums: Tuple[int, ...]
    model_flops: float    # analytic useful FLOPs per step (MODEL_FLOPS)
    meta: Dict[str, Any]
    dtype: str = "float32"                 # the compute dtype (roofline peak)
    schedule: Optional[List] = None        # analytic collectives of one device
    analytic: Optional[Dict[str, Any]] = field(default=None, repr=False)


def _pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _meta(shape, dtype=torch.float32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def local_args(cell: CellSpec, mesh) -> Tuple:
    """One device's blocks of the cell's arguments, as ``meta`` tensors."""
    def block(spec, t):
        if not isinstance(t, torch.Tensor):
            return t
        return _meta(shard_shape(tuple(t.shape), spec, mesh), t.dtype)

    return spec_map(block, cell.in_shardings, cell.args)


def _size(mesh, axes) -> int:
    return math.prod(mesh.shape[a] for a in axes)


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------


def _fsdp_param_pspecs(cfg: LMConfig, dp: Tuple[str, ...], mesh):
    """TP pspecs from the model + FSDP over the data axes on a free,
    divisible major dim (skipping the stacked layer axis)."""
    from repro_torch.models import transformer as T

    model_size = mesh.shape["model"]
    dp_size = _size(mesh, dp)
    specs = T.param_pspecs(cfg, model_size=model_size)
    shapes = T.param_shapes(cfg)

    def upgrade(spec, shape, start):
        parts = list(spec)
        dims = tuple(shape.shape)
        for i in range(start, len(parts)):
            if parts[i] is None and dims[i] % dp_size == 0:
                parts[i] = dp
                return P(*parts)
        return spec

    out = {
        "embed": upgrade(specs["embed"], shapes["embed"], 0),
        "final_norm": P(None),
        "groups": [],
    }
    for g_spec, g_shape in zip(specs["groups"], shapes["groups"]):
        gg = {}
        for k, v in g_spec.items():
            if k in ("attn_norm", "ffn_norm"):
                gg[k] = v
            else:
                gg[k] = spec_map(lambda sp, sh: upgrade(sp, sh, 1), v, g_shape[k])
        out["groups"].append(gg)
    if "unembed" in specs:
        out["unembed"] = upgrade(specs["unembed"], shapes["unembed"], 0)
    return out


def _lm_train_flops(cfg: LMConfig, tokens: int) -> float:
    return 6.0 * cfg.active_param_count() * tokens


def _lm_fwd_flops(cfg: LMConfig, tokens: int, kv_len: int, batch: int) -> float:
    dense = 2.0 * cfg.active_param_count() * tokens
    # attention scores+values: 2 * 2 * h * dh * q * kv per sequence
    attn = 4.0 * cfg.n_layers * cfg.n_heads * cfg.d_head * (tokens // max(batch, 1)) * kv_len * batch
    return dense + attn


def _row_spec(spec, shape):
    return P(*spec[: max(len(shape.shape) - 1, 0)]) if len(shape.shape) >= 2 else spec


def _col_spec(spec, shape):
    nd = len(shape.shape)
    if nd < 2:
        return P()
    full = tuple(spec) + (None,) * (nd - len(spec))
    return P(*(full[: nd - 2] + (full[nd - 1],)))


def _build_lm_cell(arch, cfg: LMConfig, shape: ShapeCell, mesh, probe_n_micro_one: bool = False) -> CellSpec:
    from repro_torch.launch import sharded as S
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import AdafactorState, AdamWState, adafactor_init, adamw_init

    # the cells run the chunked attention, as the reference's cells do (its
    # flash kernel has no backward and prefill/decode take a cache)
    cfg = dataclasses.replace(cfg, attn_impl="sdpa")
    dp = dp_axes(mesh)
    n_dp = _size(mesh, dp)
    pspecs = _fsdp_param_pspecs(cfg, dp, mesh)
    p_shapes = T.param_shapes(cfg)
    kind = shape.kind
    seq = shape.params["seq_len"]
    batch = shape.params["global_batch"]

    if kind == "train":
        # Adafactor for the 100B-class archs (factored second moments), as
        # the reference
        use_adafactor = cfg.param_count() > 6e10
        if use_adafactor:
            opt_shapes = adafactor_init(p_shapes)
            row_specs = spec_map(_row_spec, pspecs, p_shapes)
            col_specs = spec_map(_col_spec, pspecs, p_shapes)
            opt_specs = AdafactorState(row=row_specs, col=col_specs, count=P())
        else:
            opt_shapes = adamw_init(p_shapes)
            opt_specs = AdamWState(mu=pspecs, nu=pspecs, count=P())
        pc = cfg.param_count()
        n_micro = 1 if probe_n_micro_one else (16 if pc > 6e10 else (2 if pc > 1.4e10 else 1))
        micro = max(batch // max(n_micro, 1), n_dp)
        n_micro = batch // micro
        fn = S.make_lm_train_step(cfg, mesh, pspecs, n_micro=n_micro, adafactor=use_adafactor)
        args = (p_shapes, opt_shapes, _meta((batch, seq), torch.int32), _meta((batch, seq), torch.int32))
        in_sh = (pspecs, opt_specs, P(dp, None), P(dp, None))
        return CellSpec(
            arch, shape.name, fn, args, in_sh, (0, 1),
            _lm_train_flops(cfg, batch * seq),
            {"family": "lm", "kind": kind, "tokens": batch * seq, "n_micro": n_micro},
            dtype=cfg.dtype,
            schedule=S.lm_train_schedule(cfg, mesh, pspecs, batch, seq, n_micro, use_adafactor),
        )

    if kind == "prefill":
        cache_shapes = T.kv_cache_shapes(cfg, batch, seq)
        cache_specs = T.kv_cache_pspecs(cfg, dp, model_size=mesh.shape["model"])
        fn = S.make_lm_prefill_step(cfg, mesh, pspecs, cache_specs)
        args = (p_shapes, cache_shapes, _meta((batch, seq), torch.int32))
        in_sh = (pspecs, cache_specs, P(dp, None))
        return CellSpec(
            arch, shape.name, fn, args, in_sh, (1,),
            _lm_fwd_flops(cfg, batch * seq, seq, batch),
            {"family": "lm", "kind": kind, "tokens": batch * seq},
            dtype=cfg.dtype,
        )

    # decode: one new token against a seq-length cache
    shard_seq = batch < n_dp  # long_500k: batch=1 -> shard the sequence axis
    cache_shapes = T.kv_cache_shapes(cfg, batch, seq)
    cache_specs = T.kv_cache_pspecs(cfg, dp, shard_seq=shard_seq, model_size=mesh.shape["model"])
    tok_spec = P(dp, None) if not shard_seq else P(None, None)
    fn = S.make_lm_decode_step(cfg, mesh, pspecs, cache_specs)
    # the index is a host int in the port (the cache write is a host-side
    # branch); the dry run writes the last position
    args = (p_shapes, cache_shapes, _meta((batch, 1), torch.int32), seq - 1)
    in_sh = (pspecs, cache_specs, tok_spec, P())
    return CellSpec(
        arch, shape.name, fn, args, in_sh, (1,),
        _lm_fwd_flops(cfg, batch, seq, batch),
        {"family": "lm", "kind": "decode", "tokens": batch, "kv_len": seq},
        dtype=cfg.dtype,
    )


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------


def _gnn_batch_specs(n: int, e: int, d_feat: int, mesh, equivariant: bool, n_graphs: int):
    """The batch's fields (the reference's ``GraphBatch`` leaves, int32
    indices) as meta tensors and their specs."""
    dp = dp_axes(mesh)
    every = tuple(mesh.axis_names)
    shapes = {
        "node_feat": _meta((n, d_feat)),
        "src": _meta((e,), torch.int32),
        "dst": _meta((e,), torch.int32),
        "edge_mask": _meta((e,)),
        "node_mask": _meta((n,)),
        "graph_id": _meta((n,), torch.int32),
    }
    specs = {
        "node_feat": P(dp, None),
        "src": P(every),
        "dst": P(every),
        "edge_mask": P(every),
        "node_mask": P(dp),
        "graph_id": P(dp),
    }
    if equivariant:
        shapes["positions"], specs["positions"] = _meta((n, 3)), P(dp, None)
    return shapes, specs


def _gnn_flops(cfg: GNNConfig, n: int, e: int, d_feat: int) -> float:
    c = cfg.d_hidden
    if cfg.model == "gcn":
        return 2.0 * cfg.n_layers * (e * c + n * d_feat * c)
    if cfg.model == "gat":
        return 2.0 * cfg.n_layers * (e * cfg.n_heads * c * 3 + n * d_feat * cfg.n_heads * c)
    # equivariant: tp paths ~ 60c muls per edge per degree set + radial MLP
    per_edge = 60.0 * c + 2.0 * cfg.n_rbf * c + 6.0 * c * c
    per_node = 2.0 * (13 * c) * (3 * c) * 3  # linear mixes on s/v/t
    order = {1: 1, 2: 2, 3: 3}[max(cfg.correlation_order, 1)]
    return cfg.n_layers * (e * per_edge + n * per_node * order)


def _single_device(step, what: str):
    """A family's step on a one-device mesh; a larger mesh is refused (the
    port has no sharded executor for it, and the dry run counts it)."""
    def fn(comm, *args):
        if comm.world != 1:
            raise NotImplementedError(f"{what} cells have no sharded executor in the port; "
                                      "the dry run counts them analytically")
        return step(*args)

    return fn


def _gnn_step(run_cfg: GNNConfig):
    from repro_torch.launch.train import gnn_train_step
    from repro_torch.models.gnn.message import GraphBatch

    step = gnn_train_step(run_cfg, 1e-3)

    def run(params, opt_state, batch, labels):
        gb = GraphBatch(batch["node_feat"], batch.get("positions"), batch["src"].long(),
                        batch["dst"].long(), batch["edge_mask"], batch["node_mask"],
                        batch["graph_id"].long(), batch["n_graphs"])
        state, metrics = step({"params": params, "opt": opt_state}, (gb, labels))
        return state["params"], state["opt"], metrics

    return run


def _build_gnn_cell(arch, cfg: GNNConfig, shape: ShapeCell, mesh) -> CellSpec:
    from repro_torch.models import gnn as G
    from repro_torch.train.optimizer import AdamWState, adamw_init
    from repro_torch.train.tree import tree_map

    equivariant = cfg.model in ("nequip", "mace")
    lanes = 512  # pad node/edge counts to a multiple that divides every mesh

    if shape.kind == "molecule":
        bsz = shape.params["batch"]
        n = _pad_to(shape.params["n_nodes"] * bsz, lanes)
        e = _pad_to(shape.params["n_edges"] * bsz * 2, lanes)
        d_feat, n_graphs = 16, bsz
    elif shape.kind == "minibatch":
        b = shape.params["batch_nodes"]
        f0, f1 = shape.params["fanout0"], shape.params["fanout1"]
        n = _pad_to(b * (1 + f0 + f0 * f1), lanes)
        e = _pad_to(2 * b * (f0 + f0 * f1), lanes)
        d_feat, n_graphs = 128, 1
    else:  # full_graph
        n = _pad_to(shape.params["n_nodes"], lanes)
        e = _pad_to(shape.params["n_edges"], lanes)
        d_feat, n_graphs = shape.params["d_feat"], 1

    run_cfg = cfg
    if equivariant and e > (1 << 22):
        run_cfg = dataclasses.replace(cfg, edge_chunk=1 << 18)

    dp = dp_axes(mesh)
    p_shapes = G.param_shapes(run_cfg, d_feat)
    p_specs = tree_map(lambda _: P(), p_shapes)
    opt_shapes = adamw_init(p_shapes)
    opt_specs = AdamWState(mu=p_specs, nu=p_specs, count=P())
    batch_shapes, batch_specs = _gnn_batch_specs(n, e, d_feat, mesh, equivariant, n_graphs)

    if cfg.model in ("gcn", "gat"):
        label_shape = _meta((n,), torch.int32)
        label_spec = P(dp)
    else:
        label_shape = _meta((n_graphs,))
        label_spec = P(dp) if n_graphs % max(_size(mesh, dp), 1) == 0 and n_graphs > 1 else P(None)

    # node-axis sharding for small/aligned graphs; CHANNEL sharding for huge
    # equivariant full-graph cells
    huge = equivariant and n > (1 << 20)
    node_spec = dp
    chan_spec = "model" if huge else None

    step = _gnn_step(run_cfg)
    args = (p_shapes, opt_shapes, batch_shapes, label_shape)
    in_sh = (p_specs, opt_specs, batch_specs, label_spec)
    cell = CellSpec(
        arch, shape.name,
        _single_device(lambda p, o, b, lab: step(p, o, dict(b, n_graphs=n_graphs), lab), "GNN"),
        args, in_sh, (0, 1),
        3.0 * _gnn_flops(cfg, n, e, d_feat),
        {"family": "gnn", "kind": shape.kind, "n_nodes": n, "n_edges": e,
         "node_spec": list(node_spec), "chan_spec": chan_spec},
        dtype=cfg.dtype,
    )
    cell.schedule = _gnn_schedule(run_cfg, mesh, p_shapes, n, d_feat, node_spec, chan_spec)
    return cell


def _gnn_schedule(cfg: GNNConfig, mesh, p_shapes, n: int, d_feat: int, node_spec, chan_spec):
    """Per layer, the node table all-gathered over the node axes for the
    edge gathers and the aggregate reduce-scattered back (the transposes in
    the backward); the replicated parameters' gradients all-reduced over
    every axis.  Channel-sharded cells gather nothing along the nodes."""
    from repro_torch.train.tree import tree_leaves

    every = tuple(mesh.axis_names)
    log = []
    g_node, g_all = _size(mesh, node_spec), mesh.size
    width = cfg.d_hidden * max(cfg.n_heads, 1) * (9 if cfg.model in ("nequip", "mace") else 1)
    if chan_spec is not None:
        width //= mesh.shape[chan_spec]
    for layer in range(cfg.n_layers):
        c_in = d_feat if layer == 0 and cfg.model in ("gcn", "gat") else width
        if chan_spec is None and g_node > 1:
            log += [("all-gather", n * c_in * 4, g_node, tuple(node_spec))] * 2
        if g_all > 1:
            log += [("reduce-scatter", n * width * 4, g_all, every)] * 2
    if g_all > 1:
        log += [("all-reduce", t.numel() * 4, g_all, every) for t in tree_leaves(p_shapes)]
        log.append(("all-reduce", 4, g_all, every))  # the squared norm
    return log


# ---------------------------------------------------------------------------
# RecSys cells
# ---------------------------------------------------------------------------


def _recsys_flops(cfg: RecsysConfig, batch: int) -> float:
    d = cfg.embed_dim
    lookups = batch * (cfg.n_user_fields + cfg.n_item_fields) * cfg.multi_hot_per_field * d
    dims_u = [d * cfg.n_user_fields] + list(cfg.tower_mlp)
    mlp = sum(2.0 * a * b for a, b in zip(dims_u[:-1], dims_u[1:])) * 2 * batch
    return lookups + mlp


def _recsys_step(cfg: RecsysConfig):
    from repro_torch.models import recsys as R
    from repro_torch.train.optimizer import adamw_update, clip_by_global_norm
    from repro_torch.train.tree import tree_leaves, tree_map

    def train_step(params, opt_state, user_idx, item_idx, log_q):
        for p in tree_leaves(params):
            p.requires_grad_(True)
            p.grad = None
        loss = R.loss_fn(params, cfg, user_idx.long(), item_idx.long(), log_q)
        loss.backward()
        grads, gnorm = clip_by_global_norm(tree_map(lambda p: p.grad, params), 1.0)
        params, opt_state = adamw_update(grads, opt_state, params, 1e-3)
        return params, opt_state, {"loss": loss.detach(), "gnorm": gnorm}

    return train_step


def _recsys_schedule(cfg: RecsysConfig, mesh, p_shapes, b_local: int, kind: str):
    """Each field's bag rows fetched from the devices holding them by one
    all-to-all (and its transpose in the backward), the towers' gradients
    all-reduced; retrieval gathers each model shard's top-100."""
    from repro_torch.train.tree import tree_leaves

    every = tuple(mesh.axis_names)
    g = mesh.size
    if g == 1:
        return []
    log = []
    bag_bytes = b_local * cfg.multi_hot_per_field * cfg.embed_dim * 4
    n_fields = cfg.n_user_fields + (0 if kind == "retrieval" else cfg.n_item_fields)
    log += [("all-to-all", bag_bytes, g, every)] * n_fields
    if kind == "train":
        log += [("all-to-all", bag_bytes, g, every)] * n_fields
        towers = [t for name in ("user_tower", "item_tower") for t in tree_leaves(p_shapes[name])]
        log += [("all-reduce", t.numel() * 4, g, every) for t in towers]
        log.append(("all-reduce", 4, g, every))
    if kind == "retrieval" and mesh.shape["model"] > 1:
        log.append(("all-gather", mesh.shape["model"] * 100 * 8, mesh.shape["model"], ("model",)))
    return log


def _build_recsys_cell(arch, cfg: RecsysConfig, shape: ShapeCell, mesh) -> CellSpec:
    from repro_torch.models import recsys as R
    from repro_torch.train.optimizer import AdamWState, adamw_init

    dp = dp_axes(mesh)
    n_dp = _size(mesh, dp)
    p_shapes = R.param_shapes(cfg)
    p_specs = R.param_pspecs(cfg, dp=dp)
    bag = cfg.multi_hot_per_field
    kind = shape.kind
    batch = shape.params["batch"]
    meta = {"family": "recsys", "kind": kind}

    def idx_args(b):
        return (_meta((b, cfg.n_user_fields, bag), torch.int32),
                _meta((b, cfg.n_item_fields, bag), torch.int32))

    if kind == "train":
        opt_shapes = adamw_init(p_shapes)
        opt_specs = AdamWState(mu=p_specs, nu=p_specs, count=P())
        args = (p_shapes, opt_shapes, *idx_args(batch), _meta((batch,)))
        in_sh = (p_specs, opt_specs, P(dp, None, None), P(dp, None, None), P(dp))
        flops = 3.0 * (_recsys_flops(cfg, batch) + 2.0 * batch * batch * cfg.tower_mlp[-1])
        return CellSpec(arch, shape.name, _single_device(_recsys_step(cfg), "recsys"), args, in_sh,
                        (0, 1), flops, dict(meta, batch=batch), dtype=cfg.dtype,
                        schedule=_recsys_schedule(cfg, mesh, p_shapes, batch // n_dp, kind))

    if kind == "serve":
        # bulk scoring in chunks of 16384, so the per-field gathered (b,
        # bag, d) embeddings stay small
        chunk = 16384

        def serve(params, user_idx, item_idx):
            b = user_idx.shape[0]
            if b <= chunk or b % chunk:
                return R.serve_scores(params, cfg, user_idx.long(), item_idx.long())
            return torch.cat([R.serve_scores(params, cfg, user_idx[c:c + chunk].long(),
                                             item_idx[c:c + chunk].long())
                              for c in range(0, b, chunk)])

        args = (p_shapes, *idx_args(batch))
        in_sh = (p_specs, P(dp, None, None), P(dp, None, None))
        return CellSpec(arch, shape.name, _single_device(serve, "recsys"), args, in_sh, (),
                        _recsys_flops(cfg, batch), dict(meta, batch=batch), dtype=cfg.dtype,
                        schedule=_recsys_schedule(cfg, mesh, p_shapes, max(batch // n_dp, 1), kind))

    # retrieval: one query against n_candidates precomputed item vectors
    n_cand = shape.params["n_candidates"]
    d_out = cfg.tower_mlp[-1]

    def retrieve(params, user_idx, candidates):
        scores = R.retrieval_scores(params, cfg, user_idx.long(), candidates)
        return R.retrieval_topk(scores, 100)

    args = (p_shapes, _meta((1, cfg.n_user_fields, bag), torch.int32), _meta((n_cand, d_out)))
    in_sh = (p_specs, P(None, None, None), P("model", None))
    flops = 2.0 * n_cand * d_out + _recsys_flops(cfg, 1)
    return CellSpec(arch, shape.name, _single_device(retrieve, "recsys"), args, in_sh, (), flops,
                    dict(meta, n_candidates=n_cand), dtype=cfg.dtype,
                    schedule=_recsys_schedule(cfg, mesh, p_shapes, 1, kind))


# ---------------------------------------------------------------------------
# SubGraph2Vec (paper) cells
# ---------------------------------------------------------------------------


def _subgraph_flops(plan, n: int, e_directed: int) -> float:
    """SpMM: 2*E*C_p per stage; eMA: 3*n*C_out*splits per stage."""
    from repro_torch.core.colorsets import binom

    total = 0.0
    for sub, table in zip(plan.partition.subs, plan.tables):
        if table is None:
            continue
        c_p = binom(plan.k, table.m_p)
        total += 2.0 * e_directed * c_p
        total += 3.0 * n * table.n_out * table.n_splits
    return total


@functools.lru_cache(maxsize=None)
def _subgraph_plan(k: int):
    """The cell's template and its plan (u20's split tables take seconds to
    build, and both meshes' cells share them)."""
    from repro_torch.core.counting import build_counting_plan
    from repro_torch.core.templates import PAPER_TEMPLATES, random_tree_template

    tname = {12: "u12", 14: "u14", 17: "u17", 20: "u20"}.get(k)
    template = PAPER_TEMPLATES[tname] if tname else random_tree_template(k, seed=k)
    return template, build_counting_plan(template)


def _build_subgraph_cell(arch, cfg, shape: ShapeCell, mesh, probe: bool = False) -> CellSpec:
    from repro_torch.core.distributed import distributed_input_specs, make_distributed_count_fn

    k = shape.params["k"]
    template, plan = _subgraph_plan(k)

    n_shards = mesh.size
    n = shape.params["n_vertices"]
    n_padded = _pad_to(n, n_shards)
    e_directed = 2 * shape.params["n_edges"]
    edges_per_shard = _pad_to(int(e_directed / n_shards * 1.2), 8)

    # k >= 18: the streamed eMA (the batched-B schedule would not fit)
    streamed = (k >= 18) and not probe
    column_batch = None if probe else 128
    ema_mode = "vectorized" if probe else ("streamed" if streamed else "loop")
    built = {}

    def fn(comm, colors, src, dst_local, edge_mask):
        """The count over the default group's ranks (the mesh flattened:
        vertices over every axis)."""
        import torch.distributed as dist

        if "count" not in built:
            built["count"] = make_distributed_count_fn(
                plan, dist.group.WORLD, n_padded, edges_per_shard,
                column_batch=column_batch, ema_mode=ema_mode, device=colors.device)
        return built["count"](colors, src, dst_local, edge_mask)

    args = distributed_input_specs(n_padded, n_shards, edges_per_shard)
    every = tuple(mesh.axis_names)
    in_sh = (P(every),) * 4
    cell = CellSpec(
        arch, shape.name, fn, args, in_sh, (),
        _subgraph_flops(plan, n_padded, e_directed),
        {"family": "subgraph", "kind": "count", "k": k, "n": n, "edges": e_directed},
        dtype="float32",
    )
    cell.analytic = _subgraph_analytic(plan, template, mesh, n_padded, edges_per_shard,
                                       column_batch, ema_mode, cell.model_flops)
    cell.schedule = cell.analytic.pop("schedule")
    return cell


def _subgraph_analytic(plan, template, mesh, n_padded, edges_per_shard, column_batch, ema_mode,
                       model_flops):
    """One device's counts from the port's mesh memory model
    (``CostModel.mesh_resident_elements`` / ``mesh_transient_elements``),
    the plan's stages and its liveness: temporaries, FLOPs, HBM bytes (each
    stage's edge-message gather and aggregate, and the eMA's reads and
    writes) and the column-batch all-gathers."""
    from repro_torch.core.colorsets import binom
    from repro_torch.plan.cost import CostModel
    from repro_torch.plan.ir import build_template_plan

    ir = build_template_plan([template], plans=[plan])
    cost = CostModel(ir, None)
    rows = n_padded // mesh.size
    pad = column_batch or 128
    width = column_batch or max(_pad_to(c, pad) for c in [plan.k] + [
        binom(plan.k, t.m_p) for t in plan.tables if t is not None])
    temp = 4 * (cost.mesh_resident_elements(rows, pad, ema_mode)
                + cost.mesh_transient_elements(n_padded, edges_per_shard, width))
    every = tuple(mesh.axis_names)
    log, nbytes, seen = [], 0.0, set()
    canons = ir.canons[0]
    for i, (sub, table) in enumerate(zip(plan.partition.subs, plan.tables)):
        if table is None:
            continue
        c_p = _pad_to(binom(plan.k, table.m_p), pad)
        nbytes += 4.0 * (edges_per_shard * c_p + rows * c_p
                         + rows * table.n_out * (2 * table.n_splits + 1))
        passive = canons[sub.passive]
        if ema_mode != "streamed" and passive in seen:
            continue  # the SpMM product is memoised per passive state
        seen.add(passive)
        if mesh.size > 1:
            per = width if column_batch is None else column_batch
            log += [("all-gather", n_padded * per * 4, mesh.size, every)] * (c_p // per if column_batch else 1)
    if mesh.size > 1:
        log.append(("all-reduce", 4, mesh.size, every))
    return {"flops": model_flops / mesh.size, "bytes": nbytes, "temp_bytes": float(temp),
            "method": "analytic: the mesh memory model (plan.cost mesh_*_elements) and the plan's stages",
            "schedule": log}


# ---------------------------------------------------------------------------


def analytic_counts(cell: CellSpec, mesh) -> Dict[str, Any]:
    """Per-device counts of a cell the dry run does not trace (GNN, recsys,
    subgraph2vec): FLOPs as MODEL_FLOPS split evenly over the devices, HBM
    bytes as the arguments read once and the donated ones written once, no
    temporaries counted (subgraph cells carry their own model)."""
    from repro_torch.core.sharding import tree_device_bytes

    if cell.analytic is not None:
        return dict(cell.analytic)
    arg = tree_device_bytes(cell.args, cell.in_shardings, mesh)
    donated = sum(tree_device_bytes(cell.args[i], cell.in_shardings[i], mesh)
                  for i in cell.donate_argnums)
    return {"flops": cell.model_flops / mesh.size, "bytes": float(arg + donated), "temp_bytes": 0.0,
            "method": "analytic: MODEL_FLOPS over the devices; arguments read once, donated "
                      "ones written once; no temporaries"}


def build_cell(
    arch: str,
    shape: ShapeCell,
    mesh,
    cfg_override=None,
    subgraph_probe: bool = False,
) -> CellSpec:
    family, module = get_arch(arch)
    cfg = cfg_override if cfg_override is not None else module.CONFIG
    if family == "lm":
        return _build_lm_cell(arch, cfg, shape, mesh, probe_n_micro_one=(cfg_override is not None))
    if family == "gnn":
        return _build_gnn_cell(arch, cfg, shape, mesh)
    if family == "recsys":
        return _build_recsys_cell(arch, cfg, shape, mesh)
    if family == "subgraph":
        return _build_subgraph_cell(arch, cfg, shape, mesh, probe=subgraph_probe)
    raise ValueError(f"unknown family {family}")

