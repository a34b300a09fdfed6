"""Rank bodies of ``tests/test_torch_mesh.py``.

Each function runs in every process of a gloo group that
``repro_torch.testing.ranks.run_ranks`` spawns, so this module imports only
the port (no JAX, no reference): the test process computes the expected
values with ``repro`` and compares.  Every rank returns its own results, so
the tests can also hold the ranks equal to each other.
"""

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.counting import build_counting_plan
from repro_torch.core.distributed import make_distributed_count_fn, shard_graph
from repro_torch.core.engine import CountingEngine
from repro_torch.core.estimator import estimate_embeddings
from repro_torch.core.graph import rmat_graph
from repro_torch.core.prng import prng_key, split
from repro_torch.core.templates import get_template
from repro_torch.serve.counting import CountingService
from repro_torch.testing.faults import FaultPlan, FaultSpec, TransientFault
from repro_torch.tune.search import tune

#: the reference's u3-u7 contract set (tests/test_engine_distributed.py)
U3_U7 = ("u3", "u5-1", "u5-2", "u6", "u7")
#: the ring's bit-exactness set (tests/test_mesh_pipeline.py)
RING_TEMPLATES = ("u5-1", "u7", "u10", "u12")
MODES = (
    ("loop", dict(ema_mode="loop")),
    ("unbalanced", dict(balance_degrees=False)),
    ("bf16_gather", dict(gather_dtype=torch.bfloat16)),
    ("bf16_policy", dict(dtype_policy="bf16")),
)
TREELETS = ("path6", "star6", "u6")


def _mesh_engine(graph, templates, **kw):
    kw.setdefault("column_batch", 8)
    return CountingEngine(graph, templates, device="cpu", mesh=dist.group.WORLD, **kw)


def engine_cases(rank, world):
    """The mesh engine's cases at ``world`` ranks; see the test module."""
    out = {}
    g = rmat_graph(240, 1200, seed=5)
    for name in U3_U7:
        t = get_template(name)
        colors = np.random.default_rng(3).integers(0, t.k, size=g.n)
        eng = _mesh_engine(g, [t])
        out[("raw", name)] = eng.raw_counts(colors).numpy()
    eng = _mesh_engine(g, [get_template("u6")], chunk_size=3)
    out["keys_u6"] = eng.count_keys(split(prng_key(1), 7))  # ragged: 7 = 2*3 + 1
    out["describe_u6"] = eng.describe()

    skewed = rmat_graph(300, 2400, seed=3, a=0.7, b=0.12, c=0.12)
    t = get_template("u6")
    colors = np.random.default_rng(0).integers(0, t.k, size=skewed.n)
    for tag, kw in MODES:
        out[("mode", tag)] = _mesh_engine(skewed, [t], **kw).raw_counts(colors).numpy()

    g2 = rmat_graph(240, 1200, seed=2)
    treelets = [get_template(n) for n in TREELETS]
    eng = _mesh_engine(g2, treelets, chunk_size=2)
    out["multi"] = eng.count_keys(split(prng_key(7), 4))
    out["multi_canons"] = eng.plan_ir.canons

    t = get_template("u5-2")
    tiny = _mesh_engine(g2, [t], memory_budget_bytes=1)
    wide = _mesh_engine(g2, [t], memory_budget_bytes=1 << 30)
    keys = split(prng_key(0), 3)
    out["chunk"] = {
        "tiny_chunk": tiny.chunk_size, "wide_chunk": wide.chunk_size,
        "tiny_bytes": tiny.bytes_per_coloring(), "wide_bytes": wide.bytes_per_coloring(),
        "tiny": tiny.count_keys(keys), "wide": wide.count_keys(keys),
    }
    out["estimate_u5_2"] = estimate_embeddings(
        g2, t, iterations=4, seed=2, device="cpu", mesh=dist.group.WORLD, column_batch=8
    ).per_iteration
    return out


def ring_cases(rank, world):
    """Blocking against pipelined, bitwise, and the collective fault seam
    across ring steps (``tests/test_mesh_pipeline.py``'s cases)."""
    out = {}
    g = rmat_graph(60 * world, 300 * world, seed=5)
    keys = split(prng_key(1), 4)
    for name in RING_TEMPLATES:
        t = get_template(name)
        colors = np.random.default_rng(3).integers(0, t.k, size=g.n)
        # 32 columns per collective (the reference's test uses 8): the
        # modes agree bitwise at any width, and u12 at 8 columns costs
        # thousands of gloo hops
        block = _mesh_engine(g, [t], chunk_size=2, mesh_comm="blocking", column_batch=32)
        ring = _mesh_engine(g, [t], chunk_size=2, mesh_comm="pipelined", column_batch=32)
        out[name] = {
            "modes": (block.backend_impl.comm, ring.backend_impl.comm),
            "raw": (block.raw_counts(colors).numpy(), ring.raw_counts(colors).numpy()),
            "keys": (block.count_keys(keys), ring.count_keys(keys)),
        }
    out["describe_ring"] = ring.describe()["comm"]

    t = get_template("u7")
    keys = split(prng_key(1), 2)

    def run(comm):
        eng = _mesh_engine(g, [t], chunk_size=2, mesh_comm=comm)
        eng.count_keys_chunk(keys)  # warm, outside the fault window
        plan = FaultPlan(
            [FaultSpec(site="collective", kind="transient", rate=0.7, max_fires=3)], seed=11
        )
        outcomes, counts = [], None
        with plan:
            for _ in range(8):  # retry until clean, as the scheduler does
                try:
                    counts = eng.count_keys_chunk(keys)
                    outcomes.append("ok")
                    break
                except TransientFault:
                    outcomes.append("fault")
        return counts, outcomes, plan.fires_by_site(), [s["fire_log"] for s in plan.describe()]

    out["replay"] = (run("pipelined"), run("pipelined"), run("blocking"))

    def visits(comm):
        eng = _mesh_engine(g, [t], chunk_size=2, mesh_comm=comm)
        plan = FaultPlan([FaultSpec(site="collective", kind="transient", after=10**6)], seed=0)
        with plan:
            eng.count_keys_chunk(keys)
        return plan.describe()[0]["visits"]

    out["visits"] = (visits("pipelined"), visits("blocking"))
    return out


def count_fn_cases(rank, world):
    """``make_distributed_count_fn`` on ``shard_graph``'s plain and
    degree-balanced layouts (``tests/test_distributed.py``'s counting
    cases), in the ``loop`` and ``streamed`` eMA modes."""
    out = {}
    g = rmat_graph(600, 3000, seed=2)
    for name in ("u6", "u7"):
        plan = build_counting_plan(get_template(name))
        sg = shard_graph(g, world)
        colors = np.random.default_rng(1).integers(0, plan.k, size=sg.n_padded).astype(np.int32)
        for mode in ("loop", "streamed"):
            fn = make_distributed_count_fn(plan, dist.group.WORLD, sg.n_padded,
                                           sg.edges_per_shard, column_batch=8, ema_mode=mode,
                                           device="cpu")
            out[(name, mode)] = float(fn(colors, sg.src, sg.dst_local, sg.edge_mask))
    skewed = rmat_graph(400, 4000, seed=3, a=0.7, b=0.12, c=0.12)
    plan = build_counting_plan(get_template("u5-2"))
    sg = shard_graph(skewed, world, balance_degrees=True)
    colors_g = np.random.default_rng(0).integers(0, plan.k, size=skewed.n).astype(np.int32)
    colors = np.zeros(sg.n_padded, np.int32)
    colors[sg.perm] = colors_g  # colors follow the vertex relabelling
    fn = make_distributed_count_fn(plan, dist.group.WORLD, sg.n_padded, sg.edges_per_shard,
                                   column_batch=8, device="cpu")
    out["balanced"] = float(fn(colors, sg.src, sg.dst_local, sg.edge_mask))
    out["balanced_edges_per_shard"] = (shard_graph(skewed, world).edges_per_shard,
                                       sg.edges_per_shard)
    return out


def service_cases(rank, world):
    """A mesh-backed ``CountingService`` on every rank (same submissions):
    a bag plan fails as ``invalid`` without a strike, a tree query on the
    same service is served, and a ``tune`` with ``mesh=`` picks the same
    winner on every rank although each rank measures its own times."""
    out = {}
    g = rmat_graph(240, 1200, seed=2)
    svc = CountingService(device="cpu", backend="mesh",
                          engine_kwargs={"mesh": dist.group.WORLD, "column_batch": 8})
    svc.register_graph("a", g)
    bag = svc.submit("a", "triangle", iterations=8, seed=1)
    svc.run()
    ok = svc.submit("a", "u5-2", iterations=8, seed=1)
    svc.run()
    out["service"] = {
        "bag_kind": bag.error.kind if bag.failed else None,
        "bag_cause": type(bag.error.cause).__name__ if bag.failed else None,
        "counters": dict(svc.fault_counters),
        "ok_done": ok.done,
        "means": [e.mean for e in ok.result()] if ok.done else None,
    }

    def measure(engine, probes):
        engine.count_keys_chunk(split(prng_key(0), engine.chunk_size))
        # each rank reports its own time: the winner must still agree
        return (10.0 if engine.backend == "mesh" else 50.0) + rank

    res = tune(g, [get_template("u5-1")], device="cpu", mesh=dist.group.WORLD, top_n=64,
               probes=1, save=False, measure_fn=measure)
    out["tune"] = {
        "winner": res.config.key_fragment(),
        "measured": [(m.config.key_fragment(), m.measured_us) for m in res.measured],
    }
    return out


def all_cases(rank, world):
    """Every case above, in one group (a spawn costs seconds of imports)."""
    return {
        "engine": engine_cases(rank, world),
        "ring": ring_cases(rank, world),
        "count_fn": count_fn_cases(rank, world),
        "service": service_cases(rank, world),
    }


def moe_ep_cases(rank, world, cases):
    """``tests/test_torch_moe.py``'s expert-parallel cases: for each ``(arch,
    capacity_factor, params, x)`` of numpy arrays (the whole layer and every
    rank's tokens, split over ranks on the batch axis), this rank's
    ``moe_apply(..., group=WORLD)`` on its tokens with its experts."""
    import dataclasses

    from repro_torch.configs.registry import get_arch
    from repro_torch.models.layers import moe_apply, moe_shard

    out = []
    for arch, capacity_factor, params_np, x_np in cases:
        cfg = dataclasses.replace(get_arch(arch)[1].SMOKE_CONFIG, capacity_factor=capacity_factor)
        params = {k: ({n: torch.as_tensor(a) for n, a in v.items()} if isinstance(v, dict)
                      else torch.as_tensor(v)) for k, v in params_np.items()}
        x = torch.as_tensor(np.array_split(x_np, world, axis=0)[rank])
        got, aux = moe_apply(moe_shard(params, rank, world), cfg, x, group=dist.group.WORLD)
        out.append((got.numpy(), float(aux)))
    return out


def compressed_psum_case(rank, world, x, residual):
    """``tests/test_torch_train.py``: rank ``rank``'s row of ``x`` (and of
    ``residual``) through ``compressed_psum`` over the whole group."""
    from repro_torch.train.compression import compressed_psum

    mean, new_res = compressed_psum(torch.as_tensor(x[rank]), torch.as_tensor(residual[rank]))
    return mean.numpy(), new_res.numpy()


# ---------------------------------------------------------------------------
# launch tooling (tests/test_torch_launch.py, tests/test_torch_sharding.py)
# ---------------------------------------------------------------------------


def lm_train_case(rank, world, mesh_shape, cfg, params_np, tokens, steps):
    """``steps`` sharded train steps of granite-8b's cell step on a ``(data,
    model)`` mesh from whole numpy parameters: every step's loss and
    collective log, and the parameters gathered whole after the last."""
    from repro_torch.core.sharding import P
    from repro_torch.launch.cells import _fsdp_param_pspecs
    from repro_torch.launch.mesh import AbstractMesh, dp_axes, realize_mesh
    from repro_torch.launch.sharded import Comm, make_lm_train_step
    from repro_torch.train.elastic import gather_tree, reshard_tree
    from repro_torch.train.optimizer import adamw_init

    mesh = AbstractMesh(mesh_shape, ("data", "model"))
    dm = realize_mesh(mesh, "cpu")
    comm = Comm(mesh, rank, dm)
    specs = _fsdp_param_pspecs(cfg, dp_axes(mesh), mesh)
    params = reshard_tree(params_np, dm, specs)
    opt = adamw_init(params)
    local_tokens = reshard_tree(tokens, dm, P(dp_axes(mesh), None))
    step = make_lm_train_step(cfg, mesh, specs, n_micro=1)
    losses, logs = [], []
    for _ in range(steps):
        comm.log.clear()
        params, opt, metrics = step(comm, params, opt, local_tokens, local_tokens)
        losses.append(float(metrics["loss"]))
        logs.append(list(comm.log))
    whole = gather_tree(params, dm, specs, params_np)
    return {"rank": rank, "losses": losses, "logs": logs,
            "params": whole if rank == 0 else None}


def elastic_case(rank, world, tree, specs):
    """``reshard_tree`` of a numpy tree on a ``(2, 2)`` mesh, gathered back
    whole; then, after ``plan_elastic_mesh(2)``, placed on the mesh of the
    two surviving ranks (ranks 0 and 1)."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch.mesh import AbstractMesh, realize_mesh
    from repro_torch.train.elastic import gather_tree, plan_elastic_mesh, reshard_tree

    dm = realize_mesh(AbstractMesh((2, 2), ("data", "model")), "cpu")
    local = reshard_tree(tree, dm, specs)
    whole = gather_tree(local, dm, specs, tree)
    shape = plan_elastic_mesh(2)
    small = DeviceMesh("cpu", torch.arange(2).reshape(shape), mesh_dim_names=("data", "model"))
    again = reshard_tree(tree, small, specs)
    to_np = (lambda t: None if t is None else _np_tree(t))
    return {"rank": rank, "local": _np_tree(local), "whole": whole, "shape": shape,
            "again": to_np(again)}


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np_tree(v) for v in tree]
    return tree.numpy()


def serve_case(rank, world, mesh_shape, case):
    """The sharded prefill (unless ``case["shard_seq"]``) and decode steps of
    an LM cell on a ``(data, model)`` mesh: this rank's last-position
    logits and the caches gathered whole after prefill; this rank's decode
    logits from the whole numpy caches ``case["caches"]`` placed at the
    cache specs."""
    from repro_torch.core.sharding import P
    from repro_torch.launch.cells import _fsdp_param_pspecs
    from repro_torch.launch.mesh import AbstractMesh, dp_axes, realize_mesh
    from repro_torch.launch.sharded import Comm, make_lm_decode_step, make_lm_prefill_step
    from repro_torch.models import transformer as T
    from repro_torch.train.elastic import gather_tree, reshard_tree

    cfg = case["cfg"]
    mesh = AbstractMesh(mesh_shape, ("data", "model"))
    dm = realize_mesh(mesh, "cpu")
    comm = Comm(mesh, rank, dm)
    dp = dp_axes(mesh)
    specs = _fsdp_param_pspecs(cfg, dp, mesh)
    params = reshard_tree(case["params"], dm, specs)
    cache_specs = T.kv_cache_pspecs(cfg, dp, shard_seq=case["shard_seq"],
                                    model_size=mesh.shape["model"])
    out = {"rank": rank}
    if not case["shard_seq"]:
        tokens = reshard_tree(case["tokens"], dm, P(dp, None))
        zeros = [{k: np.zeros_like(v) for k, v in g.items()} for g in case["caches"]]
        caches = reshard_tree(zeros, dm, cache_specs)
        last, caches = make_lm_prefill_step(cfg, mesh, specs, cache_specs)(comm, params, caches, tokens)
        out["prefill_last"] = last.numpy()
        out["prefill_caches"] = gather_tree(caches, dm, cache_specs, case["caches"])
    caches = reshard_tree(case["caches"], dm, cache_specs)
    tok_spec = P(None, None) if case["shard_seq"] else P(dp, None)
    token = reshard_tree(case["token"], dm, tok_spec)
    logits, _ = make_lm_decode_step(cfg, mesh, specs, cache_specs)(comm, params, caches, token,
                                                                   case["index"])
    out["decode_logits"] = logits.numpy()
    return out


def sharding_cases(rank, world, mesh_shape, cfg, params_np, tokens, steps, tree=None, specs=None,
                   serve=()):
    """:func:`lm_train_case`, :func:`elastic_case` when a tree is given, and
    :func:`serve_case` for each of ``serve`` (one spawned group for all)."""
    out = lm_train_case(rank, world, mesh_shape, cfg, params_np, tokens, steps)
    if tree is not None:
        out["elastic"] = elastic_case(rank, world, tree, specs)
    out["serve"] = [serve_case(rank, world, mesh_shape, case) for case in serve]
    return out


def vectorized_case(rank, world, graph_args, template):
    """u5's one-coloring count through ``make_distributed_count_fn`` with the
    ``vectorized`` eMA (no column batch) and with ``loop``."""
    graph = rmat_graph(*graph_args)
    plan = build_counting_plan(get_template(template))
    sg = shard_graph(graph, world)
    colors = np.random.default_rng(3).integers(0, plan.k, sg.n_padded).astype(np.int32)
    out = {}
    for mode, cb in (("vectorized", None), ("loop", 128)):
        fn = make_distributed_count_fn(plan, dist.group.WORLD, sg.n_padded, sg.edges_per_shard,
                                       column_batch=cb, ema_mode=mode, device="cpu")
        out[mode] = float(fn(colors, sg.src, sg.dst_local, sg.edge_mask))
    return out
