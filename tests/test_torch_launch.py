"""The port's launch tooling against the reference (``repro.launch``).

* ``build_cell``: the 40 non-subgraph cells of ``all_cells()`` on the
  single-pod mesh against the reference's ``build_cell`` on a JAX
  ``AbstractMesh`` (``model_flops`` and ``meta`` equal; per-device
  argument bytes equal to those of the reference's shapes and specs); the
  4 subgraph cells against the reference's ``_subgraph_flops`` and
  padding formulas, called directly.
* ``collective_wire_bytes`` over a log against the reference's over HLO
  lines carrying the same collectives.
* ``_affine_extrapolate`` against the reference's; the depth probe's fit
  of granite-8b's smoke config (4 layers) against its full-depth count.
* The ``vectorized`` eMA mode against ``loop`` through
  ``make_distributed_count_fn`` at one and two gloo ranks.
* The CLI: ``--list`` as the reference's, and one cell's record.
* The GNN and recsys cells' steps on one device (a larger mesh refused).
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
from datetime import timedelta

import jax
import pytest
import torch
import torch.distributed as dist

import torch_mesh_ranks as R
from repro.configs import registry as ref_registry
from repro.launch import cells as ref_cells
from repro.launch import probes as ref_probes
from repro.launch import roofline as ref_roofline
from repro_torch.configs import granite_8b
from repro_torch.configs.base import ShapeCell
from repro_torch.configs.registry import all_cells
from repro_torch.core.sharding import tree_device_bytes
from repro_torch.launch import cells, probes
from repro_torch.launch.mesh import AbstractMesh, make_production_mesh
from repro_torch.launch.roofline import collective_wire_bytes
from repro_torch.testing.ranks import run_ranks

RANKS_TIMEOUT_S = 300.0
#: vectorized against loop: one einsum over the splits against one add per
#: split, the reference's mesh == local contract
VECTORIZED_RTOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_ITEMSIZE = {"float32": 4, "int32": 4, "bfloat16": 2, "float16": 2, "int64": 8}


def _ref_arg_bytes(args, shardings, mesh) -> int:
    """Per-device bytes of the reference's abstract arguments at their
    ``NamedSharding``s: each dimension split over the product of its axes
    (rounded up)."""
    leaves = jax.tree.leaves(args)
    specs = jax.tree.leaves(shardings)
    assert len(leaves) == len(specs)
    total = 0
    for leaf, sh in zip(leaves, specs):
        spec = tuple(sh.spec) + (None,) * (len(leaf.shape) - len(sh.spec))
        n = 1
        for d, e in zip(leaf.shape, spec):
            axes = () if e is None else ((e,) if isinstance(e, str) else tuple(e))
            n *= -(-d // math.prod(mesh.shape[a] for a in axes))
        total += n * _ITEMSIZE[str(leaf.dtype)]
    return total


@pytest.fixture(scope="module")
def ref_cells_single():
    mesh = make_production_mesh()
    ref_mesh = jax.sharding.AbstractMesh(mesh.devices_shape, mesh.axis_names)
    out = {}
    for arch, shape in ref_registry.all_cells():
        out[(arch, shape.name)] = ref_cells.build_cell(arch, shape, ref_mesh)
    return out


def test_cells_match_reference(ref_cells_single):
    mesh = make_production_mesh()
    cells_ = all_cells()
    assert len(cells_) == 40 == len(ref_cells_single)
    for arch, shape in cells_:
        got = cells.build_cell(arch, shape, mesh)
        want = ref_cells_single[(arch, shape.name)]
        assert got.model_flops == want.model_flops, (arch, shape.name)
        extra = set(got.meta) - set(want.meta)
        assert {k: got.meta[k] for k in want.meta} == want.meta, (arch, shape.name)
        assert extra == ({"node_spec", "chan_spec"} if got.meta["family"] == "gnn" else set())
        assert got.donate_argnums == want.donate_argnums
        assert tree_device_bytes(got.args, got.in_shardings, mesh) == \
            _ref_arg_bytes(want.args, want.in_shardings, mesh), (arch, shape.name)


def test_subgraph_cells_match_reference_formulas():
    from repro.launch.cells import _pad_to

    mesh = make_production_mesh()
    cells_ = [c for c in all_cells(include_subgraph=True) if c[0] == "subgraph2vec"]
    assert len(cells_) == 4
    for arch, shape in cells_:
        got = cells.build_cell(arch, shape, mesh)
        n_shards = 256
        n_padded = _pad_to(shape.params["n_vertices"], n_shards)
        e = 2 * shape.params["n_edges"]
        _, plan = cells._subgraph_plan(shape.params["k"])
        # the reference's formula over the port's plan (the plans are held
        # equal in tests/test_torch_counting.py)
        assert got.model_flops == ref_cells._subgraph_flops(plan, n_padded, e)
        assert got.meta == {"family": "subgraph", "kind": "count", "k": shape.params["k"],
                            "n": shape.params["n_vertices"], "edges": e}
        edges_per_shard = _pad_to(int(e / n_shards * 1.2), 8)
        assert [tuple(a.shape) for a in got.args] == [(n_padded,)] + [(n_shards * edges_per_shard,)] * 3
        assert got.analytic["temp_bytes"] > 0 and got.schedule


def _hlo(op: str, nbytes: int, g: int, form: str) -> str:
    shape = f"f32[{nbytes // 4}]{{0}}"
    if op == "collective-permute":
        groups = "source_target_pairs={{0,1},{1,0}}"
    elif form == "iota":
        groups = f"replica_groups=[{16 // g},{g}]<=[16]"
    else:
        groups = "replica_groups={{" + ",".join(str(i) for i in range(g)) + "}}"
    return f"  %x.{op} = {shape} {op}(f32[8]{{0}} %p), {groups}, to_apply=%add"


@pytest.mark.parametrize("form", ["iota", "list"])
def test_collective_wire_bytes_equal_reference(form):
    ops = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")
    log = [(op, 4096 * (i + 1) * g, g) for i, op in enumerate(ops) for g in (1, 2, 16)]
    text = "\n".join(_hlo(op, nbytes, g, form) for op, nbytes, g in log)
    want_total, want_counts = ref_roofline.collective_wire_bytes(text)
    total, counts = collective_wire_bytes(log)
    assert counts == want_counts
    assert total == want_total


def test_affine_extrapolate_equals_reference():
    c1, c2 = (1.0e12, 3.0e9, 7.0), (1.5e12, 4.5e9, 1.0)
    for x1, x2, full in ((1, 2, 36), (2, 3, 27), (1 << 20, 1 << 21, 61859328)):
        assert probes._affine_extrapolate(c1, c2, x1, x2, full) == \
            ref_probes._affine_extrapolate(c1, c2, x1, x2, full)
    assert probes.affine_fit(1, 10.0, 2, 14.0, 36) == 150.0


def test_depth_probe_fits_full_depth_count():
    cfg = dataclasses.replace(granite_8b.SMOKE_CONFIG, n_layers=4, remat=True)
    mesh = AbstractMesh((2, 2), ("data", "model"))
    shape = ShapeCell("train_small", "train", {"seq_len": 64, "global_batch": 8})
    fit = probes.probe_costs("granite-8b", shape, mesh, cfg=cfg)
    full = probes._costs(cells.build_cell("granite-8b", shape, mesh, cfg_override=cfg), mesh)
    assert fit["method"] == "lm-depth L=1,2"
    for key, want in zip(("flops", "bytes", "collective_bytes", "collective_s"), full):
        assert want > 0
        assert fit[key] == pytest.approx(want, rel=1e-12), key


# ---------------------------------------------------------------------------
# the vectorized eMA mode at one and two gloo ranks
# ---------------------------------------------------------------------------

GRAPH = (300, 1500, 2)


@pytest.fixture(scope="module")
def group1():
    """A gloo group of one rank in this process (torn down after the module)."""
    tmp = tempfile.mkdtemp(prefix="torch-launch-")
    dist.init_process_group("gloo", init_method="file://" + os.path.join(tmp, "store"),
                            rank=0, world_size=1, timeout=timedelta(seconds=120))
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_vectorized_ema_equals_loop_one_rank(group1):
    out = R.vectorized_case(0, 1, GRAPH, "u5-2")
    assert out["loop"] > 0
    assert out["vectorized"] == pytest.approx(out["loop"], rel=VECTORIZED_RTOL)


def test_vectorized_ema_equals_loop_two_ranks():
    ranks = run_ranks(R.vectorized_case, 2, args=(GRAPH, "u5-2"), timeout_s=RANKS_TIMEOUT_S)
    for r in ranks:
        assert r["loop"] > 0
        assert r["vectorized"] == pytest.approx(r["loop"], rel=VECTORIZED_RTOL)
    assert ranks[0] == ranks[1]


def test_vectorized_needs_no_column_batch_and_streamed_does():
    from repro_torch.core.counting import build_counting_plan
    from repro_torch.core.distributed import make_batched_count_fn
    from repro_torch.core.templates import get_template

    with pytest.raises(ValueError, match="finite column_batch"):
        make_batched_count_fn([build_counting_plan(get_template("u3"))], None, 8, 8,
                              column_batch=None, ema_mode="streamed", device="cpu")


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _run(module: str, *args: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", module, *args], env=env, capture_output=True,
                          text=True, timeout=300, cwd=REPO)


def test_cli_list_equals_reference():
    got, want = _run("repro_torch.launch.dryrun", "--list"), _run("repro.launch.dryrun", "--list")
    assert got.returncode == 0 == want.returncode, got.stderr[-2000:] + want.stderr[-2000:]
    assert got.stdout.splitlines() == want.stdout.splitlines()
    assert len(got.stdout.splitlines()) == 44


def test_cli_writes_a_record_with_the_reference_keys(tmp_path):
    res = _run("repro_torch.launch.dryrun", "--arch", "granite-8b", "--shape", "train_4k",
               "--mesh", "single", "--out", str(tmp_path))
    assert res.returncode == 0, res.stderr[-3000:]
    rec = json.loads((tmp_path / "granite-8b__train_4k__single.json").read_text())
    ref_keys = {f.name for f in dataclasses.fields(ref_roofline.RooflineReport)} | {"fits_hbm"}
    assert ref_keys <= set(rec)
    assert rec["fits_80GB"] is rec["fits_hbm"] is True
    assert rec["n_devices"] == 256 and rec["meta"]["n_micro"] == 1
    assert rec["hlo_flops"] > 0 and rec["collective_bytes"] > 0
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    assert "FlopCounterMode" in rec["method"]
    assert "fits_80GB=True" in res.stdout


# ---------------------------------------------------------------------------
# the GNN and recsys cells' steps (one device; a larger mesh is refused)
# ---------------------------------------------------------------------------


def test_gnn_and_recsys_cell_steps_run_on_one_device():
    from repro_torch.configs import gcn_cora, two_tower_retrieval
    from repro_torch.launch.sharded import Comm
    from repro_torch.models import gnn as G
    from repro_torch.models import recsys as RS
    from repro_torch.train.optimizer import adamw_init

    one, two = AbstractMesh((1, 1), ("data", "model")), AbstractMesh((1, 2), ("data", "model"))
    gen = torch.Generator().manual_seed(0)

    cfg = gcn_cora.SMOKE_CONFIG
    shape = ShapeCell("tiny", "full_graph", {"n_nodes": 40, "n_edges": 100, "d_feat": 8})
    cell = cells.build_cell("gcn-cora", shape, one, cfg_override=cfg)
    n, e = cell.meta["n_nodes"], cell.meta["n_edges"]
    params = G.init_model(cfg, 8, seed=0, device="cpu")
    batch = {"node_feat": torch.randn((n, 8), generator=gen),
             "src": torch.randint(0, n, (e,), generator=gen, dtype=torch.int32),
             "dst": torch.randint(0, n, (e,), generator=gen, dtype=torch.int32),
             "edge_mask": torch.ones(e), "node_mask": torch.ones(n),
             "graph_id": torch.zeros(n, dtype=torch.int32)}
    labels = torch.randint(0, cfg.n_classes, (n,), generator=gen)
    _, _, metrics = cell.fn(Comm(one), params, adamw_init(params), batch, labels)
    assert torch.isfinite(metrics["loss"])
    with pytest.raises(NotImplementedError, match="no sharded executor"):
        cell.fn(Comm(two), params, adamw_init(params), batch, labels)

    cfg = two_tower_retrieval.SMOKE_CONFIG
    cell = cells.build_cell("two-tower-retrieval", ShapeCell("tiny", "train", {"batch": 16}), one,
                            cfg_override=cfg)
    params = RS.init_params(cfg, seed=0, device="cpu")
    idx = [torch.randint(0, 100, (16, f, cfg.multi_hot_per_field), generator=gen, dtype=torch.int32)
           for f in (cfg.n_user_fields, cfg.n_item_fields)]
    _, _, metrics = cell.fn(Comm(one), params, adamw_init(params), *idx, torch.zeros(16))
    assert torch.isfinite(metrics["loss"])
