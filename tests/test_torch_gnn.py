"""The port's GNN path against the reference, on the CPU: the four GNN
configs, ``forward``/``loss_fn`` and every gradient leaf of GCN, GAT,
NequIP and MACE at their smoke configs, the neighbour sampler, the graph
generators, ``make_gnn_job`` and the launcher.

The reference's parameters are drawn with ``jax.random`` and carried
across with ``gnn_params_from_numpy``; graphs come from the same numpy
streams in both packages (checked array-equal).  The cases mirror
``tests/test_arch_smoke.py::test_gnn_smoke`` and
``tests/test_substrate.py::test_neighbor_sampler_shapes_and_validity``.
"""

import contextlib
import dataclasses
import functools
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.configs.registry import get_arch as ref_get_arch
from repro.core.graph import rmat_graph as ref_rmat_graph
from repro.data.pipeline import graph_batch_from_shape as ref_graph_batch_from_shape
from repro.data.pipeline import synthetic_cora as ref_synthetic_cora
from repro.launch import train as ref_launch
from repro.models import gnn as ref_G
from repro_torch.configs import base
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.core.prng import prng_key
from repro_torch.data.pipeline import graph_batch_from_shape, synthetic_cora
from repro_torch.interop import gnn_params_from_numpy
from repro_torch.launch import train as launch
from repro_torch.models import gnn as G
from repro_torch.train import optimizer as opt
from repro_torch.train.tree import tree_leaves

GNN_ARCHS = sorted(a for a, (family, _) in ARCHS.items() if family == "gnn")
CPU = torch.device("cpu")
#: fp32 outputs summed in another order, relative to the largest magnitude
RTOL, ATOL = 1e-5, 1e-6
#: the loss and gradients through every layer
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
#: one make_gnn_job step (the updated state)
STEP_TOL = 1e-5


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1.0)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= (atol + rtol) * scale, (what, err, scale)


def _batch_arrays(batch):
    return {f.name: getattr(batch, f.name) for f in dataclasses.fields(batch)
            if f.name not in ("n_graphs", "_cache")}


def _assert_batches_equal(batch, ref_batch):
    assert batch.n_graphs == ref_batch.n_graphs
    got, want = _batch_arrays(batch), _batch_arrays(ref_batch)
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert (g is None) == (w is None), k
        if w is not None:
            assert np.array_equal(g.numpy(), np.asarray(w)), k


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_configs_are_copies(arch):
    family, module = get_arch(arch)
    ref_family, ref_module = ref_get_arch(arch)
    assert family == ref_family == "gnn"
    for name in ("CONFIG", "SMOKE_CONFIG"):
        assert dataclasses.asdict(getattr(module, name)) == dataclasses.asdict(getattr(ref_module, name))


def test_gnn_shapes_are_copies():
    assert [dataclasses.asdict(c) for c in base.GNN_SHAPES] == \
        [dataclasses.asdict(c) for c in ref_base.GNN_SHAPES]


# ---------------------------------------------------------------------------
# forward, loss and gradients
# ---------------------------------------------------------------------------


def _setup(arch, d_in=12):
    ref_cfg, cfg = ref_get_arch(arch)[1].SMOKE_CONFIG, get_arch(arch)[1].SMOKE_CONFIG
    ref_params = ref_G.init_model(jax.random.PRNGKey(0), ref_cfg, d_in)
    return ref_cfg, cfg, ref_params, gnn_params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg, CPU)


def _labels(cfg, ref_batch, ref_labels):
    if cfg.model in ("nequip", "mace"):
        return jnp.ones((ref_batch.n_graphs,), jnp.float32)
    return ref_labels


@functools.lru_cache(maxsize=None)
def _reference_run(arch):
    """The reference's forward, loss and gradients on the smoke batch, one
    jitted call per arch (shared by the two tests below)."""
    ref_cfg, cfg, ref_params, _ = _setup(arch)
    ref_batch, ref_labels = ref_graph_batch_from_shape(40, 90, 12, seed=0, batch_graphs=2)
    ref_labels = _labels(cfg, ref_batch, ref_labels)

    def run(params, batch, labels):
        return (ref_G.forward(params, ref_cfg, batch),
                jax.value_and_grad(ref_G.loss_fn)(params, ref_cfg, batch, labels))

    out, (loss, grads) = jax.jit(run)(ref_params, ref_batch, ref_labels)
    return np.asarray(out), np.asarray(loss), [np.asarray(g) for g in jax.tree.leaves(grads)], \
        np.array(ref_labels)


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_forward_matches_reference(arch):
    _, cfg, _, params = _setup(arch)
    batch, _ = graph_batch_from_shape(40, 90, 12, seed=0, batch_graphs=2, device="cpu")
    want = _reference_run(arch)[0]
    with torch.no_grad():
        out = G.forward(params, cfg, batch)
    assert out.shape == ((batch.n_nodes, cfg.n_classes) if cfg.model in ("gcn", "gat")
                         else (batch.n_graphs,))
    assert bool(torch.isfinite(out).all())
    _close(out, want)


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_loss_and_every_gradient_leaf_match_reference(arch):
    _, cfg, _, params = _setup(arch)
    batch, _ = graph_batch_from_shape(40, 90, 12, seed=0, batch_graphs=2, device="cpu")
    _, ref_loss, want, labels = _reference_run(arch)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = G.loss_fn(params, cfg, batch, torch.as_tensor(labels))
    loss.backward()
    assert np.isfinite(float(loss.detach()))
    _close(loss, ref_loss, GRAD_RTOL, GRAD_ATOL, "loss")
    assert len(leaves) == len(want)
    for i, (p, w) in enumerate(zip(leaves, want)):
        g = torch.zeros_like(p) if p.grad is None else p.grad  # unreached: zero, as jax.grad's
        _close(g, w, GRAD_RTOL, GRAD_ATOL, f"leaf {i}")


def test_masked_nodes_and_edges_match_reference():
    """GAT and GCN on a batch with masked edges and nodes, isolated nodes
    among them."""
    for arch in ("gat-cora", "gcn-cora"):
        ref_cfg, cfg, ref_params, params = _setup(arch)
        ref_batch, ref_labels = ref_graph_batch_from_shape(40, 60, 12, seed=4, batch_graphs=1)
        rng = np.random.default_rng(4)
        emask = (rng.random(60) > 0.3).astype(np.float32)
        nmask = (rng.random(40) > 0.2).astype(np.float32)
        ref_batch = dataclasses.replace(ref_batch, edge_mask=jnp.asarray(emask), node_mask=jnp.asarray(nmask))
        batch, _ = graph_batch_from_shape(40, 60, 12, seed=4, batch_graphs=1, device="cpu")
        batch = dataclasses.replace(batch, edge_mask=torch.as_tensor(emask), node_mask=torch.as_tensor(nmask))
        want = jax.jit(jax.value_and_grad(ref_G.loss_fn), static_argnums=1)(
            ref_params, ref_cfg, ref_batch, ref_labels)
        for p in tree_leaves(params):
            p.requires_grad_(True)
        loss = G.loss_fn(params, cfg, batch, torch.as_tensor(np.array(ref_labels)).long())
        loss.backward()
        _close(loss, want[0], GRAD_RTOL, GRAD_ATOL, f"{arch} loss")
        for i, (p, w) in enumerate(zip(tree_leaves(params), jax.tree.leaves(want[1]))):
            _close(p.grad, w, GRAD_RTOL, GRAD_ATOL, f"{arch} leaf {i}")


def test_params_from_numpy_checks_every_path():
    ref_cfg, cfg, ref_params, params = _setup("nequip")
    tree = jax.tree.map(np.asarray, ref_params)
    assert [tuple(p.shape) for p in tree_leaves(params)] == [w.shape for w in jax.tree.leaves(tree)]
    tree["blocks"][1]["mix"]["w_v"] = tree["blocks"][1]["mix"]["w_v"][:, :3]
    with pytest.raises(ValueError, match=r"/blocks\[1\]/mix/w_v: shape"):
        gnn_params_from_numpy(tree, cfg, CPU)
    with pytest.raises(ValueError, match="embed/0/w"):
        gnn_params_from_numpy({"layers": []}, cfg, CPU)
    meta = G.param_shapes(cfg, 12)
    assert [p.shape for p in tree_leaves(meta)] == [p.shape for p in tree_leaves(params)]


# ---------------------------------------------------------------------------
# the neighbour sampler
# ---------------------------------------------------------------------------


def _isolated_last_csr():
    """A 6-node CSR whose last node has no neighbour: its draw reads one
    past ``col_idx``, which both packages clamp."""
    col = np.array([1, 2, 0, 3, 0, 4, 1, 2, 4, 2, 3], dtype=np.int32)
    row_ptr = np.array([0, 2, 4, 6, 8, 11, 11], dtype=np.int64)
    return row_ptr, col, np.array([5, 0, 3, 5], dtype=np.int32), (3, 2)


def _rmat_csr():
    row_ptr, col = ref_rmat_graph(500, 3000, seed=0).csr()
    return row_ptr, col, np.arange(32, dtype=np.int32), (5, 3)


@pytest.mark.parametrize("graph", [_rmat_csr, _isolated_last_csr], ids=["rmat500", "isolated_last"])
def test_sampler_bit_equal_to_reference(graph):
    row_ptr, col, seeds, fanouts = graph()
    sample = jax.jit(lambda *a: dataclasses.astuple(ref_G.sample_node_flow(*a, fanouts))[:2])
    ref_flow = ref_G.NodeFlow(*sample(jax.random.PRNGKey(0), jnp.asarray(row_ptr), jnp.asarray(col),
                                      jnp.asarray(seeds)), fanouts)
    flow = G.sample_node_flow(prng_key(0), torch.as_tensor(row_ptr), torch.as_tensor(col),
                              torch.as_tensor(seeds), fanouts)
    assert flow.fanouts == ref_flow.fanouts
    for got, want in zip(flow.layer_nodes + flow.layer_valid, ref_flow.layer_nodes + ref_flow.layer_valid):
        assert np.array_equal(got.numpy(), np.asarray(want))
    # every valid sampled neighbour is a real neighbour of its parent
    parents = flow.layer_nodes[0].numpy()
    children = flow.layer_nodes[1].numpy().reshape(len(parents), fanouts[0])
    valid = flow.layer_valid[1].numpy().reshape(len(parents), fanouts[0])
    for i, p in enumerate(parents):
        nbrs = set(col[row_ptr[p]:row_ptr[p + 1]].tolist())
        assert all(int(children[i, j]) in nbrs for j in range(fanouts[0]) if valid[i, j])

    rng = np.random.default_rng(5)
    feats = rng.standard_normal((len(row_ptr) - 1, 8)).astype(np.float32)
    pos = rng.standard_normal((len(row_ptr) - 1, 3)).astype(np.float32)
    ref_batch = ref_G.node_flow_to_batch(ref_flow, jnp.asarray(feats), jnp.asarray(pos))
    batch = G.node_flow_to_batch(flow, torch.as_tensor(feats), torch.as_tensor(pos))
    _assert_batches_equal(batch, ref_batch)
    n_layers = [len(seeds)]
    for f in fanouts:
        n_layers.append(n_layers[-1] * f)
    assert batch.n_nodes == sum(n_layers) and batch.n_edges == 2 * sum(n_layers[1:])


# ---------------------------------------------------------------------------
# the graph generators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(40, 90, 12, 2, True), (30, 64, 5, 1, False), (7, 11, 3, 4, True)])
def test_graph_batch_from_shape_array_equal(shape):
    n, e, d, graphs, with_pos = shape
    ref_batch, ref_labels = ref_graph_batch_from_shape(n, e, d, seed=3, batch_graphs=graphs,
                                                       with_positions=with_pos)
    batch, labels = graph_batch_from_shape(n, e, d, seed=3, batch_graphs=graphs,
                                           with_positions=with_pos, device="cpu")
    _assert_batches_equal(batch, ref_batch)
    assert labels.dtype == torch.int64 and np.array_equal(labels.numpy(), np.asarray(ref_labels))


def test_synthetic_cora_array_equal():
    ref_g, ref_feat, ref_labels = ref_synthetic_cora()
    g, feat, labels = synthetic_cora(device="cpu")
    assert g.n == ref_g.n == 2708
    assert np.array_equal(g.src, ref_g.src) and np.array_equal(g.dst, ref_g.dst)
    assert feat.shape == (2708, 1433) and np.array_equal(feat.numpy(), ref_feat)
    assert np.array_equal(labels.numpy(), ref_labels)


def test_entry_points_default_to_the_card():
    """Without a device the GNN entry points run on the card, and raise
    without one."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    cfg = get_arch("gcn-cora")[1].CONFIG
    for call in (lambda: graph_batch_from_shape(4, 4, 2), lambda: synthetic_cora(n=8, e=8, d=4),
                 lambda: G.init_model(cfg, 4), lambda: launch.make_gnn_job(cfg, 8, 1e-3),
                 lambda: launch.main(["--arch", "gcn-cora", "--steps", "2"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


# ---------------------------------------------------------------------------
# the job and the launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["gcn-cora", "mace"])
def test_make_gnn_job_step_matches_reference(arch):
    """One ``make_gnn_job`` step of each package from the same parameters
    and batch: loss, gradient norm and every leaf of the updated state.
    One arch per family (the per-arch gradients are held above); MACE's
    step has leaves the loss does not reach, which both update as zero
    gradients."""
    ref_cfg, cfg = ref_get_arch(arch)[1].SMOKE_CONFIG, get_arch(arch)[1].SMOKE_CONFIG
    ref_state, ref_step, ref_data = ref_launch.make_gnn_job(ref_cfg, 32, 1e-3)
    state, step, data = launch.make_gnn_job(cfg, 32, 1e-3, device="cpu")
    state["params"] = gnn_params_from_numpy(jax.tree.map(np.asarray, ref_state["params"]), cfg, CPU)
    state["opt"] = opt.adamw_init(state["params"])
    ref_batch, batch = next(ref_data(0)), next(data(0))
    _assert_batches_equal(batch[0], ref_batch[0])
    assert np.array_equal(batch[1].numpy(), np.asarray(ref_batch[1]))

    ref_state, ref_metrics = ref_step(ref_state, ref_batch)
    state, metrics = step(state, batch)
    _close(metrics["loss"], ref_metrics["loss"], STEP_TOL, STEP_TOL, "loss")
    _close(metrics["gnorm"], ref_metrics["gnorm"], STEP_TOL, STEP_TOL, "gnorm")
    assert int(state["opt"].count) == int(ref_state["opt"].count) == 1
    for i, (g, w) in enumerate(zip(tree_leaves(state), jax.tree.leaves(ref_state))):
        _close(g.detach(), w, STEP_TOL, STEP_TOL, f"state leaf {i}")


def _printed(fn, *args) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args)
    return out.getvalue()


def test_launcher_trains_gcn_and_resumes_from_its_checkpoint(tmp_path):
    args = ["--arch", "gcn-cora", "--smoke", "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    first = _printed(launch.main, args + ["--steps", "10"])
    assert "family=gnn resumed=False start_step=0" in first and "done 10 steps" in first
    second = _printed(launch.main, args + ["--steps", "20"])
    assert "resumed=True start_step=10" in second and "done 20 steps" in second
    assert sorted(os.listdir(tmp_path)) == ["step_00000010", "step_00000020"]
