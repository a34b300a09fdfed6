"""The port's two-tower recommender against the reference, on the CPU: the
config, the shape grid, ``embedding_bag`` (with ``jnp.take``'s handling of
indices out of range), ``forward``/``loss_fn`` and every gradient leaf,
serving and retrieval, the click stream, ``make_recsys_job`` and the
launcher, whose checkpoints each package restores from the other.

The reference's parameters are drawn with ``jax.random`` and carried across
with ``recsys_params_from_numpy``; indices come from the same numpy click
stream in both packages (checked array-equal).  The cases mirror
``tests/test_arch_smoke.py::test_recsys_smoke``.
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
from repro.configs import registry as ref_registry
from repro.configs import two_tower_retrieval as ref_two_tower
from repro.data.pipeline import click_batches as ref_click_batches
from repro.launch import train as ref_launch
from repro.models import recsys as ref_R
from repro_torch.configs import base, registry, two_tower_retrieval
from repro_torch.data.pipeline import click_batches
from repro_torch.interop import recsys_params_from_numpy
from repro_torch.launch import train as launch
from repro_torch.models import recsys as R
from repro_torch.train import optimizer as opt
from repro_torch.train.tree import tree_leaves

CPU = torch.device("cpu")
#: fp32 outputs summed in another order, relative to the largest magnitude
RTOL, ATOL = 1e-5, 1e-6
#: the loss and gradients through both towers
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
#: one make_recsys_job step (the updated state)
STEP_TOL = 1e-5


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1.0)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= (atol + rtol) * scale, (what, err, scale)


def _cut(cfg, scale):
    """``cfg`` with every field's vocabulary cut to ``max(int(v * scale), 8)``:
    the click stream then draws inside the tables ``init_params`` builds."""
    def sizes(vs):
        return tuple(max(int(v * scale), 8) for v in vs)

    return dataclasses.replace(cfg, user_vocab_sizes=sizes(cfg.user_vocab_sizes),
                               item_vocab_sizes=sizes(cfg.item_vocab_sizes))


#: (name, config of each package, batch): the smoke config, and the
#: published widths with the vocabulary cut to 1e-5
CASES = {
    "smoke": (ref_two_tower.SMOKE_CONFIG, two_tower_retrieval.SMOKE_CONFIG, 8),
    "full_width": (_cut(ref_two_tower.CONFIG, 1e-5), _cut(two_tower_retrieval.CONFIG, 1e-5), 16),
}


def _params(ref_cfg, cfg, vocab_scale=1.0):
    ref_params = ref_R.init_params(jax.random.PRNGKey(0), ref_cfg, vocab_scale)
    params = recsys_params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg, CPU, vocab_scale)
    return ref_params, params


def _grads(params, fn):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
        p.grad = None
    loss = fn(params)
    loss.backward()
    return loss.detach(), [p.grad for p in leaves]


# ---------------------------------------------------------------------------
# configs and the shape grid
# ---------------------------------------------------------------------------


def test_configs_and_shapes_are_copies():
    assert [(f.name, f.default) for f in dataclasses.fields(base.RecsysConfig)] == \
        [(f.name, f.default) for f in dataclasses.fields(ref_base.RecsysConfig)]
    for name in ("CONFIG", "SMOKE_CONFIG"):
        assert dataclasses.asdict(getattr(two_tower_retrieval, name)) == \
            dataclasses.asdict(getattr(ref_two_tower, name))
    assert [dataclasses.asdict(c) for c in base.RECSYS_SHAPES] == \
        [dataclasses.asdict(c) for c in ref_base.RECSYS_SHAPES]
    assert registry.get_arch("two-tower-retrieval")[0] == "recsys"


@pytest.mark.parametrize("include_subgraph", [False, True])
def test_shapes_for_and_all_cells_equal_reference(include_subgraph):
    for arch in ref_registry.ARCHS:
        assert [dataclasses.asdict(c) for c in registry.shapes_for(arch)] == \
            [dataclasses.asdict(c) for c in ref_registry.shapes_for(arch)]
    cells = [(a, dataclasses.asdict(c)) for a, c in registry.all_cells(include_subgraph)]
    want = [(a, dataclasses.asdict(c)) for a, c in ref_registry.all_cells(include_subgraph)]
    assert cells == want and len(cells) == 40 + 4 * include_subgraph


def test_param_shapes_match_reference():
    """At the published config (shapes only, no storage) and at a cut scale."""
    for scale in (1.0, 1e-3):
        want = jax.eval_shape(lambda s=scale: ref_R.init_params(jax.random.PRNGKey(0),
                                                                ref_two_tower.CONFIG, s))
        got = R.param_shapes(two_tower_retrieval.CONFIG, scale)
        assert [tuple(g.shape) for g in tree_leaves(got)] == [w.shape for w in jax.tree.leaves(want)]
        assert all(g.device.type == "meta" and g.dtype == torch.float32 for g in tree_leaves(got))


def test_init_params_scales():
    cfg = two_tower_retrieval.SMOKE_CONFIG
    params = R.init_params(cfg, seed=0, device="cpu")
    again = R.init_params(cfg, seed=0, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params), tree_leaves(again)))
    assert [t.shape[0] for t in params["user_tables"]] == [1024, 512, 512]
    assert 0.008 < float(params["item_tables"][0].std()) < 0.012
    w = params["user_tower"][0]["w"]
    assert abs(float(w.std()) * w.shape[0] ** 0.5 - 1.0) < 0.1
    assert all(float(layer["b"].abs().max()) == 0.0 for layer in params["item_tower"])


# ---------------------------------------------------------------------------
# embedding_bag
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_embedding_bag_matches_reference(combiner, weighted):
    """Values, and the gradients of a random cotangent with respect to the
    table (rows repeat within and across bags) and the weights; one bag's
    weights are all zero (the mean's ``max(sum, 1)``)."""
    rng = np.random.default_rng(0)
    table = rng.standard_normal((37, 8)).astype(np.float32)
    idx = rng.integers(0, 37, size=(9, 5)).astype(np.int32)
    idx[1] = idx[0]
    w = rng.random((9, 5)).astype(np.float32) * 2.0
    w[2] = 0.0
    cot = rng.standard_normal((9, 8)).astype(np.float32)

    def ref_fn(t, wt):
        out = ref_R.embedding_bag(t, jnp.asarray(idx), wt if weighted else None, combiner)
        return jnp.sum(out * cot), out

    (_, want), (g_t, g_w) = jax.value_and_grad(ref_fn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(table), jnp.asarray(w))
    t = torch.tensor(table, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    got = R.embedding_bag(t, torch.as_tensor(idx).long(), wt if weighted else None, combiner)
    (got * torch.as_tensor(cot)).sum().backward()
    _close(got, want, what="values")
    _close(t.grad, g_t, GRAD_RTOL, GRAD_ATOL, "table grad")
    if weighted:
        _close(wt.grad, g_w, GRAD_RTOL, GRAD_ATOL, "weight grad")


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_embedding_bag_indices_out_of_range_as_jnp_take(combiner):
    """``jnp.take``'s default mode: ``-rows <= i < 0`` wraps; a bag holding
    an index ``>= rows`` or ``< -rows`` is NaN (and only that bag)."""
    rng = np.random.default_rng(1)
    table = rng.standard_normal((10, 4)).astype(np.float32)
    idx = np.array([[0, 1, 2], [-1, -10, 3], [10, 0, 0], [4, -11, 5], [9, 9, 9]], np.int32)
    want = np.asarray(ref_R.embedding_bag(jnp.asarray(table), jnp.asarray(idx), None, combiner))
    got = R.embedding_bag(torch.as_tensor(table), torch.as_tensor(idx).long(), None, combiner).numpy()
    nan_rows = np.isnan(want).all(-1)
    assert nan_rows.tolist() == [False, False, True, True, False]
    assert np.array_equal(np.isnan(got), np.isnan(want))
    _close(got[~nan_rows], want[~nan_rows])
    wrapped = table[[9, 0, 3]].sum(0) / (3 if combiner == "mean" else 1)
    np.testing.assert_allclose(got[1], wrapped, rtol=1e-6)


# ---------------------------------------------------------------------------
# forward, loss and gradients
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _reference_run(case):
    """The reference's towers, and its loss and gradients without and with
    logQ, on the first click batch: one jitted call per case."""
    ref_cfg, _, b = CASES[case]
    ref_params, _ = _params(ref_cfg, CASES[case][1])
    uix, iix, log_q = next(ref_click_batches(ref_cfg, b, seed=3))

    def run(params):
        loss = functools.partial(ref_R.loss_fn, cfg=ref_cfg, user_idx=uix, item_idx=iix)
        return (ref_R.forward(params, ref_cfg, uix, iix), jax.value_and_grad(loss)(params),
                jax.value_and_grad(lambda p: loss(p, log_q=log_q))(params))

    towers, plain, corrected = jax.jit(run)(ref_params)

    def host(run):
        return float(run[0]), [np.asarray(g) for g in jax.tree.leaves(run[1])]

    return [np.asarray(t) for t in towers], host(plain), host(corrected)


@pytest.mark.parametrize("with_log_q", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_loss_and_grads_match_reference(case, with_log_q):
    ref_cfg, cfg, b = CASES[case]
    _, params = _params(ref_cfg, cfg)
    uix, iix, log_q = next(click_batches(cfg, b, seed=3, device="cpu"))
    towers, plain, corrected = _reference_run(case)
    with torch.no_grad():
        for got, want, name in zip(R.forward(params, cfg, uix, iix), towers, ("user", "item")):
            _close(got, want, what=name)
            np.testing.assert_allclose(torch.linalg.vector_norm(got, dim=-1).numpy(), 1.0, rtol=1e-5)
    want_loss, want_grads = corrected if with_log_q else plain
    loss, grads = _grads(params, lambda p: R.loss_fn(p, cfg, uix, iix, log_q if with_log_q else None))
    assert np.isfinite(float(loss))
    _close(loss, np.float32(want_loss), GRAD_RTOL, GRAD_ATOL, "loss")
    assert len(grads) == len(want_grads)
    for i, (g, w) in enumerate(zip(grads, want_grads)):
        _close(g, w, GRAD_RTOL, GRAD_ATOL, f"grad leaf {i}")


def test_scaled_tables_under_the_full_click_stream_give_nan_as_reference():
    """``init_params(vocab_scale < 1)`` fed by the uncut config's click
    stream reads past the tables: NaN in both packages (so the card's cells
    cut the config's vocabulary instead)."""
    ref_cfg, cfg = ref_two_tower.SMOKE_CONFIG, two_tower_retrieval.SMOKE_CONFIG
    ref_params, params = _params(ref_cfg, cfg, vocab_scale=0.1)
    uix, iix, log_q = next(ref_click_batches(ref_cfg, 32, seed=0))
    want = float(ref_R.loss_fn(ref_params, ref_cfg, uix, iix, log_q))
    got = R.loss_fn(params, cfg, *(torch.as_tensor(np.array(a)) for a in (uix, iix, log_q)))
    assert np.isnan(want) and torch.isnan(got)


# ---------------------------------------------------------------------------
# serving and retrieval
# ---------------------------------------------------------------------------


def test_serve_and_retrieval_scores_match_reference():
    ref_cfg, cfg, b = CASES["full_width"]
    ref_params, params = _params(ref_cfg, cfg)
    uix, iix, _ = next(ref_click_batches(ref_cfg, b, seed=5))
    t_uix, t_iix = torch.as_tensor(np.array(uix)).long(), torch.as_tensor(np.array(iix)).long()
    with torch.no_grad():
        _close(R.serve_scores(params, cfg, t_uix, t_iix),
               ref_R.serve_scores(ref_params, ref_cfg, uix, iix), what="serve")
        cands = np.random.default_rng(2).standard_normal((300, cfg.tower_mlp[-1])).astype(np.float32)
        got = R.retrieval_scores(params, cfg, t_uix[:1], torch.as_tensor(cands))
    want = ref_R.retrieval_scores(ref_params, ref_cfg, uix[:1], jnp.asarray(cands))
    _close(got, want, what="retrieval")
    values, ids = R.retrieval_topk(got, 10)
    ref_values, ref_ids = ref_R.retrieval_topk(want, 10)
    assert ids.dtype == torch.int64 and values.dtype == torch.float32
    _close(values, ref_values, what="top-k values")


@pytest.mark.parametrize("shape", [(64,), (3, 50)])
def test_retrieval_topk_ties_as_lax_top_k(shape):
    """Ties (equal scores, -0.0 beside +0.0, negatives) come out in the
    order ``lax.top_k`` gives: descending, equal scores by ascending index."""
    rng = np.random.default_rng(4)
    scores = rng.integers(-4, 5, size=shape).astype(np.float32) / 2
    flat = scores.reshape(-1)
    flat[flat == 0] = np.where(rng.random(int((flat == 0).sum())) < 0.5, -0.0, 0.0)
    for k in (1, 7, shape[-1]):
        want_v, want_i = jax.lax.top_k(jnp.asarray(scores), k)
        values, ids = R.retrieval_topk(torch.as_tensor(scores), k)
        assert np.array_equal(ids.numpy(), np.asarray(want_i)), k
        assert np.array_equal(values.numpy(), np.asarray(want_v)), k
        assert np.array_equal(np.signbit(values.numpy()), np.signbit(np.asarray(want_v))), k
    with pytest.raises(TypeError, match="float32"):
        R.retrieval_topk(torch.as_tensor(scores, dtype=torch.float64), 3)


# ---------------------------------------------------------------------------
# interop, data, the job and the launcher
# ---------------------------------------------------------------------------


def test_recsys_params_from_numpy_names_the_bad_path():
    cfg = two_tower_retrieval.SMOKE_CONFIG
    good = jax.tree.map(np.asarray, ref_R.init_params(jax.random.PRNGKey(0), ref_two_tower.SMOKE_CONFIG))
    bad = dict(good, item_tables=list(good["item_tables"]))
    bad["item_tables"][1] = np.zeros((3, 16), np.float32)
    with pytest.raises(ValueError, match=r"/item_tables\[1\]: shape \(3, 16\)"):
        recsys_params_from_numpy(bad, cfg, CPU)
    with pytest.raises(ValueError, match="/user_tower: expected a list of 3"):
        recsys_params_from_numpy(dict(good, user_tower=good["user_tower"][:2]), cfg, CPU)
    with pytest.raises(ValueError, match="params: keys"):
        recsys_params_from_numpy({k: v for k, v in good.items() if k != "user_tables"}, cfg, CPU)
    with pytest.raises(ValueError, match=r"/user_tables\[0\]: shape"):
        recsys_params_from_numpy(good, cfg, CPU, vocab_scale=0.5)


def test_click_batches_equal_reference_and_resume():
    cfg = two_tower_retrieval.CONFIG
    ref = ref_click_batches(ref_two_tower.CONFIG, 64, seed=7)
    ours = click_batches(cfg, 64, seed=7, device="cpu")
    batches = [next(ours) for _ in range(3)]
    for got in batches:
        want = next(ref)
        assert [g.dtype for g in got] == [torch.int64, torch.int64, torch.float32]
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w))
    resumed = next(click_batches(cfg, 64, seed=7, start_step=2, device="cpu"))
    assert all(torch.equal(a, b) for a, b in zip(resumed, batches[2]))


def test_entry_points_default_to_the_card():
    """Without a device the recsys entry points run on the card, and raise
    without one (``click_batches`` at the call, not at the first batch)."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    cfg = two_tower_retrieval.SMOKE_CONFIG
    for call in (lambda: click_batches(cfg, 4), lambda: R.init_params(cfg),
                 lambda: launch.make_recsys_job(cfg, 8, 1e-3),
                 lambda: launch.main(["--arch", "two-tower-retrieval", "--smoke", "--steps", "2"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_make_recsys_job_step_matches_reference():
    """One ``make_recsys_job`` step of each package from the same parameters
    and clicks: loss, gradient norm and every leaf of the updated state."""
    ref_cfg, cfg = ref_two_tower.SMOKE_CONFIG, two_tower_retrieval.SMOKE_CONFIG
    ref_state, ref_step, ref_data = ref_launch.make_recsys_job(ref_cfg, 32, 1e-3)
    state, step, data = launch.make_recsys_job(cfg, 32, 1e-3, device="cpu")
    state["params"] = recsys_params_from_numpy(jax.tree.map(np.asarray, ref_state["params"]), cfg, CPU)
    state["opt"] = opt.adamw_init(state["params"])
    ref_batch, batch = next(ref_data(0)), next(data(0))
    for g, w in zip(batch, ref_batch):
        assert np.array_equal(g.numpy(), np.asarray(w))

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


def _losses(out: str):
    line = next(l for l in out.splitlines() if l.startswith("done"))
    first, last = line.split("loss ")[1].split(" -> ")
    return float(first), float(last)


def test_launcher_trains_resumes_and_crosses_packages(tmp_path):
    """The port's launcher trains (the loss falls) and resumes from its own
    checkpoint; the reference's launcher resumes from the port's checkpoint,
    and the port's from the reference's."""
    args = ["--arch", "two-tower-retrieval", "--smoke", "--ckpt-dir", str(tmp_path)]
    first = _printed(launch.main, args + ["--device", "cpu", "--steps", "10"])
    assert "family=recsys resumed=False start_step=0" in first and "done 10 steps" in first
    assert _losses(first)[1] < _losses(first)[0]
    second = _printed(launch.main, args + ["--device", "cpu", "--steps", "20"])
    assert "resumed=True start_step=10" in second and "done 20 steps" in second
    third = _printed(ref_launch.main, args + ["--steps", "30"])
    assert "resumed=True start_step=20" in third and "done 30 steps" in third
    fourth = _printed(launch.main, args + ["--device", "cpu", "--steps", "40"])
    assert "resumed=True start_step=30" in fourth and "done 40 steps" in fourth
    assert "step_00000040" in os.listdir(tmp_path)
