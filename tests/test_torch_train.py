"""The port's training path against the reference, on the CPU: ``loss_fn``
and its gradients for the five LM archs, the train step, the optimizers,
checkpoints (across packages too), the loop, compression, elastic planning,
the token stream, the launcher and the example.

Reference weights are drawn with ``jax.random`` and carried across with
``lm_params_from_numpy``; every other input is made from a numpy seed.
The substrate cases mirror ``tests/test_substrate.py`` and
``tests/test_distributed.py::test_compressed_psum_preserves_mean``.
"""

import contextlib
import dataclasses
import functools
import importlib.util
import io
import os
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import torch_mesh_ranks as R
from repro.configs.registry import get_arch as ref_get_arch
from repro.data.pipeline import token_batches as ref_token_batches
from repro.launch import train as ref_launch
from repro.models import transformer as ref_T
from repro.train import checkpoint as ref_ckpt
from repro.train import compression as ref_comp
from repro.train import optimizer as ref_opt
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.data.pipeline import token_batches
from repro_torch.interop import lm_params_from_numpy
from repro_torch.launch import train as launch
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.testing.ranks import run_ranks
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import compression as comp
from repro_torch.train import optimizer as opt
from repro_torch.train.elastic import plan_elastic_mesh, survivors_after_failure
from repro_torch.train.loop import LoopConfig, TrainLoop
from repro_torch.train.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

LM_ARCHS = sorted(a for a, (family, _) in ARCHS.items() if family == "lm")
CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: loss and gradients against jax.value_and_grad, and one train step
GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5
STEP_RTOL, STEP_ATOL = 1e-4, 1e-6
#: the optimizers and schedules on the same fp32 arrays: a few ulp
ULP_RTOL, ULP_ATOL = 1e-6, 1e-9
BATCH, SEQ, LOSS_CHUNK = 2, 24, 8


def _configs(arch, **changes):
    ref_cfg = dataclasses.replace(ref_get_arch(arch)[1].SMOKE_CONFIG, **changes)
    cfg = dataclasses.replace(get_arch(arch)[1].SMOKE_CONFIG, **changes)
    return ref_cfg, cfg


def _params(ref_cfg, cfg, seed=0):
    ref_params = ref_T.init_params(jax.random.PRNGKey(seed), ref_cfg)
    return ref_params, lm_params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg, CPU)


def _batch(cfg, seed=3):
    tokens, labels = next(token_batches(cfg, BATCH, SEQ, seed=seed, device="cpu"))
    return tokens, labels


@functools.lru_cache(maxsize=None)
def _ref_value_and_grad(ref_cfg, loss_chunk):
    """One compiled reference function per (config, chunk) in this module."""
    return jax.jit(lambda p, t, l: jax.value_and_grad(ref_T.loss_fn)(p, ref_cfg, t, l,
                                                                      loss_chunk=loss_chunk))


def _port_loss_and_grads(params, cfg, tokens, labels, loss_chunk=0):
    for p in tree_leaves(params):
        p.requires_grad_(True)
        p.grad = None
    loss = T.loss_fn(params, cfg, tokens, labels, loss_chunk=loss_chunk)
    loss.backward()
    return loss.detach(), tree_map(lambda p: p.grad, params)


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------


def test_tree_order_is_jax_tree_order():
    """Dict keys sorted, lists and NamedTuple fields in order, None empty:
    the leaf numbering of a checkpoint."""
    tree = {"params": {"unembed": 0, "embed": 1, "groups": [{"ffn_norm": 2, "attn_norm": 3}],
                       "final_norm": 4},
            "opt": opt.AdamWState(mu=[5, (6, 7)], nu=None, count=8), "b": 9}
    ref_tree = {"params": tree["params"], "b": 9,
                "opt": ref_opt.AdamWState(mu=[5, (6, 7)], nu=None, count=8)}
    leaves, treedef = tree_flatten(tree)
    assert leaves == jax.tree.leaves(ref_tree) == [9, 5, 6, 7, 8, 1, 4, 3, 2, 0]
    back = tree_unflatten(treedef, leaves)
    assert back == tree and isinstance(back["opt"], opt.AdamWState)
    assert tree_map(lambda a, b: a + b, tree, tree)["opt"].count == 16
    with pytest.raises(ValueError):
        tree_map(lambda a, b: a, tree, {"x": 1})


# ---------------------------------------------------------------------------
# loss_fn and its gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("loss_chunk", [0, LOSS_CHUNK])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_loss_and_grads_match_reference(arch, loss_chunk, monkeypatch):
    """Every gradient leaf, in ``jax.tree.leaves`` order, on the Zipf token
    stream; the MoE archs at the published capacity, where pairs drop."""
    ref_cfg, cfg = _configs(arch)
    ref_params, params = _params(ref_cfg, cfg, seed=1)
    tokens, labels = _batch(cfg)
    want_loss, want_grads = _ref_value_and_grad(ref_cfg, loss_chunk)(
        ref_params, jnp.asarray(tokens.numpy()), jnp.asarray(labels.numpy()))

    routed = []
    moe_route = L.moe_route
    monkeypatch.setattr(L, "moe_route", lambda *a: routed.append(moe_route(*a)) or routed[-1])
    loss, grads = _port_loss_and_grads(params, cfg, tokens, labels, loss_chunk)
    _close(loss, want_loss, GRAD_RTOL, GRAD_ATOL, "loss")
    want_leaves = jax.tree.leaves(want_grads)
    got_leaves = tree_leaves(grads)
    assert [tuple(g.shape) for g in got_leaves] == [w.shape for w in want_leaves]
    for i, (g, w) in enumerate(zip(got_leaves, want_leaves)):
        _close(g, w, GRAD_RTOL, GRAD_ATOL, f"gradient leaf {i}")
    if cfg.moe:
        _, _, experts = routed[0]
        capacity = max(int(experts.numel() * cfg.capacity_factor / cfg.n_experts), 4)
        assert int(torch.bincount(experts.reshape(-1)).max()) > capacity, "no pair dropped"


def test_chunked_loss_keeps_no_logits():
    """With ``loss_chunk`` autograd saves no ``(b, s, vocab)`` or ``(b, chunk,
    vocab)`` logits; without it, it does (a vocab apart from every other
    width of the config)."""
    _, cfg = _configs("granite-8b", vocab_size=96)
    params = T.init_params(cfg, seed=0, device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    tokens, labels = _batch(cfg)

    def saved_shapes(loss_chunk):
        shapes = []

        def pack(t):
            shapes.append(tuple(t.shape))
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            T.loss_fn(params, cfg, tokens, labels, loss_chunk=loss_chunk)
        return shapes

    logits = {(BATCH, SEQ, cfg.vocab_size), (BATCH, LOSS_CHUNK, cfg.vocab_size)}
    assert logits & set(saved_shapes(0))
    assert not logits & set(saved_shapes(LOSS_CHUNK))


@pytest.mark.parametrize("arch", ["granite-8b", "deepseek-v2-lite-16b", "dbrx-132b"])
def test_remat_gives_the_same_gradients(arch):
    """``cfg.remat`` recomputes each layer in the backward: dense GQA, MLA +
    MoE and MoE, bit for bit on the CPU."""
    _, cfg = _configs(arch)
    tokens, labels = _batch(cfg)
    out = {}
    for remat in (False, True):
        params = T.init_params(cfg, seed=2, device="cpu")
        out[remat] = _port_loss_and_grads(params, dataclasses.replace(cfg, remat=remat),
                                          tokens, labels)
    assert torch.equal(out[False][0], out[True][0])
    for g, h in zip(tree_leaves(out[False][1]), tree_leaves(out[True][1])):
        assert torch.equal(g, h)


def test_flash_backward_raises_as_the_reference():
    """The forward through the flash path works under grad; its backward
    raises on the CPU as on the card.  The reference cannot differentiate
    its Pallas kernel either."""
    ref_cfg, cfg = _configs("granite-8b", attn_impl="flash")
    ref_params, params = _params(ref_cfg, cfg)
    tokens, labels = _batch(cfg)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    loss = T.loss_fn(params, cfg, tokens, labels)
    want = ref_T.loss_fn(ref_params, ref_cfg, jnp.asarray(tokens.numpy()), jnp.asarray(labels.numpy()))
    _close(loss.detach(), want, GRAD_RTOL, GRAD_ATOL, "flash loss")
    with pytest.raises(NotImplementedError, match="attn_impl='sdpa'"):
        loss.backward()
    with pytest.raises(Exception):
        jax.grad(ref_T.loss_fn)(ref_params, ref_cfg, jnp.asarray(tokens.numpy()),
                                jnp.asarray(labels.numpy()))

    from repro_torch.kernels.flash_attention.ops import flash_attention

    q = torch.randn((1, 8, 2, 16), requires_grad=True)
    out = flash_attention(q, q.detach(), q.detach())
    with pytest.raises(NotImplementedError):
        out.sum().backward()
    with torch.no_grad():
        assert torch.equal(flash_attention(q, q, q), out.detach())


# ---------------------------------------------------------------------------
# the train step, the slice as a whole
# ---------------------------------------------------------------------------


def test_train_step_matches_reference():
    """One ``make_lm_job`` step of each package on granite-8b's smoke config
    from the same weights and batch."""
    ref_cfg, cfg = _configs("granite-8b")
    ref_state, ref_step, ref_data = ref_launch.make_lm_job(ref_cfg, BATCH, SEQ, 3e-4)
    state, step, data = launch.make_lm_job(cfg, BATCH, SEQ, 3e-4, device="cpu")
    state["params"] = lm_params_from_numpy(jax.tree.map(np.asarray, ref_state["params"]), cfg, CPU)
    state["opt"] = opt.adamw_init(state["params"])
    ref_batch, batch = next(ref_data(0)), next(data(0))
    assert all(np.array_equal(np.asarray(r), b.numpy()) for r, b in zip(ref_batch, batch))

    ref_state, ref_metrics = ref_step(ref_state, ref_batch)
    state, metrics = step(state, batch)
    _close(metrics["loss"], ref_metrics["loss"], GRAD_RTOL, GRAD_ATOL, "loss")
    _close(metrics["gnorm"], ref_metrics["gnorm"], GRAD_RTOL, GRAD_ATOL, "gnorm")
    assert int(state["opt"].count) == int(ref_state["opt"].count) == 1
    for i, (g, w) in enumerate(zip(tree_leaves(state), jax.tree.leaves(ref_state))):
        _close(g.detach(), w, STEP_RTOL, STEP_ATOL, f"state leaf {i}")


# ---------------------------------------------------------------------------
# optimizers and schedules against the reference on the same arrays
# ---------------------------------------------------------------------------


def _np_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((6, 5)) * scale).astype(np.float32),
            "stack": [(rng.standard_normal((3, 4, 5)) * scale).astype(np.float32)],
            "b": (rng.standard_normal(7) * scale).astype(np.float32)}


def _torch_tree(tree):
    return tree_map(lambda a: torch.as_tensor(a.copy()), tree)


def _assert_trees_close(got, want, rtol=ULP_RTOL, atol=ULP_ATOL):
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for i, (a, b) in enumerate(zip(g, w)):
        _close(a, b, rtol, atol, f"leaf {i}")


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_optimizer_matches_reference(kind):
    """Four updates on the same params and grads, with a float and a tensor
    learning rate."""
    init, update = {"adamw": (opt.adamw_init, opt.adamw_update),
                    "adafactor": (opt.adafactor_init, opt.adafactor_update)}[kind]
    ref_init, ref_update = {"adamw": (ref_opt.adamw_init, ref_opt.adamw_update),
                            "adafactor": (ref_opt.adafactor_init, ref_opt.adafactor_update)}[kind]
    ref_params = jax.tree.map(jnp.asarray, _np_tree(0))
    params = _torch_tree(_np_tree(0))
    ref_state, state = ref_init(ref_params), init(params)
    for i in range(4):
        g = _np_tree(10 + i, scale=0.1)
        lr = 1e-2 if i % 2 else torch.tensor(2e-2)
        ref_params, ref_state = ref_update(jax.tree.map(jnp.asarray, g), ref_state, ref_params,
                                           jnp.float32(lr))
        params, state = update(_torch_tree(g), state, params, lr)
    _assert_trees_close(params, ref_params)
    _assert_trees_close(state, ref_state)
    assert state.count.dtype == torch.int32 and int(state.count) == 4


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _np_tree(3)
    ref_clipped, ref_norm = ref_opt.clip_by_global_norm(jax.tree.map(jnp.asarray, g), max_norm)
    grads = _torch_tree(g)
    clipped, norm = opt.clip_by_global_norm(grads, max_norm)
    assert clipped is grads  # scaled in place
    _close(norm, ref_norm, ULP_RTOL, 0, "norm")
    _assert_trees_close(clipped, ref_clipped)


def test_schedules_match_reference():
    for port, ref in (
        (opt.cosine_schedule(3e-4, 50, 0.1), ref_opt.cosine_schedule(3e-4, 50, 0.1)),
        (opt.linear_warmup_cosine(3e-4, 10, 60), ref_opt.linear_warmup_cosine(3e-4, 10, 60)),
    ):
        for step in (0, 1, 5, 9, 10, 11, 33, 60, 75):
            want = ref(jnp.int32(step))
            got = port(torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32
            _close(got, want, ULP_RTOL, 0, f"step {step}")
            _close(port(step), want, ULP_RTOL, 0, f"int step {step}")


# mirrors of tests/test_substrate.py


def test_adamw_converges_quadratic():
    params = {"w": torch.tensor([5.0, -3.0, 2.0])}
    state = opt.adamw_init(params)
    for _ in range(300):
        w = params["w"].detach().requires_grad_(True)
        torch.sum(w ** 2).backward()
        params, state = opt.adamw_update({"w": w.grad}, state, params, 0.05, weight_decay=0.0)
    assert float(params["w"].abs().max()) < 1e-2


def test_adafactor_state_is_factored():
    s = opt.adafactor_init({"w": torch.zeros((64, 32)), "b": torch.zeros((32,))})
    assert s.row["w"].shape == (64,) and s.col["w"].shape == (32,)
    assert s.row["b"].shape == (32,)


def test_clip_by_global_norm():
    clipped, norm = opt.clip_by_global_norm({"a": torch.ones((10,)) * 10.0}, 1.0)
    assert float(norm) == pytest.approx(np.sqrt(1000.0))
    assert float(torch.linalg.norm(clipped["a"])) == pytest.approx(1.0, rel=1e-5)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip_and_atomicity():
    with tempfile.TemporaryDirectory() as d:
        tree = {"a": torch.arange(5.0), "b": {"c": torch.ones((2, 3))}}
        ckpt.save_checkpoint(d, 3, tree)
        ckpt.save_checkpoint(d, 7, tree_map(lambda x: x * 2, tree))
        # a torn write must be ignored
        os.makedirs(os.path.join(d, "step_00000009.tmp"), exist_ok=True)
        restored, manifest = ckpt.restore_latest(d, tree)
        assert manifest["step"] == 7
        np.testing.assert_allclose(restored["a"].numpy(), np.arange(5.0) * 2)
        assert ckpt.restore_latest(os.path.join(d, "missing"), tree) is None


def test_checkpoint_shape_mismatch_raises():
    with tempfile.TemporaryDirectory() as d:
        path = ckpt.save_checkpoint(d, 1, {"a": torch.zeros((4,))})
        with pytest.raises(ValueError):
            ckpt.restore_checkpoint(path, {"a": torch.zeros((5,))})
        with pytest.raises(ValueError, match="leaves"):
            ckpt.restore_checkpoint(path, {"a": torch.zeros((4,)), "b": torch.zeros(())})


def test_async_checkpointer_gc():
    with tempfile.TemporaryDirectory() as d:
        ck = ckpt.AsyncCheckpointer(d, keep=2)
        for step in (1, 2, 3, 4):
            ck.save(step, {"x": torch.full((3,), float(step))})
        ck.wait()
        kept = sorted(p for p in os.listdir(d) if p.startswith("step_"))
        assert kept == ["step_00000003", "step_00000004"]


def test_async_checkpointer_copies_before_returning():
    """An in-place update right after ``save`` does not reach the file."""
    with tempfile.TemporaryDirectory() as d:
        x = torch.zeros(1 << 16)
        ck = ckpt.AsyncCheckpointer(d)
        ck.save(1, {"x": x})
        x.add_(1.0)
        ck.wait()
        restored, _ = ckpt.restore_latest(d, {"x": x})
        assert float(restored["x"].abs().max()) == 0.0


def _lm_states(cfg, ref_cfg):
    """The reference's ``{"params", "opt"}`` after one step, and the port's
    state holding the same values."""
    ref_state, ref_step, ref_data = ref_launch.make_lm_job(ref_cfg, BATCH, SEQ, 3e-4)
    ref_state, _ = ref_step(ref_state, next(ref_data(0)))
    state, _, _ = launch.make_lm_job(cfg, BATCH, SEQ, 3e-4, device="cpu")
    for p in tree_leaves(state["params"]):
        p.requires_grad_(True)
    return ref_state, state


def test_checkpoints_restore_across_packages():
    """A full ``{"params", "opt"}`` state written by the reference restores
    in the port, leaf for leaf, and the reverse."""
    ref_cfg, cfg = _configs("granite-8b")
    ref_state, state = _lm_states(cfg, ref_cfg)
    with tempfile.TemporaryDirectory() as d:
        ref_ckpt.save_checkpoint(d, 1, ref_state)
        restored, manifest = ckpt.restore_latest(d, state)
    assert manifest["step"] == 1
    assert isinstance(restored["opt"], opt.AdamWState) and restored["opt"].count.dtype == torch.int32
    for g, w in zip(tree_leaves(restored), jax.tree.leaves(ref_state)):
        assert np.array_equal(g.detach().numpy(), np.asarray(w))
    # names, not only positions: the ffn and attention norms share a shape
    np.testing.assert_array_equal(restored["params"]["groups"][0]["ffn_norm"].detach().numpy(),
                                  np.asarray(ref_state["params"]["groups"][0]["ffn_norm"]))
    np.testing.assert_array_equal(restored["opt"].nu["groups"][0]["attn"]["w_k"].numpy(),
                                  np.asarray(ref_state["opt"].nu["groups"][0]["attn"]["w_k"]))

    with tempfile.TemporaryDirectory() as d:
        ckpt.save_checkpoint(d, 2, restored)
        back, manifest = ref_ckpt.restore_latest(d, ref_state)
    assert manifest["step"] == 2 and isinstance(back["opt"], ref_opt.AdamWState)
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(ref_state)):
        assert np.array_equal(np.asarray(g), np.asarray(w))


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------


def test_loop_crash_restart_bitexact():
    def train_step(s, b):
        return {"p": s["p"] * 1.5 + b, "n": s["n"] + 1}, {"loss": torch.sum(s["p"])}

    def data(start):
        def gen():
            i = start
            while True:
                yield torch.tensor(float(i % 3))
                i += 1
        return gen()

    init = {"p": torch.ones(()), "n": torch.zeros(())}
    with tempfile.TemporaryDirectory() as d:
        cfg = LoopConfig(total_steps=20, ckpt_dir=d, ckpt_every=5, log_every=100)
        expected = TrainLoop(cfg, train_step, data, init).run()

    with tempfile.TemporaryDirectory() as d:
        cfg = LoopConfig(total_steps=20, ckpt_dir=d, ckpt_every=5, log_every=100)
        loop = TrainLoop(cfg, train_step, data, init)
        loop.inject_fault_at(13)
        with pytest.raises(RuntimeError):
            loop.run()
        loop2 = TrainLoop(cfg, train_step, data, init)
        assert loop2.try_restore() and loop2.step == 10
        resumed = loop2.run()

    assert torch.equal(resumed["p"], expected["p"])
    assert float(resumed["n"]) == 20


def test_lm_crash_restart_bitexact():
    """The LM job through ``TrainLoop``: 20 steps straight, or crashed at 13
    and resumed from step 10, land on the same bits (the card's ``[train]``
    gate, on the CPU)."""
    _, cfg = _configs("granite-8b")
    with tempfile.TemporaryDirectory() as d:
        state, step, data = launch.make_lm_job(cfg, BATCH, SEQ, 3e-4, device="cpu")
        expected = TrainLoop(LoopConfig(total_steps=20, ckpt_dir=d, ckpt_every=5), step, data,
                             state).run()
    with tempfile.TemporaryDirectory() as d:
        cfg_loop = LoopConfig(total_steps=20, ckpt_dir=d, ckpt_every=5)
        state, step, data = launch.make_lm_job(cfg, BATCH, SEQ, 3e-4, device="cpu")
        loop = TrainLoop(cfg_loop, step, data, state)
        loop.inject_fault_at(13)
        with pytest.raises(RuntimeError, match="injected"):
            loop.run()
        state, step, data = launch.make_lm_job(cfg, BATCH, SEQ, 3e-4, device="cpu")
        loop2 = TrainLoop(cfg_loop, step, data, state)
        assert loop2.try_restore() and loop2.step == 10
        resumed = loop2.run()
    for g, w in zip(tree_leaves(resumed), tree_leaves(expected)):
        assert torch.equal(g, w)


def test_straggler_watchdog_raises():
    calls = {"i": 0}

    def train_step(s, b):
        calls["i"] += 1
        time.sleep(0.25 if calls["i"] == 15 else 0.005)
        return s, {"loss": torch.zeros(())}

    def data(start):
        def gen():
            while True:
                yield 0.0
        return gen()

    cfg = LoopConfig(total_steps=30, straggler_factor=5.0, straggler_policy="raise", log_every=100)
    loop = TrainLoop(cfg, train_step, data, {"x": torch.zeros(())})
    with pytest.raises(RuntimeError, match="straggler"):
        loop.run()
    assert loop.straggler_events and loop.straggler_events[0].step == 14


# ---------------------------------------------------------------------------
# compression and elastic planning
# ---------------------------------------------------------------------------


@given(seed=st.integers(min_value=0, max_value=100))
@settings(max_examples=10, deadline=None)
def test_compression_error_feedback_property(seed):
    """The mean of the decompressed gradients tends to the true gradient
    (error feedback), and each round equals the reference's."""
    x_np = np.random.default_rng(seed).standard_normal(256).astype(np.float32)
    x = torch.as_tensor(x_np)
    res, acc = torch.zeros_like(x), torch.zeros_like(x)
    ref_res = jnp.zeros_like(jnp.asarray(x_np))
    n = 16
    for _ in range(n):
        dec, res = comp.compress_with_feedback(x, res, codec="int8")
        ref_dec, ref_res = ref_comp.compress_with_feedback(jnp.asarray(x_np), ref_res, codec="int8")
        _close(dec, ref_dec, 1e-6, 1e-7, "int8 round")
        acc = acc + dec
    err = float((acc / n - x).abs().max()) / (float(x.abs().max()) + 1e-9)
    assert err < 0.02


def test_topk_sparsify():
    x_np = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    y = comp.topk_sparsify(torch.as_tensor(x_np), frac=0.05)
    nz = int((y != 0).sum())
    assert 50 <= nz <= 60  # ties allowed
    assert float(y[y != 0].abs().min()) >= float(np.sort(np.abs(x_np))[-60])
    np.testing.assert_array_equal(y.numpy(), np.asarray(ref_comp.topk_sparsify(jnp.asarray(x_np), 0.05)))
    # ties at the threshold survive, as the reference's >= keeps them
    tied = torch.tensor([3.0, -3.0, 1.0, 3.0, 0.5])
    assert comp.topk_sparsify(tied, frac=0.2).tolist() == [3.0, -3.0, 0.0, 3.0, 0.0]
    q, scale = comp.quantize_int8(torch.as_tensor(x_np))
    ref_q, ref_scale = ref_comp.quantize_int8(jnp.asarray(x_np))
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(ref_q))
    _close(comp.dequantize_int8(q, scale), ref_comp.dequantize_int8(ref_q, ref_scale), 1e-6, 0, "dequant")
    with pytest.raises(ValueError):
        comp.compress_with_feedback(q.float(), q.float(), codec="fp4")


def test_compressed_psum_at_four_ranks():
    """``compressed_psum`` over 4 gloo ranks: the reference's bound on the
    error of the mean, and equality with its formula recomputed in numpy."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    residual = (rng.standard_normal((4, 64)) * 0.01).astype(np.float32)
    out = run_ranks(R.compressed_psum_case, 4, args=(x, residual), timeout_s=300.0)

    g = x + residual
    scale = np.float32(max(np.abs(gi).max() / np.float32(127.0) + np.float32(1e-12) for gi in g))
    q = np.clip(np.round(g / scale), -127, 127).astype(np.int8)
    mean = q.astype(np.int32).sum(0).astype(np.float32) * scale / np.float32(4.0)
    for rank, (got_mean, got_res) in enumerate(out):
        np.testing.assert_allclose(got_mean, mean, rtol=1e-6, atol=0)
        np.testing.assert_allclose(got_res, g[rank] - q[rank].astype(np.float32) * scale,
                                   rtol=1e-6, atol=1e-7)
    true_mean = g.mean(0)
    assert np.abs(out[0][0] - true_mean).max() / (np.abs(true_mean).max() + 1e-9) < 0.05


def test_elastic_plan():
    assert plan_elastic_mesh(16, model_parallel=4) == (4, 4)
    assert plan_elastic_mesh(13, model_parallel=4) == (3, 4)  # drops a straggler
    with pytest.raises(ValueError):
        plan_elastic_mesh(3, model_parallel=4)
    assert survivors_after_failure(list(range(8)), [2, 5]) == [0, 1, 3, 4, 6, 7]


# ---------------------------------------------------------------------------
# the token stream
# ---------------------------------------------------------------------------


def test_token_batches_equal_reference_and_resume():
    ref_cfg, cfg = _configs("granite-8b")
    ref = ref_token_batches(ref_cfg, 2, 16, seed=5, start_step=0)
    got = token_batches(cfg, 2, 16, seed=5, start_step=0, device="cpu")
    for _ in range(3):
        for r, g in zip(next(ref), next(got)):
            assert g.dtype == torch.int64 and np.array_equal(g.numpy(), np.asarray(r))
    stream = token_batches(cfg, 2, 16, seed=5, device="cpu")
    next(stream), next(stream)
    resumed = token_batches(cfg, 2, 16, seed=5, start_step=2, device="cpu")
    for r, g in zip(next(stream), next(resumed)):
        assert torch.equal(r, g)


def test_entry_points_default_to_the_card():
    """Without a device the training entry points run on the card, and
    raise without one."""
    _, cfg = _configs("granite-8b")
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        token_batches(cfg, 2, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.make_lm_job(cfg, 2, 8, 3e-4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.main(["--arch", "granite-8b", "--smoke", "--steps", "2"])


# ---------------------------------------------------------------------------
# the launcher and the example
# ---------------------------------------------------------------------------


def _printed(fn, *args) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args)
    return out.getvalue()


def test_launcher_resumes_from_its_checkpoint(tmp_path):
    args = ["--arch", "granite-8b", "--smoke", "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    first = _printed(launch.main, args + ["--steps", "10"])
    assert "resumed=False start_step=0" in first and "done 10 steps" in first
    second = _printed(launch.main, args + ["--steps", "20"])
    assert "resumed=True start_step=10" in second and "done 20 steps" in second
    assert sorted(os.listdir(tmp_path)) == ["step_00000010", "step_00000020"]
    recsys = _printed(launch.main, ["--arch", "two-tower-retrieval", "--smoke", "--device", "cpu",
                                    "--steps", "2"])
    assert "family=recsys resumed=False start_step=0" in recsys and "done 2 steps" in recsys
    with pytest.raises(SystemExit, match="family subgraph"):
        launch.main(["--arch", "subgraph2vec", "--device", "cpu"])


def test_example_train_lm_tiny_loss_falls():
    path = os.path.join(REPO, "examples", "torch", "train_lm.py")
    spec = importlib.util.spec_from_file_location("torch_train_lm_example", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    out = _printed(module.main, ["--tiny", "--device", "cpu", "--steps", "30"])
    assert "lm-tiny" in out and out.rstrip().endswith("OK")
