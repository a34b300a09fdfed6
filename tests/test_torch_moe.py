"""The port's MLA attention and MoE feed-forward against the reference, on
the CPU: DeepSeek-V2-Lite's and DBRX's smoke configs.

Reference weights are drawn with ``jax.random`` and carried across as
numpy arrays; inputs come from numpy seeds.  ``moe_apply`` is held at the
published ``capacity_factor`` with drops asserted (which pairs drop depends
on each pair's queue position, token-major and slot-minor), in fp32 and
bf16.  The expert-parallel form runs at 2 and 4 gloo ranks, one spawned
group each (``tests/torch_mesh_ranks.py``, which imports only the port).
Tolerances: the reference's port-vs-reference bar ``rtol = atol = 2e-4``;
bf16 outputs, one bf16 rounding apart (2^-8 of the value) after products
summed in other orders, at ``2e-2`` of the largest output; EP against the
dense path ``< 1e-4`` as ``tests/test_distributed.py``'s EP test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as ref_get_arch
from repro.models import layers as ref_layers
from repro.models import transformer as ref_T
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServeEngine as RefServeEngine

import torch_mesh_ranks as R
from repro_torch.configs.registry import get_arch
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models import layers as L
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.testing.moe import moe_loop
from repro_torch.testing.ranks import run_ranks

MOE_ARCHS = ("deepseek-v2-lite-16b", "dbrx-132b")
RTOL = ATOL = 2e-4
BF16_RTOL = 2e-2
EP_ATOL = 1e-4
WORLDS = (2, 4)
#: a spawned group's own wall-clock limit (and its collectives' timeout)
RANKS_TIMEOUT_S = 300.0
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _configs(arch, **changes):
    ref_cfg = dataclasses.replace(ref_get_arch(arch)[1].SMOKE_CONFIG, **changes)
    cfg = dataclasses.replace(get_arch(arch)[1].SMOKE_CONFIG, **changes)
    return ref_cfg, cfg


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree))


def _moe_layer(arch, seed, shape, **changes):
    """The reference's ``init_moe`` weights (and the port's copy) and fp32
    numpy activations of ``shape + (d_model,)``: normal draws plus one
    direction that all tokens share, so that they favour the same experts
    and some overflow their capacity."""
    ref_cfg, cfg = _configs(arch, **changes)
    ref_params = ref_layers.init_moe(jax.random.PRNGKey(seed), ref_cfg)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape + (cfg.d_model,)) + 1.5 * rng.standard_normal(cfg.d_model)
    x = x.astype(np.float32)
    return ref_cfg, cfg, ref_params, _torch_tree(ref_params), x


def _dropped_pairs(cfg, experts):
    n_tok, k = experts.shape
    capacity = max(int(n_tok * k * cfg.capacity_factor / cfg.n_experts), 4)
    counts = np.bincount(experts.reshape(-1), minlength=cfg.n_experts)
    return int(np.maximum(counts - capacity, 0).sum())


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_matches_reference_with_drops(arch, dtype):
    """96 tokens at the published capacity factor 1.25: some experts
    overflow, and the same pairs drop on both sides."""
    jdt, tdt = DTYPES[dtype]
    ref_cfg, cfg, ref_params, params, x = _moe_layer(arch, 5, (4, 24))
    want, want_aux = ref_layers.moe_apply(ref_params, ref_cfg, jnp.asarray(x, jdt))
    xt = torch.as_tensor(x).to(tdt)
    got, aux = L.moe_apply(params, cfg, xt)
    assert got.dtype == tdt and got.shape == x.shape

    # the same routing: top-k in descending order, ties to the lower index
    logits = jnp.asarray(x, jdt).reshape(-1, cfg.d_model).astype(jnp.float32) @ ref_params["router"]
    _, ref_experts = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.moe_top_k)
    _, _, experts = L.moe_route(params["router"], xt.reshape(-1, cfg.d_model), cfg.moe_top_k)
    np.testing.assert_array_equal(experts.numpy(), np.asarray(ref_experts))
    assert _dropped_pairs(cfg, experts.numpy()) > 0

    np.testing.assert_allclose(float(aux), float(want_aux), rtol=RTOL, atol=0)
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    else:
        assert np.abs(got - want).max() <= BF16_RTOL * np.abs(want).max()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_loop_matches_reference_with_drops(arch):
    """The plain per-expert loop ``chip_smoke.py`` holds ``moe_apply``
    against, under the port's routing, against the reference's layer."""
    ref_cfg, cfg, ref_params, params, x = _moe_layer(arch, 6, (4, 24))
    want, _ = ref_layers.moe_apply(ref_params, ref_cfg, jnp.asarray(x))
    xt = torch.as_tensor(x)
    _, gates, experts = L.moe_route(params["router"], xt.reshape(-1, cfg.d_model), cfg.moe_top_k)
    got, dropped = moe_loop(params, cfg, xt, gates, experts)
    assert dropped == _dropped_pairs(cfg, experts.numpy()) > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(L.moe_apply(params, cfg, xt)[0].numpy(), got.numpy(),
                               rtol=RTOL, atol=ATOL)


def test_moe_shard_slices_the_experts():
    _, cfg, _, params, _ = _moe_layer("deepseek-v2-lite-16b", 0, (1, 1))
    shard = L.moe_shard(params, 1, 2)
    assert set(shard) == set(params)
    for name in L.EXPERT_WEIGHTS:
        assert torch.equal(shard[name], params[name][2:4])
    assert shard["router"] is params["router"] and shard["shared"] is params["shared"]
    with pytest.raises(ValueError, match="do not split"):
        L.moe_shard(params, 0, 3)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prompt", [1, 9])
def test_mla_prefill_and_absorbed_decode_match_reference(prompt):
    """A prompt written into a 16-row latent cache, then two one-token
    steps on the absorbed path (a one-token prompt takes it too); outputs
    and caches against the reference, and the cache-free call."""
    ref_cfg, cfg = _configs("deepseek-v2-lite-16b")
    ref_params = ref_layers.init_attention(jax.random.PRNGKey(7), ref_cfg)
    params = _torch_tree(ref_params)
    x = np.random.default_rng(7).standard_normal((2, prompt + 2, cfg.d_model)).astype(np.float32)
    shapes = {"c_kv": (2, 16, cfg.kv_lora_rank), "k_rope": (2, 16, cfg.qk_rope_head_dim)}
    ref_cache = {k: jnp.zeros(s) for k, s in shapes.items()}
    cache = {k: torch.zeros(s) for k, s in shapes.items()}
    steps = [(0, prompt)] + [(i, i + 1) for i in (prompt, prompt + 1)]
    for lo, hi in steps:
        pos = np.arange(lo, hi)
        want, ref_cache = ref_layers.attention_apply(
            ref_params, ref_cfg, jnp.asarray(x[:, lo:hi]), jnp.asarray(pos), ref_cache, jnp.int32(lo))
        got, new_cache = L.attention_apply(params, cfg, torch.as_tensor(x[:, lo:hi]),
                                           torch.as_tensor(pos), cache, lo)
        assert new_cache is cache  # written in place
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
        for k in shapes:
            np.testing.assert_allclose(cache[k].numpy(), np.asarray(ref_cache[k]), rtol=RTOL, atol=ATOL)
    assert not cache["c_kv"][:, prompt + 2:].any()

    pos = np.arange(prompt + 2)
    want, _ = ref_layers.attention_apply(ref_params, ref_cfg, jnp.asarray(x), jnp.asarray(pos))
    got, none = L.attention_apply(params, cfg, torch.as_tensor(x), torch.as_tensor(pos))
    assert none is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_engine_matches_reference_on_mixed_lengths(arch):
    """Prompts of 3, 7, 2 and 5 tokens on 2 slots at the published capacity
    factor: prefill (MLA: decompressed) and decode (MLA: absorbed) through
    per-slot cache views, token for token with the reference."""
    ref_cfg, cfg = _configs(arch)
    ref_params = ref_T.init_params(jax.random.PRNGKey(0), ref_cfg)
    params = lm_params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg, "cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in (3, 7, 2, 5)]
    budgets = (5, 3, 6, 4)
    ref_reqs = [RefRequest(uid=i, prompt=p, max_new_tokens=m)
                for i, (p, m) in enumerate(zip(prompts, budgets))]
    RefServeEngine(ref_cfg, ref_params, max_batch=2, max_len=32).run(ref_reqs)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=m) for i, (p, m) in enumerate(zip(prompts, budgets))]
    engine = ServeEngine(cfg, params, max_batch=2, max_len=32)
    engine.run(reqs)
    for req, ref_req in zip(reqs, ref_reqs):
        assert req.done and req.generated == ref_req.generated
    assert set(engine.caches[0]) == ({"c_kv", "k_rope"} if cfg.attention == "mla" else {"k", "v"})
    assert engine.stats["prefills"] == 4


# ---------------------------------------------------------------------------
# expert parallelism at 2 and 4 gloo ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ep_cases():
    """Per arch, the reference EP test's layer and tokens (``init_moe`` at
    key 0, ``(4, 16, d)`` normal activations at ``fold_in(key, 1)``) at an
    ample capacity factor (``n_experts``), and ``_moe_layer``'s skewed
    tokens at the published one."""
    cases = []
    for arch in MOE_ARCHS:
        ref_cfg, cfg = _configs(arch)
        key = jax.random.PRNGKey(0)
        params = jax.tree.map(np.asarray, ref_layers.init_moe(key, ref_cfg))
        x = np.array(jax.random.normal(jax.random.fold_in(key, 1), (4, 16, cfg.d_model)))
        cases.append((arch, float(cfg.n_experts), params, x))
        cases.append((arch, cfg.capacity_factor, params, _moe_layer(arch, 8, (4, 16))[-1]))
    return cases


@pytest.fixture(scope="module")
def ep_ranks(ep_cases):
    """``{world: [rank results]}``: ``R.moe_ep_cases`` at 2 and 4 gloo ranks."""
    return {w: run_ranks(R.moe_ep_cases, w, args=(ep_cases,), timeout_s=RANKS_TIMEOUT_S)
            for w in WORLDS}


@pytest.mark.parametrize("world", WORLDS)
def test_moe_ep_matches_dense_path(ep_cases, ep_ranks, world):
    """Ample capacity: no pair drops, so the ranks' local routing serves what
    the dense path serves (the reference's EP condition)."""
    for i, (arch, cf, params, x) in enumerate(ep_cases):
        if cf != float(get_arch(arch)[1].SMOKE_CONFIG.n_experts):
            continue
        ref_cfg, cfg = _configs(arch, capacity_factor=cf)
        got = np.concatenate([r[i][0] for r in ep_ranks[world]], axis=0)
        want, _ = ref_layers.moe_apply(params, ref_cfg, jnp.asarray(x))
        assert float(np.abs(got - np.asarray(want)).max()) < EP_ATOL
        dense, _ = L.moe_apply(_torch_tree(params), cfg, torch.tensor(x))
        assert float(np.abs(got - dense.numpy()).max()) < EP_ATOL


@pytest.mark.parametrize("world", WORLDS)
def test_moe_ep_routes_and_drops_per_rank(ep_cases, ep_ranks, world):
    """Every case: each rank's output is the dense path on its own tokens
    (routing and capacity are local, so at the published factor each rank
    drops its own pairs), and aux is the ranks' mean on every rank."""
    dropped = 0
    for i, (arch, cf, params, x) in enumerate(ep_cases):
        _, cfg = _configs(arch, capacity_factor=cf)
        auxes = []
        for rank, r in enumerate(ep_ranks[world]):
            xl = torch.tensor(np.array_split(x, world, axis=0)[rank])
            want, aux = L.moe_apply(_torch_tree(params), cfg, xl)
            assert float(np.abs(r[i][0] - want.numpy()).max()) < EP_ATOL
            auxes.append(float(aux))
            _, _, experts = L.moe_route(torch.tensor(params["router"]),
                                        xl.reshape(-1, cfg.d_model), cfg.moe_top_k)
            dropped += _dropped_pairs(cfg, experts.numpy())
        assert len({r[i][1] for r in ep_ranks[world]}) == 1
        np.testing.assert_allclose(ep_ranks[world][0][i][1], np.mean(auxes), rtol=1e-6)
    assert dropped > 0
