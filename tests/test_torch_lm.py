"""The port's LM inference path against the reference, on the CPU: the
five LM archs (dense GQA, MLA, MoE) at their smoke configs.

Reference weights are drawn with ``jax.random`` and carried across with
``lm_params_from_numpy``; token ids come from numpy seeds.  The reference's
flash path runs its Pallas kernel in interpret mode, the port's its plain
attention version (CPU tensors).  Tolerances are the reference's own bars
(``tests/test_flash_attention.py``, ``tests/test_arch_smoke.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as ref_ARCHS
from repro.configs.registry import get_arch as ref_get_arch
from repro.models import layers as ref_layers
from repro.models import transformer as ref_T
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServeEngine as RefServeEngine
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Request, ServeEngine

LM_ARCHS = sorted(a for a, (family, _) in ARCHS.items() if family == "lm")
CPU = torch.device("cpu")


def _configs(arch, **changes):
    """The reference's and the port's SMOKE_CONFIG of ``arch``, with the same
    ``changes`` applied to both."""
    ref_cfg = dataclasses.replace(ref_get_arch(arch)[1].SMOKE_CONFIG, **changes)
    cfg = dataclasses.replace(get_arch(arch)[1].SMOKE_CONFIG, **changes)
    return ref_cfg, cfg


def _params(ref_cfg, cfg, seed=0):
    ref_params = ref_T.init_params(jax.random.PRNGKey(seed), ref_cfg)
    return ref_params, lm_params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg, CPU)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=shape).astype(np.int32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_configs_are_copies(arch):
    ref_module, module = ref_get_arch(arch)[1], get_arch(arch)[1]
    for name in ("CONFIG", "SMOKE_CONFIG"):
        ref_cfg, cfg = getattr(ref_module, name), getattr(module, name)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
        assert cfg.param_count() == ref_cfg.param_count()
        assert cfg.active_param_count() == ref_cfg.active_param_count()


def test_unported_archs_raise_with_their_roadmap_item():
    """No arch is left unported: every id of the reference's registry is in
    the port's with the same family; an id neither knows raises."""
    for arch, (family, _) in ref_ARCHS.items():
        assert get_arch(arch)[0] == ARCHS[arch][0] == family
    with pytest.raises(KeyError):
        get_arch("no-such-arch")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_rmsnorm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    gamma = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        L.rmsnorm(torch.as_tensor(x), torch.as_tensor(gamma), 1e-5).numpy(),
        np.asarray(ref_layers.rmsnorm(jnp.asarray(x), jnp.asarray(gamma), 1e-5)), rtol=1e-5, atol=1e-6)
    positions = np.arange(7, 16)
    for theta in (10000.0, 10000000.0):
        np.testing.assert_allclose(
            L.apply_rope(torch.as_tensor(x), torch.as_tensor(positions), theta).numpy(),
            np.asarray(ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(positions), theta)),
            rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kv_len", [None, 13])
@pytest.mark.parametrize("causal", [True, False])
def test_sdpa_chunked_matches_reference(kv_len, causal):
    """GQA (h=4, h_kv=2), query chunks of 8 over 21 queries (a ragged last
    chunk), queries at positions 3.. of a 24-long key sequence."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 21, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 24, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 24, 2, 16)).astype(np.float32)
    pos = np.arange(3, 24)
    got = L._sdpa_chunked(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                          torch.as_tensor(pos), kv_len, causal, 8)
    want = ref_layers._sdpa_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
                                    None if kv_len is None else jnp.int32(kv_len), causal, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "squared_relu", "gelu"])
def test_ffn_matches_reference(activation):
    params = ref_layers.init_ffn(jax.random.PRNGKey(2), 32, 48, activation)
    x = np.random.default_rng(2).standard_normal((2, 5, 32)).astype(np.float32)
    got = L.ffn_apply({k: torch.as_tensor(np.array(v)) for k, v in params.items()}, activation,
                      torch.as_tensor(x))
    want = ref_layers.ffn_apply(params, activation, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("attn_impl", ["sdpa", "flash"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_matches_reference(arch, attn_impl):
    """24 tokens: the sdpa path runs two query chunks of 16, the flash path
    one padded block."""
    ref_cfg, cfg = _configs(arch, attn_impl=attn_impl)
    ref_params, params = _params(ref_cfg, cfg, seed=3)
    tokens = _tokens(cfg, (2, 24), seed=4)
    want, want_aux, _ = ref_T.forward(ref_params, ref_cfg, jnp.asarray(tokens))
    got, aux, caches = T.forward(params, cfg, tokens)
    assert got.shape == (2, 24, cfg.vocab_size) and caches is None
    assert (float(aux) > 0.0) == cfg.moe
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    hidden, _, _ = T.forward(params, cfg, tokens, return_hidden=True)
    ref_hidden, _, _ = ref_T.forward(ref_params, ref_cfg, jnp.asarray(tokens), return_hidden=True)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(ref_hidden), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_decode_match_reference_and_forward(arch):
    """Mirrors ``tests/test_arch_smoke.py::test_lm_decode_matches_forward``,
    MoE archs at ``capacity_factor = n_experts`` as there (no drops, so the
    teacher-forced forward routes as the decode does)."""
    moe = get_arch(arch)[1].SMOKE_CONFIG
    ref_cfg, cfg = _configs(arch, **({"capacity_factor": float(moe.n_experts)} if moe.moe else {}))
    ref_params, params = _params(ref_cfg, cfg, seed=1)
    tokens = _tokens(cfg, (2, 11), seed=1)

    ref_caches = ref_T.init_kv_cache(ref_cfg, 2, 32)
    ref_lg, ref_caches = ref_T.prefill(ref_params, ref_cfg, jnp.asarray(tokens), ref_caches)
    caches = T.init_kv_cache(cfg, 2, 32, device="cpu")
    lg, caches = T.prefill(params, cfg, tokens, caches)
    np.testing.assert_allclose(lg.numpy(), np.asarray(ref_lg), rtol=2e-4, atol=2e-4)
    for g, ref_g in zip(caches, ref_caches):
        assert set(g) == set(ref_g)
        for name in g:
            np.testing.assert_allclose(g[name].numpy(), np.asarray(ref_g[name]), rtol=2e-4, atol=2e-4)

    nxt = lg[:, -1].argmax(-1)[:, None]
    assert np.array_equal(nxt.numpy(), np.asarray(jnp.argmax(ref_lg[:, -1], -1)[:, None]))
    lg2, _ = T.decode_step(params, cfg, nxt, caches, 11)
    ref_lg2, _ = ref_T.decode_step(ref_params, ref_cfg, jnp.asarray(nxt.numpy()), ref_caches,
                                   jnp.int32(11))
    np.testing.assert_allclose(lg2.numpy(), np.asarray(ref_lg2), rtol=2e-4, atol=2e-4)
    full, _, _ = T.forward(params, cfg, torch.cat([torch.as_tensor(tokens).long(), nxt], 1))
    np.testing.assert_allclose(lg2.numpy(), full[:, -1].numpy(), rtol=2e-2, atol=2e-4)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_init_params_has_reference_shapes(arch):
    ref_cfg, cfg = _configs(arch)
    want = jax.tree.map(lambda s: tuple(s.shape), ref_T.param_shapes(ref_cfg))
    params = T.init_params(cfg, seed=0, device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), params) == want
    assert jax.tree.map(lambda t: tuple(t.shape), T.param_shapes(cfg)) == want
    assert all(t.dtype == torch.float32 for t in jax.tree.leaves(params))
    # norms, which param_count leaves out: two per layer, the final one, and
    # MLA's kv_norm
    norms = 2 * cfg.n_layers * cfg.d_model + cfg.d_model + cfg.n_layers * cfg.kv_lora_rank
    assert sum(t.numel() for t in jax.tree.leaves(params)) - norms == cfg.param_count()
    # the reference's scales: embedding 0.02, unembedding 1/sqrt(d_model)
    assert abs(float(params["embed"].std()) - 0.02) < 0.002
    assert abs(float(params["unembed"].std()) * np.sqrt(cfg.d_model) - 1.0) < 0.1
    again = T.init_params(cfg, seed=0, device="cpu")
    assert torch.equal(params["groups"][0]["attn"]["w_q"], again["groups"][0]["attn"]["w_q"])
    shapes = T.kv_cache_shapes(cfg, 3, 20)
    assert [{k: tuple(v.shape) for k, v in g.items()} for g in shapes] == \
        [{k: tuple(v.shape) for k, v in g.items()} for g in ref_T.kv_cache_shapes(ref_cfg, 3, 20)]


def test_lm_params_from_numpy_checks_shapes():
    ref_cfg, cfg = _configs("granite-8b")
    params_np = jax.tree.map(np.asarray, ref_T.init_params(jax.random.PRNGKey(0), ref_cfg))
    params_np["groups"][0]["attn"]["w_q"] = params_np["groups"][0]["attn"]["w_q"][..., :8]
    with pytest.raises(ValueError, match="w_q"):
        lm_params_from_numpy(params_np, cfg, CPU)
    del params_np["unembed"]
    with pytest.raises(ValueError, match="keys"):
        lm_params_from_numpy(params_np, cfg, CPU)


def test_entry_points_default_to_the_card():
    _, cfg = _configs("granite-8b")
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init_kv_cache(cfg, 1, 8)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def test_serve_engine_matches_reference_on_mixed_lengths():
    """Prompts of 3, 7, 2 and 5 tokens on 2 slots: the reference's shared
    write index makes slots read rows their prompt never wrote, and slots
    are refilled; the port reproduces it token for token."""
    ref_cfg, cfg = _configs("granite-8b")
    ref_params, params = _params(ref_cfg, cfg, seed=0)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in (3, 7, 2, 5)]
    budgets = (5, 3, 6, 4)
    ref_reqs = [RefRequest(uid=i, prompt=p, max_new_tokens=m) for i, (p, m) in enumerate(zip(prompts, budgets))]
    RefServeEngine(ref_cfg, ref_params, max_batch=2, max_len=32).run(ref_reqs)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=m) for i, (p, m) in enumerate(zip(prompts, budgets))]
    engine = ServeEngine(cfg, params, max_batch=2, max_len=32)
    engine.run(reqs)
    for req, ref_req in zip(reqs, ref_reqs):
        assert req.done and req.generated == ref_req.generated
        assert len(req.generated) == req.max_new_tokens
    assert engine.stats["prefills"] == 4
    assert engine.stats["decode_tokens"] == sum(budgets) - 4


def test_serve_engine_matches_offline_greedy_on_equal_lengths():
    ref_cfg, cfg = _configs("granite-20b")
    _, params = _params(ref_cfg, cfg, seed=2)
    prompts = [_tokens(cfg, 6, seed=s) for s in (6, 7, 8)]
    reqs = [Request(uid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)]
    ServeEngine(cfg, params, max_batch=3, max_len=32).run(reqs)
    toks = torch.as_tensor(np.stack(prompts)).long()
    for _ in range(5):
        logits, _, _ = T.forward(params, cfg, toks)
        toks = torch.cat([toks, logits[:, -1].argmax(-1)[:, None]], 1)
    for i, req in enumerate(reqs):
        assert req.generated == toks[i, 6:].tolist()
