"""The port's partition specs, shard geometry, sharded LM train step and
``reshard_tree`` against the reference (``repro``) and their definitions.

* ``param_pspecs`` / ``kv_cache_pspecs`` of the five LMs and the recsys
  ``param_pspecs``, and the LM cells' FSDP specs
  (``launch.cells._fsdp_param_pspecs``, on a JAX ``AbstractMesh``), equal
  to the reference's as tuples.
* ``shard_index`` equal to ``NamedSharding.devices_indices_map`` on 4 and
  8 host devices (one JAX subprocess).
* The sharded train step of granite-8b's cell at 2 and 4 gloo ranks
  (rank bodies in ``tests/torch_mesh_ranks.py``) against ``make_lm_job``'s
  single-device step from the same parameters and tokens: losses and
  every parameter leaf within 1e-6 relative (a leaf's max |diff| over its
  max |value|), the loss falling, and the logged collectives equal to
  ``lm_train_schedule``.
* The sharded prefill and split-K decode steps (MQA, MLA with MoE, and
  ``long_500k``'s sequence over every axis) against ``prefill`` and
  ``decode_step`` on one device, within 1e-5 of the largest value.
* ``reshard_tree`` / ``gather_tree`` on a (2, 2) gloo mesh, and again
  after ``plan_elastic_mesh(2)``.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

import torch_mesh_ranks as R
from repro.configs import registry as ref_registry
from repro.launch import cells as ref_cells
from repro.models import recsys as ref_recsys
from repro.models import transformer as ref_T
from repro_torch.configs import granite_8b
from repro_torch.configs import registry
from repro_torch.core.sharding import P, shard_index, shard_shape, tree_device_bytes
from repro_torch.launch import cells
from repro_torch.launch.mesh import AbstractMesh, dp_axes, make_production_mesh
from repro_torch.launch.sharded import lm_train_schedule, schedule_counts
from repro_torch.launch.train import make_lm_job
from repro_torch.models import recsys
from repro_torch.models import transformer as T
from repro_torch.testing.ranks import run_ranks
from repro_torch.train.tree import tree_leaves, tree_map

LM_ARCHS = ("deepseek-v2-lite-16b", "dbrx-132b", "nemotron-4-15b", "granite-8b", "granite-20b")
RANKS_TIMEOUT_S = 300.0
#: the sharded step against the single-device step: a leaf's (or the
#: loss's) max |diff| over its max |value|; the sums over devices run in
#: another order than one device's (fp32 unit roundoff 6e-8)
STEP_RTOL = 1e-6
STEPS = 3


def plain(tree):
    """Specs as tuples, trees as dicts and lists (either package's)."""
    if isinstance(tree, (P, PartitionSpec)):
        return ("P",) + tuple(tuple(e) if isinstance(e, (list, tuple)) else e for e in tree)
    if isinstance(tree, dict):
        return {k: plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [plain(v) for v in tree]
    return tree


def _configs(arch):
    return registry.get_arch(arch)[1].CONFIG, ref_registry.get_arch(arch)[1].CONFIG


@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("model_size", [16, 4])
def test_lm_specs_equal_reference(arch, model_size):
    cfg, ref_cfg = _configs(arch)
    assert plain(T.param_pspecs(cfg, model_size=model_size)) == plain(
        ref_T.param_pspecs(ref_cfg, model_size=model_size))
    for dp in (("data",), ("pod", "data")):
        for shard_seq in (False, True):
            assert plain(T.kv_cache_pspecs(cfg, dp, shard_seq=shard_seq, model_size=model_size)) == \
                plain(ref_T.kv_cache_pspecs(ref_cfg, dp, shard_seq=shard_seq, model_size=model_size))


@pytest.mark.parametrize("dp", [("data",), ("pod", "data")])
def test_recsys_specs_equal_reference(dp):
    cfg, ref_cfg = _configs("two-tower-retrieval")
    assert plain(recsys.param_pspecs(cfg, dp=dp)) == plain(ref_recsys.param_pspecs(ref_cfg, dp=dp))


@pytest.mark.parametrize("multi_pod", [False, True])
def test_fsdp_specs_equal_reference(multi_pod):
    mesh = make_production_mesh(multi_pod=multi_pod)
    ref_mesh = jax.sharding.AbstractMesh(mesh.devices_shape, mesh.axis_names)
    for arch in LM_ARCHS:
        cfg, ref_cfg = _configs(arch)
        got = cells._fsdp_param_pspecs(cfg, dp_axes(mesh), mesh)
        want = ref_cells._fsdp_param_pspecs(ref_cfg, dp_axes(mesh), ref_mesh)
        assert plain(got) == plain(want), arch


_INDICES_CHILD = r"""
import json, sys
import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
out = []
for shape in [(2, 2), (2, 4)]:
    devs = np.array(jax.devices()[: shape[0] * shape[1]]).reshape(shape)
    mesh = Mesh(devs, ("data", "model"))
    order = {d: i for i, d in enumerate(devs.flat)}
    for spec in [(("model", "data"), None), ("data", "model")]:
        m = NamedSharding(mesh, P(*spec)).devices_indices_map((16, 8))
        out.append({"shape": shape, "spec": spec, "map": {
            order[d]: [[s.start or 0, s.stop if s.stop is not None else n] for s, n in zip(idx, (16, 8))]
            for d, idx in m.items()}})
print(json.dumps(out))
"""


def test_shard_index_equals_named_sharding():
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8", JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", _INDICES_CHILD], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    cases = json.loads(res.stdout.strip().splitlines()[-1])
    assert len(cases) == 4
    for case in cases:
        mesh = AbstractMesh(case["shape"], ("data", "model"))
        spec = P(*(tuple(e) if isinstance(e, list) else e for e in case["spec"]))
        for d, want in case["map"].items():
            assert [list(r) for r in shard_index((16, 8), spec, mesh, int(d))] == want, (case, d)


def test_tree_device_bytes_counts_blocks():
    mesh = AbstractMesh((2, 4), ("data", "model"))
    shapes = {"a": torch.empty((16, 8), device="meta"), "b": [torch.empty((6,), dtype=torch.int32,
                                                                           device="meta"), 5]}
    specs = {"a": P(("model", "data"), None), "b": [P(None), P()]}
    assert shard_shape((16, 8), specs["a"], mesh) == (2, 8)
    assert tree_device_bytes(shapes, specs, mesh) == 2 * 8 * 4 + 6 * 4 + 4


# ---------------------------------------------------------------------------
# the sharded train step and reshard_tree at 2 and 4 gloo ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def step_setup():
    """granite-8b's smoke config at the reference test's heads, its
    parameters from ``make_lm_job`` (seed 0), tokens (4, 32) from a seed,
    and the single-device job's losses and parameters after each step."""
    cfg = dataclasses.replace(granite_8b.SMOKE_CONFIG, n_heads=8, n_kv_heads=4)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 32)).astype(np.int64)
    state, step, _ = make_lm_job(cfg, 4, 32, 3e-4, device="cpu", loss_chunk=512)
    params_np = tree_map(lambda p: p.detach().numpy().copy(), state["params"])
    losses = []
    for _ in range(STEPS):
        state, metrics = step(state, (torch.as_tensor(tokens), torch.as_tensor(tokens)))
        losses.append(float(metrics["loss"]))
    want = tree_map(lambda p: p.detach().numpy().copy(), state["params"])
    return cfg, tokens, params_np, losses, want


ELASTIC_TREE = {
    "a": np.arange(16 * 6, dtype=np.float32).reshape(16, 6),
    "b": [np.arange(8, dtype=np.int64), np.arange(4 * 6 * 2, dtype=np.float32).reshape(4, 6, 2)],
}
ELASTIC_SPECS = {"a": P(("model", "data"), None), "b": [P("data"), P(None, "model", "data")]}


#: (arch, config changes, mesh, shard_seq) of the prefill and decode cases:
#: MQA (the sequence over "model", as granite-20b's caches at the
#: production meshes), MLA with MoE (no drops, so routing is per token),
#: and long_500k's layout (batch 1, the sequence over every axis)
SERVE_CASES = (
    ("granite-8b", dict(n_heads=8, n_kv_heads=1), (1, 2), False),
    ("deepseek-v2-lite-16b", dict(capacity_factor=4.0), (1, 2), False),
    ("granite-8b", dict(n_heads=8, n_kv_heads=4), (2, 2), True),
)
#: sharded prefill and decode against one device's: the logits' and
#: caches' max |diff| over their max |value| (sums over other splits)
SERVE_RTOL = 1e-5


def _serve_case(arch, changes, shard_seq):
    """A config, its parameters, a prompt, the caches ``prefill`` fills, and
    one decode token at the prompt's last position, with one device's
    answers."""
    smoke = registry.get_arch(arch)[1].SMOKE_CONFIG
    cfg = dataclasses.replace(smoke, **changes)
    params = T.init_params(cfg, seed=2, device="cpu")
    b, s = (1, 32) if shard_seq else (2, 32)
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int64)
    token = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int64)
    caches = T.init_kv_cache(cfg, b, s, device="cpu")
    logits, caches = T.prefill(params, cfg, torch.as_tensor(tokens), caches)
    caches_np = [{k: v.numpy().copy() for k, v in g.items()} for g in caches]
    want_decode, _ = T.decode_step(params, cfg, torch.as_tensor(token), caches, s - 1)
    case = {"cfg": cfg, "params": tree_map(lambda p: p.numpy(), params), "tokens": tokens,
            "caches": caches_np, "token": token, "index": s - 1, "shard_seq": shard_seq}
    return case, {"prefill_last": logits[:, -1].numpy(), "caches": caches_np,
                  "decode_logits": want_decode.numpy()}


@pytest.fixture(scope="module")
def serve_cases():
    return [(_serve_case(arch, changes, shard_seq), shape)
            for arch, changes, shape, shard_seq in SERVE_CASES]


@pytest.fixture(scope="module")
def step_ranks(step_setup, serve_cases):
    cfg, tokens, params_np, _, _ = step_setup
    out = {}
    for shape in ((1, 2), (2, 2)):
        extra = (ELASTIC_TREE, ELASTIC_SPECS) if shape == (2, 2) else (None, None)
        serve = [case for (case, _), s in serve_cases if s == shape]
        out[shape] = run_ranks(R.sharding_cases, shape[0] * shape[1],
                               args=(shape, cfg, params_np, tokens, STEPS) + extra + (serve,),
                               timeout_s=RANKS_TIMEOUT_S)
    return out


def _close(got, want):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= SERVE_RTOL * np.abs(want).max()


@pytest.mark.parametrize("i", range(len(SERVE_CASES)))
def test_sharded_prefill_and_decode_match_single_device(serve_cases, step_ranks, i):
    (_, want), shape = serve_cases[i]
    index = [j for j, (_, s) in enumerate(serve_cases) if s == shape].index(i)
    shard_seq = SERVE_CASES[i][3]
    for r in step_ranks[shape]:
        got = r["serve"][index]
        rows = slice(None) if shard_seq else _rows(r["rank"], shape, want["decode_logits"].shape[0])
        _close(got["decode_logits"], want["decode_logits"][rows])
        if shard_seq:
            assert "prefill_last" not in got
            continue
        _close(got["prefill_last"], want["prefill_last"][rows])
        for a, b in zip(tree_leaves(got["prefill_caches"]), tree_leaves(want["caches"])):
            _close(a, b)


def _rows(rank, shape, b):
    """Rank ``rank``'s batch rows at ``P(("data",), None)``."""
    per = b // shape[0]
    d = rank // shape[1]
    return slice(d * per, (d + 1) * per)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_sharded_step_matches_single_device(step_setup, step_ranks, shape):
    _, _, _, want_losses, want = step_setup
    ranks = step_ranks[shape]
    for r in ranks:  # every rank holds the same global loss
        np.testing.assert_allclose(r["losses"], want_losses, rtol=STEP_RTOL, atol=0)
    assert ranks[0]["losses"][-1] < ranks[0]["losses"][0], ranks[0]["losses"]
    got = ranks[0]["params"]
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= STEP_RTOL * np.abs(b).max()


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_sharded_step_collectives_equal_schedule(step_setup, step_ranks, shape):
    cfg = step_setup[0]
    mesh = AbstractMesh(shape, ("data", "model"))
    specs = cells._fsdp_param_pspecs(cfg, dp_axes(mesh), mesh)
    want = schedule_counts(lm_train_schedule(cfg, mesh, specs, 4, 32, 1))
    for r in step_ranks[shape]:
        for log in r["logs"]:
            assert schedule_counts(log) == want
    assert {op for op, *_ in want} == {"all-gather", "reduce-scatter", "all-reduce"}


def test_reshard_tree_places_gathers_and_replaces(step_ranks):
    mesh = AbstractMesh((2, 2), ("data", "model"))
    leaves, specs = tree_leaves(ELASTIC_TREE), [ELASTIC_SPECS["a"]] + ELASTIC_SPECS["b"]
    for r in step_ranks[(2, 2)]:
        el = r["elastic"]
        rank = r["rank"]
        for x, spec, got in zip(leaves, specs, tree_leaves(el["local"])):
            block = tuple(slice(a, b) for a, b in shard_index(x.shape, spec, mesh, rank))
            np.testing.assert_array_equal(got, x[block])
        for x, got in zip(leaves, tree_leaves(el["whole"])):
            np.testing.assert_array_equal(got, x)
        assert tuple(el["shape"]) == (1, 2)
        small = AbstractMesh(el["shape"], ("data", "model"))
        if rank >= 2:
            assert el["again"] is None
            continue
        for x, spec, got in zip(leaves, specs, tree_leaves(el["again"])):
            block = tuple(slice(a, b) for a, b in shard_index(x.shape, spec, small, rank))
            np.testing.assert_array_equal(got, x[block])
