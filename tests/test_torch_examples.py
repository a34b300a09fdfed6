"""The port's examples (``examples/torch/``) and the paper's config against
the reference's, on the CPU.

Each example runs in this process beside its reference counterpart
(``examples/*.py``), both with their output captured: the text must be the
same and every number in it within ``rtol=1e-5`` (the two frameworks sum
fp32 in different orders).  The reference's fusion slack is pinned to 1.0,
the port's on the CPU, so both pick the same chunks.  Running both in one
process also gives ``ppin_treelets`` the same ``hash(name)`` graph seeds.
"""

import contextlib
import dataclasses
import importlib.util
import io
import os
import re
import subprocess
import sys

import numpy as np
import pytest

import repro.plan.cost as ref_cost
from repro.configs.registry import get_arch as ref_get_arch
from repro.core import engine as ref_engine
from repro.core import estimator as ref_estimator
from repro.core import graph as ref_graph
from repro.core import templates as ref_templates

from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.core import estimate_embeddings, get_template, rmat_graph
from repro_torch.plan import cost

RTOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ("quickstart", "ppin_treelets", "counting_service")
_NUMBER = re.compile(r"-?\d+(?:\.\d+)?(?:e[+-]?\d+)?")


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    monkeypatch.setattr(ref_cost, "load_fusion_slack", lambda path=None: 1.0)
    monkeypatch.setenv(cost.BENCH_ENV_VAR, str(tmp_path / "memory.json"))
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tuned.json"))
    monkeypatch.delenv("REPRO_ENGINE_BACKEND", raising=False)
    monkeypatch.delenv("REPRO_TUNE", raising=False)


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _printed(fn, *args) -> list:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args)
    return out.getvalue().splitlines()


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_prints_the_reference_estimates(name):
    ref = _load(os.path.join(REPO, "examples", f"{name}.py"), f"ref_example_{name}")
    port = _load(os.path.join(REPO, "examples", "torch", f"{name}.py"), f"torch_example_{name}")
    want = _printed(ref.main)
    got = _printed(port.main, ["--device", "cpu"])
    assert len(got) == len(want) and len(want) >= 4
    for g, w in zip(got, want):
        assert _NUMBER.sub("#", g) == _NUMBER.sub("#", w), (g, w)
        gv = [float(x) for x in _NUMBER.findall(g)]
        wv = [float(x) for x in _NUMBER.findall(w)]
        np.testing.assert_allclose(gv, wv, rtol=RTOL, err_msg=f"{g!r} vs {w!r}")


def test_subgraph2vec_config_is_the_reference():
    assert ARCHS["subgraph2vec"][0] == "subgraph"
    family, module = get_arch("subgraph2vec")
    ref_family, ref_module = ref_get_arch("subgraph2vec")
    assert family == ref_family == "subgraph"
    for attr in ("CONFIG", "SMOKE_CONFIG"):
        cfg, ref_cfg = getattr(module, attr), getattr(ref_module, attr)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
        assert type(cfg).__name__ == type(ref_cfg).__name__ == "SubgraphConfig"


def test_subgraph2vec_smoke_config_estimate_matches_reference():
    """``SMOKE_CONFIG`` (u5-2 on rmat 512 / 2000) through both packages'
    ``estimate_embeddings``, 8 colorings of seed 0."""
    cfg = get_arch("subgraph2vec")[1].SMOKE_CONFIG
    got = estimate_embeddings(rmat_graph(cfg.n_vertices, cfg.n_edges, seed=0),
                              get_template(cfg.template), iterations=8, seed=0,
                              dtype=cfg.dtype, device="cpu")
    want = ref_estimator.estimate_embeddings(
        ref_graph.rmat_graph(cfg.n_vertices, cfg.n_edges, seed=0),
        ref_templates.get_template(cfg.template), iterations=8, seed=0, dtype=cfg.dtype)
    assert got.iterations == want.iterations == 8
    np.testing.assert_allclose(got.per_iteration, np.asarray(want.per_iteration), rtol=RTOL)
    assert got.mean == pytest.approx(want.mean, rel=RTOL)


def test_distributed_example_matches_the_reference_local_estimate():
    """``examples/torch/distributed_counting.py`` at 2 gloo ranks, run as a
    user runs it (it spawns its own ranks): the reference example's lines,
    its estimate within ``RTOL`` of the reference's local engine on the same
    seed (the reference example's own mesh cannot run here), and its
    mesh-vs-local cross-check under ``1e-5``."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-W", "ignore::FutureWarning",
         os.path.join(REPO, "examples", "torch", "distributed_counting.py"),
         "--device", "cpu", "--ranks", "2", "--timeout", "240"],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0] == "mesh: 2 ranks (gloo, cpu)"
    assert [line.split(":")[0] for line in lines] == [
        "mesh", "graph", "distributed estimate", "mesh vs local engine"]
    want = ref_engine.CountingEngine(
        ref_graph.rmat_graph(2048, 20_000, seed=11), [ref_templates.get_template("u7")],
        backend="edges").estimate(iterations=8, seed=0)[0]
    got = float(_NUMBER.findall(lines[2])[0])
    assert got == pytest.approx(want.mean, rel=1e-3)  # printed to 4 digits
    assert float(_NUMBER.findall(lines[3])[-1]) < 1e-5


def test_serve_lm_example_serves_every_request():
    """``examples/torch/serve_lm.py``: the reference example's config and
    requests, every one served to its 12 tokens (the weights are the port's
    own draws, so the tokens differ from the reference's)."""
    module = _load(os.path.join(REPO, "examples", "torch", "serve_lm.py"), "torch_serve_lm_example")
    lines = _printed(module.main, ["--device", "cpu"])
    assert len([line for line in lines if line.startswith("  req ")]) == 10
    assert lines[-1].startswith("OK")
