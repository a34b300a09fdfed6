"""The port's autotuner against the reference's, on the CPU.

Mirrors the 16 tests of ``tests/test_tune.py`` — config round trips, the
cache's persistence and robustness, the search's determinism, the
resolution ladder (explicit > env > tuned > heuristic), mixed-backend
execution, ``REPRO_TUNE=full`` through the front-end, and the quarantine
interop — and holds the port against ``repro.tune`` on the same numpy-made
rmat graphs:

* ``candidate_lattice(platform="cpu")`` equals the reference's, in
  candidates, order and predicted/raw us to ``rel=1e-12``; on ``"cuda"``
  every non-``blocked`` uniform candidate equals the reference's ``"tpu"``
  lattice's, beside one ``blocked`` candidate per (budget, chunk);
* ``tune`` with the same canned ``measure_fn`` picks the same winner and
  writes the same cache entries and calibration in both packages;
* mixed engines equal uniform ones and the reference's mixed engines at
  ``rtol=1e-5`` (the two frameworks sum fp32 in different orders).

The reference's fusion slack is pinned to 1.0, the port's, so both price
the same chunks; ``REPRO_TUNE_CACHE`` points every test at a temporary
file, which both packages read.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import repro.plan.cost as ref_cost
import repro.tune as ref_tune
from repro.core import CountingEngine as RefEngine
from repro.core import graph as ref_graph
from repro.core import templates as ref_templates
from repro.plan.ir import build_template_plan as ref_build_plan

from repro_torch.core import graph as port_graph
from repro_torch.core.engine import CountingEngine, engine_cache_key
from repro_torch.core.templates import get_template
from repro_torch.exec.select import resolve_backend_config, tune_mode
import repro_torch.plan.cost as port_cost
from repro_torch.plan.cost import CostModel
from repro_torch.plan.ir import build_template_plan
from repro_torch.tune import (
    TUNING_SCHEMA_VERSION,
    TuningCache,
    TuningConfig,
    consult,
    measure_engine_us,
    tune,
)
from repro_torch.tune.cache import entry_key, load_calibration

RTOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    monkeypatch.setattr(ref_cost, "load_fusion_slack", lambda path=None: 1.0)
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "default_tuned.json"))
    monkeypatch.delenv("REPRO_ENGINE_BACKEND", raising=False)
    monkeypatch.delenv("REPRO_TUNE", raising=False)


def _graph(side="port", n=120, e=600, seed=3):
    mod = port_graph if side == "port" else ref_graph
    return mod.rmat_graph(n, e, seed=seed)


def _leaders(graph, tname):
    plan = build_template_plan([get_template(tname)])
    cost = CostModel(plan, graph, torch.float32)
    return plan, cost.tree_group_leaders()


def _mixed_config(leaders, backends=("edges", "sell"), cls=TuningConfig):
    return cls(
        default_backend=backends[0],
        group_backends=tuple(
            (addr, backends[k % len(backends)]) for k, addr in enumerate(leaders)
        ),
    )


def _fake_measure(engine, probes):
    # a pure function of the probed configuration, the reference test's:
    # favors sell strongly so the winner differs from the predicted order
    base = {"edges": 50.0, "ell": 40.0, "sell": 10.0, "dense": 70.0}.get(engine.backend, 30.0)
    return base + 0.01 * engine.chunk_size + 0.1 * (engine.column_batch or 0)


# ---------------------------------------------------------------------------
# TuningConfig: JSON round trip, normalization, key fragments
# ---------------------------------------------------------------------------


CONFIG_ARGS = [
    dict(default_backend="edges"),
    dict(default_backend="sell", column_batch=8, chunk_size=24),
    dict(default_backend="edges", group_backends=(((0, 5), "sell"), ((0, 4), "edges")),
         column_batch=4),
]


@pytest.mark.parametrize("args", CONFIG_ARGS)
def test_config_json_roundtrip_bit_exact(args):
    cfg = TuningConfig(**args)
    back = TuningConfig.from_json(json.loads(json.dumps(cfg.to_json())))
    assert back == cfg
    assert back.key_fragment() == cfg.key_fragment()
    assert back.describe() == cfg.describe()
    # the same JSON, fragment and summary as the reference's config
    ref = ref_tune.TuningConfig(**args)
    assert cfg.to_json() == ref.to_json()
    assert cfg.key_fragment() == ref.key_fragment()
    assert cfg.describe() == ref.describe()
    assert TuningConfig.from_json(ref.to_json()) == cfg


def test_config_bindings_normalized_sorted():
    a = TuningConfig("edges", group_backends=(((0, 5), "sell"), ((0, 4), "edges")))
    b = TuningConfig("edges", group_backends=(((0, 4), "edges"), ((0, 5), "sell")))
    assert a == b and a.key_fragment() == b.key_fragment()
    assert a.mixed and a.backend_name == "mixed"
    assert not TuningConfig("edges", group_backends=(((0, 4), "edges"),)).mixed


def test_config_version_mismatch_raises():
    assert TUNING_SCHEMA_VERSION == ref_tune.TUNING_SCHEMA_VERSION
    data = TuningConfig("edges").to_json()
    data["version"] = TUNING_SCHEMA_VERSION + 1
    with pytest.raises(ValueError):
        TuningConfig.from_json(data)
    with pytest.raises(ValueError):
        TuningConfig.from_json({"default_backend": "edges"})  # no version
    with pytest.raises(ValueError):
        TuningConfig.from_json("edges")  # not an object


# ---------------------------------------------------------------------------
# TuningCache: persistence round trip + corrupt-file robustness
# ---------------------------------------------------------------------------


def test_cache_roundtrip_bit_exact(tmp_path):
    path = str(tmp_path / "tuned.json")
    cfg = TuningConfig("edges", group_backends=(((0, 4), "sell"),), column_batch=6, chunk_size=20)
    cache = TuningCache(path)
    cache.put("sig-a", [[0, 1, 2]], cfg, device="cpu", meta={"measured_us": 1.5})
    cache.merge_calibration({"edges": 1.25, "sell": 0.8})
    assert cache.save() == path

    loaded = TuningCache.load(path)
    assert loaded.get("sig-a", [[0, 1, 2]], "cpu") == cfg
    assert loaded.get("sig-a", [[0, 1, 2]], "cpu").key_fragment() == cfg.key_fragment()
    assert loaded.meta("sig-a", [[0, 1, 2]], "cpu")["measured_us"] == 1.5
    assert loaded.calibration == {"edges": 1.25, "sell": 0.8}
    assert consult("sig-a", [[0, 1, 2]], device="cpu", path=path) == cfg
    assert consult("sig-a", [[0, 1, 2]], device=torch.device("cpu"), path=path) == cfg
    assert load_calibration(path) == {"edges": 1.25, "sell": 0.8}
    assert loaded.get("sig-b", [[0, 1, 2]], "cpu") is None
    assert loaded.get("sig-a", [[9, 9]], "cpu") is None
    assert loaded.get("sig-a", [[0, 1, 2]], "NVIDIA H100 80GB HBM3") is None
    # the file is the reference's format: its cache reads the same entry
    ref = ref_tune.TuningCache.load(path)
    assert ref.get("sig-a", [[0, 1, 2]], "cpu").to_json() == cfg.to_json()
    assert ref.calibration == loaded.calibration
    assert entry_key("sig-a", [[0, 1, 2]], "cpu") == ref_tune.entry_key("sig-a", [[0, 1, 2]], "cpu")


@pytest.mark.parametrize(
    "content",
    [
        "this is not json{{{",
        json.dumps([1, 2, 3]),  # not an object
        json.dumps({"version": TUNING_SCHEMA_VERSION + 7, "entries": {}}),
        json.dumps({}),  # missing version
    ],
)
def test_cache_corrupt_or_stale_files_ignored(tmp_path, content, caplog):
    path = str(tmp_path / "bad.json")
    with open(path, "w") as fh:
        fh.write(content)
    with caplog.at_level("WARNING", logger="repro_torch.tune"):
        cache = TuningCache.load(path)
    assert cache.entries == {} and cache.calibration == {}
    assert any("ignoring" in r.getMessage() for r in caplog.records)
    assert consult("sig", [[0]], device="cpu", path=path) is None
    assert load_calibration(path) == {}


def test_cache_malformed_entry_ignored(tmp_path):
    path = str(tmp_path / "tuned.json")
    key = entry_key("sig-a", [[0, 1]], "cpu")
    with open(path, "w") as fh:
        json.dump(
            {
                "version": TUNING_SCHEMA_VERSION,
                "entries": {key: {"config": {"version": 99, "default_backend": 3}}},
                "calibration": {"edges": "NaNsense", "sell": -2, "dense": 1.5},
            },
            fh,
        )
    cache = TuningCache.load(path)
    assert cache.get("sig-a", [[0, 1]], "cpu") is None  # warned, not raised
    assert cache.calibration == {"dense": 1.5}  # bad ratios dropped
    assert ref_tune.TuningCache.load(path).calibration == cache.calibration


# ---------------------------------------------------------------------------
# The candidate lattice against the reference's
# ---------------------------------------------------------------------------


LATTICE_CASES = {
    "rmat120-u5-1": ((120, 600, 3), ["u5-1"], 1 << 22),
    "rmat150-u5-1+u5-2": ((150, 700, 3), ["u5-1", "u5-2"], 1 << 22),
    "rmat160-u7": ((160, 700, 2), ["u7"], 1 << 23),
    "rmat140-u3+triangle": ((140, 520, 3), ["u3", "triangle"], 1 << 22),
}


def _lattices(case, platform_ref, platform_port, calibration):
    (n, e, s), names, budget = LATTICE_CASES[case]
    ref = ref_cost.CostModel(
        ref_build_plan([ref_templates.get_template(t) for t in names]),
        _graph("ref", n, e, s), np.float32, fusion_slack=1.0,
    ).candidate_lattice(platform=platform_ref, calibration=calibration,
                        memory_budget_bytes=budget)
    port = CostModel(
        build_template_plan([get_template(t) for t in names]), _graph("port", n, e, s),
        torch.float32,
    ).candidate_lattice(platform=platform_port, calibration=calibration,
                        memory_budget_bytes=budget)
    return ref, port


@pytest.mark.parametrize("case", list(LATTICE_CASES))
def test_candidate_lattice_cpu_equals_reference(case):
    calibration = {"edges": 1.3, "sell": 0.7}
    ref, port = _lattices(case, "cpu", "cpu", calibration)
    assert [c.config.to_json() for c in port] == [c.config.to_json() for c in ref]
    for p, r in zip(port, ref):
        assert p.predicted_us == pytest.approx(r.predicted_us, rel=1e-12)
        assert p.raw_us == pytest.approx(r.raw_us, rel=1e-12)
    assert all(c.config.default_backend != "blocked" for c in port)


@pytest.mark.parametrize("case", list(LATTICE_CASES))
def test_candidate_lattice_cuda_adds_one_blocked_candidate_per_budget_and_chunk(case, monkeypatch):
    # the card prices an element at WORK_ELEMENT_US_CUDA; the reference's
    # formulas at that scale give the same uniform candidates
    monkeypatch.setattr(ref_cost, "WORK_ELEMENT_US", port_cost.WORK_ELEMENT_US_CUDA)
    ref, port = _lattices(case, "tpu", "cuda", {})

    def uniform(lattice):
        return {json.dumps(c.config.to_json(), sort_keys=True): (c.predicted_us, c.raw_us)
                for c in lattice if not c.config.mixed and c.config.default_backend != "blocked"}

    want, got = uniform(ref), uniform(port)
    assert set(got) == set(want)
    for k in got:
        assert got[k] == pytest.approx(want[k], rel=1e-12)
    blocked = [c.config for c in port if c.config.backend_name == "blocked"]
    assert blocked and all(c.column_batch is None for c in blocked)
    pairs = [(c.memory_budget_bytes, c.chunk_size) for c in blocked]
    assert len(pairs) == len(set(pairs))
    assert len({c.chunk_size for c in blocked}) == len(blocked)  # budgets deduped
    # priced as the port runs it: per member stage, no column batch
    cm = CostModel(build_template_plan([get_template(t) for t in LATTICE_CASES[case][1]]),
                   _graph("port", *LATTICE_CASES[case][0]), torch.float32)
    for leader in cm.tree_group_leaders():
        assert cm.group_cost_us(leader, "blocked", 4) == cm.group_cost_us(leader, "blocked", 64)


#: ``u5-1`` at chunk 64 and a 48 GiB budget: the tuner's measured us per
#: coloring on an NVIDIA H100 80GB HBM3 at 700 W, lowest and highest over
#: PR 16's chip runs (PERF.md section 6), per graph and backend.
CARD_MEASURED_US = {
    "rmat2k": ((2048, 20_000, 1), {"blocked": (67.67, 114.33), "edges": (91.66, 127.61)}),
    "rmat8k": ((8192, 80_000, 2), {"blocked": (86.77, 144.65), "edges": (110.80, 175.72)}),
}


def _card_chunk64(graph_spec):
    cm = CostModel(build_template_plan([get_template("u5-1")]), _graph("port", *graph_spec),
                   torch.float32)
    lattice = cm.candidate_lattice(platform="cuda", calibration={}, memory_budget_bytes=48 << 30)
    return cm, [c.config for c in lattice
                if not c.config.mixed and c.config.chunk_size == 64]


def test_work_model_scale_on_the_cpu_is_the_reference():
    """The CPU prices an element as the reference does, so every group
    cost and config price on ``"cpu"`` equals the reference's."""
    assert port_cost.work_element_us("cpu") == ref_cost.WORK_ELEMENT_US
    assert port_cost.work_element_us(None) == ref_cost.WORK_ELEMENT_US
    (n, e, s), names, budget = LATTICE_CASES["rmat150-u5-1+u5-2"]
    ref_cm = ref_cost.CostModel(ref_build_plan([ref_templates.get_template(t) for t in names]),
                                _graph("ref", n, e, s), np.float32, fusion_slack=1.0)
    cm = CostModel(build_template_plan([get_template(t) for t in names]),
                   _graph("port", n, e, s), torch.float32)
    for leader in cm.tree_group_leaders():
        for backend in ("edges", "sell", "dense"):
            assert cm.group_cost_us(leader, backend, 16, "cpu") == pytest.approx(
                ref_cm.group_cost_us(leader, backend, 16), rel=1e-12)
    cfg = TuningConfig("edges", column_batch=16, chunk_size=8)
    got = cm.predict_config_us(cfg, chunk_size=8, platform="cpu")
    want = ref_cm.predict_config_us(ref_tune.TuningConfig("edges", column_batch=16, chunk_size=8),
                                    chunk_size=8)
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("graph_name", list(CARD_MEASURED_US))
def test_work_model_scale_on_the_card_puts_measured_ratios_inside_the_clamp(graph_name):
    """The H100's measured us per coloring over the card's raw prediction
    lie inside ``CALIBRATION_CLAMP``, so the loader applies them unclamped;
    at the reference's XLA:CPU scale the rmat8k ratios fall under its floor,
    which is what froze the card's lattice in its uncalibrated order."""
    spec, measured = CARD_MEASURED_US[graph_name]
    cm, configs = _card_chunk64(spec)
    lo, hi = port_cost.CALIBRATION_CLAMP
    for cfg in configs:
        if cfg.backend_name not in measured:
            continue
        _, raw_card = cm.predict_config_us(cfg, chunk_size=64, platform="cuda")
        _, raw_cpu = cm.predict_config_us(cfg, chunk_size=64, platform="cpu")
        assert raw_card < raw_cpu
        for us in measured[cfg.backend_name]:
            assert lo < us / raw_card < hi, (cfg, us, raw_card)
            if graph_name == "rmat8k":
                assert us / raw_cpu < lo


# ---------------------------------------------------------------------------
# The search: deterministic given the measurements, equal to the reference's
# ---------------------------------------------------------------------------


def test_tuner_determinism_same_measurements_same_config(tmp_path):
    g = _graph()
    templates = [get_template("u5-1")]
    results = [
        tune(g, templates, top_n=4, probes=1, save=False, measure_fn=_fake_measure,
             device="cpu")
        for _ in range(2)
    ]
    assert results[0].config == results[1].config
    assert results[0].measured == results[1].measured
    assert results[0].calibration == results[1].calibration
    assert results[0].cache_path is None
    best = min(results[0].measured, key=lambda m: m.measured_us)
    assert results[0].config == best.config
    # the reference's tuner on the same graph and measurements agrees
    port_path, ref_path = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    got = tune(g, templates, top_n=6, probes=1, cache_path=port_path,
               measure_fn=_fake_measure, device="cpu")
    want = ref_tune.tune(_graph("ref"), [ref_templates.get_template("u5-1")], top_n=6,
                         probes=1, cache_path=ref_path, measure_fn=_fake_measure)
    assert got.config.to_json() == want.config.to_json()
    assert [m.config.to_json() for m in got.measured] == [m.config.to_json() for m in want.measured]
    assert got.calibration == pytest.approx(want.calibration, rel=1e-12)
    assert (got.lattice_size, got.heuristic_backend, got.device) == (
        want.lattice_size, want.heuristic_backend, want.device)
    port_file, ref_file = (json.load(open(p)) for p in (port_path, ref_path))
    assert port_file["entries"].keys() == ref_file["entries"].keys()
    for key, entry in port_file["entries"].items():
        assert entry["config"] == ref_file["entries"][key]["config"]
        for field in ("measured_us", "predicted_us"):
            assert entry["meta"].pop(field) == pytest.approx(
                ref_file["entries"][key]["meta"].pop(field), rel=1e-12)
        assert entry["meta"] == ref_file["entries"][key]["meta"]
    assert port_file["calibration"] == pytest.approx(ref_file["calibration"], rel=1e-12)


def test_tune_persists_and_engine_picks_it_up(tmp_path, monkeypatch):
    path = str(tmp_path / "tuned.json")
    g = _graph()
    templates = [get_template("u5-1")]
    result = tune(g, templates, top_n=2, probes=1, cache_path=path,
                  measure_fn=_fake_measure, device="cpu")
    assert result.cache_path == path
    plan = build_template_plan(templates)
    assert consult(g.signature(), plan.canons, device="cpu", path=path) == result.config

    monkeypatch.setenv("REPRO_TUNE_CACHE", path)
    eng = CountingEngine(g, templates, device="cpu")
    d = eng.describe()["backend"]
    assert d["source"] == "tuned" and d["tuning"] == result.config.describe()
    assert d["name"] == result.config.backend_name
    if result.config.chunk_size is not None:
        assert eng.chunk_size == result.config.chunk_size
    if result.config.column_batch is not None:
        assert eng.column_batch == result.config.column_batch
    assert engine_cache_key(g, templates, device="cpu") == eng.cache_key()
    assert eng.cache_key()[-1] == result.config.key_fragment()
    # the reference engine reads the port's file to the same resolution
    ref = RefEngine(_graph("ref"), [ref_templates.get_template("u5-1")])
    assert ref.describe()["backend"]["source"] == "tuned"
    assert (ref.backend, ref.chunk_size, ref.column_batch) == (
        eng.backend, eng.chunk_size, eng.column_batch)
    assert ref.cache_key()[-1] == eng.cache_key()[-1]


def test_measure_engine_us_times_count_keys_chunk():
    eng = CountingEngine(_graph(), [get_template("u3")], device="cpu", chunk_size=4)
    calls = []
    real = eng.count_keys_chunk

    def spy(keys):
        calls.append(keys.clone())
        return real(keys)

    eng.count_keys_chunk = spy
    us = measure_engine_us(eng, probes=3)
    assert us > 0 and len(calls) == 4  # one warm-up and three timed launches
    # the keys are split(prng_key(0), chunk), the reference's draw
    want = torch.as_tensor(np.asarray(jax.random.split(jax.random.PRNGKey(0), 4)).astype(np.int64))
    assert all(torch.equal(k, want) for k in calls)


# ---------------------------------------------------------------------------
# Resolution ladder: explicit > env > tuned > heuristic
# ---------------------------------------------------------------------------


def _seed_cache(path, g, templates, backend="sell"):
    plan = build_template_plan(templates)
    cache = TuningCache(path)
    cache.put(g.signature(), plan.canons, TuningConfig(default_backend=backend), device="cpu")
    cache.save()
    return plan


def test_env_override_beats_tuned_and_heuristic(tmp_path, monkeypatch):
    path = str(tmp_path / "tuned.json")
    g = _graph()
    templates = [get_template("u5-1")]
    _seed_cache(path, g, templates, backend="sell")
    monkeypatch.setenv("REPRO_TUNE_CACHE", path)

    monkeypatch.setenv("REPRO_ENGINE_BACKEND", "dense")
    eng = CountingEngine(g, templates, device="cpu")
    d = eng.describe()["backend"]
    assert (d["name"], d["source"]) == ("dense", "env")
    assert eng.cache_key()[-1] is None
    ref = RefEngine(_graph("ref"), [ref_templates.get_template("u5-1")])
    assert (ref.backend, ref.backend_source) == ("dense", "env")

    eng2 = CountingEngine(g, templates, device="cpu", backend="edges")
    d2 = eng2.describe()["backend"]
    assert (d2["name"], d2["source"]) == ("edges", "explicit")


def test_tune_mode_off_falls_back_to_heuristic(tmp_path, monkeypatch):
    path = str(tmp_path / "tuned.json")
    g = _graph()
    templates = [get_template("u5-1")]
    _seed_cache(path, g, templates, backend="sell")
    monkeypatch.setenv("REPRO_TUNE_CACHE", path)

    monkeypatch.setenv("REPRO_TUNE", "off")
    d = CountingEngine(g, templates, device="cpu").describe()["backend"]
    assert d["source"] == "heuristic"
    ref = RefEngine(_graph("ref"), [ref_templates.get_template("u5-1")])
    assert ref.backend_source == "heuristic" and ref.backend == d["name"]

    monkeypatch.setenv("REPRO_TUNE", "cached")
    d = CountingEngine(g, templates, device="cpu").describe()["backend"]
    assert (d["name"], d["source"]) == ("sell", "tuned")
    ref = RefEngine(_graph("ref"), [ref_templates.get_template("u5-1")])
    assert (ref.backend, ref.backend_source) == ("sell", "tuned")


def test_tune_mode_bad_value_warns_and_defaults(monkeypatch, caplog):
    monkeypatch.setenv("REPRO_TUNE", "frobnicate")
    with caplog.at_level("WARNING", logger="repro_torch.engine"):
        assert tune_mode() == "cached"  # never raises
    assert any("frobnicate" in r.getMessage() for r in caplog.records)


def test_resolve_backend_config_sources(tmp_path, monkeypatch):
    g = _graph()
    name, source, reason, cfg = resolve_backend_config(g, backend="edges", device="cpu")
    assert (name, source, cfg) == ("edges", "explicit", None)
    name, source, reason, cfg = resolve_backend_config(g, backend="auto", device="cpu")
    assert source == "heuristic" and reason
    monkeypatch.setenv("REPRO_ENGINE_BACKEND", "sell")
    name, source, _, _ = resolve_backend_config(g, backend="auto", device="cpu")
    assert (name, source) == ("sell", "env")
    monkeypatch.delenv("REPRO_ENGINE_BACKEND")
    # a config passed in is the tuned rung; a cache entry for another kind
    # of device is never consulted
    cfg = TuningConfig("ell", chunk_size=8)
    assert resolve_backend_config(g, tuning=cfg, device="cpu")[:2] == ("ell", "tuned")
    path = str(tmp_path / "tuned.json")
    plan = build_template_plan([get_template("u5-1")])
    cache = TuningCache(path)
    cache.put(g.signature(), plan.canons, cfg, device="NVIDIA H100 80GB HBM3")
    cache.save()
    monkeypatch.setenv("REPRO_TUNE_CACHE", path)
    assert resolve_backend_config(g, canons=plan.canons, device="cpu")[1] == "heuristic"


# ---------------------------------------------------------------------------
# Mixed-backend execution == the uniform engines == the reference's mixed
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tname", ["u3", "u5-1", "u5-2", "u6", "u7"])
def test_mixed_backend_bit_exact_vs_uniform(tname):
    graphs = [
        ("rmat", dict(n=120, num_edges=600, seed=3)),
        ("erdos_renyi", dict(n=100, num_edges=500, seed=1)),
        ("grid", dict(rows=8, cols=12)),
    ]
    for kind, spec in graphs:
        g = getattr(port_graph, f"{kind}_graph")(**spec)
        plan, leaders = _leaders(g, tname)
        cfg = _mixed_config(leaders)
        oracle = CountingEngine(g, [get_template(tname)], device="cpu", backend="edges")
        mixed = CountingEngine(g, [get_template(tname)], device="cpu", backend="mixed",
                               tuning=cfg)
        assert isinstance(mixed.backend_impl._impls["sell"].stage_tables, dict)
        assert mixed.backend_impl._impls["sell"].stage_tables is mixed.backend_impl.stage_tables
        rng = np.random.default_rng(7)
        colors = [rng.integers(0, get_template(tname).k, size=g.n) for _ in range(2)]
        for c in colors:
            a = oracle.raw_counts(c).numpy()
            b = mixed.raw_counts(c).numpy()
            np.testing.assert_allclose(b, a, rtol=RTOL)
        if kind == "rmat":
            rg = getattr(ref_graph, f"{kind}_graph")(**spec)
            ref_cfg = _mixed_config(leaders, cls=ref_tune.TuningConfig)
            ref = RefEngine(rg, [ref_templates.get_template(tname)], backend="mixed",
                            tuning=ref_cfg)
            for c in colors:
                np.testing.assert_allclose(mixed.raw_counts(c).numpy(),
                                           np.asarray(ref.raw_counts(c)), rtol=RTOL)
            keys = np.asarray(jax.random.split(jax.random.PRNGKey(3), 3))
            np.testing.assert_allclose(mixed.count_keys(keys), np.asarray(ref.count_keys(keys)),
                                       rtol=RTOL)
            np.testing.assert_allclose(mixed.count_keys(keys), oracle.count_keys(keys), rtol=RTOL)


def test_mixed_engine_binding_blocked_groups_matches_uniform_engines():
    # on the CPU both kernels run their plain versions; each sub-impl of the
    # mixed engine is a full backend aliasing the owner's tables
    g = _graph(n=160, e=700, seed=2)
    templates = [get_template("u5-1"), get_template("u5-2")]
    leaders = CostModel(build_template_plan(templates), g, torch.float32).tree_group_leaders()
    cfg = _mixed_config(leaders, backends=("blocked", "edges"))
    mixed = CountingEngine(g, templates, device="cpu", backend="mixed", tuning=cfg,
                           chunk_size=3)
    assert mixed.backend_impl._impls["blocked"].operand is not None
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(4), 5))
    got = mixed.count_keys(keys)
    for uniform in ("blocked", "edges"):
        want = CountingEngine(g, templates, device="cpu", backend=uniform,
                              chunk_size=3).count_keys(keys)
        np.testing.assert_allclose(got, want, rtol=RTOL)
    assert mixed.describe()["backend"]["tuning"]["groups"]


def test_mixed_engine_requires_tuning_config():
    with pytest.raises(ValueError):
        CountingEngine(_graph(), [get_template("u5-1")], device="cpu", backend="mixed")


# ---------------------------------------------------------------------------
# REPRO_TUNE=full: the service self-queues, the front-end drains
# ---------------------------------------------------------------------------


def _full_mode_run(side, path, monkeypatch):
    if side == "port":
        from repro_torch.serve import CountingService
        from repro_torch.serve.frontend import make_frontend

        monkeypatch.setattr("repro_torch.tune.search.measure_engine_us", _fake_measure)
        svc = CountingService(chunk_size=4, device="cpu")
        g = _graph()
    else:
        from repro.serve import CountingService
        from repro.serve.frontend import make_frontend

        monkeypatch.setattr("repro.tune.search.measure_engine_us", _fake_measure)
        svc = CountingService(chunk_size=4)
        g = _graph("ref")
    monkeypatch.setenv("REPRO_TUNE_CACHE", path)
    svc.register_graph("g", g)
    fe = make_frontend(svc, manual=True)
    fut = fe.submit("t0", "g", "u5-1", iterations=4, seed=1)
    fe.drain()
    assert fut.done() and not fut.failed()
    tuned_round = None
    for _ in range(4):
        info = fe.step()
        if info["tuned"] is not None:
            tuned_round = info["tuned"]
            break
    q = svc.submit("g", "u5-1", iterations=2, seed=2)
    svc.run()
    assert q.done
    return dict(
        tuned=tuned_round, tunes_run=fe.tunes_run, completed=svc.tunes_completed,
        stats=svc.stats()["tuning"], source=svc.engine(q.engine_key).describe()["backend"]["source"],
        means=[e.mean for e in fut.result(0)] + [e.mean for e in q.result()],
        entries=json.load(open(path))["entries"],
    )


def test_full_mode_service_queues_and_frontend_drains_tune(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNE", "full")
    port = _full_mode_run("port", str(tmp_path / "port.json"), monkeypatch)
    ref = _full_mode_run("ref", str(tmp_path / "ref.json"), monkeypatch)
    assert port["tuned"] == ("g", ("u5-1",))
    assert port["tunes_run"] == port["completed"] == 1
    assert port["stats"] == {"mode": "full", "tunes_completed": 1, "pending": 0,
                             "tuned_cached_engines": 1}
    assert port["source"] == "tuned"
    for key in ("tuned", "tunes_run", "completed", "stats", "source"):
        assert port[key] == ref[key], key
    np.testing.assert_allclose(port["means"], ref["means"], rtol=RTOL)
    assert port["entries"].keys() == ref["entries"].keys()
    for key in port["entries"]:
        assert port["entries"][key]["config"] == ref["entries"][key]["config"]


# ---------------------------------------------------------------------------
# Quarantine interop: a quarantined key loses its tuned entry
# ---------------------------------------------------------------------------


def test_quarantine_drops_tuned_cache_entry(tmp_path, monkeypatch):
    from repro_torch.serve import CountingService, ManualClock, RetryPolicy
    from repro_torch.serve.resilience import QUARANTINE_STRIKES
    from repro_torch.testing.faults import FaultPlan, FaultSpec

    path = str(tmp_path / "tuned.json")
    g = _graph()
    templates = [get_template("u5-1")]
    plan = _seed_cache(path, g, templates, backend="edges")
    monkeypatch.setenv("REPRO_TUNE_CACHE", path)
    assert consult(g.signature(), plan.canons, device="cpu", path=path) is not None

    svc = CountingService(device="cpu")
    svc.register_graph("g", g)
    key = svc.engine_key_for("g", svc._resolve_templates("u5-1"))
    assert key[-1] is not None
    svc._drop_tuned_entry(key)
    assert consult(g.signature(), plan.canons, device="cpu", path=path) is None

    # the same through the failure path: repeated deterministic launch
    # failures quarantine the key, which drops the entry again
    _seed_cache(path, g, templates, backend="edges")
    svc = CountingService(device="cpu", chunk_size=4, clock=ManualClock(),
                          retry_policy=RetryPolicy(max_retries=3, backoff_base=0.0))
    svc.register_graph("g", g)
    with FaultPlan([FaultSpec(site="launch", kind="deterministic",
                              max_fires=QUARANTINE_STRIKES)], seed=1):
        for s in range(QUARANTINE_STRIKES):
            q = svc.submit("g", "u5-1", iterations=4, seed=s)
            svc.run()
            assert q.failed and q.error.kind == "deterministic"
    assert consult(g.signature(), plan.canons, device="cpu", path=path) is None


CARD_KIND = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize(
    "config, kept",
    [
        (dict(default_backend="blocked"), True),
        (dict(default_backend="edges", group_backends=(((1, 0), "blocked"),)), True),
        (dict(default_backend="edges"), False),
    ],
    ids=["blocked", "mixed_binds_blocked", "edges"],
)
def test_quarantine_keeps_blocked_tuned_entry_on_the_card(tmp_path, monkeypatch, config, kept):
    """On a card, a tuned entry that binds ``blocked`` survives quarantine
    (dropping it would rebuild the key on the heuristic's plain path); any
    other entry is dropped as on the CPU."""
    from repro_torch.serve import CountingService

    path = str(tmp_path / "tuned.json")
    g = _graph()
    plan = build_template_plan([get_template("u5-1")])
    cfg = TuningConfig(**config)
    cache = TuningCache(path)
    cache.put(g.signature(), plan.canons, cfg, device=CARD_KIND)
    cache.save()
    monkeypatch.setenv("REPRO_TUNE_CACHE", path)
    monkeypatch.setattr("repro_torch.tune.cache.device_kind", lambda device=None: CARD_KIND)

    svc = CountingService(device="cpu")
    svc.register_graph("g", g)
    key = svc.engine_key_for("g", svc._resolve_templates("u5-1"))
    key = key[:-1] + (cfg.key_fragment(),)
    svc.device = torch.device("cuda")  # the service's view of its device only
    svc._drop_tuned_entry(key)
    survived = consult(g.signature(), plan.canons, device=CARD_KIND, path=path)
    assert (survived == cfg) if kept else (survived is None)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def test_cli_tunes_on_the_cpu_into_a_temporary_cache(tmp_path):
    path = tmp_path / "cli.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("REPRO_TUNE_CACHE", None)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.tune", "u3", "--graph", "rmat:120:600:3",
         "--device", "cpu", "--cache", str(path), "--top-n", "2", "--probes", "1"],
        env=env, capture_output=True, text=True, timeout=240, cwd=str(tmp_path),
    )
    assert out.returncode == 0, out.stderr
    assert "device=cpu" in out.stdout and "<- winner" in out.stdout
    data = json.loads(path.read_text())
    assert data["version"] == TUNING_SCHEMA_VERSION
    (key,) = data["entries"]
    assert key.endswith("|cpu")
    assert data["entries"][key]["meta"]["dtype_policy"] == "float32"
