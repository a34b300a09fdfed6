"""The port's memory model against the reference's, on the CPU.

* ``load_fusion_slack`` and ``CostModel(fusion_slack=...)``: the three
  cases of ``tests/test_plan.py``'s fusion-slack section, on the port's
  rows, which carry the device kind they were measured on; rows of another
  device kind, and the reference's untagged rows, never apply.
* ``CountingEngine.compiled_memory_analysis`` on the CPU: the prediction is
  ``chunk_size * bytes_per_coloring``, equal to the reference's with its
  fusion slack pinned to 1.0 (the port's CPU slack), and the measured side
  is ``None``, as the reference's is without ``memory_analysis()``.
* ``make_count_step``: colorings bit-equal to ``jax.random.randint`` on the
  same keys, estimates within ``rtol=1e-5`` of the reference's step.
"""

import json
import logging
import math
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.plan.cost as ref_cost
from repro.core import CountingEngine as RefEngine
from repro.core import counting as ref_counting
from repro.core import estimator as ref_estimator
from repro.core import graph as ref_graph
from repro.core import templates as ref_templates

import repro_torch.core.estimator as port_estimator
from repro_torch.core import graph as port_graph
from repro_torch.core.counting import build_counting_plan, spmm_edges
from repro_torch.core.engine import CountingEngine
from repro_torch.core.estimator import make_count_step
from repro_torch.core.templates import get_template
from repro_torch.plan import cost
from repro_torch.plan.cost import CostModel, load_fusion_slack, memory_model_row

RTOL = 1e-5
CPU = torch.device("cpu")
CARD_KIND = "NVIDIA H100 80GB HBM3"
#: the reference's loader, before the fixture pins it to 1.0
REF_LOAD_FUSION_SLACK = ref_cost.load_fusion_slack


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    monkeypatch.setattr(ref_cost, "load_fusion_slack", lambda path=None: 1.0)
    monkeypatch.setenv(cost.BENCH_ENV_VAR, str(tmp_path / "default_memory.json"))
    monkeypatch.delenv("REPRO_ENGINE_BACKEND", raising=False)


def _rows_file(path, rows):
    path.write_text(json.dumps({"rows": rows}))
    return str(path)


def _row(name, derived, device="cpu"):
    row = {"name": name, "derived": derived}
    if device is not None:
        row["device"] = device
    return row


# ---------------------------------------------------------------------------
# load_fusion_slack (tests/test_plan.py's three cases)
# ---------------------------------------------------------------------------


def test_fusion_slack_defaults_to_one_without_bench_rows(tmp_path):
    """Missing file, unparsable file, and row-free file all fall back to
    the safe 1.0 (the uncalibrated analytic model)."""
    assert load_fusion_slack(str(tmp_path / "missing.json"), "cpu") == 1.0
    assert load_fusion_slack(_rows_file(tmp_path / "empty.json", []), "cpu") == 1.0
    junk = tmp_path / "junk.json"
    junk.write_text("not json at all")
    assert load_fusion_slack(str(junk), "cpu") == 1.0
    assert cost.fusion_slack_factor(CPU) == 1.0  # the default file is missing


def test_fusion_slack_calibration_applied_and_logged(tmp_path, caplog):
    """memory_model rows calibrate the factor (geometric mean, raw-ratio
    fixed point via applied_fusion_slack) and the application is logged on
    the repro_torch.plan logger; the reference reads the same rows alike."""
    rows = [
        _row("engine/g/u5/memory_model", "predicted_over_actual=0.900"),
        # calibrated row: raw ratio = 1.000 * 0.8 = 0.8
        _row("engine/g/u6/memory_model", "predicted_over_actual=1.000;applied_fusion_slack=0.8"),
        _row("engine/g/u6/batched64", "speedup=3x"),
    ]
    path = _rows_file(tmp_path / "bench.json", rows)
    with caplog.at_level(logging.INFO, logger="repro_torch.plan"):
        got = load_fusion_slack(path, "cpu")
    assert got == pytest.approx(math.sqrt(0.9 * 0.8))
    assert any("fusion-slack calibration applied" in r.message for r in caplog.records)
    # the reference's loader reads the same rows alike
    assert got == pytest.approx(REF_LOAD_FUSION_SLACK(path))
    # out of band: clamped, as the reference clamps
    wild = _rows_file(tmp_path / "wild.json", [_row("a/memory_model", "predicted_over_actual=9.0")])
    assert load_fusion_slack(wild, "cpu") == cost.SLACK_CLAMP[1]


def test_picker_applies_slack_to_bytes():
    """slack < 1 (model under-predicts) inflates the effective bytes and
    can only shrink the picked chunk; slack = 1 is the identity and equals
    the reference's bytes; an out-of-band factor is rejected."""
    g = port_graph.rmat_graph(2048, 20_000, seed=1)
    eng = CountingEngine(g, [get_template("u6")], device="cpu")
    ref_eng = RefEngine(ref_graph.rmat_graph(2048, 20_000, seed=1), [ref_templates.get_template("u6")])
    t, r = eng.backend_impl.transient_elements(), eng.backend_impl.resident_elements()
    raw = (t + r) * eng.cost.itemsize
    identity = CostModel(eng.plan_ir, g, fusion_slack=1.0)
    halved = CostModel(eng.plan_ir, g, fusion_slack=0.5)
    assert identity.bytes_per_coloring(t, r) == raw == ref_eng.bytes_per_coloring()
    assert halved.bytes_per_coloring(t, r) == 2 * raw
    budget = 32 * 1024 * 1024
    assert halved.pick_chunk_size(halved.bytes_per_coloring(t, r), budget) <= (
        identity.pick_chunk_size(identity.bytes_per_coloring(t, r), budget)
    )
    with pytest.raises(ValueError, match="fusion_slack"):
        CostModel(eng.plan_ir, g, fusion_slack=4.0)


# ---------------------------------------------------------------------------
# device kinds
# ---------------------------------------------------------------------------


def test_rows_of_another_device_kind_are_ignored(tmp_path, monkeypatch):
    """A card's rows never size a CPU engine (and the reverse); rows
    without a device kind, as the reference's are, apply to none; the
    engine reads its own device's rows from the default file."""
    rows = [
        _row("engine/g/u12/memory_model", "predicted_over_actual=1.600", device=CARD_KIND),
        _row("engine/g/u18/memory_model", "predicted_over_actual=1.960", device=CARD_KIND),
        _row("engine/g/u5/memory_model", "predicted_over_actual=0.800", device=None),
    ]
    path = _rows_file(tmp_path / "card.json", rows)
    assert load_fusion_slack(path, "cpu") == 1.0
    assert load_fusion_slack(path, CPU) == 1.0
    assert load_fusion_slack(path, CARD_KIND) == pytest.approx(math.sqrt(1.6 * 1.96))
    # the reference's own committed file: XLA:CPU rows, untagged
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert load_fusion_slack(os.path.join(repo, "BENCH_counting.json"), "cpu") == 1.0

    monkeypatch.setenv(cost.BENCH_ENV_VAR, path)
    g = port_graph.rmat_graph(300, 1500, seed=2)
    eng = CountingEngine(g, [get_template("u5-1")], device="cpu")
    assert eng.cost.fusion_slack == 1.0
    assert eng.describe()["memory"]["fusion_slack"] == 1.0
    # CPU rows, written as the smoke script writes a card's, do apply
    analysis = {"predicted_bytes": 900.0, "actual_temp_bytes": 1000.0, "ratio": 0.9}
    row = memory_model_row("engine/g/u5-1/memory_model", analysis, CPU, 1.0)
    assert row["device"] == "cpu"
    assert row["derived"].startswith("predicted_bytes=900;actual_temp_bytes=1000;"
                                     "predicted_over_actual=0.900;")
    _rows_file(tmp_path / "card.json", rows + [row])  # rewritten: the memo notices
    assert load_fusion_slack(path, "cpu") == pytest.approx(0.9)
    eng = CountingEngine(g, [get_template("u5-1")], device="cpu")
    assert eng.cost.fusion_slack == pytest.approx(0.9)
    # a model bound to no device prices uncalibrated
    assert CostModel(eng.plan_ir, g).fusion_slack == 1.0


# ---------------------------------------------------------------------------
# compiled_memory_analysis
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tname,backend", [("u5-1", "edges"), ("u6", "sell"), ("triangle", "edges")])
def test_compiled_memory_analysis_on_the_cpu(tname, backend):
    """The prediction is ``chunk * bytes_per_coloring``, equal to the
    reference's at fusion slack 1.0; the CPU keeps no allocation
    statistics, so the measured side is None."""
    g = port_graph.rmat_graph(300, 1500, seed=2)
    eng = CountingEngine(g, [get_template(tname)], device="cpu", backend=backend, chunk_size=2)
    report = eng.compiled_memory_analysis(iterations=2)
    assert report["predicted_bytes"] == 2 * eng.bytes_per_coloring()
    assert report["actual_temp_bytes"] is None and report["ratio"] is None
    ref = RefEngine(ref_graph.rmat_graph(300, 1500, seed=2), [ref_templates.get_template(tname)],
                    backend=backend, chunk_size=2)
    assert report["predicted_bytes"] == ref.compiled_memory_analysis(iterations=2)["predicted_bytes"]
    # iterations=None: one chunk, the same prediction
    assert eng.compiled_memory_analysis()["predicted_bytes"] == report["predicted_bytes"]


# ---------------------------------------------------------------------------
# make_count_step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tname", ["u5-2", "u7"])
def test_make_count_step_matches_reference(tname, monkeypatch):
    g = port_graph.rmat_graph(200, 900, seed=4)
    rg = ref_graph.rmat_graph(200, 900, seed=4)
    t, rt = get_template(tname), ref_templates.get_template(tname)
    plan, ref_plan = build_counting_plan(t), ref_counting.build_counting_plan(rt)
    src, dst = (torch.as_tensor(a, dtype=torch.long) for a in (g.src, g.dst))
    step = make_count_step(plan, g.n, partial(spmm_edges, src, dst, g.n), device="cpu")
    ref_step = ref_estimator.make_count_step(
        ref_plan, rg.n, partial(ref_counting.spmm_edges, jnp.asarray(rg.src), jnp.asarray(rg.dst), rg.n))
    drawn = []
    real_randint = port_estimator.randint
    monkeypatch.setattr(port_estimator, "randint",
                        lambda *a: drawn.append(real_randint(*a)) or drawn[-1])
    keys = jax.random.split(jax.random.PRNGKey(11), 4)
    for key in keys:
        got = step(np.asarray(key))
        want = float(ref_step(key))
        assert got.dim() == 0 and got.device == CPU
        assert float(got) == pytest.approx(want, rel=RTOL)
        colors = np.asarray(jax.random.randint(key, (g.n,), 0, plan.k))
        np.testing.assert_array_equal(drawn[-1].numpy(), colors)
    assert len(drawn) == len(keys)


def test_blocked_engine_binds_no_streamed_tables():
    """The ``blocked`` kernels read their own stage layout, so the engine
    binds no passive-column batches (at u20's widths they would take
    hundreds of GB): a u18 engine binds its two wide stages' bucketed tables and
    nothing streamed; a streamed backend still binds its batches, equal to
    the reference's bucketing."""
    g = port_graph.rmat_graph(64, 300, seed=1)
    eng = CountingEngine(g, [get_template("u18")], device="cpu", backend="blocked")
    assert all(t.batches == () for t in eng.backend_impl.stage_tables.values())
    assert sum(t.wide for t in eng.backend_impl._fused_tables.values()) == 2
    edges = CountingEngine(g, [get_template("u6")], device="cpu", backend="edges")
    assert all(len(t.batches) > 0 for t in edges.backend_impl.stage_tables.values())
