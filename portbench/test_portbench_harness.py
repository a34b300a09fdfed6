"""Whole runs of each cell at a test's size on the CPU (the harness's look for
a card skipped): sound runs come out correct, and a run whose timed path is
broken underneath, or the control in the next lower precision, does not."""

import json
import math

import numpy as np
import pytest
import torch

from portbench import run as harness
from portbench.drivers.estimates import estimate_keys
from portbench.drivers.service import arrival_times
from portbench.common import percentile
from portbench.registry import Benchmark
from repro_torch.core.engine import CountingEngine

CPU = torch.device("cpu")
SEED = 2**31 + 977
CELLS = ("rmat20-u12-batch", "rmat8k-motifs-batch", "rmat8k-motifs-service")


def one_run(root, cell, trace=False, precision=None):
    return harness.run(root, cell, SEED, 0.5, trace, CPU, precision=precision)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny_root, cell):
    result = one_run(tiny_root, cell)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) >= {"setup_s"} and len(result["metrics"]) >= 2
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert json.loads(json.dumps(result)) == result


@pytest.mark.parametrize("cell", ("rmat8k-motifs-batch", "rmat8k-motifs-service"))
def test_traced_run_reports_layers(tiny_root, cell):
    result = one_run(tiny_root, cell, trace=True)
    assert result["correct"]
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "setup_s" not in result["metrics"]


def test_same_seed_same_inputs():
    spec = {"generator": "rmat", "n": 256, "edges": 1500, "a": 0.57, "b": 0.19, "c": 0.19}
    bench = Benchmark(harness.ROOT)

    def graph(seed):
        return harness.make_graph(bench, spec, seed, CPU)[0]

    assert graph(SEED).signature() == graph(SEED).signature()
    assert graph(SEED).signature() != graph(SEED + 1).signature()
    assert torch.equal(estimate_keys(SEED, 3, 100, CPU), estimate_keys(SEED, 3, 100, CPU))
    assert np.array_equal(arrival_times(2.0, 51, 26), arrival_times(2.0, 51, 26))


def broken_count_keys(monkeypatch, fault):
    real = CountingEngine.count_keys

    def count_keys(self, keys):
        out = real(self, keys)
        if fault == "altered":  # every answer off by a part in a thousand where produced
            return out * 1.001
        if fault == "half_left_out":  # the second half of the batch repeats the first
            half = (out.shape[0] + 1) // 2
            out[half:] = out[:out.shape[0] - half]
            return out
        raise ValueError(fault)

    monkeypatch.setattr(CountingEngine, "count_keys", count_keys)


def broken_chunks(monkeypatch, fault):
    real = CountingEngine.count_keys_chunk

    def count_keys_chunk(self, keys):
        out = real(self, keys)
        if fault == "altered":
            return out * 1.001
        if fault == "rows_swapped":  # a launch's rows handed to the wrong colorings
            return np.roll(out, 1, axis=0)
        raise ValueError(fault)

    monkeypatch.setattr(CountingEngine, "count_keys_chunk", count_keys_chunk)


@pytest.mark.parametrize("cell", ("rmat20-u12-batch", "rmat8k-motifs-batch"))
@pytest.mark.parametrize("fault", ("altered", "half_left_out"))
def test_broken_batch_path_is_not_correct(tiny_root, monkeypatch, cell, fault):
    broken_count_keys(monkeypatch, fault)
    result = one_run(tiny_root, cell)
    assert not result["correct"]
    assert result["checks"]["max_rel_gap"]["value"] > result["checks"]["max_rel_gap"]["limit"]


@pytest.mark.parametrize("fault", ("altered", "rows_swapped"))
def test_broken_service_path_is_not_correct(tiny_root, monkeypatch, fault):
    broken_chunks(monkeypatch, fault)
    result = one_run(tiny_root, "rmat8k-motifs-service")
    assert not result["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_in_bfloat16_is_not_correct(tiny_root, cell):
    """The control: the program's own bf16 state path in place of fp32."""
    result = one_run(tiny_root, cell, precision="bf16")
    assert not result["correct"]
    gap = result["checks"]["max_rel_gap"]
    assert math.isfinite(gap["value"]) and gap["value"] > gap["limit"]


def test_percentile_and_arrivals():
    assert percentile([3.0, 1.0, 2.0, 4.0], 50) == 2.0
    assert percentile(list(range(1, 101)), 95) == 95
    a = arrival_times(4.0, 50.0, schedule_seed=1)
    b = arrival_times(4.0, 50.0, schedule_seed=2)
    assert len(a) == len(b) == 200 and a[0] == 0.0 and a[-1] < 50.0
    assert not np.array_equal(a, b)
    assert sorted(np.diff(np.append(a, 50.0))) == pytest.approx(sorted(np.diff(np.append(b, 50.0))))


@pytest.mark.cuda
def test_one_run_on_the_card(cuda_device):
    result = harness.run(harness.ROOT, "rmat8k-motifs-batch", SEED, 1.0, False, cuda_device)
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"


#: cells that later PRs can add from data files alone: (cell, config, its
#: file's changes to a configuration already there, traffic file, check file)
FURTHER_CELLS = {
    # Erdos-Renyi: the R-MAT generator with a uniform initiator
    "er-u12-batch": ("er-u12", ("rmat20-u12", {"a": 0.25, "b": 0.25, "c": 0.25, "d": 0.25}),
                     {"kind": "estimates", "colorings": 4, "templates": ["u12"]}),
    # one key a call through the streaming increment, padded to the chunk
    "rmat8k-u5-stream": ("rmat8k-motifs", None,
                         {"kind": "estimates", "colorings": 4, "templates": ["u5-1"],
                          "entry": "count_keys_chunk", "keys_per_call": 1}),
    # the service under transient launch faults, which its retries clear
    "rmat8k-motifs-chaos": ("rmat8k-motifs", None,
                            {"kind": "service", "rate_qps": 16.0, "schedule_seed": 26,
                             "iterations": 16, "warm_queries": 1,
                             "faults": [{"site": "launch", "kind": "transient", "rate": 0.125}],
                             "tenants": [{"name": "tenant0", "templates": ["u5-1"]},
                                         {"name": "tenant1", "templates": ["g3-0", "g3-1"]}]}),
    # each query of a tenant a different template set
    "rmat8k-motifs-cold": ("rmat8k-motifs", None,
                           {"kind": "service", "rate_qps": 8.0, "schedule_seed": 26,
                            "iterations": 16, "warm_queries": 1,
                            "tenants": [{"name": "tenant0", "template_sets": [
                                ["g3-0"], ["g4-0", "g4-1"], ["g3-0", "g3-1"], ["g4-1"],
                                ["g3-1"]]}]}),
}


@pytest.mark.parametrize("cell", sorted(FURTHER_CELLS))
def test_a_further_cell_needs_only_data_files(tiny_root, cell):
    """The further cells that PERF.md lists run from new data files and
    ``BENCHMARK.json`` entries alone, and come out correct."""
    config, derived, traffic = FURTHER_CELLS[cell]
    pkg = tiny_root / "portbench"
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    if derived is not None:
        base, changes = derived
        cfg = json.loads((pkg / "configs" / f"{base}.json").read_text())
        cfg.update(name=config, graph=dict(cfg["graph"], **changes))
        (pkg / "configs" / f"{config}.json").write_text(json.dumps(cfg))
        spec["configs"].append({"name": config, "source": "a test", "why": "a test",
                                "file": f"portbench/configs/{config}.json", "reduced": []})
    (pkg / "traffic" / f"{cell}.json").write_text(json.dumps(traffic))
    (pkg / "workloads" / f"{cell}.json").write_text(
        json.dumps({"sample": 4, "max_rel_gap_limit": 1e-4}))
    spec["workloads"].append({"name": cell, "config": config, "traffic": cell, "chips": 1,
                              "why": "a test"})
    for m in spec["end_to_end"]:
        if "workloads" in m and {"query_p50_s": "service", "colorings_per_s": "estimates"}.get(
                m["name"]) == traffic["kind"]:
            m["workloads"].append(cell)
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    result = one_run(tiny_root, cell)
    assert result["correct"], result["checks"]
    assert len(result["metrics"]) >= 2 and result["failed"] == 0
    if "faults" in traffic:
        assert result["run"]["faults"]["transient"] > 0
