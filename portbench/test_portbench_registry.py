"""``BENCHMARK.json`` keeps to the benchmark's contract, and the harness finds
every configuration, traffic mix, cell check and metric reader by name."""

import ast
import json
import re
from pathlib import Path

import pytest

from portbench.registry import Benchmark

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "portbench"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source"}
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def all_metrics():
    return SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./\-]{1,200}", p) and ".." not in p
    assert 1 <= len(SPEC["command"]) <= 32
    assert all(1 <= len(w) <= 200 and "\n" not in w and "\t" not in w for w in SPEC["command"])
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    cells = len(SPEC["workloads"])
    runs = 2 + 14 * 24  # the check of a benchmark at its full 24 cells
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert 1 <= cells <= 24 and 1 <= len(SPEC["configs"]) <= 24
    assert 1 <= len(SPEC["end_to_end"]) <= 16 and 1 <= len(SPEC["per_layer"]) <= 128


@pytest.mark.parametrize("entry", SPEC["configs"] + SPEC["workloads"] + all_metrics(),
                         ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.match(entry["name"]), entry["name"]
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in entry.get("reduced", []):
        assert NAME.match(key)
    if "unit" in entry:
        assert UNIT.match(entry["unit"]), entry["unit"]
        assert entry["better"] in ("lower", "higher")
    texts = [entry[k] for k in ("why", "layer") if k in entry]
    if "file" in entry:  # a configuration's source is a URL or a paper
        texts.append(entry["source"])
    for text in texts:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_names_are_unique_and_entries_have_only_their_keys():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in all_metrics()]
    assert len(names) == len(set(names))
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and len(c["reduced"]) <= 16
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    bench = Benchmark(ROOT)
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for w in SPEC["workloads"]:
        reported = {m["name"] for m in bench.end_to_end(w["name"])}
        assert "setup_s" in reported and len(reported) >= 2
        layers = bench.per_layer(w["name"])
        assert layers
        for m in layers:
            assert m["moves"] in reported, (w["name"], m["name"])
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
    for m in all_metrics():
        for cell in m.get("workloads", []):
            bench.cell(cell)
    configs = {c["name"] for c in SPEC["configs"]}
    assert configs == {w["config"] for w in SPEC["workloads"]}  # each used by some cell


def test_the_harness_finds_each_piece_by_name():
    bench = Benchmark(ROOT)
    files = set()
    for c in SPEC["configs"]:
        path = ROOT / c["file"]
        assert path.is_relative_to(PACKAGE) and path.is_file() and path not in files
        files.add(path)
        cfg = bench.config(c["name"])
        assert cfg["name"] == c["name"]
        for key in c["reduced"]:
            assert key in cfg["graph"] or key in cfg
    for w in SPEC["workloads"]:
        cfg, traffic, check = bench.config(w["config"]), bench.traffic(w["traffic"]), bench.check(
            w["name"])
        assert callable(bench.driver(traffic["kind"]))
        assert callable(bench.graph(cfg["graph"]["generator"]))
        names = traffic.get("templates") or [n for t in traffic["tenants"]
                                             for s in t.get("template_sets", [t.get("templates")])
                                             for n in s]
        assert set(names) <= set(cfg["templates"])
        assert check["sample"] >= 1 and check["max_rel_gap_limit"] > 0
    for m in SPEC["per_layer"]:
        assert callable(bench.reader(m["name"]))


def test_a_new_cell_is_found_from_new_files_alone(tmp_path):
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "rmat8k-motifs-batch3", "config": "rmat8k-motifs",
                              "traffic": "estimates-g3", "chips": 1, "why": "a test cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    pkg = tmp_path / "portbench"
    for sub in ("configs", "traffic", "workloads", "metrics", "drivers", "graphs"):
        (pkg / sub).mkdir(parents=True)
        for f in (PACKAGE / sub).iterdir():
            if f.is_file():
                (pkg / sub / f.name).write_bytes(f.read_bytes())
    (pkg / "traffic" / "estimates-g3.json").write_text(
        json.dumps({"kind": "estimates", "colorings": 10, "templates": ["g3-0", "g3-1"]}))
    (pkg / "workloads" / "rmat8k-motifs-batch3.json").write_text(
        json.dumps({"sample": 2, "max_rel_gap_limit": 1e-4}))
    (pkg / "metrics" / "colorings_seen.batch3.py").write_text("def read(ctx):\n    return 1.0\n")
    spec["per_layer"].append({"name": "colorings_seen.batch3", "unit": "colorings",
                              "better": "higher", "source": "program_counter", "layer": "device",
                              "moves": "colorings_per_s", "workloads": ["rmat8k-motifs-batch3"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = Benchmark(tmp_path)
    assert bench.traffic(bench.cell("rmat8k-motifs-batch3")["traffic"])["templates"] == [
        "g3-0", "g3-1"]
    assert [m["name"] for m in bench.per_layer("rmat8k-motifs-batch3")] == [
        "colorings_seen.batch3"]
    assert bench.reader("colorings_seen.batch3")(None) == 1.0


def imported_top_levels(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py")), ids=lambda p: p.name)
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not imported_top_levels(path) & FORBIDDEN
    if "reference" in path.parts:
        assert "repro_torch" not in imported_top_levels(path)
        assert not ({"portbench"} & imported_top_levels(path))
