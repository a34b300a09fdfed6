"""Shared fixtures of the benchmark's own tests: a tiny copy of the
benchmark (the same cells, files and readers, at graph sizes a CPU test
holds)."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

#: per configuration: vertices and sampled edges of the test's graph
TINY_GRAPHS = {"rmat20-u12": (192, 1000), "rmat8k-motifs": (256, 1500)}
#: per traffic mix: the parameters the tests shrink
TINY_TRAFFIC = {"estimates-u12": {"colorings": 4}, "estimates-g4": {"colorings": 20},
                "two-tenant-poisson": {"rate_qps": 8.0}}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: beside the other test workers, more would only
    contend for the cores (and spin)."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def tiny_root(tmp_path):
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    pkg = tmp_path / "portbench"
    for sub in ("configs", "traffic", "workloads", "metrics", "drivers", "graphs"):
        (pkg / sub).mkdir(parents=True)
        for f in (ROOT / "portbench" / sub).iterdir():
            if f.is_file():
                (pkg / sub / f.name).write_bytes(f.read_bytes())
    for name, (n, edges) in TINY_GRAPHS.items():
        path = pkg / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg["graph"].update(n=n, edges=edges)
        cfg["memory_budget_gib"] = 0.05
        path.write_text(json.dumps(cfg))
    for name, changes in TINY_TRAFFIC.items():
        path = pkg / "traffic" / f"{name}.json"
        path.write_text(json.dumps({**json.loads(path.read_text()), **changes}))
    return tmp_path


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
