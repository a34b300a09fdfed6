"""Find a cell's configuration, traffic, check and metric readers by name.

``BENCHMARK.json`` at the checkout's root names the cells; everything that
belongs to one configuration, traffic mix, cell or per-layer metric sits in
a file of its own under this package, so a new cell or metric is new files
and new entries, never an edit:

* ``configs/<config>.json``: the deployment (graph, templates, budget, the
  guarantees), the file ``BENCHMARK.json`` names;
* ``traffic/<traffic>.json``: a traffic mix's parameters, which the driver
  its ``kind`` names reads;
* ``drivers/<kind>.py``: one kind of traffic's driver, ``run(cell)`` (a
  :class:`portbench.common.Cell`), which returns ``(Context, checks)``;
* ``graphs/<generator>.py``: one graph generator, ``make(spec, seed,
  device)``, which returns the edges ``(src, dst)`` that a configuration's
  ``graph`` keys and the run's seed give;
* ``workloads/<cell>.json``: how the cell's answers are checked (how many
  are compared, and the limit of each number compared);
* ``metrics/<metric>.py``: one per-layer metric's reader, ``read(ctx)``,
  which returns a number or ``None`` when it finds nothing to read.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

PACKAGE = Path(__file__).resolve().parent


class Benchmark:
    def __init__(self, root: Path):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self.package = self.root / PACKAGE.name

    def cell(self, name: str) -> Dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> Dict:
        return json.loads((self.package / "traffic" / f"{name}.json").read_text())

    def check(self, cell: str) -> Dict:
        return json.loads((self.package / "workloads" / f"{cell}.json").read_text())

    def end_to_end(self, cell: str) -> List[Dict]:
        return [m for m in self.spec["end_to_end"] if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> List[Dict]:
        reported = {m["name"] for m in self.end_to_end(cell)}
        out = []
        for m in self.spec["per_layer"]:
            if "workloads" in m:
                if cell in m["workloads"]:
                    out.append(m)
            elif m["moves"] in reported:
                out.append(m)
        return out

    def _load(self, folder: str, name: str):
        path = self.package / folder / f"{name}.py"
        if not path.is_file():
            raise KeyError(f"no {folder}/{name}.py in {self.package}")
        spec = importlib.util.spec_from_file_location(
            f"portbench_{folder}_" + name.replace(".", "_").replace("-", "_"), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    def reader(self, metric: str) -> Callable:
        return self._load("metrics", metric).read

    def driver(self, kind: str) -> Callable:
        return self._load("drivers", kind).run

    def graph(self, generator: str) -> Callable:
        return self._load("graphs", generator).make
