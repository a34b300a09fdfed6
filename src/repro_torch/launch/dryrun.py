"""Dry run: analyse every (arch x shape x mesh) cell without a device.

Usage:
  python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all [--mesh both] [--include-subgraph] [--probe]
  python -m repro_torch.launch.dryrun --list

The reference compiles each cell with XLA on 256 or 512 virtual devices and
reads the compiler's memory and cost analyses.  Torch has no such
compiler, so for every LM cell this traces one device's share of the step
(device 0, ``launch.sharded``) on ``meta`` tensors, with the mesh's
collectives simulated:

* FLOPs from ``torch.utils.flop_counter.FlopCounterMode``, which counts
  matmul-class operations only (the reference's ``cost_analysis`` counts
  elementwise operations too);
* bytes accessed from a dispatch-mode counter: every non-view operation's
  tensor inputs and outputs, once each (eager, unfused);
* per-device memory as the arguments' blocks at their placement plus the
  peak of live temporaries in the trace;
* collectives from the executor's log, ring-costed;

then prices the cell on the H100's datasheet constants (``launch.roofline``).
GNN, recsys and subgraph2vec cells have no sharded executor (or their
steps need data, such as a sort, that a ``meta`` trace lacks) and are
counted analytically (``cells.analytic_counts``); each record's ``method``
says which.  Records go to ``<out>/<arch>__<shape>__<mesh>.json`` with the
reference's keys, ``fits_80GB`` in place of ``fits_16GB``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
import weakref
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

__all__ = ["MemoryCounter", "trace_counts", "cell_counts", "analyze_cell", "run_cell", "main"]

#: meta-trace method string of the LM records
TRACE_METHOD = ("meta trace of device 0's step: FlopCounterMode FLOPs (matmul-class ops only; "
                "the reference's cost_analysis counts elementwise ops too), bytes of every "
                "non-view op's inputs and outputs, peak live temporaries")


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class MemoryCounter(TorchDispatchMode):
    """Counts, over the operations dispatched inside it, the bytes each
    non-view operation reads and writes (``bytes``) and the peak of the
    storages its outputs allocate while they live (``peak``).  Storages
    that exist before (the arguments) are not temporaries."""

    def __init__(self, known=()):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._known = {id(t.untyped_storage()) for t in known}
        self._keep = [t.untyped_storage() for t in known]  # ids stay valid
        self._tracked: Dict[int, int] = {}

    def _free(self, key: int) -> None:
        self.live -= self._tracked.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if getattr(func, "is_view", False):
            return out
        outs = list(_tensors(out))
        self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs))) + sum(_nbytes(t) for t in outs)
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in self._known or key in self._tracked:
                continue
            self._tracked[key] = st.nbytes()
            self.live += st.nbytes()
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)
        return out


def trace_counts(cell, mesh, rank: int = 0) -> Dict:
    """One device's counts of ``cell``'s step from a ``meta`` trace: FLOPs,
    bytes accessed, peak temporaries and the collective log."""
    from repro_torch.launch.cells import local_args
    from repro_torch.launch.sharded import Comm

    args = local_args(cell, mesh)
    comm = Comm(mesh, rank)
    with FlopCounterMode(display=False) as flops, MemoryCounter(_tensors(args)) as mem:
        out = cell.fn(comm, *args)
        del out
    return {"flops": float(flops.get_total_flops()), "bytes": float(mem.bytes),
            "temp_bytes": float(mem.peak), "log": list(comm.log), "method": TRACE_METHOD}


def cell_counts(cell, mesh) -> Dict:
    """Per-device counts: traced for LM cells, analytic for the others."""
    from repro_torch.launch.cells import analytic_counts

    if cell.meta["family"] == "lm":
        return trace_counts(cell, mesh)
    out = analytic_counts(cell, mesh)
    out["log"] = list(cell.schedule or [])
    return out


def analyze_cell(cell, mesh, mesh_name: str, counts: Optional[Dict] = None, meta=None):
    """``(RooflineReport, counts)`` of a built cell on ``mesh``."""
    from repro_torch.core.sharding import tree_device_bytes
    from repro_torch.launch.roofline import analyze

    t0 = time.monotonic()
    counts = counts or cell_counts(cell, mesh)
    arg = float(tree_device_bytes(cell.args, cell.in_shardings, mesh))
    report = analyze(
        arch=cell.arch, shape=cell.shape, mesh_name=mesh_name, mesh=mesh,
        flops=counts["flops"], bytes_accessed=counts["bytes"], log=counts["log"], dtype=cell.dtype,
        model_flops=cell.model_flops, per_device_memory_bytes=arg + counts["temp_bytes"],
        argument_bytes=arg,
        meta={**cell.meta, **(meta or {}), "trace_s": round(time.monotonic() - t0, 2)},
    )
    return report, counts


def run_cell(arch: str, shape_name: str, mesh_name: str, out_dir: Optional[str],
             probe: bool = False, mesh=None) -> Dict:
    """Build, analyse and print one cell; write its record under
    ``out_dir`` (none when ``None``)."""
    from repro_torch.configs.registry import shapes_for
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.roofline import HBM_BW, HBM_BYTES, peak_flops

    shape = next(s for s in shapes_for(arch) if s.name == shape_name)
    mesh = mesh or make_production_mesh(multi_pod=(mesh_name == "multi"))
    t0 = time.monotonic()
    cell = build_cell(arch, shape, mesh)
    t_build = time.monotonic() - t0
    report, counts = analyze_cell(cell, mesh, mesh_name, meta={"build_s": round(t_build, 2)})
    rec = report.to_json()
    rec["method"] = counts["method"]
    print(f"== {arch} x {shape_name} x {mesh_name} ({mesh.size} devices) ==")
    print("counts: flops/device=%.3e bytes/device=%.3e collective wire bytes/device=%.3e (%s)"
          % (report.hlo_flops, report.hlo_bytes, report.collective_bytes, counts["method"]))

    if probe:
        from repro_torch.launch.probes import probe_costs

        corr = probe_costs(arch, shape, mesh)
        if corr is not None:
            rec["probe"] = corr
            rec["hlo_flops"] = corr["flops"]
            rec["hlo_bytes"] = corr["bytes"]
            rec["collective_bytes"] = corr["collective_bytes"]
            rec["compute_s"] = corr["flops"] / peak_flops(cell.dtype)
            rec["memory_s"] = corr["bytes"] / HBM_BW
            rec["collective_s"] = corr["collective_s"]
            terms = {"compute": rec["compute_s"], "memory": rec["memory_s"],
                     "collective": rec["collective_s"]}
            rec["bottleneck"] = max(terms, key=terms.get)
            denom = corr["flops"] * mesh.size
            rec["useful_flops_ratio"] = cell.model_flops / denom if denom else 0.0
            print(f"probe-fit: compute={rec['compute_s']:.3e}s memory={rec['memory_s']:.3e}s "
                  f"collective={rec['collective_s']:.3e}s bottleneck={rec['bottleneck']} "
                  f"useful={rec['useful_flops_ratio']:.3f} ({corr['method']})")
    per_dev = report.per_device_memory_bytes or 0.0
    rec["fits_hbm"] = bool(per_dev < HBM_BYTES)
    rec["fits_80GB"] = rec["fits_hbm"]
    print(f"roofline: compute={rec['compute_s']:.3e}s memory={rec['memory_s']:.3e}s "
          f"collective={rec['collective_s']:.3e}s bottleneck={rec['bottleneck']} "
          f"useful_flops_ratio={rec['useful_flops_ratio']:.3f}")
    print(f"per-device bytes (arg+temp): {per_dev:.3e} fits_80GB={rec['fits_80GB']}")

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_name}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"wrote {path}")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--include-subgraph", action="store_true")
    ap.add_argument("--probe", action="store_true", help="depth-fit (affine) roofline costs")
    ap.add_argument("--out", default="results/dryrun")
    args = ap.parse_args(argv)

    from repro_torch.configs.registry import all_cells, shapes_for

    if args.list:
        for arch, shape in all_cells(include_subgraph=True):
            print(f"{arch} {shape.name}")
        return 0

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells = (
        all_cells(include_subgraph=args.include_subgraph)
        if args.all
        else [(args.arch, s) for s in shapes_for(args.arch) if args.shape in (None, s.name)]
    )

    failures = []
    t0 = time.monotonic()
    for arch, shape in cells:
        for mesh_name in meshes:
            try:
                run_cell(arch, shape.name, mesh_name, args.out, probe=args.probe)
            except Exception as e:  # the sweep reports every cell, then fails
                traceback.print_exc()
                failures.append((arch, shape.name, mesh_name, repr(e)))
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        return 1
    print(f"\nALL CELLS ANALYSED in {time.monotonic() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
