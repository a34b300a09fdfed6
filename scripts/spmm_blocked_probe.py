"""Time kernel B at the bag stages' widths, beside other builds of it.

Builds the motif benchmark's graph on the card (``portbench/configs/
rmat8k-motifs.json``: R-MAT, n = 8192, 131,072 sampled edges, seed 2) and,
per width, times ``spmm_blocked_launch`` of each library with CUDA events
(one warm-up, then ``--reps`` launches), beside ``torch.sparse.mm`` on the
same CSR.  Every library's output must equal the first's bit for bit (each
output tile is one warp's sum in edge order, whatever the slab width), and
the first's must match the plain version.  The libraries:

* ``committed``: ``csrc/spmm_blocked.cu`` of this tree;
* ``--parent PATH``: another tree's ``spmm_blocked.cu`` (same C entry point);
* ``--slab-bytes 8388608,...``: copies of the committed source under
  ``build/probe`` whose slabs span that many bytes of M (at n = 8192 a
  tile is 4 MiB).

::

    git archive <commit> src | tar -x -C build/parent
    python3 scripts/spmm_blocked_probe.py --parent \\
        build/parent/src/repro_torch/kernels/spmm_blocked/csrc/spmm_blocked.cu

Prints one JSON line per width (``--out`` appends them to a file).  Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as C  # noqa: E402
from portbench.roofline import bound_s, product_work  # noqa: E402

#: The paw's and 4-cycle's extends at a chunk of 10, the 4-cycle's last
#: extend, and the service's triangle (24,576 x 23), then two narrow ones.
WIDTHS = (491_520, 327_680, 565_248, 300, 40)


def slab_variant(nbytes: int) -> Path:
    """A copy of the committed source whose slabs span ``nbytes`` of M."""
    from repro_torch.kernels.spmm_blocked.ops import SOURCE

    text = re.sub(r"constexpr int64_t kSlabBytes = [^;]+;",
                  f"constexpr int64_t kSlabBytes = {nbytes};", SOURCE.read_text())
    header = (SOURCE.parents[2] / "csrc" / "edge_walk.cuh").resolve()
    text = text.replace('#include "../../csrc/edge_walk.cuh"', f'#include "{header}"')
    path = ROOT / "build" / "probe" / f"spmm_blocked_slab{nbytes}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    return path


def launcher(lib, operand, partials):
    fn = lib.spmm_blocked_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, p, i, p, i, p, p, i, p, p, i, p, p, p, p,
                   ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    part = operand.partition

    def run(m, out):
        import torch

        launched, slabs = ctypes.c_int(0), ctypes.c_int(0)
        status = fn(operand.row_ptr.data_ptr(), operand.src.data_ptr(), operand.n, m.data_ptr(),
                    m.shape[1], out.data_ptr(), part.n_ranges, part.range_ptr.data_ptr(),
                    part.heavy_slot.data_ptr(), part.n_heavy, part.heavy_rows.data_ptr(),
                    part.seg_ptr.data_ptr(), part.n_segments, part.seg_beg.data_ptr(),
                    part.seg_end.data_ptr(), partials.data_ptr(),
                    torch.cuda.current_stream().cuda_stream, ctypes.byref(launched),
                    ctypes.byref(slabs))
        if status != 0:
            raise RuntimeError(f"launch failed: cudaError_t {status}")
        return slabs.value

    return run


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--widths", default=",".join(map(str, WIDTHS)))
    parser.add_argument("--parent", default="", help="another tree's spmm_blocked.cu")
    parser.add_argument("--slab-bytes", default="", help="slab sizes in bytes, e.g. 8388608")
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--out", default="")
    args = parser.parse_args()

    import torch

    from portbench.graphs.rmat import make
    from repro_torch.core.graph import Graph
    from repro_torch.kernels import _build
    from repro_torch.kernels.spmm_blocked import ops
    from repro_torch.kernels.spmm_blocked.ref import spmm_ref

    device = torch.device("cuda", 0)
    spec = json.loads((ROOT / "portbench" / "configs" / "rmat8k-motifs.json").read_text())["graph"]
    src, dst = make(spec, 0, device)
    graph = Graph(n=spec["n"], src=src.cpu().numpy(), dst=dst.cpu().numpy())
    operand = ops.prepare_operand(graph, device)
    part = operand.partition
    sources = {"committed": ops.SOURCE}
    if args.parent:
        sources["parent"] = Path(args.parent).resolve()
    for nbytes in filter(None, args.slab_bytes.split(",")):
        sources[f"slab_bytes_{int(nbytes)}"] = slab_variant(int(nbytes))
    built = _build.build(list(sources.values()))
    libs = {name: _build.load(path) for name, path in sources.items()}
    head = {"card": C.card_line(), "n": operand.n, "edges": operand.num_directed,
            "heavy_rows": part.n_heavy, "segments": part.n_segments, "ranges": part.n_ranges,
            "build_s": built}
    print(json.dumps(head), flush=True)
    csr = torch.sparse_csr_tensor(operand.row_ptr.long(), operand.src.long(),
                                  torch.ones(operand.num_directed, device=device),
                                  size=(operand.n, operand.n))
    lines = [head]
    for c in map(int, args.widths.split(",")):
        gen = torch.Generator(device=device).manual_seed(c)
        m = torch.rand((operand.n, c), generator=gen, device=device)
        partials = torch.empty((part.n_segments, c), device=device)
        want, buf = torch.empty_like(m), None
        row = {"cols": c,
               "bound_ms": bound_s(*product_work(c, operand.n, operand.num_directed))[0] * 1e3,
               "model": ops.slab_visits(operand, c)}
        for name, lib in libs.items():
            run = launcher(lib, operand, partials)
            first = name == "committed"
            if not first and buf is None:
                buf = torch.empty_like(m)  # after the plain version's output is freed
            out = want if first else buf
            slabs = run(m, out)
            torch.cuda.synchronize()
            if first:
                ref = spmm_ref(operand.src, operand.dst, operand.n, m, col_chunk=4096)
                atol = 1e-6 * float(ref.abs().max())
                for lo in range(0, c, 16_384):  # bounded temporaries
                    torch.testing.assert_close(want[:, lo:lo + 16_384], ref[:, lo:lo + 16_384],
                                               rtol=1e-4, atol=atol)
                del ref
            elif not torch.equal(want, buf):
                raise AssertionError(f"{name} at C={c}: not bitwise equal to the committed build")
            row[name] = {"ms": C.time_ms(lambda: run(m, out), args.reps), "slabs": slabs}
        del buf, out
        torch.cuda.empty_cache()
        row["library_ms"] = C.time_ms(lambda: torch.sparse.mm(csr, m), args.reps)
        print(json.dumps(row), flush=True)
        lines.append(row)
        del m, want, partials
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
