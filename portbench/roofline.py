"""The least time the chip could take for the counting kernels' work.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit):
3.35 TB/s of HBM3 and 67 TFLOP/s of float32 outside the tensor cores.  A
kernel's bound is the larger of its bytes over the first and its operations
over the second, each input byte read once and each output byte written
once, whatever the kernel reads again.  The byte and operation counts are
those ``chip_smoke.py`` used for kernels A and B from PR 11 on, computed
here from the shapes of :mod:`portbench.shapes`.
"""

from __future__ import annotations

from typing import Sequence, Tuple

from .shapes import TreeStage

PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12


def bound_s(nbytes: float, flops: float) -> Tuple[float, str]:
    """``(seconds, "bytes" | "operations")``: the larger of the two times."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FP32_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fused_stage_work(stage: TreeStage, n: int, e: int, bsz: int) -> Tuple[float, float]:
    """Kernel A on one stage of ``bsz`` colorings over ``n`` vertices and
    ``e`` directed edges: ``(bytes, flops)``.  Bytes: both input states and
    the output in float32, the row pointers and column indices, the split
    table.  Operations: one add per edge and passive column, a multiply and
    an add per vertex, output and split."""
    nbytes = (n * bsz * (stage.c_p + stage.c_a + stage.n_out) * 4 + (n + 1) * 4 + e * 4
              + stage.n_out * stage.n_splits * 4)
    flops = e * bsz * stage.c_p + 2 * n * bsz * stage.n_out * stage.n_splits
    return float(nbytes), float(flops)


def product_work(cols: int, n: int, e: int) -> Tuple[float, float]:
    """Kernel B, the adjacency times an ``(n, cols)`` float32 state:
    ``(bytes, flops)``: the input and the output, the row pointers and
    column indices; one add per edge and column."""
    return float(2 * n * cols * 4 + (n + 1) * 4 + e * 4), float(e * cols)


def tree_chunk_bound_s(stages: Sequence[TreeStage], n: int, e: int, bsz: int) -> float:
    """Kernel A's least seconds for one chunk of ``bsz`` colorings."""
    return sum(bound_s(*fused_stage_work(st, n, e, bsz))[0] for st in stages)


def bag_chunk_bound_s(widths: Sequence[int], n: int, e: int, bsz: int) -> float:
    """Kernel B's least seconds for one chunk: ``widths`` are one coloring's
    product columns (:func:`portbench.shapes.bag_product_widths`)."""
    return sum(bound_s(*product_work(w * bsz, n, e))[0] for w in widths)
