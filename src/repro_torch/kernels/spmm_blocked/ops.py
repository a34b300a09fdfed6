"""The compact SpMM operand, its edge-balanced partition, and the wrapper of
the blocked SpMM kernel.

The reference pads every (dst-block, src-block) pair of a blocked-ELL
layout to the largest pair's edge count (``repro.core.graph.
build_blocked_ell``).  On an R-MAT graph one hub pair holds thousands of
edges while most pairs hold a few, so the padded operand of a graph with
2^20 vertices would be hundreds of GB.  The port's kernels read the edge
list in its canonical ``(dst, src)`` order instead, with CSR offsets per
destination vertex, and split the work by edges rather than by rows
(:class:`EdgePartition`), so a hub row no longer sets a launch's length.

On a CPU tensor :func:`spmm_blocked` runs the plain version
(:func:`repro_torch.kernels.spmm_blocked.ref.spmm_ref`); on a CUDA tensor it
launches ``csrc/spmm_blocked.cu`` or raises.
"""

from __future__ import annotations

import ctypes
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.kernels import _build

from .ref import spmm_ref

__all__ = [
    "CompactOperand",
    "EdgePartition",
    "build_partition",
    "prepare_operand",
    "tile_width",
    "edge_visits",
    "spmm_blocked",
    "SOURCE",
    "HEAVY_DEGREE",
    "SEGMENT_EDGES",
    "RANGE_ROWS",
    "RANGE_EDGES",
    "KERNEL_WARPS",
    "check_schedule",
    "check_int32_counts",
]

SOURCE = Path(__file__).resolve().parent / "csrc" / "spmm_blocked.cu"

# The partition's constants, chosen on the smoke graph (R-MAT, n = 2^20,
# 16.1 M directed edges, mean degree 15.3, max 39,733): rows above degree
# 1024 are 1,351 rows carrying 23.5% of the edges, and 2048-edge segments
# cut them into 3,030 warp items per column tile, enough to spread them
# over the card next to the light ranges.  A light range is at most 16 rows
# (16 rows x 924 passive columns x 4 B = 59 KB of shared aggregate, u12's
# widest) and at most 4096 edges, so a warp that walked a whole range for
# every 128-column tile of 924 columns would make 4096 x 8 = 32,768 edge
# visits: that is the cap on every u12 stage, and the heavy warps make at
# most 2048.  build_partition reads them when it is called.
#: Rows of higher degree are heavy: cut into segments.
HEAVY_DEGREE = 1024
#: Largest segment of a heavy row, in edges.
SEGMENT_EDGES = 2048
#: Most rows in one light range.
RANGE_ROWS = 16
#: Most edges in one light range (above HEAVY_DEGREE, see build_partition).
RANGE_EDGES = 4096
#: Warps per CTA in both kernels (``kWarps`` in ``csrc/edge_walk.cuh``;
#: :func:`check_schedule` holds it against the built library).
KERNEL_WARPS = 8


@dataclass(frozen=True)
class EdgePartition:
    """The edge-balanced work split of a compact operand, int32 on a device.

    * ``heavy_rows`` ``(n_heavy,)``: the rows of degree above the threshold,
      ascending; ``heavy_slot`` ``(n,)`` maps a row to its index there, or -1.
    * Heavy row ``h`` owns segments ``seg_ptr[h] : seg_ptr[h + 1]``; segment
      ``s`` is the edge range ``seg_beg[s] : seg_end[s]`` (at least two per
      row, at most :data:`SEGMENT_EDGES` edges each, in edge order).
    * Light range ``r`` is rows ``range_ptr[r] : range_ptr[r + 1]``: the
      ranges tile ``0..n`` in order, each at most :data:`RANGE_ROWS` rows
      and :data:`RANGE_EDGES` light edges (heavy rows in a range count no
      edges).
    """

    range_ptr: torch.Tensor
    heavy_rows: torch.Tensor
    heavy_slot: torch.Tensor
    seg_ptr: torch.Tensor
    seg_beg: torch.Tensor
    seg_end: torch.Tensor
    build_seconds: float

    @property
    def n_ranges(self) -> int:
        return int(self.range_ptr.shape[0]) - 1

    @property
    def n_heavy(self) -> int:
        return int(self.heavy_rows.shape[0])

    @property
    def n_segments(self) -> int:
        return int(self.seg_beg.shape[0])


def build_partition(row_ptr, device) -> EdgePartition:
    """Partition the rows of a CSR with offsets ``row_ptr`` (``(n + 1,)``).

    O(n + |E|) NumPy, no loop over rows.  A heavy row (degree above
    :data:`HEAVY_DEGREE`) of degree ``d`` gets ``max(2, ceil(d /
    SEGMENT_EDGES))`` segments of near-equal length.  A light range starts at
    every multiple of :data:`RANGE_ROWS` and wherever the light edges before
    a row cross a multiple of ``RANGE_EDGES - HEAVY_DEGREE``; as no light row
    has more than ``HEAVY_DEGREE`` edges, a range then holds fewer than
    :data:`RANGE_EDGES`.
    """
    t0 = time.perf_counter()
    heavy_degree, segment_edges = HEAVY_DEGREE, SEGMENT_EDGES
    range_rows, range_edges = RANGE_ROWS, RANGE_EDGES
    if not 0 < heavy_degree < range_edges or segment_edges < 1 or range_rows < 1:
        raise ValueError("need 0 < HEAVY_DEGREE < RANGE_EDGES, SEGMENT_EDGES >= 1, "
                         "RANGE_ROWS >= 1")
    row_ptr = np.asarray(row_ptr, dtype=np.int64)
    n = row_ptr.shape[0] - 1
    deg = np.diff(row_ptr)
    heavy = deg > heavy_degree

    heavy_rows = np.flatnonzero(heavy)
    heavy_slot = np.full(n, -1, dtype=np.int64)
    heavy_slot[heavy_rows] = np.arange(heavy_rows.size)
    hdeg = deg[heavy_rows]
    nseg = np.maximum(2, -(-hdeg // segment_edges))
    seg_ptr = np.zeros(heavy_rows.size + 1, dtype=np.int64)
    np.cumsum(nseg, out=seg_ptr[1:])
    owner = np.repeat(np.arange(heavy_rows.size), nseg)
    idx = np.arange(owner.size) - seg_ptr[owner]
    base, extra = hdeg[owner] // nseg[owner], hdeg[owner] % nseg[owner]
    seg_beg = row_ptr[heavy_rows][owner] + idx * base + np.minimum(idx, extra)
    seg_end = seg_beg + base + (idx < extra)

    light_deg = np.where(heavy, 0, deg)
    before = np.cumsum(light_deg) - light_deg
    key = before // (range_edges - heavy_degree)
    start = np.arange(n) % range_rows == 0
    start[1:] |= key[1:] != key[:-1]
    range_ptr = np.append(np.flatnonzero(start), n)

    device = torch.device(device)

    def i32(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=device)

    return EdgePartition(
        range_ptr=i32(range_ptr),
        heavy_rows=i32(heavy_rows),
        heavy_slot=i32(heavy_slot),
        seg_ptr=i32(seg_ptr),
        seg_beg=i32(seg_beg),
        seg_end=i32(seg_end),
        build_seconds=time.perf_counter() - t0,
    )


@dataclass(frozen=True)
class CompactOperand:
    """A graph's edges sorted by ``(dst, src)`` plus CSR offsets, on a device.

    ``src`` / ``dst`` are ``(|E|,)`` int32 with both directions of every
    undirected edge; ``row_ptr`` is ``(n + 1,)`` int32, so the in-edges of
    vertex ``v`` are ``src[row_ptr[v]:row_ptr[v + 1]]``.  ``partition`` is
    the work split both kernels launch over.
    """

    n: int
    src: torch.Tensor
    dst: torch.Tensor
    row_ptr: torch.Tensor
    partition: EdgePartition

    @property
    def device(self) -> torch.device:
        return self.src.device

    @property
    def num_directed(self) -> int:
        return int(self.src.shape[0])


def prepare_operand(graph, device) -> CompactOperand:
    """Build the compact operand of ``graph`` (a ``repro_torch`` ``Graph``)
    and its partition."""
    if graph.num_directed >= 2**31:
        raise ValueError("the compact operand indexes edges with int32")
    deg = np.bincount(graph.dst, minlength=graph.n)
    row_ptr = np.zeros(graph.n + 1, dtype=np.int64)
    np.cumsum(deg, out=row_ptr[1:])
    device = torch.device(device)
    return CompactOperand(
        n=graph.n,
        src=torch.as_tensor(np.ascontiguousarray(graph.src, dtype=np.int32), device=device),
        dst=torch.as_tensor(np.ascontiguousarray(graph.dst, dtype=np.int32), device=device),
        row_ptr=torch.as_tensor(row_ptr.astype(np.int32), device=device),
        partition=build_partition(row_ptr, device),
    )


def _vector_width(c: int) -> int:
    return 4 if c % 4 == 0 else 2 if c % 2 == 0 else 1


def tile_width(c: int) -> int:
    """Columns one warp walk covers for a ``c``-column operand: the choice of
    ``edge_walk::dispatch`` (``csrc/edge_walk.cuh``) with aligned pointers."""
    vec = _vector_width(c)
    if c > 16 * vec:
        return 128
    lanes = 1
    while lanes * vec < c:
        lanes *= 2
    return lanes * vec


def edge_visits(
    operand: CompactOperand, cols: int, rows_pass: Optional[int] = None
) -> Dict[str, int]:
    """The most edge visits (edges walked serially x column tiles walked for)
    any one warp makes in a launch, from the partition the kernels use.

    ``cols`` is the width one light CTA walks (kernel B: ``C``; kernel A:
    ``C_p``, one coloring per CTA); a heavy warp walks one segment for one
    column tile, whatever the row's width.  Light CTAs walk their range in
    passes of ``rows_pass`` rows (default: the whole range), and warp ``w``
    takes the pass's (row, tile) items ``w, w + 8, ...``, rows outer.  This
    models the shared-memory path of kernel A (every stage whose row fits,
    u12's all) and kernel B; :func:`check_schedule` holds its copies of the
    tile width and warp count against each library when it loads.
    """
    part = operand.partition
    row_ptr = operand.row_ptr.cpu().numpy().astype(np.int64)
    range_ptr = part.range_ptr.cpu().numpy().astype(np.int64)
    light = part.heavy_slot.cpu().numpy() < 0
    seg_len = (part.seg_end - part.seg_beg).cpu().numpy()
    n = operand.n
    deg = np.where(light, np.diff(row_ptr), 0)
    rows_pass = rows_pass or RANGE_ROWS
    n_tiles = -(-cols // tile_width(cols))
    rng = np.repeat(np.arange(part.n_ranges), np.diff(range_ptr))
    local = (np.arange(n) - range_ptr[rng]) % rows_pass
    per_warp = np.zeros(part.n_ranges * KERNEL_WARPS, dtype=np.int64)
    for t in range(n_tiles):
        warp = (local * n_tiles + t) % KERNEL_WARPS
        per_warp += np.bincount(rng * KERNEL_WARPS + warp, weights=deg,
                                minlength=per_warp.size).astype(np.int64)
    light_max = int(per_warp.max(initial=0))
    heavy_max = int(seg_len.max(initial=0))
    return {"light_warp": light_max, "heavy_warp": heavy_max,
            "max": max(light_max, heavy_max), "tiles": n_tiles}


#: Operand widths at which :func:`check_schedule` compares the tile choice.
_CHECKED_WIDTHS = range(1, 2049)


def check_schedule(lib: ctypes.CDLL) -> None:
    """Raise unless a built counting-kernel library walks the tiles and
    warps that :func:`tile_width`, :data:`KERNEL_WARPS` and so
    :func:`edge_visits` assume (its exported ``edge_walk_tile_width`` and
    ``edge_walk_warps``)."""
    width = lib.edge_walk_tile_width
    width.argtypes, width.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    if lib.edge_walk_warps() != KERNEL_WARPS:
        raise RuntimeError(f"the library runs {lib.edge_walk_warps()} warps per CTA, "
                           f"the host model {KERNEL_WARPS}")
    for c in _CHECKED_WIDTHS:
        if width(c, _vector_width(c)) != tile_width(c):
            raise RuntimeError(f"the library walks {width(c, _vector_width(c))}-column tiles "
                               f"at C={c}, the host model {tile_width(c)}")


#: Largest value the kernels hold in a 32-bit ``int``.
INT32_MAX = 2**31 - 1


def check_int32_counts(operand: CompactOperand, c: int) -> Dict[str, int]:
    """The counts a launch of ``csrc/spmm_blocked.cu`` over a ``c``-column
    operand holds in 32-bit ``int``s; raises ``ValueError`` naming the first
    that does not fit, so that none wraps.

    A bag extend's state flattened to ``(n, n**(r-1) * B * C)`` is far wider
    than a tree stage: 49,152 columns at n = 8192, B = 1 and C = 6.  The
    kernel's column index runs to ``c`` plus one tile (128 columns), each
    heavy segment is one warp item per column tile, the grid is the heavy
    blocks (8 items each) and the light ranges, and a light CTA walks its
    rows times the tiles; row offsets are 64-bit already.
    """
    part = operand.partition
    n_tiles = -(-c // 128)  # tile_width is 128 above 64 columns, one tile below
    heavy_items = part.n_segments * n_tiles
    counts = {
        "column index (C + one tile)": c + 128,
        "heavy items (segments x column tiles)": heavy_items + KERNEL_WARPS,
        "grid (heavy blocks + light ranges)": -(-heavy_items // KERNEL_WARPS) + part.n_ranges,
        "light-range items (rows x column tiles)": RANGE_ROWS * n_tiles,
    }
    for what, value in counts.items():
        if value > INT32_MAX:
            raise ValueError(
                f"spmm_blocked cannot launch on {c} columns: its {what} would be {value}, "
                f"past the kernel's 32-bit int ({INT32_MAX}); split the columns"
            )
    return counts


def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.spmm_blocked_launch
    if fn.argtypes is None:
        check_schedule(lib)
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, p, i, p, i, p, p, i, p, p, i, p, p, p, p,
                       ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    return lib


def spmm_blocked(operand: CompactOperand, m: torch.Tensor) -> torch.Tensor:
    """``B = A_G @ M`` for fp32 ``M`` of shape ``(n, C)``; returns ``(n, C)`` fp32.

    Each call that launches the CUDA kernel adds one to
    ``spmm_blocked.launches`` and the number of device kernels it issued (1,
    or 2 with heavy rows: the reduction) to ``spmm_blocked.device_launches``;
    its scratch (one ``C``-wide row per heavy segment) is ``n_segments * C *
    4`` bytes.  A width whose launch counts would pass the kernel's 32-bit
    ints raises (:func:`check_int32_counts`).
    """
    if m.dim() != 2 or m.shape[0] != operand.n:
        raise ValueError(f"expected M of shape ({operand.n}, C), got {tuple(m.shape)}")
    if m.dtype != torch.float32:
        raise TypeError(f"spmm_blocked takes float32, got {m.dtype}")
    if m.device != operand.device:
        raise ValueError(f"M on {m.device} but the operand on {operand.device}")
    if m.device.type == "cpu":
        return spmm_ref(operand.src, operand.dst, operand.n, m)
    if m.device.type != "cuda":
        raise ValueError(f"spmm_blocked runs on cpu or cuda, not {m.device}")
    if not m.is_contiguous():
        raise ValueError("spmm_blocked needs a contiguous M")
    n, c = m.shape
    check_int32_counts(operand, c)
    part = operand.partition
    out = torch.empty((n, c), dtype=torch.float32, device=m.device)
    partials = torch.empty((part.n_segments, c), dtype=torch.float32, device=m.device)
    launched = ctypes.c_int(0)
    status = _library().spmm_blocked_launch(
        operand.row_ptr.data_ptr(),
        operand.src.data_ptr(),
        n,
        m.data_ptr(),
        c,
        out.data_ptr(),
        part.n_ranges,
        part.range_ptr.data_ptr(),
        part.heavy_slot.data_ptr(),
        part.n_heavy,
        part.heavy_rows.data_ptr(),
        part.seg_ptr.data_ptr(),
        part.n_segments,
        part.seg_beg.data_ptr(),
        part.seg_end.data_ptr(),
        partials.data_ptr(),
        torch.cuda.current_stream(m.device).cuda_stream,
        ctypes.byref(launched),
    )
    _build.check(status, "spmm_blocked")
    spmm_blocked.launches += 1
    spmm_blocked.device_launches += launched.value
    return out


spmm_blocked.launches = 0
spmm_blocked.device_launches = 0
