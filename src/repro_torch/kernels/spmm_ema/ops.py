"""Host side of the fused SpMM+eMA kernel: stage tables, geometry, wrapper.

A stage's split table ``(idx_a, idx_p)`` is prepared once per stage for
the kernel.  Where a row's passive aggregate and active state fit the
shared-memory budget (every stage of the templates up to u17), the kernel holds the whole
aggregate, and the table is packed: every output's ``(active column,
passive column)`` entries in split order, one int32 each (``active |
passive << 16``), stored split-major so that consecutive outputs' entries
are contiguous -- the single bucket of ``colorsets.bucketed_split_entries``
whose tile spans every passive column.  A wider stage (u20's reach
184,756 columns) is walked in passive tiles of :data:`WIDE_TILE_COLS`
columns, and its entries are bucketed by (tile, output), each bucket in
split order, as two int32 arrays.  The graph operand is the compact CSR of
:mod:`repro_torch.kernels.spmm_blocked.ops` with its edge-balanced
partition.

On CPU tensors :func:`spmm_ema` runs the plain two-pass version
(:func:`repro_torch.kernels.spmm_ema.ref.spmm_ema_ref`); on CUDA tensors it
launches ``csrc/spmm_ema.cu`` or raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.spmm_blocked import ops as blocked_ops
from repro_torch.kernels.spmm_blocked.ops import CompactOperand

from .ref import spmm_ema_ref

__all__ = [
    "FusedStageTables",
    "prepare_stage_tables",
    "kernel_geometry",
    "row_fits",
    "scratch_bytes",
    "check_int32_counts",
    "spmm_ema",
    "SOURCE",
    "SMEM_BUDGET_BYTES",
    "WIDE_TILE_COLS",
]

SOURCE = Path(__file__).resolve().parent / "csrc" / "spmm_ema.cu"

#: Shared memory one CTA may take: a pass's passive aggregate and active
#: state, rows x (C_p + C_a) floats.  112 KiB keeps two CTAs (16 warps) on
#: an SM's 228 KiB at u12's root stage (16 rows of 792 + 792 columns:
#: 99 KiB).
SMEM_BUDGET_BYTES = 112 * 1024

#: Passive columns a CTA holds at once on a stage whose row does not fit
#: the budget: a multiple of the 128-column warp walk; 16 rows of it take
#: 64 KiB.
WIDE_TILE_COLS = 1024


def row_fits(c_p: int, c_a: int) -> bool:
    """Whether one row's passive aggregate and active state fit the budget
    (the kernel then holds all ``C_p`` columns; else it walks tiles)."""
    return (c_p + c_a) * 4 <= SMEM_BUDGET_BYTES


@dataclass(frozen=True)
class FusedStageTables:
    """One stage's split table, plain and prepared for the kernel, on a device.

    ``ent`` is set where a row fits shared memory (:func:`row_fits`);
    otherwise the stage is wide, and passive tile ``pt`` (columns
    ``pt * tile_p`` on) has the buckets ``tile_ptr[pt] : tile_ptr[pt + 1]``,
    bucket ``j`` holding output ``bucket_out[j]``'s entries
    ``bucket_ptr[j] : bucket_ptr[j + 1]`` of ``bucket_a`` / ``bucket_p``.
    """

    n_out: int
    c_p: int
    c_a: int
    tile_p: int          # passive columns per tile (all of C_p when ent is set)
    idx_a: torch.Tensor  # (n_out, n_splits) int64 — the plain table
    idx_p: torch.Tensor  # (n_out, n_splits) int64
    ent: Optional[torch.Tensor] = None         # (n_splits, n_out) int32: (idx_a | idx_p << 16).T
    tile_ptr: Optional[torch.Tensor] = None    # (n_tiles + 1,) int32
    bucket_out: Optional[torch.Tensor] = None  # (n_buckets,) int32
    bucket_ptr: Optional[torch.Tensor] = None  # (n_buckets + 1,) int32
    bucket_a: Optional[torch.Tensor] = None    # (n_out * n_splits,) int32
    bucket_p: Optional[torch.Tensor] = None    # (n_out * n_splits,) int32

    @property
    def n_splits(self) -> int:
        return int(self.idx_a.shape[1])

    @property
    def wide(self) -> bool:
        return self.ent is None


def _buckets(idx_a, idx_p, c_p: int, tile: int):
    """The wide layout: entries sorted by (passive tile, output), split
    order kept inside each bucket; empty buckets left out."""
    n_out, n_splits = idx_a.shape
    if n_out * n_splits >= 2**31:
        raise ValueError("stage tables too large for int32 offsets")
    n_tiles = -(-c_p // tile)
    key = ((idx_p // tile) * n_out + np.arange(n_out)[:, None]).ravel()
    order = np.argsort(key, kind="stable")
    keys, starts = np.unique(key[order], return_index=True)
    bucket_ptr = np.append(starts, key.size)
    tile_ptr = np.searchsorted(keys // n_out, np.arange(n_tiles + 1))
    return (tile_ptr, keys % n_out, bucket_ptr,
            idx_a.ravel()[order], idx_p.ravel()[order])


def prepare_stage_tables(idx_a, idx_p, c_p: int, c_a: int, device) -> FusedStageTables:
    """Prepare ``(n_out, n_splits)`` split tables for the kernel: packed
    where a row fits shared memory, bucketed by passive tile where not.

    ``c_p`` / ``c_a`` are the passive / active state widths the tables
    index; every index is checked against them, because the kernel reads
    without bounds checks.
    """
    idx_a = np.asarray(idx_a, dtype=np.int64)
    idx_p = np.asarray(idx_p, dtype=np.int64)
    if idx_a.shape != idx_p.shape or idx_a.ndim != 2:
        raise ValueError("idx_a and idx_p must be (n_out, n_splits) arrays")
    if idx_a.size and not (
        0 <= idx_a.min() and idx_a.max() < c_a and 0 <= idx_p.min() and idx_p.max() < c_p
    ):
        raise ValueError(f"split indices outside C_a={c_a} / C_p={c_p}")
    device = torch.device(device)

    def i32(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=device)

    plain = dict(n_out=idx_a.shape[0], c_p=int(c_p), c_a=int(c_a),
                 idx_a=torch.as_tensor(idx_a, device=device),
                 idx_p=torch.as_tensor(idx_p, device=device))
    if row_fits(c_p, c_a):  # then C_a, C_p < 2^15: the packing holds
        return FusedStageTables(tile_p=int(c_p), ent=i32((idx_a | idx_p << 16).T), **plain)
    tile = min(int(c_p), WIDE_TILE_COLS)
    if tile < c_p and tile % 128:
        raise ValueError(f"WIDE_TILE_COLS={WIDE_TILE_COLS} is no multiple of the 128-column walk")
    tile_ptr, bucket_out, bucket_ptr, bucket_a, bucket_p = _buckets(idx_a, idx_p, int(c_p), tile)
    return FusedStageTables(
        tile_p=tile, tile_ptr=i32(tile_ptr), bucket_out=i32(bucket_out),
        bucket_ptr=i32(bucket_ptr), bucket_a=i32(bucket_a), bucket_p=i32(bucket_p), **plain)


def kernel_geometry(c_p: int, c_a: int, range_rows: int) -> int:
    """Rows per pass of a light range: the whole range when its shared
    state fits :data:`SMEM_BUDGET_BYTES`, else as many rows as fit (each
    pass walks its rows' edges for every passive tile).  The shared state of
    a row is its passive aggregate and active state where :func:`row_fits`,
    else one passive tile of ``min(C_p, WIDE_TILE_COLS)`` columns."""
    floats = c_p + c_a if row_fits(c_p, c_a) else min(c_p, WIDE_TILE_COLS)
    return _rows_per_pass(floats, range_rows)


def _rows_per_pass(row_floats: int, range_rows: int) -> int:
    rows = min(range_rows, SMEM_BUDGET_BYTES // (row_floats * 4))
    if rows < 1:
        raise ValueError(f"a row's {row_floats} shared floats exceed the shared memory budget")
    return rows


def scratch_bytes(operand: CompactOperand, bsz: int, c_p: int) -> int:
    """Device scratch of one launch: the heavy segments' partial aggregates
    and the heavy rows' aggregates, ``B * C_p`` floats each."""
    part = operand.partition
    return (part.n_segments + part.n_heavy) * bsz * c_p * 4 if part.n_heavy else 0


#: Most colorings one launch takes: they are the grid's y dimension.
MAX_GRID_Y = 65_535


def check_int32_counts(operand: CompactOperand, bsz: int, tables: FusedStageTables) -> Dict[str, int]:
    """The counts a launch of ``csrc/spmm_ema.cu`` over ``bsz`` colorings
    of a stage holds in 32-bit ``int``s; raises ``ValueError`` naming the
    first that does not fit, so that none wraps.

    The heavy rows' aggregate runs over ``B * C_p`` columns: its column
    index runs to that plus one tile, each segment is one warp item per
    column tile, and the grid is those items in blocks of 8.  The light and
    wide kernels' grid is the light ranges by the colorings (the grid's y
    dimension, at most :data:`MAX_GRID_Y`); a CTA walks a pass's rows times
    the column tiles of its passive tile, writes its rows' outputs, and
    indexes the passive state up to ``C_p`` plus one tile.  The split
    entries are indexed by output and split.  Row and state offsets are
    64-bit already.
    """
    part = operand.partition
    c_p, int32_max = tables.c_p, blocked_ops.INT32_MAX
    heavy_cols = bsz * c_p
    heavy_items = part.n_segments * -(-heavy_cols // blocked_ops.tile_width(heavy_cols))
    rows_pass = _rows_per_pass(tables.tile_p if tables.wide else c_p + tables.c_a,
                               blocked_ops.RANGE_ROWS)
    counts = (
        ("heavy column index (B x C_p + one tile)", heavy_cols + 128, int32_max),
        ("heavy items (segments x column tiles)",
         heavy_items + blocked_ops.KERNEL_WARPS, int32_max),
        ("heavy grid (blocks of 8 items)", -(-heavy_items // blocked_ops.KERNEL_WARPS), int32_max),
        ("light grid (ranges)", part.n_ranges, int32_max),
        ("grid y (colorings)", bsz, MAX_GRID_Y),
        ("light-range items (rows x column tiles)",
         rows_pass * -(-tables.tile_p // blocked_ops.tile_width(c_p)), int32_max),
        ("light-range outputs (rows x outputs)", rows_pass * tables.n_out, int32_max),
        ("passive column index (C_p + one tile)", c_p + tables.tile_p, int32_max),
        ("split entries (outputs x splits)", tables.n_out * tables.n_splits, int32_max),
    )
    for what, value, limit in counts:
        if value > limit:
            raise ValueError(
                f"spmm_ema cannot launch at B={bsz}, C_p={c_p}, C_a={tables.c_a}, "
                f"n_out={tables.n_out}: its {what} would be {value}, past the kernel's "
                f"limit ({limit}); split the chunk or the stage"
            )
    return {what: value for what, value, _ in counts}


def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.spmm_ema_launch
    if fn.argtypes is None:
        blocked_ops.check_schedule(lib)
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, p, i, p, i, i, p, i, i, i, i, p, p, i, p, i, p, p, p, p,
                       p, p, p, p, p, i, p, p, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    return lib


def spmm_ema(
    operand: CompactOperand,
    m_p: torch.Tensor,
    m_a: torch.Tensor,
    tables: FusedStageTables,
) -> torch.Tensor:
    """One fused DP stage: ``(n, B, C_p)``, ``(n, B, C_a)`` fp32 ->
    ``(n, B, n_out)`` fp32, without materialising ``A_G @ M_p`` outside the
    heavy rows (:func:`scratch_bytes`).

    Each call that launches the CUDA kernel adds one to
    ``spmm_ema.launches`` and the number of device kernels it issued (1, or
    3 with heavy rows: their segments and reduction) to
    ``spmm_ema.device_launches``.  A launch whose 32-bit counts would
    wrap raises (:func:`check_int32_counts`).
    """
    n = operand.n
    if m_p.dim() != 3 or m_a.dim() != 3:
        raise ValueError("spmm_ema takes (n, B, C) states")
    if m_p.shape[0] != n or m_a.shape[0] != n or m_p.shape[1] != m_a.shape[1]:
        raise ValueError(
            f"state shapes {tuple(m_p.shape)} / {tuple(m_a.shape)} do not fit n={n}"
        )
    if m_p.shape[2] != tables.c_p or m_a.shape[2] != tables.c_a:
        raise ValueError(
            f"states have {m_p.shape[2]} / {m_a.shape[2]} columns, "
            f"the tables {tables.c_p} / {tables.c_a}"
        )
    if m_p.dtype != torch.float32 or m_a.dtype != torch.float32:
        raise TypeError(f"spmm_ema takes float32, got {m_p.dtype} / {m_a.dtype}")
    if not (m_p.device == m_a.device == operand.device == tables.idx_a.device):
        raise ValueError("states, operand and tables must share one device")
    if m_p.device.type == "cpu":
        return spmm_ema_ref(
            operand.src, operand.dst, n, m_p, m_a, tables.idx_a, tables.idx_p
        )
    if m_p.device.type != "cuda":
        raise ValueError(f"spmm_ema runs on cpu or cuda, not {m_p.device}")
    if not (m_p.is_contiguous() and m_a.is_contiguous()):
        raise ValueError("spmm_ema needs contiguous states")
    bsz, c_p, c_a = m_p.shape[1], tables.c_p, tables.c_a
    check_int32_counts(operand, bsz, tables)
    part = operand.partition
    rows_pass = _rows_per_pass(tables.tile_p if tables.wide else c_p + c_a,
                               blocked_ops.RANGE_ROWS)
    out = torch.empty((n, bsz, tables.n_out), dtype=torch.float32, device=m_p.device)
    width = bsz * c_p if part.n_heavy else 0
    partials = torch.empty((part.n_segments, width), dtype=torch.float32, device=m_p.device)
    heavy_agg = torch.empty((part.n_heavy, width), dtype=torch.float32, device=m_p.device)
    launched = ctypes.c_int(0)

    def ptr(t):
        return None if t is None else t.data_ptr()

    status = _library().spmm_ema_launch(
        operand.row_ptr.data_ptr(),
        operand.src.data_ptr(),
        n,
        m_p.data_ptr(),
        c_p,
        m_a.data_ptr(),
        c_a,
        bsz,
        ptr(tables.ent),
        tables.n_splits,
        tables.n_out,
        rows_pass,
        part.n_ranges,
        part.range_ptr.data_ptr(),
        part.heavy_slot.data_ptr(),
        part.n_heavy,
        part.seg_ptr.data_ptr(),
        part.n_segments,
        part.seg_beg.data_ptr(),
        part.seg_end.data_ptr(),
        partials.data_ptr(),
        heavy_agg.data_ptr(),
        ptr(tables.tile_ptr),
        ptr(tables.bucket_out),
        ptr(tables.bucket_ptr),
        ptr(tables.bucket_a),
        ptr(tables.bucket_p),
        tables.tile_p,
        out.data_ptr(),
        torch.cuda.current_stream(m_p.device).cuda_stream,
        ctypes.byref(launched),
    )
    _build.check(status, "spmm_ema")
    spmm_ema.launches += 1
    spmm_ema.device_launches += launched.value
    return out


spmm_ema.launches = 0
spmm_ema.device_launches = 0
