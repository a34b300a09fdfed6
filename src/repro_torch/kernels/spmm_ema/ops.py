"""Host side of the fused SpMM+eMA kernel: stage tables, geometry, wrapper.

A stage's split table ``(idx_a, idx_p)`` is re-bucketed once per stage by
passive-column tile of :data:`TILE_COLS` columns — per tile, per output row,
the ``(active column, passive column - tile start)`` entries in split order,
padded with ``-1`` (the layout of ``colorsets.bucketed_split_entries``,
flattened for the kernel).  The graph operand is the compact CSR of
:mod:`repro_torch.kernels.spmm_blocked.ops`.

On CPU tensors :func:`spmm_ema` runs the plain two-pass version
(:func:`repro_torch.kernels.spmm_ema.ref.spmm_ema_ref`); on CUDA tensors it
launches ``csrc/spmm_ema.cu`` or raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.spmm_blocked.ops import CompactOperand

from .ref import spmm_ema_ref

__all__ = [
    "FusedStageTables",
    "prepare_stage_tables",
    "kernel_geometry",
    "spmm_ema",
    "SOURCE",
    "TILE_COLS",
    "SMEM_BUDGET_BYTES",
]

SOURCE = Path(__file__).resolve().parent / "csrc" / "spmm_ema.cu"

#: Passive columns per tile; must equal ``kTileCols`` in ``csrc/spmm_ema.cu``.
TILE_COLS = 64

#: Shared memory one CTA may take (aggregate tile + output tile).  64 KiB
#: leaves room for three CTAs (24 warps) on an SM's 227 KiB.
SMEM_BUDGET_BYTES = 64 * 1024

#: Destination rows per CTA, tried widest first.
_ROW_CHOICES = (64, 32, 16, 8)


@dataclass(frozen=True)
class FusedStageTables:
    """One stage's split entries bucketed by passive tile, on a device."""

    n_out: int
    c_p: int
    c_a: int
    idx_a: torch.Tensor        # (n_out, n_splits) int64 — the plain table
    idx_p: torch.Tensor        # (n_out, n_splits) int64
    batch_lo: torch.Tensor     # (n_batches,) int32 — first passive column
    batch_cols: torch.Tensor   # (n_batches,) int32 — columns in the tile
    batch_width: torch.Tensor  # (n_batches,) int32 — entries per output row
    batch_off: torch.Tensor    # (n_batches,) int32 — offset into ent_a/ent_p
    ent_a: torch.Tensor        # flat int32, -1 marks a padded slot
    ent_p: torch.Tensor        # flat int32, passive column within the tile

    @property
    def n_batches(self) -> int:
        return int(self.batch_lo.shape[0])


def prepare_stage_tables(idx_a, idx_p, c_p: int, c_a: int, device) -> FusedStageTables:
    """Bucket ``(n_out, n_splits)`` split tables by :data:`TILE_COLS` tile.

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
    n_out = idx_a.shape[0]
    lo_l, cols_l, width_l, off_l, ea_l, ep_l = [], [], [], [], [], []
    off = 0
    for lo in range(0, c_p, TILE_COLS):
        cols = min(TILE_COLS, c_p - lo)
        sel = (idx_p >= lo) & (idx_p < lo + cols)
        width = int(sel.sum(axis=1).max(initial=0))
        if width == 0:
            continue
        slot = np.cumsum(sel, axis=1) - 1  # position of each entry in its row
        rows, ts = np.nonzero(sel)
        ea = np.full((n_out, width), -1, dtype=np.int32)
        ep = np.zeros((n_out, width), dtype=np.int32)
        ea[rows, slot[rows, ts]] = idx_a[rows, ts]
        ep[rows, slot[rows, ts]] = idx_p[rows, ts] - lo
        lo_l.append(lo)
        cols_l.append(cols)
        width_l.append(width)
        off_l.append(off)
        ea_l.append(ea.ravel())
        ep_l.append(ep.ravel())
        off += ea.size
    if off >= 2**31:
        raise ValueError("stage tables too large for int32 offsets")
    device = torch.device(device)

    def i32(values):
        return torch.as_tensor(np.asarray(values, dtype=np.int32), device=device)

    empty = np.zeros(0, dtype=np.int32)
    return FusedStageTables(
        n_out=n_out,
        c_p=int(c_p),
        c_a=int(c_a),
        idx_a=torch.as_tensor(idx_a, device=device),
        idx_p=torch.as_tensor(idx_p, device=device),
        batch_lo=i32(lo_l),
        batch_cols=i32(cols_l),
        batch_width=i32(width_l),
        batch_off=i32(off_l),
        ent_a=i32(np.concatenate(ea_l) if ea_l else empty),
        ent_p=i32(np.concatenate(ep_l) if ep_l else empty),
    )


def kernel_geometry(n_out: int) -> Tuple[int, int]:
    """``(rows per CTA, output columns per CTA)`` for a stage.

    The widest row block whose aggregate and output tiles fit the shared
    memory budget; past 8 rows the output columns are tiled instead (each
    output tile re-walks the edges).
    """
    for rows in _ROW_CHOICES:
        if rows * (TILE_COLS + n_out) * 4 <= SMEM_BUDGET_BYTES:
            return rows, n_out
    rows = _ROW_CHOICES[-1]
    return rows, SMEM_BUDGET_BYTES // (4 * rows) - TILE_COLS


def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.spmm_ema_launch
    if fn.argtypes is None:
        lib.spmm_ema_tile_cols.argtypes = []
        lib.spmm_ema_tile_cols.restype = ctypes.c_int
        if lib.spmm_ema_tile_cols() != TILE_COLS:
            raise RuntimeError("csrc/spmm_ema.cu was built with another tile width")
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, p, i, p, i, i, i, p, p, p, p, p, p, i, i, i, p, p]
        fn.restype = ctypes.c_int
    return lib


def spmm_ema(
    operand: CompactOperand,
    m_p: torch.Tensor,
    m_a: torch.Tensor,
    tables: FusedStageTables,
) -> torch.Tensor:
    """One fused DP stage: ``(n, B, C_p)``, ``(n, B, C_a)`` fp32 ->
    ``(n, B, n_out)`` fp32, without materialising ``A_G @ M_p``.

    Each launch of the CUDA kernel adds one to ``spmm_ema.launches``.
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
    if not (m_p.device == m_a.device == operand.device == tables.ent_a.device):
        raise ValueError("states, operand and tables must share one device")
    if m_p.device.type == "cpu":
        return spmm_ema_ref(
            operand.src, operand.dst, n, m_p, m_a, tables.idx_a, tables.idx_p
        )
    if m_p.device.type != "cuda":
        raise ValueError(f"spmm_ema runs on cpu or cuda, not {m_p.device}")
    if not (m_p.is_contiguous() and m_a.is_contiguous()):
        raise ValueError("spmm_ema needs contiguous states")
    bsz, c_a = m_p.shape[1], m_a.shape[2]
    rows, out_tile = kernel_geometry(tables.n_out)
    out = torch.empty((n, bsz, tables.n_out), dtype=torch.float32, device=m_p.device)
    status = _library().spmm_ema_launch(
        operand.row_ptr.data_ptr(),
        operand.src.data_ptr(),
        n,
        m_p.data_ptr(),
        tables.c_p,
        m_a.data_ptr(),
        c_a,
        bsz,
        tables.n_batches,
        tables.batch_lo.data_ptr(),
        tables.batch_cols.data_ptr(),
        tables.batch_width.data_ptr(),
        tables.batch_off.data_ptr(),
        tables.ent_a.data_ptr(),
        tables.ent_p.data_ptr(),
        tables.n_out,
        out_tile,
        rows,
        out.data_ptr(),
        torch.cuda.current_stream(m_p.device).cuda_stream,
    )
    _build.check(status, "spmm_ema")
    spmm_ema.launches += 1
    return out


spmm_ema.launches = 0
