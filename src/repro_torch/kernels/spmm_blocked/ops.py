"""The compact SpMM operand and the wrapper of the blocked SpMM kernel.

The reference pads every (dst-block, src-block) pair of a blocked-ELL
layout to the largest pair's edge count (``repro.core.graph.
build_blocked_ell``).  On an R-MAT graph one hub pair holds thousands of
edges while most pairs hold a few, so the padded operand of a graph with
2^20 vertices would be hundreds of GB.  The port's kernels read the edge
list in its canonical ``(dst, src)`` order instead, with CSR offsets per
destination vertex; a destination block of ``rows`` vertices owns the edge
range ``row_ptr[v0] : row_ptr[v0 + rows]``.

On a CPU tensor :func:`spmm_blocked` runs the plain version
(:func:`repro_torch.kernels.spmm_blocked.ref.spmm_ref`); on a CUDA tensor it
launches ``csrc/spmm_blocked.cu`` or raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import _build

from .ref import spmm_ref

__all__ = ["CompactOperand", "prepare_operand", "spmm_blocked", "SOURCE"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "spmm_blocked.cu"


@dataclass(frozen=True)
class CompactOperand:
    """A graph's edges sorted by ``(dst, src)`` plus CSR offsets, on a device.

    ``src`` / ``dst`` are ``(|E|,)`` int32 with both directions of every
    undirected edge; ``row_ptr`` is ``(n + 1,)`` int32, so the in-edges of
    vertex ``v`` are ``src[row_ptr[v]:row_ptr[v + 1]]``.
    """

    n: int
    src: torch.Tensor
    dst: torch.Tensor
    row_ptr: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.src.device

    @property
    def num_directed(self) -> int:
        return int(self.src.shape[0])


def prepare_operand(graph, device) -> CompactOperand:
    """Build the compact operand of ``graph`` (a ``repro_torch`` ``Graph``)."""
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
    )


def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.spmm_blocked_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, p, i, p, p]
        fn.restype = ctypes.c_int
    return lib


def spmm_blocked(operand: CompactOperand, m: torch.Tensor) -> torch.Tensor:
    """``B = A_G @ M`` for fp32 ``M`` of shape ``(n, C)``; returns ``(n, C)`` fp32.

    Each launch of the CUDA kernel adds one to ``spmm_blocked.launches``.
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
    out = torch.empty((n, c), dtype=torch.float32, device=m.device)
    status = _library().spmm_blocked_launch(
        operand.row_ptr.data_ptr(),
        operand.src.data_ptr(),
        n,
        m.data_ptr(),
        c,
        out.data_ptr(),
        torch.cuda.current_stream(m.device).cuda_stream,
    )
    _build.check(status, "spmm_blocked")
    spmm_blocked.launches += 1
    return out


spmm_blocked.launches = 0
