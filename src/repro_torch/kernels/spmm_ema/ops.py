"""Host side of the fused SpMM+eMA kernel: stage tables, geometry, wrapper.

A stage's split table ``(idx_a, idx_p)`` is prepared once per stage for
the kernel, by one of two routes:

* ``shared`` (every stage of the templates up to u17): a row's passive
  aggregate and active state fit :data:`SMEM_BUDGET_BYTES`; the kernel
  holds whole rows, and the table is packed: every output's ``(active
  column, passive column)`` entries in split order, one int32 each
  (``active | passive << 16``), stored split-major so that consecutive
  outputs' entries are contiguous -- the single bucket of
  ``colorsets.bucketed_split_entries`` whose tile spans every passive
  column.
* ``streamed`` (the wide stages: u18's two, u20's four, up to 184,756
  passive columns): a :class:`WidePlan` cuts the outputs into groups and
  each group's split entries into pieces in split order, each piece with
  its active and passive support (the columns its entries read) small
  enough that :data:`WIDE_ROWS` rows of it fit :data:`WIDE_SMEM_BYTES`
  (local positions below 2^16, read as unsigned halves).  The kernel
  writes the aggregate and the active state of a block of rows into a
  device scratch, vertex axis fastest, then per (group, :data:`WIDE_ROWS`
  rows) stages each piece's supports in shared memory and accumulates the
  group's outputs in registers, writing each once.

The graph operand is the compact CSR of
:mod:`repro_torch.kernels.spmm_blocked.ops` with its edge-balanced
partition.  On CPU tensors :func:`spmm_ema` runs the plain two-pass version
(:func:`repro_torch.kernels.spmm_ema.ref.spmm_ema_ref`); on CUDA tensors it
launches ``csrc/spmm_ema.cu`` or raises.

The same library holds the bag eMA (:func:`bag_ema`): a non-tree bag
op's colorset update, the eMA above without the SpMM, over states of any
number of vertex axes read through their strides, with the op's adjacency
masks read inside the kernel.  It runs only on a card: it has no plain
version of its own, since the executor's per-term loop, which runs the
update everywhere else, gives the same bits.  :func:`bag_ema_refusal`
says why a launch would not be taken (off a card, not fp32, past the
kernel's limits); the executor then runs its loop.

The wide path can be forced at small widths by lowering the module
constants: :data:`SMEM_BUDGET_BYTES` below a row's ``(C_p + C_a) * 4``
bytes sends a stage to it, :data:`WIDE_SMEM_BYTES` caps a piece's
supports at ``WIDE_SMEM_BYTES / 16`` columns, and :data:`WIDE_GROUP_MAX` /
:data:`WIDE_SCRATCH_BYTES` set the group size and the rows per scratch
block.
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
    "WidePlan",
    "prepare_stage_tables",
    "stage_route",
    "plan_wide_stage",
    "kernel_geometry",
    "row_fits",
    "block_rows",
    "scratch_bytes",
    "check_int32_counts",
    "spmm_ema",
    "SOURCE",
    "SMEM_BUDGET_BYTES",
    "WIDE_SMEM_BYTES",
    "WIDE_ROWS",
    "WIDE_GROUP_MAX",
    "WIDE_SCRATCH_BYTES",
    "WIDE_THREADS",
    "wave_blocks",
    "pack_bag_entries",
    "bag_ema_refusal",
    "bag_ema",
    "BAG_MAX_AXES",
    "BAG_MAX_ENTRIES",
]

SOURCE = Path(__file__).resolve().parent / "csrc" / "spmm_ema.cu"

#: Shared memory one CTA may take: a pass's passive aggregate and active
#: state, rows x (C_p + C_a) floats.  112 KiB keeps two CTAs (16 warps) on
#: an SM's 228 KiB at u12's root stage (16 rows of 792 + 792 columns:
#: 99 KiB).
SMEM_BUDGET_BYTES = 112 * 1024

#: Shared memory one eMA block of the wide path may take: all a Hopper
#: block can (227 KB of the SM's 256 KB), one block per SM.
WIDE_SMEM_BYTES = 232_448

#: Threads of a wide eMA block (``kWideThreads`` in the source).
WIDE_THREADS = 1024

#: Rows one streamed eMA block holds: a float4 of them per staged column,
#: so each split entry serves four FMAs (fixed by the kernel's layout).
WIDE_ROWS = 4

#: Most outputs of one streamed group (at most four per thread of an eMA
#: block: each thread holds four (output, 4-row) float4 accumulators).
WIDE_GROUP_MAX = 4 * WIDE_THREADS

#: Device scratch of a streamed stage: one block of rows' aggregate and
#: active state, ``rows x (C_p + C_a)`` floats (the vertex axis fastest
#: within each 4-row sub-block); a stage walks its rows in blocks of this
#: size.
WIDE_SCRATCH_BYTES = 1 << 30

#: Sub-blocks of the eMA grid's tiles where a streamed stage's split
#: entries pass half the card's L2: all groups take a tile of sub-blocks
#: in turn, so the table is read once per tile instead of once per
#: sub-block (a table that fits stays in L2 under tiles of one).
WIDE_SUB_TILE = 16

#: The routes, in the order of the source's ``route`` argument.
ROUTES = ("shared", "streamed")


def row_fits(c_p: int, c_a: int) -> bool:
    """Whether one row's passive aggregate and active state fit the budget
    of the shared-memory path (else the stage takes the wide path)."""
    return (c_p + c_a) * 4 <= SMEM_BUDGET_BYTES


def stage_route(c_p: int, c_a: int) -> str:
    """``shared`` where a row fits the shared-memory path's budget, else
    ``streamed`` (see the module docstring)."""
    return "shared" if row_fits(c_p, c_a) else "streamed"


def wave_blocks(device) -> int:
    """Wide eMA blocks one wave holds on ``device``: one per SM of a card,
    0 (no cut to waves) elsewhere."""
    device = torch.device(device)
    if device.type != "cuda":
        return 0
    return torch.cuda.get_device_properties(device).multi_processor_count


@dataclass(frozen=True)
class WidePlan:
    """A streamed stage's groups and pieces, on a device.

    Group ``g`` holds outputs ``group_out[g] : group_out[g + 1]`` and the
    pieces ``group_piece[g] : group_piece[g + 1]``.  Piece ``j`` takes, of
    every output of its group, the same run of consecutive splits, so an
    output's entries are summed in split order, piece after piece.  Its
    supports are the sorted active columns ``sup_a[piece_sa[j] :
    piece_sa[j + 1]]`` and passive columns ``sup_p[piece_sp[j] :
    piece_sp[j + 1]]`` its entries read; its entries are
    ``ent[piece_ent[j] : piece_ent[j + 1]]``, split-major (entry ``t`` of
    the group's outputs contiguous), each ``la | lp << 16`` with ``la`` /
    ``lp`` positions in those supports, read as unsigned.
    """

    group_out: torch.Tensor    # (n_groups + 1,) int32
    group_piece: torch.Tensor  # (n_groups + 1,) int32
    piece_ent: torch.Tensor    # (n_pieces + 1,) int32
    piece_sa: torch.Tensor     # (n_pieces + 1,) int32
    piece_sp: torch.Tensor     # (n_pieces + 1,) int32
    sup_a: torch.Tensor        # int32 active columns
    sup_p: torch.Tensor        # int32 passive columns
    max_group: int             # outputs of the largest group
    max_support: int           # columns of the largest piece's supports
    staged_columns: int        # columns staged per row: all pieces' supports

    @property
    def n_groups(self) -> int:
        return int(self.group_out.numel()) - 1

    @property
    def n_pieces(self) -> int:
        return int(self.piece_ent.numel()) - 1

    @property
    def smem_bytes(self) -> int:
        """Shared bytes of one eMA block: the largest piece's supports, a
        float4 of :data:`WIDE_ROWS` rows per column."""
        return self.max_support * WIDE_ROWS * 4


@dataclass(frozen=True)
class FusedStageTables:
    """One stage's split table, plain and prepared for the kernel, on a device.

    ``route`` is :func:`stage_route`'s.  ``ent`` is the packed split-major
    table (``shared``), or the plan's local entries (``streamed``, with
    ``plan`` set).
    """

    n_out: int
    c_p: int
    c_a: int
    route: str
    idx_a: torch.Tensor  # (n_out, n_splits) int64 — the plain table
    idx_p: torch.Tensor  # (n_out, n_splits) int64
    ent: torch.Tensor    # int32: (idx_a | idx_p << 16).T, or the plan's entries
    plan: Optional[WidePlan] = None

    @property
    def n_splits(self) -> int:
        return int(self.idx_a.shape[1])

    @property
    def wide(self) -> bool:
        return self.route != "shared"


def _distinct(cols, seen, stamp, slot):
    """The columns of ``cols`` not yet stamped ``stamp`` in ``seen``, each
    once (``slot``: scratch of ``seen``'s size; the last write of a
    repeated column wins, so one position per column matches)."""
    fresh = cols[seen[cols] != stamp]
    slot[fresh] = np.arange(fresh.size)
    return fresh[slot[fresh] == np.arange(fresh.size)]


def _greedy_pieces(a, p, c_a: int, c_p: int, cap: int):
    """Cut one group's ``(G, S)`` entries into runs of splits ``[t0, t1)``
    whose supports (distinct active plus passive columns) stay within
    ``cap``: each run grows a split at a time while it fits.  Returns the
    runs and the columns they stage, or None where one split alone is past
    the cap."""
    seen_a, slot_a = np.full(c_a, -1, np.int64), np.empty(c_a, np.int64)
    seen_p, slot_p = np.full(c_p, -1, np.int64), np.empty(c_p, np.int64)
    runs, t0, size, staged = [], 0, 0, 0
    for t in range(a.shape[1]):
        new_a = _distinct(a[:, t], seen_a, t0, slot_a)
        new_p = _distinct(p[:, t], seen_p, t0, slot_p)
        if size + new_a.size + new_p.size > cap and t > t0:
            runs.append((t0, t))
            staged += size
            t0, size = t, 0
            new_a = _distinct(a[:, t], seen_a, t0, slot_a)
            new_p = _distinct(p[:, t], seen_p, t0, slot_p)
        if new_a.size + new_p.size > cap:
            return None
        seen_a[new_a], seen_p[new_p] = t0, t0  # stamped with the run's first split
        size += new_a.size + new_p.size
    runs.append((t0, a.shape[1]))
    return runs, staged + size


def plan_wide_stage(idx_a, idx_p, c_p: int, c_a: int):
    """The streamed plan's numpy arrays: groups of at most
    :data:`WIDE_GROUP_MAX` consecutive outputs (colex order), each cut by
    :func:`_greedy_pieces` under the support cap of
    :data:`WIDE_SMEM_BYTES`.  Of the group sizes ``WIDE_GROUP_MAX / 2**i``
    (i < 4), the one that stages the fewest columns per row wins (the
    larger on a tie).  Returns a dict of the :class:`WidePlan` fields."""
    idx_a = np.asarray(idx_a, dtype=np.int64)
    idx_p = np.asarray(idx_p, dtype=np.int64)
    n_out = idx_a.shape[0]
    cap = WIDE_SMEM_BYTES // (WIDE_ROWS * 4)
    if cap >= 1 << 16:
        raise ValueError(f"a support of {cap} columns passes the 16-bit local index")
    best = None
    for size in sorted({min(n_out, max(1, WIDE_GROUP_MAX >> i)) for i in range(4)},
                       reverse=True):
        groups, staged = [], 0
        for o0 in range(0, n_out, size):
            cut = _greedy_pieces(idx_a[o0:o0 + size], idx_p[o0:o0 + size], c_a, c_p, cap)
            if cut is None:
                break
            groups.append((o0, cut[0]))
            staged += cut[1]
        else:
            if best is None or staged < best[0]:
                best = (staged, size, groups)
    if best is None:
        raise ValueError(f"no group of outputs fits {WIDE_SMEM_BYTES} shared bytes")
    staged, size, groups = best
    group_out, group_piece = [0], [0]
    piece_ent, piece_sa, piece_sp = [0], [0], [0]
    sup_a, sup_p, ents = [], [], []
    max_support = 0
    pos_a, pos_p = np.empty(c_a, np.int64), np.empty(c_p, np.int64)
    for o0, runs in groups:
        o1 = min(n_out, o0 + size)
        for t0, t1 in runs:
            a, p = idx_a[o0:o1, t0:t1], idx_p[o0:o1, t0:t1]
            ua, up = np.unique(a), np.unique(p)
            pos_a[ua], pos_p[up] = np.arange(ua.size), np.arange(up.size)
            local = pos_a[a] | pos_p[p] << 16
            ents.append(local.T.ravel())
            sup_a.append(ua)
            sup_p.append(up)
            piece_ent.append(piece_ent[-1] + local.size)
            piece_sa.append(piece_sa[-1] + ua.size)
            piece_sp.append(piece_sp[-1] + up.size)
            max_support = max(max_support, ua.size + up.size)
        group_out.append(o1)
        group_piece.append(len(piece_ent) - 1)
    return dict(group_out=group_out, group_piece=group_piece, piece_ent=piece_ent,
                piece_sa=piece_sa, piece_sp=piece_sp, sup_a=np.concatenate(sup_a),
                sup_p=np.concatenate(sup_p),
                ent=np.concatenate(ents).astype(np.uint32).view(np.int32),
                max_group=min(size, n_out), max_support=max_support, staged_columns=staged)


def prepare_stage_tables(idx_a, idx_p, c_p: int, c_a: int, device) -> FusedStageTables:
    """Prepare ``(n_out, n_splits)`` split tables for the kernel: packed
    where a row fits the shared-memory path's budget, planned in groups and
    pieces where not (:func:`stage_route`).

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
    if idx_a.size >= 2**31:
        raise ValueError("stage tables too large for int32 offsets")
    device = torch.device(device)

    def i32(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=device)

    route = stage_route(c_p, c_a)
    plain = dict(n_out=idx_a.shape[0], c_p=int(c_p), c_a=int(c_a), route=route,
                 idx_a=torch.as_tensor(idx_a, device=device),
                 idx_p=torch.as_tensor(idx_p, device=device))
    if route == "shared":  # C_a, C_p < 2^15 here: the signed halves hold
        packed = (idx_a | idx_p << 16).T.astype(np.uint32).view(np.int32)
        return FusedStageTables(ent=i32(packed), **plain)
    arrays = plan_wide_stage(idx_a, idx_p, c_p, c_a)
    plan = WidePlan(**{k: i32(arrays[k]) for k in (
        "group_out", "group_piece", "piece_ent", "piece_sa", "piece_sp", "sup_a", "sup_p")},
        max_group=arrays["max_group"], max_support=arrays["max_support"],
        staged_columns=arrays["staged_columns"])
    return FusedStageTables(ent=i32(arrays["ent"]), plan=plan, **plain)


def kernel_geometry(c_p: int, c_a: int, range_rows: int) -> int:
    """Rows per pass of a light range: the whole range when its shared
    state fits :data:`SMEM_BUDGET_BYTES`, else as many rows as fit; a
    streamed stage's eMA block holds :data:`WIDE_ROWS` rows."""
    if stage_route(c_p, c_a) == "streamed":
        return WIDE_ROWS
    return _rows_per_pass(c_p + c_a, range_rows)


def _rows_per_pass(row_floats: int, range_rows: int) -> int:
    rows = min(range_rows, SMEM_BUDGET_BYTES // (row_floats * 4))
    if rows < 1:
        raise ValueError(
            f"a row's {row_floats} shared floats exceed {SMEM_BUDGET_BYTES} shared bytes")
    return rows


def block_rows(n_rows: int, row_floats: int, n_groups: int = 1, waves_of: int = 0) -> int:
    """State rows (vertex x coloring) of one block of a streamed stage: as
    many whole sub-blocks of :data:`WIDE_ROWS` as the scratch holds of
    ``row_floats`` floats per row (at least one), at most all rows.  Where
    the rows take several blocks, a block's ``n_groups x sub-blocks`` eMA
    blocks are cut down to whole waves of ``waves_of`` blocks (the card's
    SMs, :func:`wave_blocks`; 0: no cut)."""
    total = -(-n_rows // WIDE_ROWS)
    sub = min(max(WIDE_SCRATCH_BYTES // (WIDE_ROWS * row_floats * 4), 1), total)
    waves = n_groups * sub // waves_of if waves_of else 0
    if sub < total and waves:
        sub = max(1, waves * waves_of // n_groups)
    return sub * WIDE_ROWS


def scratch_bytes(operand: CompactOperand, bsz: int, c_p: int,
                  tables: Optional[FusedStageTables] = None) -> int:
    """Device scratch of one launch: the heavy segments' partial aggregates
    and the heavy rows' aggregates, ``B * C_p`` floats each, and on a
    streamed stage one block's aggregate and active state
    (:func:`block_rows` on the operand's device x ``(C_p + C_a)``)."""
    part = operand.partition
    heavy = (part.n_segments + part.n_heavy) * bsz * c_p * 4 if part.n_heavy else 0
    if tables is None or tables.route != "streamed":
        return heavy
    return heavy + _stream_rows(operand, bsz, tables) * (c_p + tables.c_a) * 4


def _stream_rows(operand: CompactOperand, bsz: int, tables: FusedStageTables) -> int:
    return block_rows(operand.n * bsz, tables.c_p + tables.c_a, tables.plan.n_groups,
                      wave_blocks(operand.device))


#: Most colorings one launch takes: they are the grid's y dimension.
MAX_GRID_Y = 65_535


def check_int32_counts(operand: CompactOperand, bsz: int, tables: FusedStageTables) -> Dict[str, int]:
    """The counts a launch of ``csrc/spmm_ema.cu`` over ``bsz`` colorings
    of a stage holds in 32-bit ``int``s; raises ``ValueError`` naming the
    first that does not fit, so that none wraps.

    The heavy rows' aggregate runs over ``B * C_p`` columns: its column
    index runs to that plus one tile, each segment is one warp item per
    column tile, and the grid is those items in blocks of 8.  The
    ``shared`` kernel's grid is the light ranges by the colorings (the
    grid's y dimension, at most :data:`MAX_GRID_Y`); a CTA
    walks a pass's rows times the column tiles of ``C_p``, writes its rows'
    outputs, and indexes the passive state up to ``C_p`` plus one tile.  A
    ``streamed`` launch indexes the state rows (``n x B``), fills a block's
    aggregate and active state as (sub-block, column tile) warp items,
    runs its eMA over a 1-D grid of (group, sub-block) blocks, and indexes
    the plan's supports.  The split entries are indexed by output and
    split.  Row, state and scratch offsets are 64-bit already.
    """
    part = operand.partition
    c_p, int32_max = tables.c_p, blocked_ops.INT32_MAX
    heavy_cols = bsz * c_p
    heavy_items = part.n_segments * -(-heavy_cols // blocked_ops.tile_width(heavy_cols))
    tiles = -(-c_p // blocked_ops.tile_width(c_p))
    counts = [
        ("heavy column index (B x C_p + one tile)", heavy_cols + 128, int32_max),
        ("heavy items (segments x column tiles)",
         heavy_items + blocked_ops.KERNEL_WARPS, int32_max),
        ("heavy grid (blocks of 8 items)", -(-heavy_items // blocked_ops.KERNEL_WARPS), int32_max),
    ]
    if tables.route == "streamed":
        plan = tables.plan
        n_rows = operand.n * bsz
        rows = _stream_rows(operand, bsz, tables)
        items = rows // WIDE_ROWS * (tiles + -(-tables.c_a // 128))
        counts += [
            ("state rows (n x B + one sub-block)", n_rows + WIDE_ROWS, int32_max),
            ("fill items (sub-blocks x passive and active column tiles)",
             items + blocked_ops.KERNEL_WARPS, int32_max),
            ("eMA grid (groups x sub-blocks of a block)", plan.n_groups * rows // WIDE_ROWS,
             int32_max),
            ("support columns (all pieces)", int(plan.sup_a.numel() + plan.sup_p.numel()),
             int32_max),
        ]
    else:
        rows_pass = _rows_per_pass(c_p + tables.c_a, blocked_ops.RANGE_ROWS)
        counts += [
            ("light grid (ranges)", part.n_ranges, int32_max),
            ("grid y (colorings)", bsz, MAX_GRID_Y),
            ("light-range items (rows x column tiles)", rows_pass * tiles, int32_max),
            ("light-range outputs (rows x outputs)", rows_pass * tables.n_out, int32_max),
            ("passive column index (C_p + one tile)", c_p + 128, int32_max),
        ]
    counts.append(("split entries (outputs x splits)", tables.n_out * tables.n_splits, int32_max))
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
        built = (lib.spmm_ema_wide_threads(), lib.spmm_ema_wide_rows())
        if built != (WIDE_THREADS, WIDE_ROWS):
            raise RuntimeError(f"the library's wide eMA blocks are {built} (threads, rows), "
                               f"the host plans {(WIDE_THREADS, WIDE_ROWS)}")
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, p, i, p, i, i, p, i, i, i, i, p, p, i, p, i, p, p, p, p,
                       i, i, p, p, p, p, p, p, p, i, i, p, p, p, ctypes.POINTER(ctypes.c_int)]
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
    heavy rows and, on a streamed stage, one block of rows
    (:func:`scratch_bytes`).

    Each call that launches the CUDA kernel adds one to
    ``spmm_ema.launches`` and the number of device kernels it issued to
    ``spmm_ema.device_launches``: 1 on the ``shared`` route, 2 per block of rows (fill, eMA) on the ``streamed`` one, 2 more
    with heavy rows (their segments and reduction).  A launch whose 32-bit
    counts would wrap raises (:func:`check_int32_counts`).
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
    dev = m_p.device
    out = torch.empty((n, bsz, tables.n_out), dtype=torch.float32, device=dev)
    width = bsz * c_p if part.n_heavy else 0
    partials = torch.empty((part.n_segments, width), dtype=torch.float32, device=dev)
    heavy_agg = torch.empty((part.n_heavy, width), dtype=torch.float32, device=dev)
    plan = tables.plan
    route = ROUTES.index(tables.route)
    sub_tile = 1
    if plan is None:
        rows = _rows_per_pass(c_p + c_a, blocked_ops.RANGE_ROWS)
        smem = rows * (c_p + c_a) * 4
        scratch = None
    else:
        rows = _stream_rows(operand, bsz, tables)
        smem = plan.smem_bytes
        scratch = torch.empty((rows * (c_p + c_a),), dtype=torch.float32, device=dev)
        if tables.ent.numel() * 4 > torch.cuda.get_device_properties(dev).L2_cache_size // 2:
            sub_tile = WIDE_SUB_TILE
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
        tables.ent.data_ptr(),
        tables.n_splits,
        tables.n_out,
        rows,
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
        route,
        0 if plan is None else plan.n_groups,
        ptr(plan and plan.group_out),
        ptr(plan and plan.group_piece),
        ptr(plan and plan.piece_ent),
        ptr(plan and plan.piece_sa),
        ptr(plan and plan.piece_sp),
        ptr(plan and plan.sup_a),
        ptr(plan and plan.sup_p),
        smem,
        sub_tile,
        ptr(scratch),
        out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
        ctypes.byref(launched),
    )
    _build.check(status, "spmm_ema")
    spmm_ema.launches += 1
    spmm_ema.device_launches += launched.value
    return out


spmm_ema.launches = 0
spmm_ema.device_launches = 0


#: Most vertex axes of a bag eMA operand (``kBagMaxAxes`` in the source;
#: the 6-vertex graphlets' bag states have up to 5).
BAG_MAX_AXES = 6

#: Most term-table entries (``n_terms x n_out``) one bag eMA launch holds
#: in shared memory.
BAG_MAX_ENTRIES = 4096


def pack_bag_entries(idx_a, idx_p, device) -> Optional[torch.Tensor]:
    """A bag op's term-major ``(n_terms, n_out)`` rank tables as the bag
    eMA reads them: one int32 ``ia | ip << 16`` per entry, term-major; None
    where a rank passes 2^15 - 1 (the op then takes the executor's loop)."""
    idx_a = np.asarray(idx_a, dtype=np.int64)
    idx_p = np.asarray(idx_p, dtype=np.int64)
    if idx_a.shape != idx_p.shape or idx_a.ndim != 2:
        raise ValueError("idx_a and idx_p must be (n_terms, n_out) arrays")
    if idx_a.size and min(idx_a.min(), idx_p.min()) < 0:
        raise ValueError("bag table ranks must be >= 0")
    if idx_a.size and max(idx_a.max(), idx_p.max()) >= 1 << 15:
        return None
    packed = np.ascontiguousarray(idx_a | idx_p << 16, dtype=np.int32)
    return torch.as_tensor(packed, device=device)


def bag_ema_refusal(a: torch.Tensor, p: torch.Tensor, ent: Optional[torch.Tensor],
                    mask_axes=(), adj: Optional[torch.Tensor] = None) -> Optional[str]:
    """Why :func:`bag_ema` would not launch the kernel on these operands and
    packed table ``ent`` (None: it would).  The executor loops where this
    gives a reason: on the CPU, for a dtype other than float32 (a bf16
    store), and past the kernel's limits (ranks of 2^15 or more, which
    :func:`pack_bag_entries` does not pack, :data:`BAG_MAX_AXES`,
    :data:`BAG_MAX_ENTRIES`, 2^31 vertex tuples)."""
    if p.device.type != "cuda":
        return f"runs on a card, not {p.device.type}"
    if ent is None:
        return "the op's table has ranks of 2^15 or more"
    used = [a, p] + ([adj] if mask_axes else [])
    if any(t.dtype != torch.float32 for t in used):
        return f"takes float32, got {', '.join(str(t.dtype) for t in used)}"
    if ent.dtype != torch.int32 or ent.dim() != 2:
        return f"the packed table is {ent.dtype} {tuple(ent.shape)}, not int32 (n_terms, n_out)"
    if any(t.device != p.device for t in used + [ent]):
        return "operands on different devices"
    r = p.dim() - 2
    if r < 0 or r > BAG_MAX_AXES or a.dim() != p.dim() or a.shape[:-1] != p.shape[:-1]:
        return f"operands {tuple(a.shape)} / {tuple(p.shape)} are no bag states"
    n = p.shape[0] if r else 1
    if any(d != n for d in p.shape[:r]) or n ** r >= 2**31:
        return f"vertex axes {tuple(p.shape[:r])} are not n < 2^31 / r each"
    if a.stride(-1) != 1 or p.stride(-1) != 1:
        return "color columns are not contiguous"
    if ent.numel() > BAG_MAX_ENTRIES or max(a.shape[-1], p.shape[-1]) > 1 << 15:
        return f"a table of {ent.numel()} entries over {a.shape[-1]} / {p.shape[-1]} columns"
    if mask_axes and (adj is None or tuple(adj.shape) != (n, n) or not adj.is_contiguous()
                      or not all(0 < x < r for x in mask_axes)):
        return f"masks {tuple(mask_axes)} need a contiguous (n, n) adjacency and axes in (0, r)"
    return None


def _bag_library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.bag_ema_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, p, i, i, i, p, p, p, p]
        fn.restype = ctypes.c_int
    return lib


def bag_ema(a: torch.Tensor, p: torch.Tensor, ent: torch.Tensor, mask_axes=(),
            adj: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One bag op's colorset update on a card, ``(n,) * r + (B, C_a)`` and
    ``(n,) * r + (B, C_p)`` -> a contiguous ``(n,) * r + (B, n_out)``
    float32 state: ``out[i, b, o] = (prod_x adj[i_0, i_x]) * sum_t
    a[i, b, ia[t][o]] * p[i, b, ip[t][o]]``, the terms summed in table order
    from zero.  For 0/1 masks and finite operands that is, bit for bit, the
    executor's loop (``exec.local.LocalBackend._bag_extend_loop`` /
    ``_bag_join_loop``), which the card tests hold it against.

    ``ent`` is the op's :func:`pack_bag_entries` table
    (``exec.base.BagStageTables.ent``); ``mask_axes`` are the vertex axes
    ``x`` of the masks ``adj[i_0, i_x]``.  Launches the kernel, adding one
    to ``bag_ema.launches``, or raises with :func:`bag_ema_refusal`'s
    reason (on the CPU too: the executor loops there).
    """
    mask_axes = tuple(mask_axes)
    why = bag_ema_refusal(a, p, ent, mask_axes, adj)
    if why is not None:
        raise ValueError(f"bag_ema cannot launch: {why}")
    r = p.dim() - 2
    n_terms, n_out = ent.shape
    out = torch.empty(tuple(p.shape[:-1]) + (n_out,), dtype=torch.float32, device=p.device)
    strides = ctypes.c_int64 * (r + 1)
    axes = (ctypes.c_int * max(len(mask_axes), 1))(*mask_axes)
    status = _bag_library().bag_ema_launch(
        a.data_ptr(), strides(*a.stride()[:-1]),
        p.data_ptr(), strides(*p.stride()[:-1]),
        r, p.shape[0] if r else 1, p.shape[-2],
        ent.data_ptr(), n_terms, n_out,
        len(mask_axes), axes, adj.data_ptr() if mask_axes else None,
        out.data_ptr(), torch.cuda.current_stream(p.device).cuda_stream,
    )
    _build.check(status, "bag_ema")
    bag_ema.launches += 1
    return out


bag_ema.launches = 0
