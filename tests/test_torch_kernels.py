"""The port's kernel modules against the reference's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; the reference runs
its Pallas kernels in interpret mode, as its own tests do.  The CUDA
kernels themselves run only on a card, where ``tests/test_torch_cuda.py``
(and ``chip_smoke.py``, at full size) holds them against the plain versions.
The host-side preparation the CUDA kernels read (packed stage tables, the
wide path's group-and-piece plans, geometry, the compact operand and its
edge-balanced partition) is checked here, with PyTorch mirrors of both
kernels' schedules: heavy segments' partial sums reduced in segment order,
light ranges, the passive aggregate held whole or in row passes, wide
stages streamed through a block aggregate in groups and pieces, and narrow tiles whose lane groups take several edges
per load and fold with a butterfly.  Small partitions and shared-memory budgets are set on
the modules' constants with ``monkeypatch``.  The mirrors sum in
another order than the plain versions, so they are held to fp32 tolerance
(``rtol=1e-5, atol=1e-4`` on values of order 10).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.colorsets import build_split_table as ref_build_split_table
from repro.core.graph import rmat_graph as ref_rmat_graph
from repro.kernels.spmm_blocked.ops import prepare_operand as ref_prepare_operand
from repro.kernels.spmm_blocked.ops import spmm_blocked as ref_spmm_blocked
from repro.kernels.spmm_blocked.ref import spmm_ref as ref_spmm_ref
from repro.kernels.spmm_ema.ops import prepare_fused_operand, spmm_ema_batched

from repro_torch.core.colorsets import binom, bucketed_split_entries, build_split_table
from repro_torch.core.graph import Graph, rmat_graph
from repro_torch.kernels.spmm_blocked import ops as blocked_ops
from repro_torch.kernels.spmm_blocked.ops import (
    prepare_operand,
    spmm_blocked,
    tile_width,
)
from repro_torch.kernels.spmm_blocked.ref import spmm_ref
from repro_torch.kernels.spmm_ema import ops as ema_ops
from repro_torch.kernels.spmm_ema.ops import (
    SMEM_BUDGET_BYTES,
    WIDE_SMEM_BYTES,
    kernel_geometry,
    prepare_stage_tables,
    spmm_ema,
    stage_route,
)
from repro_torch.kernels.spmm_ema.ref import spmm_ema_ref


def _close(got, want, rtol=1e-5, atol=1e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# spmm_blocked
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "n,e,cols,block",
    [(200, 800, 16, 128), (513, 2000, 130, 256), (64, 100, 1, 128)],
)
def test_spmm_blocked_matches_reference_kernel(n, e, cols, block):
    ref_g = ref_rmat_graph(n, e, seed=n + e)
    g = rmat_graph(n, e, seed=n + e)
    m = np.random.default_rng(0).standard_normal((g.n, cols)).astype(np.float32)
    want = ref_spmm_blocked(
        ref_prepare_operand(ref_g, block_size=block, edge_chunk=128), jnp.asarray(m),
        interpret=True,
    )
    before = spmm_blocked.launches
    got = spmm_blocked(prepare_operand(g, "cpu"), torch.from_numpy(m))
    assert spmm_blocked.launches == before  # the plain version launches nothing
    assert got.shape == (g.n, cols) and got.dtype == torch.float32
    _close(got, want)


def _with_isolated_tail(g, n_total):
    return Graph(n=n_total, src=g.src, dst=g.dst)


@pytest.mark.parametrize("n_total,rows", [(301, 32), (1000, 64)])
def test_compact_operand_empty_destination_blocks(n_total, rows):
    """Isolated trailing vertices leave whole destination blocks without
    edges; ``n`` is not a multiple of the block size."""
    g = _with_isolated_tail(rmat_graph(120, 500, seed=5), n_total)
    op = prepare_operand(g, "cpu")
    starts = np.minimum(np.arange(0, g.n + rows, rows), g.n)
    bp = op.row_ptr.numpy()[starts]  # edge range of each destination block
    assert bp[0] == 0 and bp[-1] == g.num_directed and np.all(np.diff(bp) >= 0)
    assert bp[-2] == bp[-1]  # the last block walks no edges
    m = np.random.default_rng(1).standard_normal((g.n, 7)).astype(np.float32)
    want = ref_spmm_ref(jnp.asarray(g.src), jnp.asarray(g.dst), g.n, jnp.asarray(m))
    got = spmm_blocked(op, torch.from_numpy(m))
    _close(got, want)
    assert float(got[120:].abs().max()) == 0.0


def test_spmm_blocked_rejects_bad_inputs():
    op = prepare_operand(rmat_graph(50, 200, seed=1), "cpu")
    with pytest.raises(TypeError):
        spmm_blocked(op, torch.zeros((50, 4), dtype=torch.float64))
    with pytest.raises(ValueError):
        spmm_blocked(op, torch.zeros((49, 4)))
    with pytest.raises(ValueError):
        spmm_blocked(op, torch.zeros((50, 4), device="meta"))


# ---------------------------------------------------------------------------
# spmm_ema
# ---------------------------------------------------------------------------


def _stage_inputs(n, bsz, k, m, m_a, seed):
    rng = np.random.default_rng(seed)
    c_p, c_a = binom(k, m - m_a), binom(k, m_a)
    m_p = rng.standard_normal((n, bsz, c_p)).astype(np.float32)
    m_aa = rng.standard_normal((n, bsz, c_a)).astype(np.float32)
    return m_p, m_aa


@pytest.mark.parametrize("n,block", [(513, 128), (200, 256), (97, 64)])
def test_spmm_ema_ragged_matches_reference_kernel(n, block):
    k, m, m_a = 5, 5, 2
    ref_g = ref_rmat_graph(n, 4 * n, seed=n)
    g = rmat_graph(n, 4 * n, seed=n)
    table = build_split_table(k, m, m_a)
    m_p, m_aa = _stage_inputs(g.n, 2, k, m, m_a, seed=n)
    want = spmm_ema_batched(
        prepare_fused_operand(ref_g, block_size=block, edge_chunk=64),
        jnp.asarray(m_p), jnp.asarray(m_aa), table.idx_a, table.idx_p, interpret=True,
    )
    tables = prepare_stage_tables(table.idx_a, table.idx_p, binom(k, m - m_a), binom(k, m_a), "cpu")
    got = spmm_ema(prepare_operand(g, "cpu"), torch.from_numpy(m_p), torch.from_numpy(m_aa), tables)
    _close(got, want)


@pytest.mark.parametrize("k,m,m_a", [(5, 3, 1), (7, 4, 2), (6, 6, 3)])
def test_spmm_ema_batched_matches_reference_kernel(k, m, m_a):
    ref_g = ref_rmat_graph(130, 520, seed=m)
    g = rmat_graph(130, 520, seed=m)
    table = build_split_table(k, m, m_a)
    ref_table = ref_build_split_table(k, m, m_a)
    m_p, m_aa = _stage_inputs(g.n, 3, k, m, m_a, seed=1)
    want = spmm_ema_batched(
        prepare_fused_operand(ref_g, block_size=64, edge_chunk=64),
        jnp.asarray(m_p), jnp.asarray(m_aa), ref_table.idx_a, ref_table.idx_p,
        interpret=True,
    )
    tables = prepare_stage_tables(table.idx_a, table.idx_p, binom(k, m - m_a), binom(k, m_a), "cpu")
    before = spmm_ema.launches
    got = spmm_ema(prepare_operand(g, "cpu"), torch.from_numpy(m_p), torch.from_numpy(m_aa), tables)
    assert spmm_ema.launches == before
    assert got.shape == (g.n, 3, table.n_out)
    _close(got, want)


@pytest.mark.parametrize("k,m,m_a", [(7, 7, 3), (12, 6, 4), (12, 12, 5)])
def test_stage_tables_bucket_like_bucketed_split_entries(k, m, m_a):
    """The kernel holds every passive column at once, so its table is the
    single bucket of ``bucketed_split_entries`` whose tile spans all of
    ``C_p``: per output row, every split entry in split order, no padding,
    packed as ``active | passive << 16`` and stored split-major."""
    table = build_split_table(k, m, m_a)
    c_p = binom(k, m - m_a)
    tables = prepare_stage_tables(table.idx_a, table.idx_p, c_p, binom(k, m_a), "cpu")
    (lo, width, ia, ip, va), = bucketed_split_entries(table, c_p)
    assert (lo, width, va) == (0, c_p, None)
    ent = tables.ent.numpy().T
    assert ent.shape == (table.n_out, table.n_splits) and tables.n_splits == table.n_splits
    np.testing.assert_array_equal(ent & 0xFFFF, ia)
    np.testing.assert_array_equal(ent >> 16, ip)


def _plan_groups(tables):
    """A streamed stage's plan as numpy: per group ``(o0, o1, pieces)``,
    each piece ``(sup_a, sup_p, la, lp)`` with ``(G, cnt)`` local entries
    decoded as unsigned 16-bit halves."""
    plan = tables.plan
    go, gp, pe, psa, psp = (x.tolist() for x in (
        plan.group_out, plan.group_piece, plan.piece_ent, plan.piece_sa, plan.piece_sp))
    ent = tables.ent.numpy().view(np.uint32).astype(np.int64)
    sup_a, sup_p = plan.sup_a.numpy(), plan.sup_p.numpy()
    groups = []
    for g in range(plan.n_groups):
        size, pieces = go[g + 1] - go[g], []
        for j in range(gp[g], gp[g + 1]):
            x = ent[pe[j]:pe[j + 1]].reshape(-1, size).T  # split-major -> (G, cnt)
            pieces.append((sup_a[psa[j]:psa[j + 1]], sup_p[psp[j]:psp[j + 1]],
                           x & 0xFFFF, x >> 16))
        groups.append((go[g], go[g + 1], pieces))
    return groups


#: Small widths forced onto the streamed route: (k, m, m_a, WIDE_SMEM_BYTES,
#: WIDE_GROUP_MAX) -- supports of at most 40 / 24 / 64 columns, groups of at
#: most 64 / 32 / 16 outputs.
_FORCED_STREAMED = [(10, 5, 1, 640, 64), (9, 5, 4, 384, 32), (12, 6, 4, 1024, 16)]


def _force_streamed(monkeypatch, wide_smem, group_max):
    monkeypatch.setattr(ema_ops, "SMEM_BUDGET_BYTES", 256)
    monkeypatch.setattr(ema_ops, "WIDE_SMEM_BYTES", wide_smem)
    monkeypatch.setattr(ema_ops, "WIDE_GROUP_MAX", group_max)


@pytest.mark.parametrize("k,m,m_a,wide_smem,group_max", _FORCED_STREAMED)
def test_wide_plan_takes_every_entry_once_in_split_order(k, m, m_a, wide_smem, group_max,
                                                         monkeypatch):
    """Every (output, split) entry of a streamed stage appears exactly once:
    the groups tile the outputs in order, and an output's entries, piece
    after piece, mapped back through the pieces' supports, are its row of
    the split table in split order.  Each piece's supports are sorted,
    distinct, exactly the columns its entries read, and fit the cap."""
    _force_streamed(monkeypatch, wide_smem, group_max)
    table = build_split_table(k, m, m_a)
    c_p, c_a = binom(k, m - m_a), binom(k, m_a)
    tables = prepare_stage_tables(table.idx_a, table.idx_p, c_p, c_a, "cpu")
    assert tables.route == "streamed" and tables.wide
    groups = _plan_groups(tables)
    assert [g[0] for g in groups] == list(range(0, table.n_out, tables.plan.max_group))
    assert groups[-1][1] == table.n_out and len(groups) > 1
    assert tables.plan.n_pieces > len(groups)  # some group is cut into pieces
    for o0, o1, pieces in groups:
        got_a = np.concatenate([sa[la] for sa, sp, la, lp in pieces], axis=1)
        got_p = np.concatenate([sp[lp] for sa, sp, la, lp in pieces], axis=1)
        np.testing.assert_array_equal(got_a, table.idx_a[o0:o1])
        np.testing.assert_array_equal(got_p, table.idx_p[o0:o1])
        for sa, sp, la, lp in pieces:
            np.testing.assert_array_equal(sa, np.unique(sa[la]))
            np.testing.assert_array_equal(sp, np.unique(sp[lp]))
            assert (sa.size + sp.size) * ema_ops.WIDE_ROWS * 4 <= wide_smem
    assert tables.plan.smem_bytes <= wide_smem
    staged = sum(sa.size + sp.size for _, _, pieces in groups for sa, sp, _, _ in pieces)
    assert staged == tables.plan.staged_columns


#: The wide stages of u18 and u20 and the route each takes: all streamed,
#: also the three whose row would fit a block's 232,448 shared bytes.
_WIDE_STAGES = [((18, 10, 7), "streamed"), ((18, 14, 10), "streamed"), ((20, 7, 1), "streamed"),
                ((20, 10, 3), "streamed"), ((20, 11, 1), "streamed"), ((20, 18, 11), "streamed")]


@pytest.mark.parametrize("stage,route", _WIDE_STAGES)
def test_u18_u20_wide_stages_fit_a_block(stage, route):
    """Each wide stage of u18 and u20 is streamed, with a plan that fits the
    card's 232,448 shared bytes: its largest piece's supports, four rows
    of them, fit, with local indices below 2^16."""
    k, m, m_a = stage
    table = build_split_table(k, m, m_a)
    c_p, c_a = binom(k, m - m_a), binom(k, m_a)
    assert WIDE_SMEM_BYTES == 232_448
    tables = prepare_stage_tables(table.idx_a, table.idx_p, c_p, c_a, "cpu")
    assert tables.route == route == stage_route(c_p, c_a) and tables.wide
    plan = tables.plan
    assert kernel_geometry(c_p, c_a, 16) == ema_ops.WIDE_ROWS
    assert plan.smem_bytes == plan.max_support * 16 <= WIDE_SMEM_BYTES
    assert plan.max_group <= ema_ops.WIDE_GROUP_MAX == 4 * ema_ops.WIDE_THREADS
    assert tables.ent.numel() == table.n_out * table.n_splits
    ent = tables.ent.numpy().view(np.uint32)
    assert int((ent & 0xFFFF).max()) < plan.max_support
    assert int((ent >> 16).max()) < plan.max_support


def test_unsigned_entry_decode_round_trips_past_2_15(monkeypatch):
    """(20, 7, 1), a 38,760-column passive, planned under a support cap of
    40,000 columns and groups of up to all 77,520 outputs: its pieces'
    local passive positions pass 2^15, so the entries pass 2^31 as int32,
    and read as unsigned halves through the supports they give back the
    split table."""
    monkeypatch.setattr(ema_ops, "WIDE_SMEM_BYTES", 16 * 40_000)
    monkeypatch.setattr(ema_ops, "WIDE_GROUP_MAX", 77_520)
    table = build_split_table(20, 7, 1)
    tables = prepare_stage_tables(table.idx_a, table.idx_p, binom(20, 6), binom(20, 1), "cpu")
    assert tables.route == "streamed" and binom(20, 6) == 38_760
    assert tables.plan.max_support > 1 << 15
    assert tables.ent.numpy().min() < 0  # an int32 read would take the passive half as negative
    for o0, o1, pieces in _plan_groups(tables):
        np.testing.assert_array_equal(
            np.concatenate([sa[la] for sa, sp, la, lp in pieces], axis=1), table.idx_a[o0:o1])
        np.testing.assert_array_equal(
            np.concatenate([sp[lp] for sa, sp, la, lp in pieces], axis=1), table.idx_p[o0:o1])


@pytest.mark.parametrize("n_out", [1, 66, 924, 3432, 12870])
def test_kernel_geometry_fits_shared_memory(n_out):
    """Rows per pass at passive and active widths of ``n_out`` columns (the
    widths u16's stages reach): the pass's aggregate and active rows fit the
    budget; the whole 16-row range when it can."""
    rows = kernel_geometry(n_out, n_out, 16)
    assert rows * n_out * 2 * 4 <= SMEM_BUDGET_BYTES
    assert 1 <= rows <= 16
    if 16 * n_out * 2 * 4 <= SMEM_BUDGET_BYTES:
        assert rows == 16
    else:
        assert (rows + 1) * n_out * 2 * 4 > SMEM_BUDGET_BYTES


# ---------------------------------------------------------------------------
# mirrors of the CUDA kernels' schedules
# ---------------------------------------------------------------------------


def _lane_groups(c):
    """Edges per load step of a warp walking ``c`` columns (``edge_walk.cuh``)."""
    vec = 4 if c % 4 == 0 else 2 if c % 2 == 0 else 1
    return 1 if c > 16 * vec else 32 // (tile_width(c) // vec)


def _fold(parts):
    """The xor butterfly over lane groups: ``(g, ...)`` -> group 0's sum."""
    g = parts.shape[0]
    off = g // 2
    while off:
        parts = parts + parts[torch.arange(g) ^ off]
        off //= 2
    return parts[0]


def _walk(m, src, beg, end, groups):
    """One warp's sum of ``m``'s rows ``src[beg:end]``: group ``i`` takes
    edges ``beg + i, beg + i + groups, ...`` in order, then the fold."""
    rows = m[src[beg:end].long()]
    parts = torch.zeros((groups,) + tuple(m.shape[1:]), dtype=torch.float32)
    for i in range(groups):
        for row in rows[i::groups]:
            parts[i] += row
    return _fold(parts)


def _heavy_sums(op, m):
    """Heavy rows' sums: each segment's partial, summed in segment order."""
    part = op.partition
    groups = _lane_groups(m.shape[1])
    src = op.src
    beg, end, seg_ptr = part.seg_beg.tolist(), part.seg_end.tolist(), part.seg_ptr.tolist()
    partials = [_walk(m, src, beg[s], end[s], groups) for s in range(part.n_segments)]
    out = torch.zeros((part.n_heavy, m.shape[1]), dtype=torch.float32)
    for h in range(part.n_heavy):
        for s in range(seg_ptr[h], seg_ptr[h + 1]):
            out[h] += partials[s]
    return out


def _mirror_spmm_blocked(op, m):
    """``spmm_blocked.cu``: per column slab (``blockIdx.y``), the heavy
    blocks' (segment, tile) items into the partials and the light ranges'
    (row, tile) items into the output, by the kernel's index arithmetic;
    then each heavy row's partials summed in segment order.  Every light
    (row, tile) and every (segment, tile) is written exactly once."""
    part = op.partition
    n, c = m.shape
    width = tile_width(c)
    n_tiles = -(-c // width)
    slab = blocked_ops.slab_tiles(c, n)
    warps = blocked_ops.KERNEL_WARPS
    heavy_blocks = -(-part.n_segments * slab // warps)
    groups = _lane_groups(c)
    out = torch.full((n, c), float("nan"))
    partials = torch.full((part.n_segments, c), float("nan"))
    writes = torch.zeros((n + part.n_segments, n_tiles), dtype=torch.int64)
    row_ptr, slot = op.row_ptr.tolist(), part.heavy_slot.tolist()
    beg, end, rp = part.seg_beg.tolist(), part.seg_end.tolist(), part.range_ptr.tolist()

    def walk(lo, hi, t, row):
        cols = slice(t * width, min(c, (t + 1) * width))
        row[cols] = _walk(m[:, cols], op.src, lo, hi, groups)

    for y in range(-(-n_tiles // slab)):
        t0 = y * slab
        tiles = min(slab, n_tiles - t0)
        for item in range(min(heavy_blocks * warps, part.n_segments * tiles)):
            seg = item // tiles
            walk(beg[seg], end[seg], t0 + item - seg * tiles, partials[seg])
            writes[n + seg, t0 + item - seg * tiles] += 1
        for r in range(part.n_ranges):
            for item in range((rp[r + 1] - rp[r]) * tiles):
                rr = item // tiles
                v = rp[r] + rr
                if slot[v] < 0:
                    walk(row_ptr[v], row_ptr[v + 1], t0 + item - rr * tiles, out[v])
                    writes[v, t0 + item - rr * tiles] += 1
    seg_ptr = part.seg_ptr.tolist()
    for h, v in enumerate(part.heavy_rows.tolist()):
        out[v] = 0.0
        for s in range(seg_ptr[h], seg_ptr[h + 1]):
            out[v] += partials[s]
    light = torch.tensor(slot + [-1] * part.n_segments) < 0
    assert torch.all(writes[light] == 1) and torch.all(writes[~light] == 0)
    return out


def _row_sums(op, m_p, rows):
    """The aggregate of state rows ``rows`` (vertex ``s // B``, coloring
    ``s % B``) as the kernels sum it: heavy rows from the segment sums,
    light rows by the warp walk."""
    n, bsz, c_p = m_p.shape
    heavy_agg = _heavy_sums(op, m_p.reshape(n, bsz * c_p)).reshape(-1, bsz, c_p)
    row_ptr, slot = op.row_ptr.tolist(), op.partition.heavy_slot.tolist()
    groups = _lane_groups(c_p)
    return torch.stack([
        heavy_agg[slot[s // bsz], s % bsz] if slot[s // bsz] >= 0 else
        _walk(m_p[:, s % bsz], op.src, row_ptr[s // bsz], row_ptr[s // bsz + 1], groups)
        for s in rows])


def _mirror_streamed(op, m_p, m_a, tables):
    """The streamed route: per block of :func:`block_rows` state rows the
    rows' aggregate (``wide_aggregate_kernel``), then per (group, 4-row
    sub-block) ``wide_ema_kernel``: ``g`` lanes per output, lane ``j``
    applying entries ``j, j + g, ...`` of each piece in turn to its own
    sums, then the butterfly."""
    n, bsz, c_p = m_p.shape
    n_state = n * bsz
    act = m_a.reshape(n_state, -1)
    groups = _plan_groups(tables)
    out = torch.full((n_state, tables.n_out), float("nan"))
    step = ema_ops.block_rows(n_state, c_p + tables.c_a, tables.plan.n_groups)
    assert step % ema_ops.WIDE_ROWS == 0
    for s0 in range(0, n_state, step):
        agg = _row_sums(op, m_p, range(s0, min(n_state, s0 + step)))
        for r0 in range(0, agg.shape[0], ema_ops.WIDE_ROWS):
            rs = slice(r0, r0 + ema_ops.WIDE_ROWS)
            for o0, o1, pieces in groups:
                g = 1
                while g < 32 and (o1 - o0) * g * 2 <= ema_ops.WIDE_THREADS:
                    g *= 2
                lanes = torch.zeros((g, agg[rs].shape[0], o1 - o0))
                for sa, sp, la, lp in pieces:
                    rows = act[s0 + r0:s0 + r0 + ema_ops.WIDE_ROWS]
                    prods = rows[:, sa][:, la] * agg[rs][:, sp][:, lp]
                    for j in range(g):
                        for t in range(j, la.shape[1], g):
                            lanes[j] += prods[:, :, t]
                out[s0 + r0:s0 + r0 + ema_ops.WIDE_ROWS, o0:o1] = _fold(lanes)
    return out.reshape(n, bsz, tables.n_out)


def _mirror_fused_kernel(op, m_p, m_a, tables, rows_pass=None):
    """``spmm_ema.cu``: the heavy rows' aggregate over the ``B * C_p`` row
    first; then, on the ``shared`` route, per (light range, coloring) CTA,
    per pass of ``rows_pass`` rows, the rows' passive aggregate (light rows
    walked, heavy rows copied) and the eMA: ``g`` lanes per (row, output)
    of the CTA's 256 threads, each applying the split entries ``j, j + g,
    ...`` in split order before the fold.  The ``streamed`` route is
    :func:`_mirror_streamed`."""
    if tables.route == "streamed":
        return _mirror_streamed(op, m_p, m_a, tables)
    part = op.partition
    n, bsz, c_p = m_p.shape
    n_out, n_splits = tables.n_out, tables.n_splits
    threads = 256
    rows_pass = rows_pass or kernel_geometry(c_p, tables.c_a, blocked_ops.RANGE_ROWS)
    ent = torch.from_numpy(tables.ent.numpy().view(np.uint32).astype(np.int64)).T
    idx_a, idx_p = ent & 0xFFFF, ent >> 16
    rp = part.range_ptr.tolist()
    out = torch.full((n, bsz, n_out), float("nan"))
    for r in range(part.n_ranges):
        for b in range(bsz):
            for p0 in range(rp[r], rp[r + 1], rows_pass):
                vs = list(range(p0, min(rp[r + 1], p0 + rows_pass)))
                agg = _row_sums(op, m_p, [v * bsz + b for v in vs])
                g = 1
                while g < 32 and g < n_splits and len(vs) * n_out * g * 2 <= threads:
                    g *= 2
                prods = m_a[vs, b][:, idx_a] * agg[:, idx_p]  # (rows, n_out, n_splits)
                lanes = torch.zeros((g, len(vs), n_out))
                for j in range(g):
                    for t in range(j, n_splits, g):
                        lanes[j] += prods[:, :, t]
                out[vs, b] = _fold(lanes)
    return out


def _hub_graph():
    """R-MAT rows with hubs, a star hub whose degree is a multiple of the
    segment, and isolated trailing vertices."""
    g = rmat_graph(90, 700, seed=6)
    hub = 100
    leaves = np.arange(0, 48)  # 48 = 6 segments of 8
    src = np.concatenate([g.src, leaves, np.full(48, hub)])
    dst = np.concatenate([g.dst, np.full(48, hub), leaves])
    order = np.lexsort((src, dst))
    return Graph(n=130, src=src[order].astype(np.int32), dst=dst[order].astype(np.int32))


def small_partition(monkeypatch, heavy_degree=12, segment_edges=8, range_rows=16,
                    range_edges=40):
    for name, value in (("HEAVY_DEGREE", heavy_degree), ("SEGMENT_EDGES", segment_edges),
                        ("RANGE_ROWS", range_rows), ("RANGE_EDGES", range_edges)):
        monkeypatch.setattr(blocked_ops, name, value)


@pytest.mark.parametrize("cols", [1, 12, 24, 64, 130])
def test_spmm_blocked_schedule_mirror(cols, monkeypatch):
    """Kernel B's schedule over a partition with many heavy rows equals the
    plain version and the reference's oracle."""
    g = _hub_graph()
    small_partition(monkeypatch)
    op = prepare_operand(g, "cpu")
    assert op.partition.n_heavy >= 4
    m = np.random.default_rng(cols).standard_normal((g.n, cols)).astype(np.float32)
    got = _mirror_spmm_blocked(op, torch.from_numpy(m))
    _close(got, spmm_ref(op.src, op.dst, g.n, torch.from_numpy(m)))
    _close(got, ref_spmm_ref(jnp.asarray(g.src), jnp.asarray(g.dst), g.n, jnp.asarray(m)))
    assert float(got[101:].abs().max()) == 0.0  # rows with no edges write zeros


@pytest.mark.parametrize("cols,one_slab_tiles,slab_bytes", [
    (130, 1, 0), (900, 1, 130 * 512 * 3), (1030, 8, 0), (2050, 8, 130 * 512 * 5)])
def test_spmm_blocked_slab_schedule_mirror(cols, one_slab_tiles, slab_bytes, monkeypatch):
    """Kernel B cut into column slabs (narrow ones forced here): two slabs
    of one tile, a last slab of fewer tiles (900 columns: 8 tiles in slabs
    of 3), 1030 columns (9 tiles, past the one-slab limit) in slabs of
    one, and 17 tiles in slabs of 5 set by the slab's bytes; each equals
    the plain version and, bit for bit, the schedule in one slab."""
    g = _hub_graph()
    small_partition(monkeypatch)
    op = prepare_operand(g, "cpu")
    m = np.random.default_rng(cols).standard_normal((g.n, cols)).astype(np.float32)
    m = torch.from_numpy(m)
    whole = _mirror_spmm_blocked(op, m)
    monkeypatch.setattr(blocked_ops, "ONE_SLAB_TILES", one_slab_tiles)
    monkeypatch.setattr(blocked_ops, "SLAB_BYTES", slab_bytes)
    assert blocked_ops.slab_tiles(cols, g.n) < -(-cols // 128)
    got = _mirror_spmm_blocked(op, m)
    assert torch.equal(got, whole)
    _close(got, spmm_ref(op.src, op.dst, g.n, m))


@pytest.mark.parametrize(
    "k,m,m_a,bsz,rows_pass",
    [(5, 2, 1, 2, None), (7, 4, 1, 1, None), (7, 7, 3, 3, None), (6, 4, 2, 2, 3)],
)
def test_spmm_ema_schedule_mirror(k, m, m_a, bsz, rows_pass, monkeypatch):
    """Kernel A's schedule (heavy aggregate, light ranges, row passes, g
    lanes per output on the 1-output root) equals the plain version and,
    per coloring, the reference's two-pass oracle.  (5, 2, 1) is a narrow
    5-column passive: 8 edges per load step."""
    _check_fused_schedule(k, m, m_a, bsz, rows_pass, monkeypatch, wide=False)


@pytest.mark.parametrize(
    "k,m,m_a,bsz,wide_smem,route",
    [(10, 5, 1, 2, 640, "streamed"), (8, 8, 4, 1, 1024, "streamed"),
     (9, 5, 4, 3, 384, "streamed")],
)
def test_spmm_ema_wide_schedule_mirror(k, m, m_a, bsz, wide_smem, route, monkeypatch):
    """Kernel A's wide path, forced by a 256-byte budget of the
    shared-memory path: (10, 5, 1) over 210 passive columns in groups of at
    most 64 outputs, pieces of at most 40 support columns and blocks of 20
    state rows (13 blocks, the last ragged); (8, 8, 4), the 1-output root
    at 32 lanes per output, its 70 splits in pieces of at most 64 support
    columns; (9, 5, 4) with a narrow 9-column passive beside a 126-column
    active state.  Equal to the plain version and the reference's
    oracle."""
    monkeypatch.setattr(ema_ops, "SMEM_BUDGET_BYTES", 256)
    monkeypatch.setattr(ema_ops, "WIDE_SMEM_BYTES", wide_smem)
    monkeypatch.setattr(ema_ops, "WIDE_GROUP_MAX", 64)
    monkeypatch.setattr(ema_ops, "WIDE_SCRATCH_BYTES", 20 * (binom(k, m - m_a) + binom(k, m_a)) * 4)
    assert stage_route(binom(k, m - m_a), binom(k, m_a)) == route
    _check_fused_schedule(k, m, m_a, bsz, None, monkeypatch, wide=True)


def _check_fused_schedule(k, m, m_a, bsz, rows_pass, monkeypatch, wide):
    from repro.kernels.spmm_ema.ref import spmm_ema_ref as ref_spmm_ema_ref

    g = _hub_graph()
    small_partition(monkeypatch)
    op = prepare_operand(g, "cpu")
    table = build_split_table(k, m, m_a)
    tables = prepare_stage_tables(table.idx_a, table.idx_p, binom(k, m - m_a), binom(k, m_a), "cpu")
    assert tables.wide == wide
    m_p, m_aa = _stage_inputs(g.n, bsz, k, m, m_a, seed=k * m)
    got = _mirror_fused_kernel(op, torch.from_numpy(m_p), torch.from_numpy(m_aa), tables, rows_pass)
    _close(got, spmm_ema_ref(op.src, op.dst, g.n, torch.from_numpy(m_p), torch.from_numpy(m_aa),
                             tables.idx_a, tables.idx_p))
    ref_table = ref_build_split_table(k, m, m_a)
    for b in range(bsz):
        want = ref_spmm_ema_ref(jnp.asarray(g.src), jnp.asarray(g.dst), g.n,
                                jnp.asarray(m_p[:, b]), jnp.asarray(m_aa[:, b]),
                                jnp.asarray(ref_table.idx_a), jnp.asarray(ref_table.idx_p))
        _close(got[:, b], want)
    assert np.all(got[101:].numpy() == 0)


@pytest.mark.parametrize("k,m,m_a,rows_pass", [(7, 4, 1, None), (7, 7, 3, None), (6, 4, 2, 4)])
def test_fused_kernel_tile_loop_mirror(k, m, m_a, rows_pass, monkeypatch):
    """The kernel's algorithm (heavy segments, light ranges, row passes,
    empty ranges, ragged ``n``) reproduces the two-pass plain version."""
    g = _with_isolated_tail(rmat_graph(45, 150, seed=k + m), 75)
    small_partition(monkeypatch, heavy_degree=6, segment_edges=4, range_rows=8, range_edges=16)
    op = prepare_operand(g, "cpu")
    assert op.partition.n_heavy > 0
    table = build_split_table(k, m, m_a)
    tables = prepare_stage_tables(table.idx_a, table.idx_p, binom(k, m - m_a), binom(k, m_a), "cpu")
    m_p, m_aa = _stage_inputs(g.n, 2, k, m, m_a, seed=3)
    got = _mirror_fused_kernel(op, torch.from_numpy(m_p), torch.from_numpy(m_aa), tables,
                               rows_pass)
    want = spmm_ema(op, torch.from_numpy(m_p), torch.from_numpy(m_aa), tables)
    _close(got, want)
    assert np.all(got[45:].numpy() == 0)


def test_spmm_ema_rejects_bad_inputs():
    g = rmat_graph(40, 120, seed=2)
    op = prepare_operand(g, "cpu")
    table = build_split_table(5, 3, 1)
    tables = prepare_stage_tables(table.idx_a, table.idx_p, binom(5, 2), binom(5, 1), "cpu")
    m_p, m_aa = (torch.from_numpy(x) for x in _stage_inputs(g.n, 2, 5, 3, 1, seed=0))
    with pytest.raises(TypeError):
        spmm_ema(op, m_p.double(), m_aa.double(), tables)
    with pytest.raises(ValueError):
        spmm_ema(op, m_p[:, :, :5], m_aa, tables)
    with pytest.raises(ValueError):
        spmm_ema(op, m_p[:, :1], m_aa, tables)


def test_stage_tables_reject_out_of_range_indices():
    table = build_split_table(5, 3, 1)
    with pytest.raises(ValueError, match="outside"):
        prepare_stage_tables(table.idx_a, table.idx_p, binom(5, 2), binom(5, 1) - 1, "cpu")
    with pytest.raises(ValueError, match="outside"):
        prepare_stage_tables(table.idx_a, table.idx_p + 1, binom(5, 2), binom(5, 1), "cpu")


def test_spmm_blocked_refuses_counts_past_int32():
    """Bag extends flatten states to (n, n**(r-1) * B * C): the wrapper
    refuses a width whose launch counts would wrap the kernel's 32-bit ints
    (checked here on the host; the card test launches the refusal)."""
    lone = prepare_operand(Graph(n=1, src=np.zeros(0, np.int64), dst=np.zeros(0, np.int64)), "cpu")
    assert blocked_ops.check_int32_counts(lone, 2**31 - 129)["column index (C + one tile)"] == 2**31 - 1
    with pytest.raises(ValueError, match="column index"):
        blocked_ops.check_int32_counts(lone, 2**31 - 128)
    g = rmat_graph(600, 4000, seed=3)
    op = prepare_operand(g, "cpu")

    def segments(count):  # a partition of `count` heavy segments, no memory behind them
        many = torch.zeros(1, dtype=torch.int32).expand(count)
        return dataclasses.replace(op, partition=dataclasses.replace(op.partition, seg_beg=many,
                                                                     seg_end=many))

    # heavy items are counted per slab: 2**20 segments x 2048 tiles would
    # wrap in one slab, but at n = 600 the slab is 13 tiles (4 MiB of M)
    assert blocked_ops.slab_tiles(2048 * 128, 600) == 13
    assert blocked_ops.check_int32_counts(segments(2**20), 2048 * 128)[
        "heavy items (segments x slab tiles)"] == 2**20 * 13 + 8
    # 2**28 segments: 7 tiles fit in one slab, the eighth wraps
    blocked_ops.check_int32_counts(segments(2**28), 7 * 128)
    with pytest.raises(ValueError, match="heavy items"):
        blocked_ops.check_int32_counts(segments(2**28), 8 * 128)
    with pytest.raises(ValueError, match="heavy items"):
        blocked_ops.check_int32_counts(segments(2**28), 2048 * 128)
    counts = blocked_ops.check_int32_counts(op, 49_152)
    assert counts["light-range items (rows x slab tiles)"] == blocked_ops.RANGE_ROWS * 13
    assert counts["grid y (slabs)"] == 384 // 13 + 1


def test_spmm_ema_refuses_counts_past_int32():
    """Kernel A's launch counts, checked on the host before a launch (the
    card test checks them at u18's and u20's sizes): u20's widest passive
    (184,756 columns, streamed) indexes its state rows, fills its one block
    of 600 rows as (sub-block, passive or active column tile) warp items
    and runs its eMA over a grid of (group, sub-block) blocks; u20's
    (20, 7, 1) likewise, its scratch and grid over its own plan.  A block
    of rows is cut to whole waves of a card's SMs (none on the CPU).  Over
    2^20 synthetic heavy segments the widest fits one coloring and not
    two; the colorings are the grid's y dimension on the shared route; the
    heavy rows' column index is B x C_p."""
    g = rmat_graph(600, 4000, seed=3)
    op = prepare_operand(g, "cpu")
    widest = build_split_table(20, 11, 1)
    tables = prepare_stage_tables(widest.idx_a, widest.idx_p, binom(20, 10), binom(20, 1), "cpu")
    assert tables.route == "streamed"
    counts = ema_ops.check_int32_counts(op, 1, tables)
    tiles = -(-184_756 // 128)
    assert ema_ops.block_rows(600, 184_776, 42, 132) == 600  # all 150 sub-blocks: 1 GiB holds 363
    assert ema_ops.block_rows(1 << 15, 184_776, 42, 132) == 4 * (115 * 132 // 42)  # whole waves
    assert ema_ops.block_rows(1 << 15, 184_776, 42) == 4 * 363  # no cut without a card
    assert ema_ops.wave_blocks("cpu") == 0
    assert counts["split entries (outputs x splits)"] == 167_960 * 11
    assert counts["state rows (n x B + one sub-block)"] == 604
    fill = counts["fill items (sub-blocks x passive and active column tiles)"]
    assert fill == 150 * (tiles + 1) + 8
    assert counts["eMA grid (groups x sub-blocks of a block)"] == 42 * 150
    assert tables.plan.n_groups == 42
    assert counts["support columns (all pieces)"] == tables.plan.staged_columns
    assert ema_ops.scratch_bytes(op, 1, 184_756, tables) == 600 * 184_776 * 4
    once_table = build_split_table(20, 7, 1)
    once = prepare_stage_tables(once_table.idx_a, once_table.idx_p, binom(20, 6), binom(20, 1),
                                "cpu")
    assert once.route == "streamed" and "light grid (ranges)" not in ema_ops.check_int32_counts(
        op, 1, once)
    counts = ema_ops.check_int32_counts(op, 1, once)
    assert counts["eMA grid (groups x sub-blocks of a block)"] == once.plan.n_groups * 150
    assert counts["fill items (sub-blocks x passive and active column tiles)"] == (
        150 * (-(-38_760 // 128) + 1) + 8)
    assert ema_ops.scratch_bytes(op, 1, 38_760, once) == 600 * 38_780 * 4
    assert ema_ops.scratch_bytes(op, 1, 38_760) == 0  # no heavy rows, no plan
    with pytest.raises(ValueError, match="heavy column index"):  # named before the grid
        ema_ops.check_int32_counts(op, 11_624 * 5, once)
    many = torch.zeros(2**20, dtype=torch.int32)
    segmented = dataclasses.replace(op, partition=dataclasses.replace(op.partition, seg_beg=many,
                                                                      seg_end=many))
    assert ema_ops.check_int32_counts(segmented, 1, tables)[
        "heavy items (segments x column tiles)"] == 2**20 * tiles + 8
    with pytest.raises(ValueError, match="heavy items"):
        ema_ops.check_int32_counts(segmented, 2, tables)
    with pytest.raises(ValueError, match="heavy column index"):
        ema_ops.check_int32_counts(op, 11_624, tables)  # 184,756 x 11,624 > 2^31 - 1
    small = build_split_table(5, 3, 1)
    fits = prepare_stage_tables(small.idx_a, small.idx_p, binom(5, 2), binom(5, 1), "cpu")
    assert not fits.wide
    assert ema_ops.check_int32_counts(op, ema_ops.MAX_GRID_Y, fits)["grid y (colorings)"] == 65_535
    with pytest.raises(ValueError, match="grid y"):
        ema_ops.check_int32_counts(op, ema_ops.MAX_GRID_Y + 1, fits)
