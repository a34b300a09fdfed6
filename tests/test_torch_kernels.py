"""The port's kernel modules against the reference's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; the reference runs
its Pallas kernels in interpret mode, as its own tests do.  The CUDA
kernels themselves run only on a card, where ``tests/test_torch_cuda.py``
(and ``chip_smoke.py``, at full size) holds them against the plain versions.
The host-side preparation the CUDA kernels read (packed or bucketed stage
tables, geometry, the compact operand and its edge-balanced partition) is
checked here, with PyTorch mirrors of both kernels' schedules: heavy
segments' partial sums reduced in segment order, light ranges, the passive
aggregate held whole or in row passes, wide stages walked in passive tiles,
and narrow tiles whose lane groups take several edges per load and fold
with a butterfly.  Small partitions and shared-memory budgets are set on
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
    WIDE_TILE_COLS,
    kernel_geometry,
    prepare_stage_tables,
    spmm_ema,
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


def _expected_bucket_order(idx_a, idx_p, tile):
    """Entries ordered by (passive tile, output, split), by another route."""
    n_out, n_splits = idx_a.shape
    o, t = np.divmod(np.arange(n_out * n_splits), n_splits)
    return np.lexsort((t, o, idx_p.ravel() // tile))


def _check_wide_tables(tables, idx_a, idx_p, c_p):
    tile = tables.tile_p
    order = _expected_bucket_order(idx_a, idx_p, tile)
    np.testing.assert_array_equal(tables.bucket_a.numpy(), idx_a.ravel()[order])
    np.testing.assert_array_equal(tables.bucket_p.numpy(), idx_p.ravel()[order])
    ptr, out, tile_ptr = (x.numpy().astype(np.int64) for x in (
        tables.bucket_ptr, tables.bucket_out, tables.tile_ptr))
    assert ptr[0] == 0 and ptr[-1] == idx_a.size and np.all(np.diff(ptr) >= 1)
    assert tile_ptr.size == -(-c_p // tile) + 1 and tile_ptr[-1] == out.size
    owner = np.repeat(np.arange(out.size), np.diff(ptr))  # bucket of each entry
    tile_of = np.repeat(np.arange(tile_ptr.size - 1), np.diff(tile_ptr))
    np.testing.assert_array_equal(tile_of[owner], tables.bucket_p.numpy() // tile)
    np.testing.assert_array_equal(out[owner], np.repeat(np.arange(idx_a.shape[0]),
                                                        idx_a.shape[1])[order])


@pytest.mark.parametrize("k,m,m_a", [(10, 5, 1), (9, 5, 4)])
def test_wide_stage_tables_bucket_like_bucketed_split_entries(k, m, m_a, monkeypatch):
    """A stage whose row does not fit shared memory (here under a budget of
    520 bytes, 128-column tiles) is bucketed by (passive tile, output):
    per tile, the non-empty rows of ``bucketed_split_entries(table, tile)``
    in output order, each in split order, with absolute passive columns."""
    monkeypatch.setattr(ema_ops, "SMEM_BUDGET_BYTES", 520)
    monkeypatch.setattr(ema_ops, "WIDE_TILE_COLS", 128)
    table = build_split_table(k, m, m_a)
    c_p = binom(k, m - m_a)
    tables = prepare_stage_tables(table.idx_a, table.idx_p, c_p, binom(k, m_a), "cpu")
    assert tables.wide and tables.ent is None and tables.tile_p == min(c_p, 128)
    _check_wide_tables(tables, table.idx_a, table.idx_p, c_p)
    tile_ptr, bucket_out, bucket_ptr = (x.tolist() for x in (
        tables.tile_ptr, tables.bucket_out, tables.bucket_ptr))
    for pt, (lo, width, ia, ip, va) in enumerate(bucketed_split_entries(table, tables.tile_p)):
        counts = ia.shape[1] * np.ones(table.n_out, int) if va is None else va.sum(1).astype(int)
        js = range(tile_ptr[pt], tile_ptr[pt + 1])
        assert [bucket_out[j] for j in js] == np.flatnonzero(counts).tolist()
        for j in js:
            o, sl = bucket_out[j], slice(bucket_ptr[j], bucket_ptr[j + 1])
            np.testing.assert_array_equal(tables.bucket_a[sl].numpy(), ia[o, :counts[o]])
            np.testing.assert_array_equal(tables.bucket_p[sl].numpy() - lo, ip[o, :counts[o]])


@pytest.mark.parametrize("k,m,m_a", [(20, 11, 1), (20, 7, 1), (20, 18, 11)])
def test_u20_wide_stages_prepare_tables(k, m, m_a):
    """u20's stages past the shared-memory budget: (20, 11, 1) has a
    184,756-column passive (past the 16-bit packing too), (20, 7, 1) 38,760
    columns, (20, 18, 11) 77,520 passive and 167,960 active columns.  Each
    is bucketed by 1024-column passive tiles and gets 16 rows per pass."""
    table = build_split_table(k, m, m_a)
    c_p, c_a = binom(k, m - m_a), binom(k, m_a)
    tables = prepare_stage_tables(table.idx_a, table.idx_p, c_p, c_a, "cpu")
    assert tables.wide and tables.tile_p == WIDE_TILE_COLS == 1024
    assert kernel_geometry(c_p, c_a, 16) == 16
    assert 16 * WIDE_TILE_COLS * 4 <= SMEM_BUDGET_BYTES
    _check_wide_tables(tables, table.idx_a, table.idx_p, c_p)


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
    """``spmm_blocked.cu``: heavy segments, light rows, heavy reduction."""
    part = op.partition
    n, c = m.shape
    out = torch.full((n, c), float("nan"))
    row_ptr, slot = op.row_ptr.tolist(), part.heavy_slot.tolist()
    groups = _lane_groups(c)
    rp = part.range_ptr.tolist()
    for r in range(part.n_ranges):
        for v in range(rp[r], rp[r + 1]):
            if slot[v] < 0:
                out[v] = _walk(m, op.src, row_ptr[v], row_ptr[v + 1], groups)
    out[part.heavy_rows.long()] = _heavy_sums(op, m)
    return out


def _mirror_wide_ema(tables, act, agg):
    """``spmm_ema_wide_kernel``'s eMA over ``(rows, C_a)`` / ``(rows, C_p)``:
    outputs zeroed, then per passive tile each non-empty bucket's entries
    added in split order."""
    out = torch.zeros((act.shape[0], tables.n_out))
    tile_ptr, bucket_out, bucket_ptr, bucket_a, bucket_p = (x.tolist() for x in (
        tables.tile_ptr, tables.bucket_out, tables.bucket_ptr, tables.bucket_a,
        tables.bucket_p))
    for pt in range(len(tile_ptr) - 1):
        for j in range(tile_ptr[pt], tile_ptr[pt + 1]):
            acc = out[:, bucket_out[j]].clone()
            for e in range(bucket_ptr[j], bucket_ptr[j + 1]):
                assert pt * tables.tile_p <= bucket_p[e] < (pt + 1) * tables.tile_p
                acc += act[:, bucket_a[e]] * agg[:, bucket_p[e]]
            out[:, bucket_out[j]] = acc
    return out


def _mirror_fused_kernel(op, m_p, m_a, tables, rows_pass=None):
    """``spmm_ema.cu``: the heavy rows' aggregate over the ``B * C_p`` row
    first; then per (light range, coloring) CTA, per pass of ``rows_pass``
    rows, the rows' passive aggregate (light rows walked, heavy rows copied;
    per column the same sums whether the walk covers all of ``C_p`` or one
    passive tile) and the eMA: where a row fits shared memory, ``g`` lanes
    per (row, output), each applying the split entries ``j, j + g, ...`` in
    split order before the fold; on a wide stage, the buckets of each
    passive tile in turn (:func:`_mirror_wide_ema`)."""
    part = op.partition
    n, bsz, c_p = m_p.shape
    n_out, n_splits = tables.n_out, tables.n_splits
    rows_pass = rows_pass or kernel_geometry(c_p, tables.c_a, blocked_ops.RANGE_ROWS)
    if not tables.wide:
        ent = tables.ent.long().T
        idx_a, idx_p = ent & 0xFFFF, ent >> 16
    heavy_agg = _heavy_sums(op, m_p.reshape(n, bsz * c_p)).reshape(-1, bsz, c_p)
    row_ptr, slot = op.row_ptr.tolist(), part.heavy_slot.tolist()
    groups = _lane_groups(c_p)
    rp = part.range_ptr.tolist()
    out = torch.full((n, bsz, n_out), float("nan"))
    for r in range(part.n_ranges):
        for b in range(bsz):
            for p0 in range(rp[r], rp[r + 1], rows_pass):
                vs = list(range(p0, min(rp[r + 1], p0 + rows_pass)))
                agg = torch.stack([
                    heavy_agg[slot[v], b] if slot[v] >= 0 else
                    _walk(m_p[:, b], op.src, row_ptr[v], row_ptr[v + 1], groups)
                    for v in vs])
                if tables.wide:
                    out[vs, b] = _mirror_wide_ema(tables, m_a[vs, b], agg)
                    continue
                g = 1
                while g < 32 and g < n_splits and len(vs) * n_out * g * 2 <= 256:
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
    "k,m,m_a,bsz",
    [(10, 5, 1, 2), (8, 8, 4, 1), (9, 5, 4, 3)],
)
def test_spmm_ema_wide_schedule_mirror(k, m, m_a, bsz, monkeypatch):
    """Kernel A's wide path, under a shared-memory budget of 520 bytes and
    128-column passive tiles: (10, 5, 1) walks two passive tiles of 210
    columns, one row per pass; (8, 8, 4) one 70-column tile; (9, 5, 4) a
    narrow 9-column passive with a 126-column active state, 14 rows per
    pass.  Equal to the plain version and the reference's oracle."""
    monkeypatch.setattr(ema_ops, "SMEM_BUDGET_BYTES", 520)
    monkeypatch.setattr(ema_ops, "WIDE_TILE_COLS", 128)
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
    many = torch.zeros(2**20, dtype=torch.int32)
    wide = dataclasses.replace(op, partition=dataclasses.replace(op.partition, seg_beg=many,
                                                                 seg_end=many))
    blocked_ops.check_int32_counts(wide, 2047 * 128)
    with pytest.raises(ValueError, match="heavy items"):
        blocked_ops.check_int32_counts(wide, 2048 * 128)
    counts = blocked_ops.check_int32_counts(op, 49_152)
    assert counts["light-range items (rows x column tiles)"] == blocked_ops.RANGE_ROWS * 384
