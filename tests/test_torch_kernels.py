"""The port's kernel modules against the reference's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; the reference runs
its Pallas kernels in interpret mode, as its own tests do.  The CUDA
kernels themselves run only on a card, where ``tests/test_torch_cuda.py``
(and ``chip_smoke.py``, at full size) holds them against the plain versions.
The host-side preparation the CUDA kernel reads (bucketed stage tables,
geometry, the compact operand) is checked here, including a NumPy mirror of
the fused kernel's tile loop.
"""

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
from repro_torch.kernels.spmm_blocked.ops import prepare_operand, spmm_blocked
from repro_torch.kernels.spmm_ema.ops import (
    SMEM_BUDGET_BYTES,
    TILE_COLS,
    kernel_geometry,
    prepare_stage_tables,
    spmm_ema,
)


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
    table = build_split_table(k, m, m_a)
    tables = prepare_stage_tables(table.idx_a, table.idx_p, binom(k, m - m_a), binom(k, m_a), "cpu")
    ent_a, ent_p = tables.ent_a.numpy(), tables.ent_p.numpy()
    buckets = [b for b in bucketed_split_entries(table, TILE_COLS) if b[2].shape[1] and (
        b[4] is None or b[4].any())]
    assert tables.n_batches == len(buckets)
    for i, (lo, width, ia, ip, va) in enumerate(buckets):
        assert tables.batch_lo[i] == lo and tables.batch_cols[i] == width
        w = int(tables.batch_width[i])
        off = int(tables.batch_off[i])
        ea = ent_a[off : off + table.n_out * w].reshape(table.n_out, w)
        ep = ent_p[off : off + table.n_out * w].reshape(table.n_out, w)
        valid = np.ones_like(ia, dtype=bool) if va is None else va > 0
        np.testing.assert_array_equal(ea >= 0, valid)
        np.testing.assert_array_equal(np.where(valid, ea, -1), np.where(valid, ia, -1))
        np.testing.assert_array_equal(np.where(valid, ep, 0), np.where(valid, ip, 0))


@pytest.mark.parametrize("n_out", [1, 66, 924, 3432, 12870])
def test_kernel_geometry_fits_shared_memory(n_out):
    rows, out_tile = kernel_geometry(n_out)
    assert rows * (TILE_COLS + out_tile) * 4 <= SMEM_BUDGET_BYTES
    assert 1 <= out_tile <= n_out and rows >= 8
    if out_tile < n_out:
        assert rows == 8


def _mirror_fused_kernel(op, m_p, m_a, tables, rows, out_tile):
    """NumPy mirror of ``spmm_ema.cu``: per (row block, coloring, output
    tile) CTA, per passive tile, walk the rows' edges into an aggregate
    tile, then apply that tile's bucketed entries in split order."""
    n, bsz, _ = m_p.shape
    n_out = tables.n_out
    row_ptr, src = op.row_ptr.numpy(), op.src.numpy()
    lo_, cols_, width_, off_ = (t.numpy() for t in (
        tables.batch_lo, tables.batch_cols, tables.batch_width, tables.batch_off))
    ent_a, ent_p = tables.ent_a.numpy(), tables.ent_p.numpy()
    out = np.full((n, bsz, n_out), np.nan, dtype=np.float32)
    for v0 in range(0, n, rows):
        vs = range(v0, min(n, v0 + rows))
        for b in range(bsz):
            for o0 in range(0, n_out, out_tile):
                acc = np.zeros((rows, out_tile), dtype=np.float32)
                for t in range(tables.n_batches):
                    agg = np.zeros((rows, TILE_COLS), dtype=np.float32)
                    for r, v in enumerate(vs):
                        for e in range(row_ptr[v], row_ptr[v + 1]):
                            agg[r, : cols_[t]] += m_p[src[e], b, lo_[t] : lo_[t] + cols_[t]]
                    for r, v in enumerate(vs):
                        for o in range(o0, min(n_out, o0 + out_tile)):
                            base = off_[t] + o * width_[t]
                            for j in range(width_[t]):
                                a = ent_a[base + j]
                                if a >= 0:
                                    acc[r, o - o0] += m_a[v, b, a] * agg[r, ent_p[base + j]]
                for r, v in enumerate(vs):
                    hi = min(n_out, o0 + out_tile)
                    out[v, b, o0:hi] = acc[r, : hi - o0]
    return out


@pytest.mark.parametrize("k,m,m_a,out_tile", [(7, 4, 1, None), (7, 7, 3, None), (6, 4, 2, 4)])
def test_fused_kernel_tile_loop_mirror(k, m, m_a, out_tile):
    """The kernel's algorithm (tiles, bucketing, output tiling, empty
    blocks, ragged ``n``) reproduces the two-pass plain version."""
    g = _with_isolated_tail(rmat_graph(45, 150, seed=k + m), 75)
    op = prepare_operand(g, "cpu")
    table = build_split_table(k, m, m_a)
    tables = prepare_stage_tables(table.idx_a, table.idx_p, binom(k, m - m_a), binom(k, m_a), "cpu")
    m_p, m_aa = _stage_inputs(g.n, 2, k, m, m_a, seed=3)
    rows, tile = kernel_geometry(table.n_out)
    got = _mirror_fused_kernel(op, m_p, m_aa, tables, 16, out_tile or tile)
    want = spmm_ema(op, torch.from_numpy(m_p), torch.from_numpy(m_aa), tables)
    _close(got, want)
    assert np.all(got[45:] == 0)


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
