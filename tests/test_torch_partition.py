"""The edge-balanced partition that both counting kernels launch over.

``repro_torch.kernels.spmm_blocked.ops.build_partition`` cuts rows above a
degree threshold into segments and packs the rest into short ranges; the
kernels' schedules over it are mirrored in ``tests/test_torch_kernels.py``.
The thresholds are module constants; tests that need small ones set them
with ``monkeypatch``.  These checks are exact (integers only) and need
neither JAX nor a card.
"""

import numpy as np
import pytest

from repro_torch.core.colorsets import binom
from repro_torch.core.graph import Graph, rmat_graph
from repro_torch.core.templates import get_template
from repro_torch.kernels.spmm_blocked import ops as blocked_ops
from repro_torch.kernels.spmm_blocked.ops import (
    HEAVY_DEGREE,
    KERNEL_WARPS,
    RANGE_EDGES,
    RANGE_ROWS,
    SEGMENT_EDGES,
    build_partition,
    check_schedule,
    check_slabs,
    edge_visits,
    prepare_operand,
    slab_tiles,
    slab_visits,
    tile_width,
)
from repro_torch.kernels.spmm_ema.ops import kernel_geometry
from repro_torch.plan.ir import build_template_plan

#: The acceptance cap: edge visits (edges x passive tiles) per warp on a u12 stage.
VISIT_CAP = 32_768


def _graph(edges, n):
    """An undirected graph from ``(u, v)`` pairs, both directions, (dst, src) order."""
    e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    src = np.concatenate([e[:, 0], e[:, 1]])
    dst = np.concatenate([e[:, 1], e[:, 0]])
    order = np.lexsort((src, dst))
    return Graph(n=n, src=src[order].astype(np.int32), dst=dst[order].astype(np.int32))


def star(leaves, hub=3, n=None):
    n = n or leaves + 1
    others = [v for v in range(n) if v != hub][:leaves]
    return _graph([(hub, v) for v in others], n)


def small_partition(monkeypatch, **thresholds):
    """Set partition thresholds by lower-case name, e.g. ``heavy_degree=6``."""
    for name, value in thresholds.items():
        monkeypatch.setattr(blocked_ops, name.upper(), value)


def _check_partition(g):
    op = prepare_operand(g, "cpu")
    part = op.partition
    row_ptr = op.row_ptr.numpy().astype(np.int64)
    deg = np.diff(row_ptr)
    t, s = blocked_ops.HEAVY_DEGREE, blocked_ops.SEGMENT_EDGES
    r, cap = blocked_ops.RANGE_ROWS, blocked_ops.RANGE_EDGES
    heavy_rows = part.heavy_rows.numpy()
    slot = part.heavy_slot.numpy()
    np.testing.assert_array_equal(heavy_rows, np.flatnonzero(deg > t))
    assert np.all(slot[heavy_rows] == np.arange(heavy_rows.size))
    assert np.sum(slot >= 0) == heavy_rows.size

    # segments: >= 2 per heavy row, <= S edges, contiguous, in edge order
    seg_ptr, beg, end = (x.numpy().astype(np.int64) for x in (
        part.seg_ptr, part.seg_beg, part.seg_end))
    assert seg_ptr[0] == 0 and seg_ptr[-1] == beg.size
    assert np.all(np.diff(seg_ptr) >= 2)
    assert np.all(end - beg >= 1) and np.all(end - beg <= s)
    covered = np.zeros(g.num_directed, dtype=np.int64)
    for h, v in enumerate(heavy_rows):
        b, e = beg[seg_ptr[h]:seg_ptr[h + 1]], end[seg_ptr[h]:seg_ptr[h + 1]]
        assert b[0] == row_ptr[v] and e[-1] == row_ptr[v + 1]
        np.testing.assert_array_equal(b[1:], e[:-1])
        for x, y in zip(b, e):
            covered[x:y] += 1

    # light ranges tile 0..n in order, <= R rows, < E_cap light edges
    rp = part.range_ptr.numpy().astype(np.int64)
    assert rp[0] == 0 and rp[-1] == g.n and np.all(np.diff(rp) >= 1)
    assert np.all(np.diff(rp) <= r)
    light_deg = np.where(slot < 0, deg, 0)
    per_range = np.add.reduceat(light_deg, rp[:-1]) if g.n else np.zeros(0)
    assert np.all(per_range < cap)
    for v in np.flatnonzero(slot < 0):
        covered[row_ptr[v]:row_ptr[v + 1]] += 1
    np.testing.assert_array_equal(covered, 1)  # every edge exactly once
    return op


@pytest.mark.parametrize("segments", [2, 3, 5])
def test_partition_star_hub_exact_multiple_of_segment(segments, monkeypatch):
    """A hub of degree ``segments * S`` gets exactly that many full segments."""
    s = 8
    g = star(segments * s, n=segments * s + 10)
    small_partition(monkeypatch, heavy_degree=6, segment_edges=s, range_rows=4, range_edges=12)
    op = _check_partition(g)
    part = op.partition
    assert part.heavy_rows.tolist() == [3]
    assert np.all((part.seg_end - part.seg_beg).numpy() == s)
    assert part.n_segments == segments


@pytest.mark.parametrize("above", [0, 1])
def test_partition_threshold_boundary(above, monkeypatch):
    """A row of degree exactly T stays light; one edge more makes it heavy,
    with two segments even though it fits in one."""
    t = 10
    g = star(t + above, n=40)
    small_partition(monkeypatch, heavy_degree=t, segment_edges=64, range_rows=8, range_edges=16)
    op = _check_partition(g)
    part = op.partition
    assert part.n_heavy == above
    if above:
        assert (part.seg_end - part.seg_beg).tolist() == [6, 5]


def test_partition_rmat_with_hubs_and_isolated_tail(monkeypatch):
    g0 = rmat_graph(300, 3000, seed=4)
    g = Graph(n=400, src=g0.src, dst=g0.dst)  # rows 300.. have no edges
    small_partition(monkeypatch, heavy_degree=40, segment_edges=32, range_rows=16,
                    range_edges=64)
    op = _check_partition(g)
    part = op.partition
    assert part.n_heavy >= 3
    rp = part.range_ptr.numpy()
    assert rp[rp >= 304].tolist() == list(range(304, 400, 16)) + [400]


def test_partition_defaults_and_empty_graph(monkeypatch):
    """The default thresholds (chosen in the module from the smoke graph)
    and an empty graph; thresholds that cannot bound a range are refused."""
    assert (HEAVY_DEGREE, SEGMENT_EDGES, RANGE_ROWS, RANGE_EDGES) == (1024, 2048, 16, 4096)
    g = rmat_graph(2000, 8000, seed=1)
    _check_partition(g)
    empty = Graph(n=33, src=np.zeros(0, np.int32), dst=np.zeros(0, np.int32))
    part = _check_partition(empty).partition
    assert part.n_heavy == 0 and part.range_ptr.tolist() == [0, 16, 32, 33]
    small_partition(monkeypatch, heavy_degree=64, range_edges=64)
    with pytest.raises(ValueError):
        build_partition(np.zeros(5, np.int64), "cpu")


@pytest.mark.parametrize("c,width", [(1, 1), (12, 16), (24, 32), (64, 64), (66, 128),
                                     (130, 128), (792, 128), (7, 8)])
def test_tile_width_mirrors_dispatch(c, width):
    assert tile_width(c) == width


class _FakeLibrary:
    """Stands in for a built kernel library's schedule exports."""

    def __init__(self, warps, width):
        def tile(c, vec):
            return width(c)

        self.edge_walk_tile_width = tile
        self.edge_walk_warps = lambda: warps


def test_check_schedule_holds_the_host_model_against_the_library():
    """The host's copies of the tile choice and warp count (which
    ``edge_visits`` and so the visit cap rest on) must match what a built
    library exports, or loading it fails."""
    check_schedule(_FakeLibrary(KERNEL_WARPS, tile_width))
    with pytest.raises(RuntimeError, match="warps"):
        check_schedule(_FakeLibrary(KERNEL_WARPS * 2, tile_width))
    with pytest.raises(RuntimeError, match="C=66"):
        check_schedule(_FakeLibrary(KERNEL_WARPS, lambda c: 64 if c == 66 else tile_width(c)))


def _u12_stages():
    plan = build_template_plan([get_template("u12")])
    seen = []
    for cplan in plan.counting_plans:
        for table in cplan.tables:
            if table is not None and (table.k, table.m, table.m_a) not in seen:
                seen.append((table.k, table.m, table.m_a))
    return [(binom(k, m - m_a), binom(k, m_a)) for k, m, m_a in seen]


def test_edge_visits_cap_on_u12_stages_of_a_hub_graph():
    """On an R-MAT graph whose hubs would break the cap if one warp walked a
    whole row per passive tile, no warp of any u12 stage (two colorings)
    makes more than 32,768 edge visits with the default partition."""
    g = rmat_graph(1 << 16, 1 << 19, seed=1)
    deg = g.degrees()
    op = prepare_operand(g, "cpu")
    assert op.partition.n_heavy > 0
    stages = _u12_stages()
    assert len(stages) == 7
    widest = max(c_p for c_p, _ in stages)
    assert int(deg.max()) * -(-widest // tile_width(widest)) > VISIT_CAP
    for c_p, c_a in stages:
        v = edge_visits(op, c_p, kernel_geometry(c_p, c_a, RANGE_ROWS))
        assert v["max"] <= VISIT_CAP, (c_p, c_a, v)
        assert v["heavy_warp"] <= SEGMENT_EDGES
        assert v["light_warp"] <= RANGE_EDGES * v["tiles"]


def test_edge_visits_counts_the_round_robin_items(monkeypatch):
    """One range of rows 0..3 with degrees (5, 0, 2, 1) at 3 tiles: items
    (row, tile) go to warps ``(row * 3 + tile) % 8``."""
    g = _graph([(0, 4), (0, 5), (0, 6), (0, 7), (0, 8), (2, 9), (2, 10), (3, 11)], 12)
    small_partition(monkeypatch, heavy_degree=6, segment_edges=4, range_rows=4, range_edges=16)
    op = prepare_operand(g, "cpu")
    v = edge_visits(op, 300)  # 3 tiles of 128 columns
    # row 0 -> warps 0, 1, 2 (5 each); row 2 -> warps 6, 7, 0; row 3 -> 1, 2, 3
    assert v == {"light_warp": 7, "heavy_warp": 0, "max": 7, "tiles": 3}


# ---------------------------------------------------------------------------
# kernel B's column slabs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def motif_operand():
    """The motif benchmark's graph (``portbench/configs/rmat8k-motifs.json``:
    R-MAT, n = 8192, 131,072 sampled edges, seed 2), built on the CPU."""
    from portbench.reference.rmat import rmat_edges

    src, dst = rmat_edges(8192, 131_072, 2)
    op = prepare_operand(Graph(n=8192, src=src.numpy(), dst=dst.numpy()), "cpu")
    assert (op.num_directed, op.partition.n_heavy, op.partition.n_ranges) == (203_750, 14, 572)
    return op


@pytest.mark.parametrize("cols", [491_520, 327_680, 565_248])
def test_slab_visits_balance_bag_widths(motif_operand, cols):
    """At the bag extends' widths (the paw's and 4-cycle's at a chunk of 10,
    the 4-cycle's last, the service's triangle) the slabs spread the launch:
    its bound is within 1.5x of the even share of the card's warps, where
    one slab's heaviest warp alone is 8.44x it."""
    v = slab_visits(motif_operand, cols)
    assert v["slabs"] == v["tiles"] > 1  # slabs of one tile at n = 8192
    assert v["even"] <= v["bound"] <= 1.5 * v["even"]
    assert v["max"] <= RANGE_EDGES
    whole = edge_visits(motif_operand, cols)["max"]
    assert round(whole / v["even"], 2) == 8.44


@pytest.mark.parametrize("cols", [12, 40, 300])
def test_slab_visits_narrow_widths_keep_one_slab(motif_operand, cols):
    """Narrow products (the leaf stage's, the paw's last extend, three
    tiles) are one slab: the schedule of every tile in turn, whose
    heaviest warp ``edge_visits`` counts."""
    v = slab_visits(motif_operand, cols)
    assert (v["slabs"], v["slab_tiles"]) == (1, v["tiles"])
    assert v["max"] == edge_visits(motif_operand, cols)["max"]


@pytest.mark.parametrize("c,n,slab", [(1024, 8192, 8), (1025, 8192, 1), (491_520, 8192, 1),
                                      (491_520, 1024, 8), (1025, 97, 9), (300, 97, 3),
                                      (2**31 - 129, 1 << 20, 257)])
def test_slab_tiles(c, n, slab):
    """Up to 8 tiles one slab; past that, slabs span 4 MiB of M (one tile
    at n = 8192, 8 at n = 1024), at least one tile, and at most 65,535
    slabs (the widest product on 2^20 rows needs 257-tile slabs)."""
    assert slab_tiles(c, n) == slab


class _FakeSlabLibrary:
    """Stands in for kernel B's library's slab export."""

    def __init__(self, slabs):
        self.spmm_blocked_slab_tiles = lambda c, vec, n: slabs(c, n)


def test_check_slabs_holds_the_host_model_against_the_library():
    """The host's copy of the slab choice (which ``slab_visits`` and the
    int32 counts rest on) must match kernel B's library, or loading it
    fails."""
    check_slabs(_FakeSlabLibrary(slab_tiles))
    with pytest.raises(RuntimeError, match="C=491520, n=8192"):
        check_slabs(_FakeSlabLibrary(
            lambda c, n: 8 if (c, n) == (491_520, 8192) else slab_tiles(c, n)))
