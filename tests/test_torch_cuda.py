"""The port's CUDA kernels against their plain versions, on a card.

Every test here is marked ``cuda`` and skips without a card; on one, run::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The file imports neither ``jax`` nor ``repro``, so it runs where only
PyTorch is installed.  Graphs have isolated trailing vertices (empty
destination blocks) and ``n`` that is no multiple of any block size.
The counting kernels also run over partitions with small thresholds (set
on the module's constants with ``monkeypatch``), so that hub rows,
segments whose count is exact, and rows at the heavy threshold all occur
on small graphs; two launches on the same inputs must give the same bits
(no atomics, no timing-dependent order).  Kernel A's wide path (stages
whose row does not fit the shared-memory path's budget, streamed through a
block aggregate) runs at u20's real widths and, forced by small budgets,
at u12's.  Kernel B also runs at the widths of bag extends
(a state of n = 8192 rows flattened to 49,152 to 565,248 columns, walked
in column slabs), and refuses widths whose launch counts would pass its
32-bit ints, as kernel
A's wrapper checks its own at u18's and u20's sizes; non-tree
templates run through the ``blocked`` engine on the card, every fp32 bag
update through the bag eMA kernel (held against the executor's loop on
the card and the CPU on strided, broadcast and masked operands, and
bitwise on a repeat), and the threefry draws on the card equal the CPU's bit for bit.
Tolerances: the plain versions sum with ``index_add_``, whose CUDA atomics
add in no fixed order, and the kernels contract multiply-adds into FMAs.
The fp32 flash-attention kernel computes in fp32 like its plain version
but takes ``exp2`` of pre-scaled scores and sums in another order (fp32:
1e-4).  The bf16 kernel runs its products on the tensor cores with P
split into two bf16 parts (an fp32 P to about 2^-16), and both outputs
are rounded to bf16, one ulp of which is 2^-7 of |want| (bf16: 1e-2
relative, 1e-4 absolute, the gate of ``chip_smoke.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.granite_8b import SMOKE_CONFIG
from repro_torch.core.colorsets import binom, build_split_table
from repro_torch.core.counting import brute_force_colorful, build_counting_plan
from repro_torch.core.engine import CountingEngine
from repro_torch.core.graph import Graph, grid_graph, rmat_graph
from repro_torch.core.prng import fold_in, prng_key, randint, split
from repro_torch.core.templates import connected_graphlets, get_template
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.spmm_blocked import ops as blocked_ops
from repro_torch.kernels.spmm_blocked.ops import prepare_operand, spmm_blocked
from repro_torch.kernels.spmm_blocked.ref import spmm_ref
from repro_torch.kernels.spmm_ema import ops as ema_ops
from repro_torch.kernels.spmm_ema.ops import prepare_stage_tables, spmm_ema
from repro_torch.kernels.spmm_ema.ref import spmm_ema_ref
from repro_torch.models import transformer as T

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _graph():
    g = rmat_graph(3000, 12000, seed=2)
    return Graph(n=3100, src=g.src, dst=g.dst)


@pytest.mark.parametrize("cols", [1, 24, 130])
def test_spmm_blocked_kernel(card, cols):
    g = _graph()
    op = prepare_operand(g, card)
    m = torch.rand((g.n, cols), device=card)
    before = spmm_blocked.launches
    got = spmm_blocked(op, m)
    torch.cuda.synchronize()
    assert spmm_blocked.launches == before + 1
    torch.testing.assert_close(got, spmm_ref(op.src, op.dst, g.n, m), rtol=1e-4, atol=1e-5)
    assert float(got[3000:].abs().max()) == 0.0


@pytest.mark.parametrize("k,m,m_a,bsz", [(7, 4, 1, 3), (7, 7, 3, 2), (12, 6, 4, 1), (16, 9, 1, 1)])
def test_spmm_ema_kernel(card, k, m, m_a, bsz):
    """(16, 9, 1) has 11,440 outputs and a 12,870-column passive: two rows
    per pass."""
    g = _graph()
    op = prepare_operand(g, card)
    table = build_split_table(k, m, m_a)
    tables = prepare_stage_tables(table.idx_a, table.idx_p, binom(k, m - m_a), binom(k, m_a), card)
    m_p = torch.rand((g.n, bsz, binom(k, m - m_a)), device=card)
    m_aa = torch.rand((g.n, bsz, binom(k, m_a)), device=card)
    before = spmm_ema.launches
    got = spmm_ema(op, m_p, m_aa, tables)
    torch.cuda.synchronize()
    assert spmm_ema.launches == before + 1
    want = spmm_ema_ref(op.src, op.dst, g.n, m_p, m_aa, tables.idx_a, tables.idx_p)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def _hub_graph():
    """R-MAT 3000 plus a star hub of degree 512 (64 segments of 8 under the
    small partition) and isolated trailing vertices."""
    g = rmat_graph(3000, 12000, seed=5)
    hub, leaves = 3050, np.arange(0, 3000, 3000 // 512)[:512]
    src = np.concatenate([g.src, leaves, np.full(leaves.size, hub)])
    dst = np.concatenate([g.dst, np.full(leaves.size, hub), leaves])
    order = np.lexsort((src, dst))
    return Graph(n=3100, src=src[order].astype(np.int32), dst=dst[order].astype(np.int32))


#: Small partitions (HEAVY_DEGREE, SEGMENT_EDGES, RANGE_ROWS, RANGE_EDGES):
#: many heavy rows; T = 16 puts degree-16 rows at the threshold and
#: degree-17 rows just above it.  The last is the default.
_PARTITIONS = ((16, 8, 16, 64), (64, 128, 4, 96), None)


def _hub_operand(card, part, monkeypatch):
    if _PARTITIONS[part] is not None:
        for name, value in zip(("HEAVY_DEGREE", "SEGMENT_EDGES", "RANGE_ROWS", "RANGE_EDGES"),
                               _PARTITIONS[part]):
            monkeypatch.setattr(blocked_ops, name, value)
    g = _hub_graph()
    return g, prepare_operand(g, card)


def _close_by_columns(got, want, atol):
    """``assert_close`` at rtol 1e-4 over 16,384 columns at a time, so that
    its temporaries stay small at bag widths."""
    for lo in range(0, got.shape[1], 16_384):
        torch.testing.assert_close(got[:, lo:lo + 16_384], want[:, lo:lo + 16_384], rtol=1e-4,
                                   atol=atol)


@pytest.mark.parametrize("part", range(len(_PARTITIONS)))
@pytest.mark.parametrize("cols", [1, 12, 24, 130, 792, 1_152, 327_680, 491_520, 565_248])
def test_spmm_blocked_kernel_hub_rows(card, cols, part, monkeypatch):
    """Past 8 column tiles kernel B walks slabs (2 tiles each at n = 3100,
    so 1,152 columns end in a slab of one), heavy segments in every one."""
    g, op = _hub_operand(card, part, monkeypatch)
    m = torch.rand((g.n, cols), device=card)
    before = spmm_blocked.device_launches, spmm_blocked.sliced_launches
    got = spmm_blocked(op, m)
    assert spmm_blocked.device_launches == before[0] + (2 if op.partition.n_heavy else 1)
    assert spmm_blocked.sliced_launches == before[1] + (-(-cols // 128) > 8)
    assert torch.equal(got, spmm_blocked(op, m))  # bitwise, launch after launch
    _close_by_columns(got, spmm_ref(op.src, op.dst, g.n, m, col_chunk=4096), atol=1e-5)
    assert float(got[3051:].abs().max()) == 0.0


@pytest.mark.parametrize("part", range(len(_PARTITIONS)))
@pytest.mark.parametrize(
    "k,m,m_a,bsz",
    [(12, 2, 1, 1), (12, 2, 1, 2), (12, 2, 1, 3), (12, 3, 1, 2), (12, 7, 1, 2), (12, 12, 5, 2),
     (12, 6, 4, 3), (5, 2, 1, 1), (7, 4, 1, 3)],
)
def test_spmm_ema_kernel_hub_rows(card, k, m, m_a, bsz, part, monkeypatch):
    """u12's stage geometries (the 12-column leaf, 66, 924 and 792 passive
    columns, the 1-output root), a narrow odd-width passive (5 columns) and
    a wide odd one (35), over heavy segments, light ranges and row passes."""
    g, op = _hub_operand(card, part, monkeypatch)
    _check_spmm_ema(card, g, op, k, m, m_a, bsz)


def _check_spmm_ema(card, g, op, k, m, m_a, bsz, wide=False):
    table = build_split_table(k, m, m_a)
    tables = prepare_stage_tables(table.idx_a, table.idx_p, binom(k, m - m_a), binom(k, m_a), card)
    assert tables.wide == wide
    m_p = torch.rand((g.n, bsz, binom(k, m - m_a)), device=card)
    m_aa = torch.rand((g.n, bsz, binom(k, m_a)), device=card)
    before = spmm_ema.device_launches
    got = spmm_ema(op, m_p, m_aa, tables)
    kernels = 1  # streamed: a fill and an eMA per block of rows
    if tables.route == "streamed":
        rows = ema_ops.block_rows(g.n * bsz, tables.c_p + tables.c_a, tables.plan.n_groups,
                                  ema_ops.wave_blocks(card))
        kernels = 2 * -(-g.n * bsz // rows)
    assert spmm_ema.device_launches == before + kernels + (2 if op.partition.n_heavy else 0)
    again = spmm_ema(op, m_p, m_aa, tables)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = spmm_ema_ref(op.src, op.dst, g.n, m_p, m_aa, tables.idx_a, tables.idx_p,
                        col_chunk=64)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert float(got[3051:].abs().max()) == 0.0
    return tables


@pytest.mark.parametrize("part", [0, 2])
@pytest.mark.parametrize("k,m,m_a,bsz,route", [(20, 11, 1, 1, "streamed"),
                                               (20, 7, 1, 2, "streamed"),
                                               (20, 18, 11, 1, "streamed")])
def test_spmm_ema_kernel_u20_wide_stages(card, k, m, m_a, bsz, route, part, monkeypatch):
    """u20's stages whose row does not fit the shared-memory path: a
    184,756-column passive (in groups of outputs and pieces of splits
    through a block aggregate), 38,760 at two colorings, and 77,520
    passive beside 167,960 active columns (190 outputs at 4 lanes
    each)."""
    g, op = _hub_operand(card, part, monkeypatch)
    assert _check_spmm_ema(card, g, op, k, m, m_a, bsz, wide=True).route == route


@pytest.mark.parametrize("tname,n", [("u18", 1 << 17), ("u20", 1 << 15)])
def test_spmm_ema_int32_counts_at_u18_and_u20_sizes(card, tname, n):
    """Kernel A's 32-bit launch counts at the full-width cells' sizes (R-MAT
    at 8 sampled edges per vertex, one coloring): every wide stage fits,
    and a launch whose counts would wrap is refused before it reaches the
    card.  Every wide stage is streamed: u18's two, u20's (20, 7, 1) (run
    twice), (20, 10, 3), (20, 11, 1) and (20, 18, 11)."""
    from repro_torch.plan.ir import build_template_plan

    op = prepare_operand(rmat_graph(n, 8 * n, seed=1), card)
    plan = build_template_plan([get_template(tname)])
    routes = {}
    for cplan in plan.counting_plans:
        for table in cplan.tables:
            if table is None:
                continue
            c_p, c_a = binom(table.k, table.m - table.m_a), binom(table.k, table.m_a)
            tables = prepare_stage_tables(table.idx_a, table.idx_p, c_p, c_a, card)
            counts = ema_ops.check_int32_counts(op, 1, tables)
            assert max(counts.values()) <= blocked_ops.INT32_MAX
            if tables.wide:  # the first count past its limit is named
                routes.setdefault(tables.route, []).append((table.k, table.m, table.m_a))
                with pytest.raises(ValueError, match="past the kernel's limit"):
                    ema_ops.check_int32_counts(op, ema_ops.MAX_GRID_Y + 1, tables)
    assert {route: sorted(stages) for route, stages in routes.items()} == {
        "u18": {"streamed": [(18, 10, 7), (18, 14, 10)]},
        "u20": {"streamed": [(20, 7, 1), (20, 7, 1), (20, 10, 3), (20, 11, 1), (20, 18, 11)]},
    }[tname]


@pytest.mark.parametrize("part", range(len(_PARTITIONS)))
@pytest.mark.parametrize(
    "k,m,m_a,bsz,budget,wide_smem,route",
    [(12, 2, 1, 1, 64, 232_448, "streamed"), (12, 6, 4, 2, 2048, 1024, "streamed"),
     (12, 12, 5, 3, 4096, 4096, "streamed"), (12, 7, 1, 2, 2048, 2048, "streamed")],
)
def test_spmm_ema_kernel_wide_path_at_u12_widths(card, k, m, m_a, bsz, budget, wide_smem, route,
                                                 part, monkeypatch):
    """The wide path forced by small shared-memory budgets: the 12-column
    leaf beside a 12-column active state in one piece per group; 66 passive beside 495 active columns
    streamed under a 64-column support cap; the 1-output root (792 + 792
    columns) streamed at 32 lanes per output in pieces of 256 columns; 924
    passive columns streamed in groups of 16 outputs, with blocks of 64
    state rows (several fill and eMA launches)."""
    monkeypatch.setattr(ema_ops, "SMEM_BUDGET_BYTES", budget)
    monkeypatch.setattr(ema_ops, "WIDE_SMEM_BYTES", wide_smem)
    monkeypatch.setattr(ema_ops, "WIDE_GROUP_MAX", 16)
    monkeypatch.setattr(ema_ops, "WIDE_SCRATCH_BYTES", 64 * (binom(k, m - m_a) + binom(k, m_a)) * 4)
    g, op = _hub_operand(card, part, monkeypatch)
    assert _check_spmm_ema(card, g, op, k, m, m_a, bsz, wide=True).route == route


def test_kernel_libraries_walk_the_schedule_the_host_models(card):
    """Both libraries export the tile choice and warp count that the visit
    count (``edge_visits``) assumes; loading them checks every width up to
    2048 columns."""
    for lib in (blocked_ops._library(), ema_ops._library()):
        blocked_ops.check_schedule(lib)
        assert lib.edge_walk_warps() == blocked_ops.KERNEL_WARPS
        assert lib.edge_walk_tile_width(792, 4) == 128
        assert lib.edge_walk_tile_width(12, 4) == 16


def test_blocked_engine_on_card_matches_edges_and_brute_force(card):
    g = _graph()
    t = get_template("u7")
    colors = np.random.default_rng(0).integers(0, t.k, size=(3, g.n))
    blocked = CountingEngine(g, [t], backend="blocked", chunk_size=2)
    assert blocked.device.type == "cuda"
    edges = CountingEngine(g, [t], backend="edges", chunk_size=2)
    np.testing.assert_allclose(
        blocked.count_colorings(colors), edges.count_colorings(colors), rtol=1e-5
    )
    tiny = grid_graph(4, 6)
    for tname in ("u5-2", "u7"):
        plan = build_counting_plan(get_template(tname))
        eng = CountingEngine(tiny, [plan.template], backend="blocked")
        c = np.random.default_rng(1).integers(0, plan.template.k, size=tiny.n)
        before = spmm_ema.launches
        raw = float(eng.raw_counts(c)[0]) / plan.automorphisms
        assert spmm_ema.launches > before  # every stage went through the fused kernel
        assert raw == brute_force_colorful(tiny, plan.template, c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("h_kv", [1, 2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel(card, causal, h_kv, d, dtype):
    """h = 4 query heads over 1 (MQA), 2 (GQA) or 4 (MHA) kv heads; square,
    ragged and rectangular sequences (causal is top-left aligned)."""
    # bf16: one output rounding (<= 2^-7 relative) of values both sides
    # compute in fp32; the absolute term stays far below typical outputs
    rtol, atol = (1e-4, 1e-4) if dtype == torch.float32 else (1e-2, 1e-4)
    gen = torch.Generator(device=card).manual_seed(d + h_kv)
    for b, sq, sk in ((2, 128, 128), (1, 100, 100), (2, 77, 200), (1, 130, 70)):
        q = torch.randn((b, sq, 4, d), generator=gen, device=card).to(dtype)
        k = torch.randn((b, sk, h_kv, d), generator=gen, device=card).to(dtype)
        v = torch.randn((b, sk, h_kv, d), generator=gen, device=card).to(dtype)
        before = flash_attention.launches
        got = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1
        assert got.shape == q.shape and got.dtype == dtype
        torch.testing.assert_close(got, flash_attention_ref(q, k, v, causal), rtol=rtol, atol=atol)


def _flash_tolerance(dtype):
    return dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,sq,sk", [(True, 300, 300), (False, 256, 333), (False, 100, 130)])
def test_flash_attention_granite_heads(card, causal, sq, sk, dtype):
    """granite-8b's head geometry, h = 32 over h_kv = 8 at d = 128.  The
    non-causal key lengths are no multiple of either kernel's key tile
    (bf16: 128, fp32: 64), so the last tile masks keys past ``sk``."""
    gen = torch.Generator(device=card).manual_seed(sk)
    q = torch.randn((2, sq, 32, 128), generator=gen, device=card).to(dtype)
    k = torch.randn((2, sk, 8, 128), generator=gen, device=card).to(dtype)
    v = torch.randn((2, sk, 8, 128), generator=gen, device=card).to(dtype)
    got = flash_attention(q, k, v, causal=causal)
    torch.testing.assert_close(got, flash_attention_ref(q, k, v, causal), **_flash_tolerance(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_reads_and_writes_the_model_layout(card, dtype):
    """q, k and v may be strided views (here the heads of one fused
    projection); the kernel reads them in place and writes a fresh
    contiguous (b, sq, h, d) ``out``: the call allocates nothing of Q's
    size beside it (no copy of q, k, v or out).  Only bf16 counts a
    tensor-core launch."""
    b, s, h, h_kv, d = 2, 200, 8, 2, 64
    gen = torch.Generator(device=card).manual_seed(3)
    qkv = torch.randn((b, s, h + 2 * h_kv, d), generator=gen, device=card).to(dtype)
    q, k, v = qkv[:, :, :h], qkv[:, :, h: h + h_kv], qkv[:, :, h + h_kv:]
    assert not q.is_contiguous()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(card)
    base = torch.cuda.memory_allocated(card)
    before = flash_attention.launches, flash_attention.tensor_core_launches
    out = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(card) - base
    assert out.shape == (b, s, h, d) and out.is_contiguous()
    assert peak - out.numel() * out.element_size() < q.numel() * q.element_size()
    assert flash_attention.launches == before[0] + 1
    assert flash_attention.tensor_core_launches == before[1] + (dtype == torch.bfloat16)
    torch.testing.assert_close(out, flash_attention_ref(q, k, v, True), **_flash_tolerance(dtype))


def test_flash_attention_raises_for_what_it_cannot_launch(card):
    q = torch.zeros((1, 8, 2, 48), device=card)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q, q)
    q = torch.zeros((1, 8, 2, 64), device=card, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_attention(q, q, q)
    q = torch.zeros((1, 8, 64, 2), device=card, dtype=torch.bfloat16).transpose(2, 3)
    with pytest.raises(ValueError, match="unit stride"):
        flash_attention(q, q, q)


def test_lm_forward_on_card_matches_cpu(card):
    """granite-8b-smoke with ``attn_impl="flash"``: the card's forward, whose
    attention is the kernel (one launch per layer), against the CPU's."""
    cfg = dataclasses.replace(SMOKE_CONFIG, attn_impl="flash")
    params = T.init_params(cfg, seed=0, device="cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(2, 100))
    want, _, _ = T.forward(params, cfg, tokens)

    def to_card(tree):
        if isinstance(tree, dict):
            return {k: to_card(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_card(v) for v in tree]
        return tree.to(card)

    before = flash_attention.launches
    got, _, _ = T.forward(to_card(params), cfg, tokens)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("cols", [49_152, 98_304, 327_680, 491_520, 565_248])
def test_spmm_blocked_kernel_at_bag_widths(card, cols):
    """Bag extends' widths on 8192 vertices (one heavy row, two segments):
    slabs of one tile, each launch counted as sliced."""
    g = rmat_graph(8192, 80_000, seed=2)
    op = prepare_operand(g, card)
    assert op.partition.n_heavy > 0
    gen = torch.Generator(device=card).manual_seed(cols)
    m = torch.rand((g.n, cols), generator=gen, device=card)
    before = spmm_blocked.sliced_launches
    got = spmm_blocked(op, m)
    assert spmm_blocked.sliced_launches == before + 1
    assert torch.equal(got, spmm_blocked(op, m))
    want = spmm_ref(op.src, op.dst, g.n, m, col_chunk=4096)
    _close_by_columns(got, want, atol=1e-6 * float(want.abs().max()))


def test_spmm_blocked_refuses_widths_past_its_int32_counts(card):
    # the column index: C plus one tile must stay below 2**31 (8 GB of M)
    lone = prepare_operand(Graph(n=1, src=np.zeros(0, np.int64), dst=np.zeros(0, np.int64)), card)
    with pytest.raises(ValueError, match="column index"):
        spmm_blocked(lone, torch.empty((1, 2**31 - 64), device=card))
    # a product in one slab: 2**28 heavy segments x 8 column tiles = 2**31
    # warp items (segments with no memory behind them: the wrapper refuses
    # before it allocates or launches)
    g = _graph()
    op = prepare_operand(g, card)
    many = torch.zeros(1, dtype=torch.int32, device=card).expand(2**28)
    wide = dataclasses.replace(op, partition=dataclasses.replace(op.partition, seg_beg=many,
                                                                 seg_end=many))
    with pytest.raises(ValueError, match="heavy items"):
        spmm_blocked(wide, torch.empty((g.n, 8 * 128), device=card))
    assert blocked_ops.check_int32_counts(op, 49_152)["column index (C + one tile)"] == 49_280


def test_u18_totals_past_fp32_range_are_finite_on_card(card):
    """u18 on R-MAT with 2^13 vertices (8 sampled edges per vertex, the
    ``[wide]`` phase's graph one size above its gate): the engine's bound
    on the totals passes fp32's range, so the walk takes a range shift, and
    the ``blocked`` engine's estimates are finite and within the limit of
    the benchmark's ``rmat17-u18-wide`` cell of the plain float64
    reference."""
    import json
    from pathlib import Path

    from portbench.reference import colorcoding

    limit = json.loads((Path(__file__).resolve().parents[1] / "portbench" / "workloads"
                        / "rmat17-u18-wide.json").read_text())["max_rel_gap_limit"]
    g = rmat_graph(1 << 13, 8 << 13, seed=1)
    t = get_template("u18")
    eng = CountingEngine(g, [t], backend="blocked", chunk_size=1, device=card)
    rng = eng.describe()["range"]
    assert eng.range_shift >= 1 and rng["bound_log2"] > 128 > rng["shifted_log2"]
    keys = split(prng_key(5, card), 2)
    est = eng.count_keys(keys)
    assert np.all(np.isfinite(est)) and np.all(est > 0)
    src, dst = (torch.as_tensor(a, dtype=torch.int64, device=card) for a in (g.src, g.dst))
    adj = colorcoding.Adjacency(src, dst, g.n, dense=False)
    for j in range(keys.shape[0]):
        colors = randint(keys[j], (g.n,), 0, t.k)
        want = colorcoding.estimate(adj, colors, [tuple(e) for e in t.edges])
        assert abs(est[j, 0] - want) <= limit * want, (j, est[j, 0], want)


def test_bag_stages_on_card_match_edges_and_cpu(card):
    g = rmat_graph(200, 900, seed=5)
    keys = split(prng_key(1), 3)
    for k in (3, 4):
        ts = list(connected_graphlets(k))
        before, fused_before = spmm_blocked.launches, ema_ops.bag_ema.launches
        blocked = CountingEngine(g, ts, device=card, backend="blocked")
        got = blocked.count_keys(keys)
        assert spmm_blocked.launches > before  # bag extends went through kernel B
        # every fp32 bag update went through the bag eMA kernel
        assert blocked.counters["bag_fused"] > 0 and blocked.counters["bag_loop"] == 0
        assert ema_ops.bag_ema.launches - fused_before == blocked.counters["bag_fused"]
        assert np.array_equal(blocked.count_keys(keys), got)  # bitwise on a repeat
        edges = CountingEngine(g, ts, device=card, backend="edges")
        want = edges.count_keys(keys)
        assert edges.counters["bag_fused"] > 0 and edges.counters["bag_loop"] == 0
        np.testing.assert_allclose(got, want, rtol=1e-4)
        cpu = CountingEngine(g, ts, device="cpu", backend="edges")
        np.testing.assert_allclose(got, cpu.count_keys(keys), rtol=1e-4)
        assert cpu.counters["bag_fused"] == 0 and cpu.counters["bag_loop"] > 0
    # a bf16 store falls back to the loop on the card
    half = CountingEngine(g, list(connected_graphlets(3)), device=card, backend="blocked",
                          dtype_policy="bf16")
    half.count_keys(keys)
    assert half.counters["bag_fused"] == 0 and half.counters["bag_loop"] > 0
    tiny = grid_graph(4, 5)
    for name in ("triangle", "square", "diamond", "clique4"):
        t = get_template(name)
        plan = build_counting_plan(t)
        c = np.random.default_rng(2).integers(0, t.k, size=tiny.n)
        eng = CountingEngine(tiny, [t], backend="blocked")
        raw = float(eng.raw_counts(c)[0])
        assert eng.counters["bag_fused"] > 0 and eng.counters["bag_loop"] == 0
        assert raw / plan.automorphisms == brute_force_colorful(tiny, t, c)


# (vertex axes, B, SpMM'd input, mask axes, permuted input) at n = 37
BAG_EMA_CASES = [
    (1, 3, True, (), False),
    (2, 10, False, (1,), False),
    (2, 23, True, (1,), False),
    (2, 10, True, (), True),
    (3, 3, True, (1, 2), False),
    (3, 2, False, (2,), True),
]


@pytest.mark.parametrize("r,bsz,spmm,mask_axes,permuted", BAG_EMA_CASES)
def test_bag_ema_kernel(card, r, bsz, spmm, mask_axes, permuted):
    """The bag eMA against the executor's loop on the same operands, on the
    card and on the CPU (the loop's ``addcmul_`` need not contract into an
    FMA as the kernel's does: 1e-6 relative), and bitwise on a repeat."""
    from repro_torch.exec.local import LocalBackend

    n, k, c_p, n_out = 37, 4, 6, 4
    rng = np.random.default_rng(r * 7 + bsz)
    ia, ip = rng.integers(0, k, (3, n_out)), rng.integers(0, c_p, (3, n_out))
    ent = ema_ops.pack_bag_entries(ia, ip, card)
    adj = rng.random((n, n)) < 0.3
    adj = torch.as_tensor((adj | adj.T).astype(np.float32), device=card)
    shape = (n,) * r + (bsz, c_p)
    p = torch.rand(shape[1:] if not spmm else shape, device=card)
    if permuted and p.dim() >= 4:
        order = list(range(p.dim() - 2))[::-1] + [p.dim() - 2, p.dim() - 1]
        p = p.permute(order).contiguous().permute(order)
    if not spmm:
        p = p.unsqueeze(0).expand(shape)
    leaf = torch.rand((n, bsz, k), device=card)
    a = leaf.reshape((n,) + (1,) * (r - 1) + (bsz, k)).expand(shape[:-1] + (k,))
    before = ema_ops.bag_ema.launches
    got = ema_ops.bag_ema(a, p, ent, mask_axes, adj)
    again = ema_ops.bag_ema(a, p, ent, mask_axes, adj)
    torch.cuda.synchronize()
    assert ema_ops.bag_ema.launches - before == 2
    assert torch.equal(got, again)
    for dev in (card, torch.device("cpu")):
        tables = dataclasses.make_dataclass("T", ["idx_a", "idx_p", "n_out", "n_terms"])(
            torch.as_tensor(ia, device=dev), torch.as_tensor(ip, device=dev), n_out, 3)
        state = p.to(dev)
        loop = LocalBackend._bag_extend_loop(state.clone() if spmm else state, spmm,
                                             leaf.to(dev), tables, list(mask_axes), adj.to(dev),
                                             torch.float32)
        torch.testing.assert_close(got.to(dev), loop, rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match="float32"):
        ema_ops.bag_ema(a.to(torch.bfloat16), p.to(torch.bfloat16), ent)


def test_prng_draws_on_card_equal_cpu(card):
    keys = split(prng_key(5), 6)
    for n, k in ((1, 2), (8191, 3), (1 << 20, 12)):
        assert torch.equal(randint(keys.to(card), (n,), 0, k).cpu(), randint(keys, (n,), 0, k))
    idx = torch.arange(6)
    assert torch.equal(fold_in(keys.to(card), idx.to(card)).cpu(), fold_in(keys, idx))
