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
whose row does not fit shared memory) runs at u20's real widths and, under
a small budget, at u12's.  Kernel B also runs at the widths of bag extends
(a state of n = 8192 rows flattened to 49,152 and 98,304 columns), and
refuses widths whose launch counts would pass its 32-bit ints; non-tree
templates run through the ``blocked`` engine on the card, and the threefry
draws on the card equal the CPU's bit for bit.
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


@pytest.mark.parametrize("part", range(len(_PARTITIONS)))
@pytest.mark.parametrize("cols", [1, 12, 24, 130, 792])
def test_spmm_blocked_kernel_hub_rows(card, cols, part, monkeypatch):
    g, op = _hub_operand(card, part, monkeypatch)
    m = torch.rand((g.n, cols), device=card)
    before = spmm_blocked.device_launches
    got = spmm_blocked(op, m)
    assert spmm_blocked.device_launches == before + (2 if op.partition.n_heavy else 1)
    again = spmm_blocked(op, m)
    torch.cuda.synchronize()
    assert torch.equal(got, again)  # bitwise, launch after launch
    torch.testing.assert_close(got, spmm_ref(op.src, op.dst, g.n, m), rtol=1e-4, atol=1e-5)
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
    assert spmm_ema.device_launches == before + (3 if op.partition.n_heavy else 1)
    again = spmm_ema(op, m_p, m_aa, tables)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = spmm_ema_ref(op.src, op.dst, g.n, m_p, m_aa, tables.idx_a, tables.idx_p,
                        col_chunk=64)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert float(got[3051:].abs().max()) == 0.0


@pytest.mark.parametrize("part", [0, 2])
@pytest.mark.parametrize("k,m,m_a,bsz", [(20, 11, 1, 1), (20, 7, 1, 2), (20, 18, 11, 1)])
def test_spmm_ema_kernel_u20_wide_stages(card, k, m, m_a, bsz, part, monkeypatch):
    """u20's stages whose row does not fit shared memory: a 184,756-column
    passive (past 28,672 columns and the 16-bit packing), 38,760, and 77,520
    passive beside 167,960 active columns; 1024-column passive tiles."""
    g, op = _hub_operand(card, part, monkeypatch)
    _check_spmm_ema(card, g, op, k, m, m_a, bsz, wide=True)


@pytest.mark.parametrize("part", range(len(_PARTITIONS)))
@pytest.mark.parametrize(
    "k,m,m_a,bsz,budget",
    [(12, 2, 1, 1, 64), (12, 6, 4, 2, 2048), (12, 12, 5, 3, 4096), (12, 7, 1, 2, 2048)],
)
def test_spmm_ema_kernel_wide_path_at_u12_widths(card, k, m, m_a, bsz, budget, part,
                                                 monkeypatch):
    """The wide path forced by a small shared-memory budget and 256-column
    passive tiles: the 12-column leaf (one row per pass), 66 passive beside
    495 active columns (one tile), 792 and 924 columns (four tiles)."""
    monkeypatch.setattr(ema_ops, "SMEM_BUDGET_BYTES", budget)
    monkeypatch.setattr(ema_ops, "WIDE_TILE_COLS", 256)
    g, op = _hub_operand(card, part, monkeypatch)
    _check_spmm_ema(card, g, op, k, m, m_a, bsz, wide=True)


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


@pytest.mark.parametrize("cols", [49_152, 98_304])
def test_spmm_blocked_kernel_at_bag_widths(card, cols):
    g = rmat_graph(8192, 80_000, seed=2)
    op = prepare_operand(g, card)
    gen = torch.Generator(device=card).manual_seed(cols)
    m = torch.rand((g.n, cols), generator=gen, device=card)
    got = spmm_blocked(op, m)
    assert torch.equal(got, spmm_blocked(op, m))
    want = spmm_ref(op.src, op.dst, g.n, m, col_chunk=4096)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6 * float(want.abs().max()))


def test_spmm_blocked_refuses_widths_past_its_int32_counts(card):
    # the column index: C plus one tile must stay below 2**31 (8 GB of M)
    lone = prepare_operand(Graph(n=1, src=np.zeros(0, np.int64), dst=np.zeros(0, np.int64)), card)
    with pytest.raises(ValueError, match="column index"):
        spmm_blocked(lone, torch.empty((1, 2**31 - 64), device=card))
    # a product: 2**20 heavy segments x 2048 column tiles = 2**31 warp items
    g = _graph()
    op = prepare_operand(g, card)
    many = torch.zeros(2**20, dtype=torch.int32, device=card)
    wide = dataclasses.replace(op, partition=dataclasses.replace(op.partition, seg_beg=many,
                                                                 seg_end=many))
    with pytest.raises(ValueError, match="heavy items"):
        spmm_blocked(wide, torch.empty((g.n, 2048 * 128), device=card))
    assert blocked_ops.check_int32_counts(op, 49_152)["column index (C + one tile)"] == 49_280


def test_bag_stages_on_card_match_edges_and_cpu(card):
    g = rmat_graph(200, 900, seed=5)
    keys = split(prng_key(1), 3)
    for k in (3, 4):
        ts = list(connected_graphlets(k))
        before = spmm_blocked.launches
        got = CountingEngine(g, ts, device=card, backend="blocked").count_keys(keys)
        assert spmm_blocked.launches > before  # bag extends went through kernel B
        want = CountingEngine(g, ts, device=card, backend="edges").count_keys(keys)
        np.testing.assert_allclose(got, want, rtol=1e-4)
        cpu = CountingEngine(g, ts, device="cpu", backend="edges").count_keys(keys)
        np.testing.assert_allclose(got, cpu, rtol=1e-4)
    tiny = grid_graph(4, 5)
    for name in ("triangle", "square", "diamond", "clique4"):
        t = get_template(name)
        plan = build_counting_plan(t)
        c = np.random.default_rng(2).integers(0, t.k, size=tiny.n)
        raw = float(CountingEngine(tiny, [t], backend="blocked").raw_counts(c)[0])
        assert raw / plan.automorphisms == brute_force_colorful(tiny, t, c)


def test_prng_draws_on_card_equal_cpu(card):
    keys = split(prng_key(5), 6)
    for n, k in ((1, 2), (8191, 3), (1 << 20, 12)):
        assert torch.equal(randint(keys.to(card), (n,), 0, k).cpu(), randint(keys, (n,), 0, k))
    idx = torch.arange(6)
    assert torch.equal(fold_in(keys.to(card), idx.to(card)).cpu(), fold_in(keys, idx))
