"""The bag eMA (``kernels/spmm_ema``: ``bag_ema``) off the card.

The kernel computes a bag extend's or join's colorset update in one pass,
``out[i, b, o] = (prod_x adj[i_0, i_x]) * sum_t a[i, b, ia[t][o]] *
p[i, b, ip[t][o]]``: the masks read per ``(i_0, i_x)`` and applied after
the sum.  It runs only on a card, where it is held against the executor's
loop (``tests/test_torch_cuda.py``, ``chip_smoke.py``).  Here that loop
(masks multiplied into the state first, one ``index_select`` + ``addcmul_``
per term) is held against the kernel's formula, computed in float64, on
random states: extends with 0, 1 and 2 masks, from an SpMM'd (owned) or
broadcast state, over 1 to 3 vertex axes, at B = 1 and 3, from permuted
(strided) states, and joins; on a permuted state it gives the bits of its
contiguous copy.  Whole bag plans routed through a stand-in for the kernel
that computes the formula from the packed table give the loop's totals,
so the executor hands the kernel the operands the formula expects.  Off a
card, and on a card for any dtype but float32 or a table past the
kernel's limits, the executor keeps its loop; the engine counts both
routes.  The file imports neither ``jax`` nor ``repro``.
"""

import types

import numpy as np
import pytest
import torch

from repro_torch.core.engine import CountingEngine
from repro_torch.core.graph import rmat_graph
from repro_torch.core.templates import connected_graphlets
from repro_torch.exec.base import BagStageTables
from repro_torch.exec.local import LocalBackend
from repro_torch.kernels.spmm_ema import ops
from repro_torch.kernels.spmm_ema.ops import bag_ema, bag_ema_refusal, pack_bag_entries

N = 6


def _tables(rng, kind, n_terms, n_out, c_a, c_p):
    ia = rng.integers(0, c_a, (n_terms, n_out))
    ip = rng.integers(0, c_p, (n_terms, n_out))
    return BagStageTables(kind=kind, n_out=n_out, n_terms=n_terms, idx_a=torch.as_tensor(ia),
                          idx_p=torch.as_tensor(ip), ent=pack_bag_entries(ia, ip, "cpu"))


def _state(rng, shape, permuted):
    """A non-negative fp32 state (counts are), as a permuted view of its
    storage where asked: the vertex axes reversed in memory."""
    x = torch.as_tensor(rng.random(shape, dtype=np.float32))
    r = len(shape) - 2
    if permuted and r >= 2:
        order = list(range(r))[::-1] + [r, r + 1]
        x = x.permute(order).contiguous().permute(order)
        assert not x.is_contiguous()
    return x


def _adj(rng):
    a = rng.random((N, N)) < 0.4
    return torch.as_tensor((a | a.T).astype(np.float32))


def _formula(a, p, ent, mask_axes=(), adj=None):
    """The kernel's formula in float64, its ranks decoded from the packed
    table: each term's product summed, the masks' product after the sum."""
    r = p.dim() - 2
    ia, ip = (ent & 0xFFFF).long(), (ent >> 16).long()
    acc = torch.zeros(tuple(p.shape[:-1]) + (ent.shape[1],), dtype=torch.float64)
    for t in range(ent.shape[0]):
        acc += a.double().index_select(r + 1, ia[t]) * p.double().index_select(r + 1, ip[t])
    n = p.shape[0] if r else 1
    for x in mask_axes:
        mask = adj.double().reshape((n,) + (1,) * (x - 1) + (n,) + (1,) * (r - 1 - x))
        acc = acc * mask.reshape(tuple(mask.shape) + (1, 1))
    return acc


# (vertex axes of the output, B, SpMM'd input, mask axes, permuted input)
EXTENDS = [
    (1, 1, True, (), False),
    (1, 3, True, (), False),
    (2, 3, False, (1,), False),
    (2, 1, True, (1,), False),
    (2, 3, True, (), False),
    (3, 3, True, (1, 2), False),
    (3, 1, False, (2,), False),
    (3, 3, False, (1, 2), True),
    (3, 3, True, (1,), True),
]


@pytest.mark.parametrize("r,bsz,spmm,mask_axes,permuted", EXTENDS)
def test_extend_loop_computes_the_kernels_formula(r, bsz, spmm, mask_axes, permuted):
    rng = np.random.default_rng(r * 100 + bsz * 10 + len(mask_axes))
    k, c_p, n_out = 4, 6, 4
    tables = _tables(rng, "extend", 3, n_out, k, c_p)
    leaf = torch.as_tensor(rng.random((N, bsz, k), dtype=np.float32))
    adj = _adj(rng)
    shape = (N,) * r + (bsz, c_p)
    if spmm:  # the neighbor sum's output: the executor owns it
        p = _state(rng, shape, permuted)
    else:  # a broadcast introduction of the new vertex's axis
        p = _state(rng, shape[1:], permuted).unsqueeze(0).expand(shape)
    # the operands the executor hands the kernel: the leaf broadcast over
    # the other vertex axes, the state as it stands
    a = leaf.reshape((N,) + (1,) * (r - 1) + (bsz, k)).expand(shape[:-1] + (k,))
    want = _formula(a, p, tables.ent, mask_axes, adj)

    def loop(state):
        return LocalBackend._bag_extend_loop(
            state.clone() if spmm else state, spmm, leaf, tables, list(mask_axes), adj,
            torch.float32)

    got = loop(p)
    assert got.shape == want.shape and got.dtype == torch.float32 and got.is_contiguous()
    # three non-negative terms in float32: a few ulps of the float64 sum;
    # a masked-out output is exactly 0 in both
    torch.testing.assert_close(got.double(), want, rtol=1e-6, atol=0)
    assert torch.equal(loop(p.contiguous()), got)
    if mask_axes:
        assert bool((got == 0).any()) and bool((got != 0).any())


@pytest.mark.parametrize("r,bsz,permuted", [(1, 1, False), (2, 3, True), (3, 3, True)])
def test_join_loop_computes_the_kernels_formula(r, bsz, permuted):
    rng = np.random.default_rng(7 + r)
    s1 = _state(rng, (N,) * r + (bsz, 6), permuted)
    s2 = _state(rng, (N,) * r + (bsz, 4), False)
    tables = _tables(rng, "join", 5, 3, 6, 4)
    got = LocalBackend._bag_join_loop(s1, s2, tables, torch.float32)
    torch.testing.assert_close(got.double(), _formula(s1, s2, tables.ent), rtol=1e-6, atol=0)
    assert torch.equal(LocalBackend._bag_join_loop(s1.contiguous(), s2, tables, torch.float32),
                       got)


def test_pack_bag_entries_packs_15_bit_ranks_and_leaves_wider_tables_to_the_loop():
    ia, ip = np.array([[0, 3], [5, 1]]), np.array([[2, 0], [1, 7]])
    ent = pack_bag_entries(ia, ip, "cpu")
    assert ent.dtype == torch.int32 and ent.shape == (2, 2)
    assert np.array_equal((ent & 0xFFFF).numpy(), ia) and np.array_equal((ent >> 16).numpy(), ip)
    top = (1 << 15) - 1
    assert int(pack_bag_entries([[top]], [[top]], "cpu")[0, 0]) == top | top << 16
    # a k >= 18 table's ranks (C(18, 9) = 48,620 colorsets) are not packed
    assert pack_bag_entries([[1 << 15]], [[0]], "cpu") is None
    assert pack_bag_entries([[0]], [[48_619]], "cpu") is None
    with pytest.raises(ValueError):
        pack_bag_entries([[-1]], [[0]], "cpu")


def test_bag_ema_refusal_routes_off_card_and_non_fp32_to_the_loop():
    rng = np.random.default_rng(3)
    p = _state(rng, (N, N, 2, 6), False)
    a = p[..., :4]
    ent = pack_bag_entries(np.zeros((3, 4), int), np.ones((3, 4), int), "cpu")
    assert "card" in bag_ema_refusal(a, p, ent)
    with pytest.raises(ValueError, match="card"):
        bag_ema(a, p, ent)  # no plain version: the executor loops off a card

    def on_card(t, dtype=None):
        # the refusal reads only device, dtype, shape and strides
        return types.SimpleNamespace(device=torch.device("cuda", 0), dtype=dtype or t.dtype,
                                     shape=t.shape, dim=t.dim, stride=t.stride, numel=t.numel,
                                     is_contiguous=t.is_contiguous)

    adj = on_card(_adj(rng))
    assert bag_ema_refusal(on_card(a), on_card(p), on_card(ent), (1,), adj) is None
    assert "2^15" in bag_ema_refusal(on_card(a), on_card(p), None, (1,), adj)
    assert "float32" in bag_ema_refusal(on_card(a, torch.bfloat16),
                                        on_card(p, torch.bfloat16), on_card(ent))
    assert "float32" in bag_ema_refusal(on_card(a), on_card(p), on_card(ent), (1,),
                                        on_card(_adj(rng), torch.bfloat16))
    wide_ent = on_card(torch.zeros((ops.BAG_MAX_ENTRIES // 4 + 1, 4), dtype=torch.int32))
    assert "entries" in bag_ema_refusal(on_card(a), on_card(p), wide_ent)
    wide = _state(rng, (2,) * (ops.BAG_MAX_AXES + 1) + (1, 1), False)
    assert "no bag states" in bag_ema_refusal(on_card(wide), on_card(wide), on_card(ent[:1, :1]))
    assert "masks" in bag_ema_refusal(on_card(a), on_card(p), on_card(ent), (0,), adj)


@pytest.mark.parametrize("k", [3, 4, 5])
def test_bag_plans_through_the_kernels_route_give_the_loops_totals(k, monkeypatch):
    g = rmat_graph(48, 240, seed=k)
    ts = [t for t in connected_graphlets(k) if not t.is_tree]
    colors = np.random.default_rng(k).integers(0, k, size=(3, g.n))
    loop = CountingEngine(g, ts, device="cpu", backend="edges", chunk_size=3)
    want = loop.count_colorings(colors)
    ops_run = loop.counters["bag_loop"]
    assert ops_run > 0 and loop.counters["bag_fused"] == 0
    assert loop.describe()["bag_ops"] == {"fused": 0, "loop": ops_run}
    # take the kernel's route on the CPU, through a stand-in for the launch
    # that computes the kernel's formula from the operands the executor
    # hands it and the op's packed table
    calls = []

    def stand_in(a, p, ent, mask_axes=(), adj=None):
        calls.append(tuple(mask_axes))
        return _formula(a, p, ent, mask_axes, adj).to(torch.float32)

    monkeypatch.setattr(ops, "bag_ema_refusal", lambda *args, **kw: None)
    monkeypatch.setattr(ops, "bag_ema", stand_in)
    fused = CountingEngine(g, ts, device="cpu", backend="edges", chunk_size=3)
    np.testing.assert_allclose(fused.count_colorings(colors), want, rtol=1e-5, atol=0)
    assert fused.counters["bag_fused"] == ops_run == len(calls) and fused.counters["bag_loop"] == 0
    assert fused.describe()["bag_ops"] == {"fused": ops_run, "loop": 0}
    assert any(calls)  # some extends carried masks
