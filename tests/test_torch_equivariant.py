"""The port's message-passing primitives and equivariant building blocks
against the reference, on the CPU: ``repro_torch.models.gnn.message`` and
``.equivariant`` beside ``repro.models.gnn``'s, the ``edge_chunk`` path of
NequIP/MACE, and the equivariance of both potentials at full depth.

Inputs come from numpy seeds; the reference's parameters are carried
across with ``gnn_params_from_numpy``.  The port sums in another order
(``torch.segment_reduce`` over sorted rows), so fp32 values agree to
``RTOL``/``ATOL`` of the largest magnitude; integer and mask rules exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as ref_get_arch
from repro.core.graph import erdos_renyi_graph as ref_erdos_renyi_graph
from repro.data.pipeline import graph_batch_from_shape as ref_graph_batch_from_shape
from repro.models import gnn as ref_G
from repro.models.gnn import equivariant as ref_eq
from repro.models.gnn import message as ref_msg
from repro_torch.configs.registry import get_arch
from repro_torch.data.pipeline import graph_batch_from_shape
from repro_torch.interop import gnn_params_from_numpy
from repro_torch.models import gnn as G
from repro_torch.models.gnn import equivariant as eq
from repro_torch.models.gnn import message as msg
from repro_torch.train.tree import tree_leaves

CPU = torch.device("cpu")
#: fp32 values summed in another order: relative to the largest magnitude
RTOL, ATOL = 1e-5, 1e-6
#: gradients through several layers of such sums
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1.0)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= atol * scale + rtol * scale, (what, err, scale)


def _t(a):
    return torch.as_tensor(np.asarray(a))


# ---------------------------------------------------------------------------
# message primitives
# ---------------------------------------------------------------------------


def _edges(seed=0, n=12, e=40):
    """Edges over ``n`` nodes where nodes 9..11 have no in-edge, node 8's
    every in-edge is masked, and a quarter of the rest are masked."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, 9, e)
    dst[:3] = 8
    mask = (rng.random(e) > 0.25).astype(np.float32)
    mask[dst == 8] = 0.0
    return n, src.astype(np.int32), dst.astype(np.int32), mask


PRIMITIVES = ("aggregate_sum", "aggregate_mean", "aggregate_max", "edge_softmax")


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("name", PRIMITIVES)
def test_message_primitive_matches_reference(name, masked):
    """Values and the gradient of a random weighted sum, on (e, 3, 2)
    messages with empty and fully masked segments."""
    n, src, dst, mask = _edges()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((len(dst), 3, 2)).astype(np.float32)
    w = rng.standard_normal((n if name != "edge_softmax" else len(dst), 3, 2)).astype(np.float32)
    m = mask if masked else None

    def ref_fn(x):
        return (getattr(ref_msg, name)(x, jnp.asarray(dst), n, None if m is None else jnp.asarray(m)) * w).sum()

    want_out = getattr(ref_msg, name)(jnp.asarray(x), jnp.asarray(dst), n,
                                      None if m is None else jnp.asarray(m))
    want_grad = jax.grad(ref_fn)(jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    out = getattr(msg, name)(xt, _t(dst), n, None if m is None else _t(m))
    _close(out, want_out, what=name)
    assert bool(torch.isfinite(out).all())
    if name != "edge_softmax":
        assert torch.equal(out[9:], torch.zeros_like(out[9:]))  # empty segments are 0
        if masked:
            assert torch.equal(out[8], torch.zeros_like(out[8]))  # so is a fully masked one
    (out * _t(w)).sum().backward()
    _close(xt.grad, want_grad, GRAD_RTOL, GRAD_ATOL, what=f"{name} grad")


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_degree_and_sym_norm_match_reference(masked):
    n, src, dst, mask = _edges(seed=2)
    m = mask if masked else None
    want_deg = ref_msg.degree(jnp.asarray(dst), n, None if m is None else jnp.asarray(m))
    want_coef = ref_msg.sym_norm_coeffs(jnp.asarray(src), jnp.asarray(dst), n,
                                        None if m is None else jnp.asarray(m))
    deg = msg.degree(_t(dst), n, None if m is None else _t(m))
    assert deg.dtype == torch.float32 and np.array_equal(deg.numpy(), np.asarray(want_deg))
    segments = msg.Segments(_t(dst), n)  # a cached sort gives the same
    for d in (_t(dst), segments):
        _close(msg.sym_norm_coeffs(_t(src), d, n, None if m is None else _t(m)), want_coef)


def test_segments_sum_and_gather_are_each_others_backward():
    """``Segments.sum``/``gather`` on an unsorted index equal ``index_add_``
    / indexing, and each one's backward is the other; a sorted index keeps
    no permutation; an index past ``n`` raises."""
    rng = np.random.default_rng(3)
    index = torch.as_tensor(rng.integers(0, 7, 30))
    seg = msg.Segments(index, 7)
    assert seg.perm is not None and msg.Segments(index.sort().values, 7).perm is None
    x = torch.as_tensor(rng.standard_normal((30, 4)).astype(np.float32), dtype=torch.float64)
    x.requires_grad_(True)
    total = seg.sum(x)
    assert torch.allclose(total, torch.zeros(7, 4, dtype=x.dtype).index_add_(0, index, x.detach()))
    g = torch.as_tensor(rng.standard_normal((7, 4)), dtype=torch.float64)
    total.backward(g)
    assert torch.equal(x.grad, g[index])
    y = g.clone().requires_grad_(True)
    seg.gather(y).backward(x.detach())
    assert torch.allclose(y.grad, torch.zeros_like(g).index_add_(0, index, x.detach()))
    with pytest.raises(ValueError, match=r"outside \[0, 7\)"):
        msg.Segments(index + 1, 7)


def test_graph_batch_sorts_once_and_moves():
    batch, _ = graph_batch_from_shape(10, 25, 3, seed=1, batch_graphs=2, device="cpu")
    by_dst = batch.by_dst()
    assert by_dst is batch.by_dst() and by_dst.dst_segments.perm is None
    assert bool((by_dst.dst[1:] >= by_dst.dst[:-1]).all())
    assert by_dst.dst_segments is by_dst.dst_segments
    # the same edges, stably reordered
    order = torch.argsort(batch.dst, stable=True)
    assert torch.equal(by_dst.src, batch.src[order]) and torch.equal(by_dst.dst, batch.dst[order])
    moved = batch.to("cpu")
    assert moved.n_nodes == 20 and moved.n_edges == 50 and moved.n_graphs == 2
    assert "by_dst" not in moved._cache


# ---------------------------------------------------------------------------
# equivariant building blocks
# ---------------------------------------------------------------------------


def _irreps(rng, n, c, sym=True):
    t = rng.standard_normal((n, c, 3, 3)).astype(np.float32)
    if sym:
        t = 0.5 * (t + np.swapaxes(t, -1, -2))
        t = t - np.trace(t, axis1=-2, axis2=-1)[..., None, None] * np.eye(3, dtype=np.float32) / 3
    return (rng.standard_normal((n, c)).astype(np.float32),
            rng.standard_normal((n, c, 3)).astype(np.float32), t)


def _both(arrays):
    return ref_eq.Irreps(*map(jnp.asarray, arrays)), eq.Irreps(*map(_t, arrays))


def _rotation(rng):
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return q.astype(np.float32)


def _case_spherical(rng):
    u = rng.standard_normal((9, 3)).astype(np.float32)
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    return [(eq.spherical_l1(_t(u)), ref_eq.spherical_l1(jnp.asarray(u))),
            (eq.spherical_l2(_t(u)), ref_eq.spherical_l2(jnp.asarray(u)))]


def _case_radial(rng):
    r = np.concatenate([rng.random(9) * 6.0, [0.0, 5.0, 7.5]]).astype(np.float32)
    return [(eq.bessel_basis(_t(r), 8, 5.0), ref_eq.bessel_basis(jnp.asarray(r), 8, 5.0)),
            (eq.cutoff_envelope(_t(r), 5.0), ref_eq.cutoff_envelope(jnp.asarray(r), 5.0))]


def _case_sym_traceless(rng):
    m = rng.standard_normal((4, 2, 3, 3)).astype(np.float32)
    return [(eq._sym_traceless(_t(m)), ref_eq._sym_traceless(jnp.asarray(m)))]


def _case_tp_paths(rng):
    ref_a, a = _both(_irreps(rng, 5, 3))
    ref_b, b = _both(_irreps(rng, 5, 3))
    got, want = eq.tp_paths_order2(a, b), ref_eq.tp_paths_order2(ref_a, ref_b)
    return list(zip(got, want))


def _case_linear_mix(rng):
    ref_x, x = _both(_irreps(rng, 5, 4))
    p = {k: rng.standard_normal((4, 6)).astype(np.float32) for k in ("w_s", "w_v", "w_t")}
    got = eq.linear_mix({k: _t(v) for k, v in p.items()}, x)
    want = ref_eq.linear_mix({k: jnp.asarray(v) for k, v in p.items()}, ref_x)
    return list(zip(got, want))


def _case_gate(rng):
    s, v, t = _irreps(rng, 5, 2)
    s = rng.standard_normal((5, 7)).astype(np.float32)  # 3 features + 2 + 2 gates
    ref_x, x = _both((s, v, t))
    with pytest.raises(ValueError, match="gate scalars"):
        eq.gate(eq.Irreps(x.s[:, :4], x.v, x.t))
    return list(zip(eq.gate(x), ref_eq.gate(ref_x)))


def _case_rotate(rng):
    r = _rotation(rng)
    ref_x, x = _both(_irreps(rng, 5, 3))
    return list(zip(x.rotate(_t(r)), ref_x.rotate(jnp.asarray(r))))


def _case_init_linear_mix(rng):
    gen = torch.Generator().manual_seed(0)
    got = eq.init_linear_mix(gen, (6, 4, 2), (3, 5, 7), CPU)
    want = ref_eq.init_linear_mix(jax.random.PRNGKey(0), (6, 4, 2), (3, 5, 7))
    meta = eq.init_linear_mix(None, (6, 4, 2), (3, 5, 7), torch.device("meta"))
    for k in want:
        assert got[k].shape == want[k].shape == meta[k].shape
        # the same N(0, 1/c_in) scale (the draws are not JAX's)
        assert 0.2 < float(got[k].std()) * np.sqrt(want[k].shape[0]) < 2.0
    return []


EQUIVARIANT_CASES = {
    "spherical": _case_spherical,
    "radial": _case_radial,
    "sym_traceless": _case_sym_traceless,
    "tp_paths_order2": _case_tp_paths,
    "linear_mix": _case_linear_mix,
    "gate": _case_gate,
    "rotate": _case_rotate,
    "init_linear_mix": _case_init_linear_mix,
}


@pytest.mark.parametrize("case", sorted(EQUIVARIANT_CASES))
def test_equivariant_function_matches_reference(case):
    for i, (got, want) in enumerate(EQUIVARIANT_CASES[case](np.random.default_rng(7))):
        _close(got, want, what=f"{case}[{i}]")


def test_tp_paths_commute_with_rotation():
    """``tp_paths_order2(R a, R b) == R tp_paths_order2(a, b)``."""
    rng = np.random.default_rng(8)
    r = _t(_rotation(rng))
    a, b = eq.Irreps(*map(_t, _irreps(rng, 6, 2))), eq.Irreps(*map(_t, _irreps(rng, 6, 2)))
    for got, want in zip(eq.tp_paths_order2(a.rotate(r), b.rotate(r)), eq.tp_paths_order2(a, b).rotate(r)):
        _close(got, want.numpy(), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the potentials: edge chunks and equivariance
# ---------------------------------------------------------------------------


def _setup(arch, **changes):
    ref_cfg = dataclasses.replace(ref_get_arch(arch)[1].SMOKE_CONFIG, **changes)
    cfg = dataclasses.replace(get_arch(arch)[1].SMOKE_CONFIG, **changes)
    return ref_cfg, cfg


def _grads(params, cfg, batch, labels):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
        p.grad = None
    loss = G.loss_fn(params, cfg, batch, labels)
    loss.backward()
    return loss.detach(), [torch.zeros_like(p) if p.grad is None else p.grad for p in leaves]


@pytest.mark.parametrize("arch", ["nequip", "mace"])
def test_edge_chunk_matches_unchunked_and_reference(arch):
    """``edge_chunk=60`` on 180 edges (3 chunks, each under checkpoint):
    energies, loss and every gradient leaf equal the unchunked path's and
    the reference's chunked ``lax.scan`` path's; a chunk that does not divide
    the edges takes the unchunked path, as in the reference."""
    ref_cfg, cfg = _setup(arch, edge_chunk=60)
    ref_batch, _ = ref_graph_batch_from_shape(40, 90, 12, seed=0, batch_graphs=2)
    batch, _ = graph_batch_from_shape(40, 90, 12, seed=0, batch_graphs=2, device="cpu")
    ref_params = ref_G.init_model(jax.random.PRNGKey(0), ref_cfg, 12)
    params = gnn_params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg, CPU)
    labels = torch.ones(2)
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(ref_G.loss_fn), static_argnums=1)(
        ref_params, ref_cfg, ref_batch, jnp.ones(2))
    loss, grads = _grads(params, cfg, batch, labels)
    plain_loss, plain_grads = _grads(params, dataclasses.replace(cfg, edge_chunk=0), batch, labels)
    _close(loss, ref_loss, what="loss")
    _close(loss, plain_loss.numpy(), what="loss vs unchunked")
    for i, (g, p, w) in enumerate(zip(grads, plain_grads, jax.tree.leaves(ref_grads))):
        _close(g, w, GRAD_RTOL, GRAD_ATOL, what=f"leaf {i}")
        _close(g, p.numpy(), GRAD_RTOL, GRAD_ATOL, what=f"leaf {i} vs unchunked")
    with torch.no_grad():
        odd = G.forward(params, dataclasses.replace(cfg, edge_chunk=70), batch)
        _close(odd, G.forward(params, dataclasses.replace(cfg, edge_chunk=0), batch).numpy())


@pytest.mark.parametrize("arch", ["nequip", "mace"])
def test_equivariance_full_configs_reduced_graph(arch):
    """NequIP/MACE at full depth, width 8, on the reference test's graph:
    the energy under a random proper rotation of the positions stays within
    the reference's bar (1e-3 relative), and equals the reference's."""
    rng = np.random.default_rng(3)
    g = ref_erdos_renyi_graph(24, 60, seed=1)
    pos = rng.standard_normal((g.n, 3)).astype(np.float32)
    q = _rotation(rng)
    feat = rng.standard_normal((g.n, 4)).astype(np.float32)
    ref_cfg = dataclasses.replace(ref_get_arch(arch)[1].CONFIG, d_hidden=8)
    cfg = dataclasses.replace(get_arch(arch)[1].CONFIG, d_hidden=8)
    ref_params = ref_G.init_model(jax.random.PRNGKey(0), ref_cfg, 4)
    params = gnn_params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg, CPU)

    def batch(p):
        return msg.GraphBatch(node_feat=_t(feat), positions=_t(p), src=_t(g.src).long(),
                              dst=_t(g.dst).long(), edge_mask=torch.ones(g.num_directed),
                              node_mask=torch.ones(g.n), graph_id=torch.zeros(g.n, dtype=torch.int64))

    def ref_batch(p):
        return ref_msg.GraphBatch(node_feat=jnp.asarray(feat), positions=jnp.asarray(p),
                                  src=jnp.asarray(g.src), dst=jnp.asarray(g.dst),
                                  edge_mask=jnp.ones(g.num_directed), node_mask=jnp.ones(g.n),
                                  graph_id=jnp.zeros(g.n, jnp.int32), n_graphs=1)

    with torch.no_grad():
        e1 = float(G.forward(params, cfg, batch(pos))[0])
        e2 = float(G.forward(params, cfg, batch(pos @ q.T))[0])
    assert abs(e1 - e2) < 1e-3 * max(abs(e1), 1.0), (cfg.name, e1, e2)
    want = float(jax.jit(ref_G.forward, static_argnums=1)(ref_params, ref_cfg, ref_batch(pos))[0])
    assert abs(e1 - want) <= RTOL * max(abs(want), 1.0), (e1, want)
