"""Message-passing primitives: segment reductions over an edge index.

The reference builds scatter/gather aggregation from ``jax.ops.segment_sum``
and ``segment_max``; ``aggregate_sum`` over an edge list is the SpMM
``B = A_G @ M`` of the paper.  Here every reduction is
``torch.segment_reduce`` over rows sorted by segment, and every gather by a
repeating index has for backward such a segment sum over the index's own
sorted order (:class:`Segments`).  On a card ``index_add_``, and the
backward of an index gather, add with atomics in no fixed order, so a
training step would not repeat bit for bit; these sums run in one fixed
order on every device.  The sort is made once per :class:`GraphBatch`
and cached with it.  The order of each sum differs from the reference's,
so results agree with it to fp32 tolerance.

Rules kept from the reference: masked messages are zeroed before a sum;
``aggregate_max`` and ``edge_softmax`` map the max of an empty (or fully
masked, for ``aggregate_max``) segment to 0; masked softmax logits are
``-1e30``; the softmax denominator is clamped at ``1e-16``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Union

import torch

__all__ = [
    "Segments",
    "GraphBatch",
    "aggregate_sum",
    "aggregate_mean",
    "aggregate_max",
    "edge_softmax",
    "degree",
    "sym_norm_coeffs",
]


class Segments:
    """The rows of an index vector grouped by value.

    ``index`` (``(e,)`` integers in ``[0, n)``) maps row ``i`` of an
    ``(e, ...)`` tensor to segment ``index[i]``.  :meth:`sum` reduces rows
    into their ``n`` segments and :meth:`gather` reads segment rows out to
    the ``e`` rows; each is the other's backward, and both run in a fixed
    order.  Built once: a stable argsort (kept only when ``index`` is not
    already sorted) and the segment lengths.
    """

    def __init__(self, index: torch.Tensor, n: int):
        index = index.to(torch.int64)
        if index.dim() != 1:
            raise ValueError(f"index must be 1-D, got shape {tuple(index.shape)}")
        self.index = index
        self.n = int(n)
        self.lengths = torch.bincount(index, minlength=self.n)  # raises on a negative value
        if self.lengths.numel() != self.n:
            raise ValueError(f"index values outside [0, {self.n})")
        ordered = index.numel() < 2 or bool((index[1:] >= index[:-1]).all())
        self.perm = None if ordered else torch.argsort(index, stable=True)

    def _sorted(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.perm is None else x.index_select(0, self.perm)

    def _sum(self, x: torch.Tensor) -> torch.Tensor:
        return torch.segment_reduce(self._sorted(x), "sum", lengths=self.lengths, axis=0,
                                    unsafe=True)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``(e, ...)`` -> ``(n, ...)``: each segment's rows summed in row
        order (an empty segment is 0)."""
        return _SegmentSum.apply(x, self)

    def gather(self, y: torch.Tensor) -> torch.Tensor:
        """``(n, ...)`` -> ``(e, ...)``: ``y[index]``."""
        return _SegmentGather.apply(y, self)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """``(e, ...)`` -> ``(n, ...)``: each segment's max (``-inf`` if
        empty), with ``torch.segment_reduce``'s own backward."""
        return torch.segment_reduce(self._sorted(x), "max", lengths=self.lengths, axis=0,
                                    unsafe=True)


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, segments):
        ctx.segments = segments
        return segments._sum(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.index_select(0, ctx.segments.index), None


class _SegmentGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, segments):
        ctx.segments = segments
        return y.index_select(0, segments.index)

    @staticmethod
    def backward(ctx, grad):
        return ctx.segments._sum(grad), None


def _segments(index: Union[torch.Tensor, Segments], n: int) -> Segments:
    if isinstance(index, Segments):
        if index.n != n:
            raise ValueError(f"segments over {index.n} rows, expected {n}")
        return index
    return Segments(index, n)


def _rows(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """A per-row ``(e,)`` vector shaped to broadcast against ``ndim`` dims."""
    return v.reshape((-1,) + (1,) * (ndim - 1))


@dataclass(frozen=True)
class GraphBatch:
    """Padded graph batch of tensors on one device.

    ``src``/``dst`` are edge endpoints (messages flow src -> dst); invalid
    (padding) edges carry ``edge_mask == 0`` and point at node 0.  Batched
    small graphs (molecule cells) are block-diagonal, with ``graph_id`` for
    the per-graph readout.  The sorts the models reduce over
    (:meth:`by_dst`, :attr:`dst_segments`, :attr:`src_segments`,
    :attr:`graph_segments`) are made on first use and cached with the batch.
    """

    node_feat: torch.Tensor               # (n, d) float
    positions: Optional[torch.Tensor]     # (n, 3) or None
    src: torch.Tensor                     # (e,) int64
    dst: torch.Tensor                     # (e,) int64
    edge_mask: torch.Tensor               # (e,) float32
    node_mask: torch.Tensor               # (n,) float32
    graph_id: Optional[torch.Tensor] = None  # (n,) int64 for batched graphs
    n_graphs: int = 1
    _cache: dict = field(default_factory=dict, init=False, repr=False, compare=False)

    @property
    def n_nodes(self) -> int:
        return self.node_feat.shape[0]

    @property
    def n_edges(self) -> int:
        return self.src.shape[0]

    def to(self, device) -> "GraphBatch":
        def move(t):
            return None if t is None else t.to(device)

        return GraphBatch(move(self.node_feat), move(self.positions), move(self.src),
                          move(self.dst), move(self.edge_mask), move(self.node_mask),
                          move(self.graph_id), self.n_graphs)

    def _cached(self, name, build):
        if name not in self._cache:
            self._cache[name] = build()
        return self._cache[name]

    def by_dst(self) -> "GraphBatch":
        """The same graph with its edges stably sorted by ``dst`` (``self``
        if they already are): every per-node result is unchanged, and the
        edge messages come out in the order the segment sums read them."""
        def build():
            segments = self.dst_segments
            if segments.perm is None:
                return self
            perm = segments.perm
            return GraphBatch(self.node_feat, self.positions, self.src[perm], self.dst[perm],
                              self.edge_mask[perm], self.node_mask, self.graph_id, self.n_graphs)

        return self._cached("by_dst", build)

    @property
    def dst_segments(self) -> Segments:
        return self._cached("dst_segments", lambda: Segments(self.dst, self.n_nodes))

    @property
    def src_segments(self) -> Segments:
        return self._cached("src_segments", lambda: Segments(self.src, self.n_nodes))

    @property
    def graph_segments(self) -> Segments:
        """Nodes by ``graph_id`` (all in graph 0 without one)."""
        def build():
            gid = self.graph_id if self.graph_id is not None else torch.zeros(
                (self.n_nodes,), dtype=torch.int64, device=self.node_feat.device)
            return Segments(gid, self.n_graphs)

        return self._cached("graph_segments", build)


def aggregate_sum(messages: torch.Tensor, dst, n: int, edge_mask=None) -> torch.Tensor:
    """Sum of each node's incoming messages.  ``dst`` is the ``(e,)``
    destination index, or its :class:`Segments` (``GraphBatch.dst_segments``)
    to reuse the batch's sort."""
    if edge_mask is not None:
        messages = messages * _rows(edge_mask, messages.dim()).to(messages.dtype)
    return _segments(dst, n).sum(messages)


def aggregate_mean(messages: torch.Tensor, dst, n: int, edge_mask=None) -> torch.Tensor:
    segments = _segments(dst, n)
    total = aggregate_sum(messages, segments, n, edge_mask)
    ones = (torch.ones((messages.shape[0],), dtype=messages.dtype, device=messages.device)
            if edge_mask is None else edge_mask.to(messages.dtype))
    deg = segments.sum(ones)
    return total / _rows(deg.clamp(min=1.0), messages.dim())


def aggregate_max(messages: torch.Tensor, dst, n: int, edge_mask=None) -> torch.Tensor:
    if edge_mask is not None:
        messages = torch.where(_rows(edge_mask, messages.dim()) > 0, messages,
                               torch.full((), -torch.inf, dtype=messages.dtype,
                                          device=messages.device))
    out = _segments(dst, n).max(messages)
    return torch.where(torch.isfinite(out), out, torch.zeros((), dtype=out.dtype, device=out.device))


def edge_softmax(logits: torch.Tensor, dst, n: int, edge_mask=None) -> torch.Tensor:
    """Numerically-stable softmax over the incoming edges of each dst node.

    logits: ``(e, ...)`` per-edge scores; returns same-shape weights summing
    to one per destination (the GAT attention normalizer); a node with no
    incoming edge has none, and a fully masked one gets weights of 0.
    """
    segments = _segments(dst, n)
    if edge_mask is not None:
        logits = torch.where(_rows(edge_mask, logits.dim()) > 0, logits,
                             torch.full((), -1e30, dtype=logits.dtype, device=logits.device))
    seg_max = segments.max(logits)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max,
                          torch.zeros((), dtype=seg_max.dtype, device=seg_max.device))
    shifted = torch.exp(logits - segments.gather(seg_max))
    if edge_mask is not None:
        shifted = shifted * _rows(edge_mask, logits.dim())
    denom = segments.sum(shifted)
    return shifted / segments.gather(denom).clamp(min=1e-16)


def degree(dst, n: int, edge_mask=None) -> torch.Tensor:
    segments = _segments(dst, n)
    ones = (torch.ones(segments.index.shape, dtype=torch.float32, device=segments.index.device)
            if edge_mask is None else edge_mask.to(torch.float32))
    return segments.sum(ones)


def sym_norm_coeffs(src, dst, n: int, edge_mask=None) -> torch.Tensor:
    """GCN symmetric normalization ``1/sqrt(d_i d_j)`` per edge (self-loops
    are the caller's responsibility).  ``dst`` may be its :class:`Segments`."""
    dst = _segments(dst, n)
    inv_sqrt = 1.0 / torch.sqrt(degree(dst, n, edge_mask).clamp(min=1.0))
    return inv_sqrt[src] * inv_sqrt[dst.index]
