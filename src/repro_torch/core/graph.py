"""Graph containers, sparse formats, and synthetic generators (NumPy).

A copy of ``repro.core.graph``: the port keeps its own host-side modules so
that it imports nothing of the JAX package.  Arrays, orderings and
``Graph.signature()`` are identical to the reference's.

* **edge list** — ``(src, dst)`` int32 pairs with both directions present,
  sorted by ``(dst, src)``; the plain SpMM is ``index_add_`` over ``dst``.
* **ELL / SELL** — padded (degree-sorted, sliced) neighbor tables for the
  gather backends.
* **blocked-ELL** — ``build_blocked_ell`` pads every (dst-block, src-block)
  pair to the largest pair.  It is kept only for parity with the reference;
  the port's CUDA kernels read the compact operand of
  ``repro_torch.kernels.spmm_blocked.ops`` instead (the padded operand of an
  R-MAT graph with 2^20 vertices would not fit on one card).

Generators: RMAT (the paper's synthetic workhorse), Erdos-Renyi, and grids.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "Graph",
    "BlockedELL",
    "SellGraph",
    "build_blocked_ell",
    "build_sell",
    "rmat_graph",
    "erdos_renyi_graph",
    "grid_graph",
    "graph_from_spec",
]


@dataclass(frozen=True)
class Graph:
    """Undirected simple graph in canonical edge-list form.

    ``src``/``dst`` contain *both* directions of every undirected edge and are
    sorted by ``(dst, src)`` so that segment reductions over ``dst`` are
    contiguous.  ``n`` is the vertex count; ``num_undirected`` the number of
    undirected edges (``len(src) == 2 * num_undirected``).
    """

    n: int
    src: np.ndarray  # (2E,) int32
    dst: np.ndarray  # (2E,) int32

    @property
    def num_directed(self) -> int:
        return int(self.src.shape[0])

    @property
    def num_undirected(self) -> int:
        return self.num_directed // 2

    @property
    def avg_degree(self) -> float:
        return self.num_directed / max(self.n, 1)

    def degrees(self) -> np.ndarray:
        return np.bincount(self.dst, minlength=self.n).astype(np.int32)

    def max_degree(self) -> int:
        return int(self.degrees().max(initial=0))

    def csr(self) -> Tuple[np.ndarray, np.ndarray]:
        """(row_ptr, col_idx) over destination-major ordering."""
        deg = self.degrees()
        row_ptr = np.zeros(self.n + 1, dtype=np.int64)
        np.cumsum(deg, out=row_ptr[1:])
        return row_ptr, self.src.astype(np.int32)

    def ell(self, max_deg: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Padded neighbor table ``(n, max_deg)`` + bool mask.

        Padded slots point at vertex 0 and are masked out.
        """
        deg = self.degrees()
        md = int(max_deg if max_deg is not None else deg.max(initial=1))
        nbr = np.zeros((self.n, md), dtype=np.int32)
        mask = np.zeros((self.n, md), dtype=bool)
        row_ptr, col_idx = self.csr()
        for i in range(self.n):
            lo, hi = int(row_ptr[i]), int(row_ptr[i + 1])
            d = min(hi - lo, md)
            nbr[i, :d] = col_idx[lo : lo + d]
            mask[i, :d] = True
        return nbr, mask

    def dense_adjacency(self) -> np.ndarray:
        a = np.zeros((self.n, self.n), dtype=np.float32)
        a[self.dst, self.src] = 1.0
        return a

    def signature(self) -> str:
        """Content hash of ``(n, src, dst)`` — the graph half of the engine
        cache key.  Graphs in canonical form (sorted, symmetrized) with the
        same structure hash identically regardless of construction route.
        """
        h = hashlib.sha1()
        h.update(np.int64(self.n).tobytes())
        h.update(np.ascontiguousarray(self.src, dtype=np.int64).tobytes())
        h.update(np.ascontiguousarray(self.dst, dtype=np.int64).tobytes())
        return h.hexdigest()


def _canonicalize(n: int, u: np.ndarray, v: np.ndarray) -> Graph:
    """Dedup, drop self-loops, symmetrize, and sort by (dst, src)."""
    keep = u != v
    u, v = u[keep], v[keep]
    lo, hi = np.minimum(u, v), np.maximum(u, v)
    und = np.unique(lo.astype(np.int64) * n + hi.astype(np.int64))
    lo = (und // n).astype(np.int32)
    hi = (und % n).astype(np.int32)
    src = np.concatenate([lo, hi])
    dst = np.concatenate([hi, lo])
    order = np.lexsort((src, dst))
    return Graph(n=n, src=src[order], dst=dst[order])


def rmat_graph(
    n: int,
    num_edges: int,
    seed: int = 0,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
) -> Graph:
    """R-MAT generator (Chakrabarti et al. 2004), the paper's synthetic data.

    ``a + b + c + d = 1`` with ``d = 1 - a - b - c``; larger ``a`` skews the
    degree distribution (the paper's ``K`` parameter sweeps this skew).
    """
    scale = int(np.ceil(np.log2(max(n, 2))))
    n_pow = 1 << scale
    rng = np.random.default_rng(seed)
    # Vectorized bit-by-bit quadrant descent for all edges at once.
    u = np.zeros(num_edges, dtype=np.int64)
    v = np.zeros(num_edges, dtype=np.int64)
    for _ in range(scale):
        r = rng.random(num_edges)
        right = (r >= a + b) & (r < a + b + c) | (r >= a + b + c)
        down = (r >= a) & (r < a + b) | (r >= a + b + c)
        u = (u << 1) | down.astype(np.int64)
        v = (v << 1) | right.astype(np.int64)
    u, v = (u % n).astype(np.int32), (v % n).astype(np.int32)
    return _canonicalize(n, u, v)


def erdos_renyi_graph(n: int, num_edges: int, seed: int = 0) -> Graph:
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n, size=num_edges).astype(np.int32)
    v = rng.integers(0, n, size=num_edges).astype(np.int32)
    return _canonicalize(n, u, v)


def grid_graph(rows: int, cols: int) -> Graph:
    """Deterministic 2-D grid — handy exact-count test fixture."""
    idx = np.arange(rows * cols).reshape(rows, cols)
    edges = []
    edges.append(np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], axis=1))
    edges.append(np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], axis=1))
    e = np.concatenate(edges, axis=0)
    return _canonicalize(rows * cols, e[:, 0].astype(np.int32), e[:, 1].astype(np.int32))


def graph_from_spec(spec: str) -> Tuple[Graph, str]:
    """The command lines' graph spec -> ``(graph, description)``:
    ``rmat:N:E[:SEED]``, ``er:N:E[:SEED]`` or ``grid:R:C`` (seed 0 by
    default).  Raises ``ValueError`` on a malformed spec."""
    parts = spec.split(":")
    kind = parts[0]
    try:
        if kind in ("rmat", "er"):
            n, e = int(parts[1]), int(parts[2])
            seed = int(parts[3]) if len(parts) > 3 else 0
            if kind == "rmat":
                return rmat_graph(n, e, seed=seed), f"rmat(n={n}, edges={e}, seed={seed})"
            return erdos_renyi_graph(n, e, seed=seed), f"erdos-renyi(n={n}, edges={e}, seed={seed})"
        if kind == "grid":
            r, c = int(parts[1]), int(parts[2])
            return grid_graph(r, c), f"grid({r}x{c})"
    except (IndexError, ValueError) as exc:
        raise ValueError(f"bad --graph spec {spec!r}: {exc}") from exc
    raise ValueError(f"unknown graph kind {kind!r} (rmat | er | grid)")


# ---------------------------------------------------------------------------
# SELL (sliced, degree-sorted ELL) — scatter-free CPU neighbor gather.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SellGraph:
    """Degree-sorted sliced-ELL layout: a *scatter-free* SpMM for skewed graphs.

    Vertices are sorted by descending degree and cut into groups of
    ``group_size`` rows; each group's neighbor lists are padded only to that
    group's own max degree (classic SELL-C-sigma with a full sort).  The
    neighbor reduction is then a padded row gather + masked sum per group —
    pure gathers and dense reductions, no scatter at all; results come back
    to original vertex order through one inverse-permutation gather.

    This exists because XLA:CPU's scatter (``segment_sum``) falls off a
    performance cliff on large edge lists (observed: ~2 ms at |E|≈30k/n=2k
    but ~400–600 ms at |E|≈130k/n=8k regardless of column count) and carries
    an |E|-proportional fixed cost per call that the fused column-batched
    pipeline would multiply.  Degree sorting bounds the padding waste that
    plain ELL suffers on power-law graphs (one hub row would pad every row
    to ``max_degree``).

    Attributes:
      group_rows: per group, (rows,) int32 — vertex ids in degree order
        (concatenating all groups gives the full degree-sorted order).
      group_nbr:  per group, (rows, d_group) int32 padded neighbor table.
      group_mask: per group, (rows, d_group) float32 validity mask.
      inv_order:  (n,) int32 — position of each degree-rank slot for the
        inverse gather: ``out = concat(group results)[inv_order]``.
      padded_slots: total padded neighbor slots across groups (the memory
        model's transient unit; ``>= num_directed``).
    """

    n: int
    group_size: int
    group_rows: Tuple[np.ndarray, ...]
    group_nbr: Tuple[np.ndarray, ...]
    group_mask: Tuple[np.ndarray, ...]
    inv_order: np.ndarray
    padded_slots: int


def build_sell(graph: Graph, group_size: int = 128) -> SellGraph:
    """Degree-sort vertices and build per-group padded neighbor tables."""
    deg = graph.degrees()
    row_ptr, col_idx = graph.csr()
    order = np.argsort(-deg, kind="stable")
    groups_rows = []
    groups_nbr = []
    groups_mask = []
    padded = 0
    for lo in range(0, graph.n, group_size):
        rows = order[lo : lo + group_size]
        d_max = max(int(deg[rows].max(initial=0)), 1)
        nbr = np.zeros((rows.size, d_max), dtype=np.int32)
        mask = np.zeros((rows.size, d_max), dtype=np.float32)
        for r, v in enumerate(rows):
            a, b = int(row_ptr[v]), int(row_ptr[v + 1])
            nbr[r, : b - a] = col_idx[a:b]
            mask[r, : b - a] = 1.0
        groups_rows.append(rows.astype(np.int32))
        groups_nbr.append(nbr)
        groups_mask.append(mask)
        padded += nbr.size
    inv_order = np.empty(graph.n, dtype=np.int32)
    inv_order[order] = np.arange(graph.n, dtype=np.int32)
    return SellGraph(
        n=graph.n,
        group_size=group_size,
        group_rows=tuple(groups_rows),
        group_nbr=tuple(groups_nbr),
        group_mask=tuple(groups_mask),
        inv_order=inv_order,
        padded_slots=padded,
    )


# ---------------------------------------------------------------------------
# Blocked-ELL (CSC-Split, TPU edition) — preprocessing for the Pallas SpMM.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BlockedELL:
    """Edges grouped by (dst-block, src-block) tile pairs.

    Attributes:
      n_padded: vertex count padded to a multiple of ``block_size``.
      block_size: tile edge (rows of M resident in VMEM per step).
      pair_dst_block: (n_pairs,) int32 — destination block id per pair.
      pair_src_block: (n_pairs,) int32 — source block id per pair.
      edge_dst_local: (n_pairs, pair_capacity) int32 — dst row within block.
      edge_src_local: (n_pairs, pair_capacity) int32 — src row within block.
      edge_valid:     (n_pairs, pair_capacity) float32 — 1.0 valid / 0.0 pad.
      row_block_ptr:  (n_blocks + 1,) int32 — pairs are sorted by dst block;
        pairs for dst block b live in ``[row_block_ptr[b], row_block_ptr[b+1])``.
    """

    n_padded: int
    block_size: int
    pair_dst_block: np.ndarray
    pair_src_block: np.ndarray
    edge_dst_local: np.ndarray
    edge_src_local: np.ndarray
    edge_valid: np.ndarray
    row_block_ptr: np.ndarray

    @property
    def n_blocks(self) -> int:
        return self.n_padded // self.block_size

    @property
    def n_pairs(self) -> int:
        return int(self.pair_dst_block.shape[0])

    @property
    def pair_capacity(self) -> int:
        return int(self.edge_dst_local.shape[1])


def build_blocked_ell(graph: Graph, block_size: int = 256, pair_capacity: Optional[int] = None) -> BlockedELL:
    """Group edges into (dst-block, src-block) pairs, padded to a capacity.

    ``pair_capacity`` defaults to the max edges in any pair rounded up to a
    multiple of 8 (sublane alignment).  Pairs are sorted by destination block
    so the kernel can keep one VMEM accumulator per destination tile.
    """
    bs = block_size
    n_padded = ((graph.n + bs - 1) // bs) * bs
    dst_b = graph.dst // bs
    src_b = graph.src // bs
    pair_key = dst_b.astype(np.int64) * (n_padded // bs) + src_b
    order = np.argsort(pair_key, kind="stable")
    pair_key_s = pair_key[order]
    uniq, starts, counts = np.unique(pair_key_s, return_index=True, return_counts=True)
    n_pairs = len(uniq)
    cap = int(counts.max(initial=1)) if pair_capacity is None else pair_capacity
    cap = ((cap + 7) // 8) * 8
    edge_dst_local = np.zeros((n_pairs, cap), dtype=np.int32)
    edge_src_local = np.zeros((n_pairs, cap), dtype=np.int32)
    edge_valid = np.zeros((n_pairs, cap), dtype=np.float32)
    dst_s, src_s = graph.dst[order], graph.src[order]
    for p in range(n_pairs):
        lo = int(starts[p])
        c = min(int(counts[p]), cap)
        edge_dst_local[p, :c] = dst_s[lo : lo + c] % bs
        edge_src_local[p, :c] = src_s[lo : lo + c] % bs
        edge_valid[p, :c] = 1.0
    pair_dst_block = (uniq // (n_padded // bs)).astype(np.int32)
    pair_src_block = (uniq % (n_padded // bs)).astype(np.int32)
    n_blocks = n_padded // bs
    row_block_ptr = np.zeros(n_blocks + 1, dtype=np.int32)
    np.add.at(row_block_ptr[1:], pair_dst_block, 1)
    row_block_ptr = np.cumsum(row_block_ptr).astype(np.int32)
    return BlockedELL(
        n_padded=n_padded,
        block_size=bs,
        pair_dst_block=pair_dst_block,
        pair_src_block=pair_src_block,
        edge_dst_local=edge_dst_local,
        edge_src_local=edge_src_local,
        edge_valid=edge_valid,
        row_block_ptr=row_block_ptr,
    )
