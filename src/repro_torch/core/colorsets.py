"""Combinadic color-set indexing and split tables.

Color coding assigns each vertex a color in ``[0, k)``.  The dynamic program
stores, for a sub-template ``T_s`` with ``m = |T_s|`` vertices, a dense count
matrix ``M_s`` of shape ``(n_vertices, C(k, m))`` whose columns are indexed by
the *rank* of the size-``m`` color set ``C_s``.

This module provides:

* a vectorized colexicographic ranking of fixed-size subsets of ``[0, k)``
  (``rank_subsets`` / ``unrank_subsets``),
* the *split tables* ``(idx_a, idx_p)`` used by the eMA stage: for every output
  color set ``C_s`` (row) and every split of ``C_s`` into an active subset of
  size ``m_a`` and a passive subset of size ``m_p`` (column), the column ranks
  into ``M_{s,a}`` and ``M_{s,p}``.

Everything here is static host-side preprocessing (NumPy); the tables are
shipped to the device as int32 arrays and reused across color-coding
iterations.  A copy of ``repro.core.colorsets`` (the port imports nothing of
the JAX package).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from functools import lru_cache

import numpy as np

__all__ = [
    "binom",
    "binom_table",
    "enumerate_subsets",
    "rank_subsets",
    "unrank_subsets",
    "SplitTable",
    "build_split_table",
    "UnionSplitTable",
    "build_union_split_table",
    "bucketed_split_entries",
    "colorful_probability",
]


@lru_cache(maxsize=None)
def binom_table(n_max: int) -> np.ndarray:
    """Pascal triangle ``C[n, r]`` for ``0 <= n, r <= n_max`` (int64)."""
    c = np.zeros((n_max + 1, n_max + 1), dtype=np.int64)
    c[:, 0] = 1
    for n in range(1, n_max + 1):
        for r in range(1, n + 1):
            c[n, r] = c[n - 1, r - 1] + c[n - 1, r]
    return c


def binom(n: int, r: int) -> int:
    """``C(n, r)`` with the usual out-of-range zeros."""
    if r < 0 or r > n or n < 0:
        return 0
    return int(binom_table(max(n, 1))[n, r])


def enumerate_subsets(k: int, m: int) -> np.ndarray:
    """All size-``m`` subsets of ``[0, k)`` in colex rank order.

    Returns an ``(C(k, m), m)`` int32 array with each row sorted ascending.
    Row ``r`` is exactly the subset with ``rank_subsets(row) == r``.
    """
    if m == 0:
        return np.zeros((1, 0), dtype=np.int32)
    combos = np.array(list(itertools.combinations(range(k), m)), dtype=np.int32)
    ranks = rank_subsets(combos)
    order = np.argsort(ranks, kind="stable")
    return combos[order]


def rank_subsets(subsets: np.ndarray) -> np.ndarray:
    """Colex rank of each row of a ``(..., m)`` array of sorted subsets.

    ``rank(c_0 < c_1 < ... < c_{m-1}) = sum_i C(c_i, i + 1)``.
    Vectorized over leading dimensions.
    """
    subsets = np.asarray(subsets)
    if subsets.shape[-1] == 0:
        return np.zeros(subsets.shape[:-1], dtype=np.int64)
    cmax = int(subsets.max(initial=0))
    table = binom_table(max(cmax, subsets.shape[-1], 1))
    idx_r = np.arange(1, subsets.shape[-1] + 1)
    return table[subsets, idx_r].sum(axis=-1)


def unrank_subsets(ranks: np.ndarray, k: int, m: int) -> np.ndarray:
    """Inverse of :func:`rank_subsets` (loop over ranks; test helper only)."""
    table = binom_table(max(k, 1))
    out = np.zeros((len(ranks), m), dtype=np.int32)
    for row, rank in enumerate(np.asarray(ranks, dtype=np.int64)):
        r = int(rank)
        for i in range(m, 0, -1):
            # Largest c with C(c, i) <= r.
            c = i - 1
            while c + 1 < k and table[c + 1, i] <= r:
                c += 1
            out[row, i - 1] = c
            r -= int(table[c, i])
    return out


@dataclass(frozen=True)
class SplitTable:
    """eMA split table for one sub-template.

    Attributes:
      idx_a: ``(n_out, n_splits)`` int32 — column ranks into ``M_{s,a}``.
      idx_p: ``(n_out, n_splits)`` int32 — column ranks into ``M_{s,p}``.
      n_out: number of output color sets, ``C(k, m)``.
      n_splits: splits per output color set, ``C(m, m_a)``.
    """

    idx_a: np.ndarray
    idx_p: np.ndarray
    n_out: int
    n_splits: int
    k: int
    m: int
    m_a: int

    @property
    def m_p(self) -> int:
        return self.m - self.m_a


def build_split_table(k: int, m: int, m_a: int) -> SplitTable:
    """Build the eMA split table for color sets of size ``m`` split ``m_a|m_p``.

    For every size-``m`` color set ``C`` (in colex rank order) and every way of
    choosing ``m_a`` of its elements as the *active* subset, records the colex
    ranks of the active subset (among size-``m_a`` subsets of ``[0, k)``) and of
    the complementary passive subset (among size-``m_p`` subsets).

    Fully vectorized over the ``C(k, m)`` color sets: the combinatorial loop is
    only over the ``C(m, m_a)`` position masks.
    """
    if not (0 <= m_a <= m <= k):
        raise ValueError(f"invalid split sizes k={k} m={m} m_a={m_a}")
    sets_m = enumerate_subsets(k, m)  # (n_out, m), colex order
    n_out = sets_m.shape[0]
    masks = list(itertools.combinations(range(m), m_a))
    n_splits = len(masks)
    idx_a = np.zeros((n_out, n_splits), dtype=np.int32)
    idx_p = np.zeros((n_out, n_splits), dtype=np.int32)
    all_pos = set(range(m))
    for t, mask in enumerate(masks):
        pos_a = np.array(mask, dtype=np.int64).reshape(1, -1)
        pos_p = np.array(sorted(all_pos - set(mask)), dtype=np.int64).reshape(1, -1)
        sub_a = np.take_along_axis(sets_m, np.broadcast_to(pos_a, (n_out, m_a)), axis=1) if m_a else np.zeros((n_out, 0), np.int32)
        sub_p = np.take_along_axis(sets_m, np.broadcast_to(pos_p, (n_out, m - m_a)), axis=1) if m - m_a else np.zeros((n_out, 0), np.int32)
        idx_a[:, t] = rank_subsets(sub_a).astype(np.int32)
        idx_p[:, t] = rank_subsets(sub_p).astype(np.int32)
    return SplitTable(idx_a=idx_a, idx_p=idx_p, n_out=n_out, n_splits=n_splits, k=k, m=m, m_a=m_a)


@dataclass(frozen=True)
class UnionSplitTable:
    """Color-subset convolution table for a bag-join step.

    A bag join multiplies two DP states whose covered vertex sets overlap
    in exactly the join bag: color sets of sizes ``m1`` and ``m2`` sharing
    exactly ``overlap`` colors combine into an output set of size
    ``m = m1 + m2 - overlap``.  For every output color set ``S`` (row, in
    colex rank order) the columns enumerate every admissible pair
    ``(S1, S2)`` with ``S1 ∪ S2 = S``, ``|S1| = m1``, ``|S2| = m2`` and
    ``|S1 ∩ S2| = overlap``, as colex ranks into the two input states.

    Attributes:
      idx_a: ``(n_out, n_pairs)`` int32 — ranks of ``S1`` into state 1.
      idx_p: ``(n_out, n_pairs)`` int32 — ranks of ``S2`` into state 2.
      n_out: ``C(k, m)`` output color sets.
      n_pairs: pairs per output set, ``C(m, overlap) * C(m - overlap,
        m1 - overlap)`` (uniform across rows — the join stays a dense
        gather-FMA exactly like the eMA split tables).
    """

    idx_a: np.ndarray
    idx_p: np.ndarray
    n_out: int
    n_pairs: int
    k: int
    m1: int
    m2: int
    overlap: int

    @property
    def m(self) -> int:
        return self.m1 + self.m2 - self.overlap


def build_union_split_table(k: int, m1: int, m2: int, overlap: int) -> UnionSplitTable:
    """Build the join table for color sets of sizes ``m1``/``m2`` overlapping
    in exactly ``overlap`` colors.

    Each pair is generated once: pick the ``overlap`` positions of ``S`` that
    form the intersection, then the ``m1 - overlap`` positions that belong
    only to ``S1`` (the rest belong only to ``S2``).  Vectorized over the
    ``C(k, m)`` output color sets like :func:`build_split_table` — the
    combinatorial loop is only over position masks.

    With ``overlap == 0`` and ``m_a = m1`` this degenerates to the disjoint
    eMA split table (same entries as ``build_split_table(k, m, m1)``), which
    is the treewidth-1 special case of the color-subset convolution.
    """
    m = m1 + m2 - overlap
    if not (0 <= overlap <= min(m1, m2) and 0 < m1 <= k and 0 < m2 <= k and m <= k):
        raise ValueError(
            f"invalid union split sizes k={k} m1={m1} m2={m2} overlap={overlap}"
        )
    sets_m = enumerate_subsets(k, m)  # (n_out, m), colex order
    n_out = sets_m.shape[0]
    combos = []
    positions = range(m)
    for inter in itertools.combinations(positions, overlap):
        rest = [p for p in positions if p not in inter]
        for extra1 in itertools.combinations(rest, m1 - overlap):
            pos1 = tuple(sorted(inter + extra1))
            pos2 = tuple(sorted(set(positions) - set(extra1)))
            combos.append((pos1, pos2))
    n_pairs = len(combos)
    idx_a = np.zeros((n_out, n_pairs), dtype=np.int32)
    idx_p = np.zeros((n_out, n_pairs), dtype=np.int32)
    for t, (pos1, pos2) in enumerate(combos):
        sub1 = sets_m[:, pos1]
        sub2 = sets_m[:, pos2]
        idx_a[:, t] = rank_subsets(sub1).astype(np.int32)
        idx_p[:, t] = rank_subsets(sub2).astype(np.int32)
    return UnionSplitTable(
        idx_a=idx_a,
        idx_p=idx_p,
        n_out=n_out,
        n_pairs=n_pairs,
        k=k,
        m1=m1,
        m2=m2,
        overlap=overlap,
    )


def bucketed_split_entries(table: SplitTable, column_batch: int):
    """Re-bucket a split table by passive-column batch, dense per output row.

    The fused SpMM+eMA pipeline walks the passive matrix in
    ``column_batch``-column slices and must apply, for each slice, exactly
    the (output, split) entries whose passive column falls inside it —
    without ever materializing the full aggregate product.  For batch ``b``
    covering passive columns ``[lo, lo + width)`` this returns entries
    *bucketed per output row* so the eMA update stays a dense gather-FMA
    (no scatter):

        ``m_s[:, o] += sum_j m_a[:, idx_a[b][o, j]] * bcol[:, idx_p[b][o, j]]
                       * valid[b][o, j]``

    Returns a list over batches of ``(lo, width, idx_a, idx_p_local,
    valid)`` with ``idx_a / idx_p_local / valid`` shaped ``(n_out, cap_b)``
    (``cap_b`` = the batch's max entries per output row; padded entries are
    zero-index, zero-valid; ``valid`` is ``None`` when every slot is real —
    the executor then skips the masking multiply).  Every (output, split)
    entry of the table lands in exactly one batch, and the batch order is
    fixed, so the fused result is deterministic and equals the two-pass eMA
    up to fp summation order.
    """
    if column_batch <= 0:
        raise ValueError(f"column_batch must be positive, got {column_batch}")
    idx_a, idx_p = np.asarray(table.idx_a), np.asarray(table.idx_p)
    n_out = idx_a.shape[0]
    c_p = binom(table.k, table.m_p)
    n_batches = -(-c_p // column_batch)
    # one stable sort by (batch, output) keeps each output's entries in
    # split order; an entry's slot is its rank inside its (batch, output)
    key = ((idx_p // column_batch) * n_out + np.arange(n_out)[:, None]).ravel()
    order = np.argsort(key, kind="stable")
    skey = key[order]
    counts = np.bincount(key, minlength=n_batches * n_out)
    starts = np.cumsum(counts) - counts
    slot = np.arange(skey.size) - starts[skey]
    outs = skey % n_out
    flat_a, flat_p = idx_a.ravel()[order], idx_p.ravel()[order]
    bounds = np.searchsorted(skey // n_out, np.arange(n_batches + 1))
    caps = counts.reshape(n_batches, n_out).max(axis=1, initial=0)
    batches = []
    for b in range(n_batches):
        lo, cap = b * column_batch, max(int(caps[b]), 1)
        width = min(column_batch, c_p - lo)
        sl = slice(bounds[b], bounds[b + 1])
        ia = np.zeros((n_out, cap), dtype=np.int32)
        ip = np.zeros((n_out, cap), dtype=np.int32)
        valid = np.zeros((n_out, cap), dtype=np.float32)
        ia[outs[sl], slot[sl]] = flat_a[sl]
        ip[outs[sl], slot[sl]] = flat_p[sl] - lo
        valid[outs[sl], slot[sl]] = 1.0
        batches.append((lo, width, ia, ip, valid if not valid.all() else None))
    return batches


def colorful_probability(k: int) -> float:
    """P(an embedding of a size-``k`` template is colorful) = k! / k**k."""
    p = 1.0
    for i in range(1, k + 1):
        p *= i / k
    return p
