"""Distributed SUBGRAPH2VEC: the paper's MPI scheme over ``torch.distributed``.

The port of ``repro.core.distributed``, the compute core of the engine's
``mesh`` backend.  The reference is one controller under ``shard_map``; the
port is the same algorithm with one process per rank.  Every rank builds the
same count function (same plans, same column batch, same comm schedule) over
the same :class:`ShardedGraph`, calls it with the same colorings, and gets the
same replicated totals.  Decomposition:

* vertices are 1-D row-partitioned over the ranks of one process group, and
  every edge lives on the rank of its destination;
* **SpMM**, the only step that communicates: the passive state ``M_p`` is
  all-gathered in ``column_batch``-column slices (the paper's batched SpMM,
  §V-C), each collective serving all ``B`` colorings of a chunk, then a
  local segment sum over this rank's edges gives that slice of the
  aggregate;
* **eMA**: vertex-local, no communication;
* the totals are summed over the ranks with one ``all_reduce``.

Every collective goes through :class:`MeshComm`, one implementation over
``torch.distributed`` (NCCL on cards, gloo on the CPU): the all-gather of a
column batch, one ring hop, the all-reduce of the totals.

Sums are fixed-order on every device, so a repeat is bitwise equal and so
are the two comm modes: the segment sums run over edges sorted by
destination once at bind time (:func:`torch.segment_reduce`, one
sequential sum per row, where ``index_add_`` on a card would add with
atomics in no fixed order), and the streamed eMA's scatter into output
columns runs one entry per output at a time (:func:`_run_slots`), so no
output column is written twice by one launch.  The summation order differs
from the reference's ``segment_sum`` and scatter-add, so totals agree with
it to fp32 tolerance.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .colorsets import binom
from .counting import CountingPlan, schedule_liveness
from .graph import Graph

__all__ = [
    "ShardedGraph",
    "shard_graph",
    "MeshComm",
    "resolve_group",
    "build_streamed_tables",
    "make_batched_count_fn",
    "make_distributed_count_fn",
    "distributed_input_specs",
]


@dataclass(frozen=True)
class ShardedGraph:
    """Host-side edge partition: shard i owns vertex rows
    ``[i * rows_per_shard, (i+1) * rows_per_shard)`` and every edge whose dst
    lies in that range, padded to ``edges_per_shard``.

    ``perm`` is the old-id -> new-id vertex relabelling applied when
    ``balance_degrees=True`` (``None`` for the identity layout).  New ids
    range over ``[0, n_padded)`` (round-robin by degree rank leaves pad
    slots interleaved), so callers that fix per-vertex data (colors) must
    scatter it into an ``(n_padded,)`` array: ``data_new[perm] = data_old``.

    ``bucket_stride`` is set by ``bucket_by_src=True``: each shard's edge
    list is then grouped by *source* shard into ``n_shards`` contiguous
    buckets of exactly ``bucket_stride`` slots (the max (dst, src)-pair edge
    count; short buckets are mask-padded), so ``edges_per_shard == n_shards
    * bucket_stride`` and the ring reads the edges of one circulating row
    slice as one bucket.
    """

    n: int
    n_padded: int
    n_shards: int
    rows_per_shard: int
    edges_per_shard: int
    src: np.ndarray        # (n_shards * edges_per_shard,) global src ids
    dst_local: np.ndarray  # (n_shards * edges_per_shard,) dst - shard offset
    edge_mask: np.ndarray  # (n_shards * edges_per_shard,) float32
    perm: Optional[np.ndarray] = None  # (n,) old -> new id in [0, n_padded)
    bucket_stride: Optional[int] = None  # slots per src-shard bucket


def shard_graph(
    graph: Graph,
    n_shards: int,
    balance_degrees: bool = False,
    bucket_by_src: bool = False,
) -> ShardedGraph:
    """1-D row partition of ``graph`` over ``n_shards`` (edges follow dst);
    the reference's layout, array for array.

    ``balance_degrees=True`` relabels vertices round-robin by degree rank
    before partitioning, so consecutive hubs land on different shards.
    ``bucket_by_src=True`` additionally orders every shard's edges into
    ``n_shards`` uniform-stride buckets by *source* shard (see
    :class:`ShardedGraph`); the mesh backend always uses it, so its blocking
    and pipelined paths run over the same edge arrays.
    """
    src, dst = graph.src, graph.dst
    rows = max(-(-graph.n // n_shards), 1)
    n_padded = rows * n_shards
    perm = None
    if balance_degrees:
        # rank r lands on shard r % n_shards at row r // n_shards
        order = np.argsort(-graph.degrees(), kind="stable")
        ranks = np.arange(graph.n)
        perm = np.empty(graph.n, dtype=np.int64)
        perm[order] = (ranks % n_shards) * rows + ranks // n_shards
        src, dst = perm[src].astype(np.int32), perm[dst].astype(np.int32)
    shard_of = dst // rows
    order = np.argsort(shard_of, kind="stable")
    src_s, dst_s, shard_s = src[order], dst[order], shard_of[order]

    if bucket_by_src:
        # pair (s, o) lives at rows [o*stride, (o+1)*stride) of shard s's
        # edge list; pad slots keep mask 0 / src 0 / dst 0
        pair = shard_s.astype(np.int64) * n_shards + src_s // rows
        pair_counts = np.bincount(pair, minlength=n_shards * n_shards)
        stride = int(pair_counts.max(initial=1))
        order2 = np.argsort(pair, kind="stable")
        src_p, dst_p = src_s[order2], dst_s[order2]
        src_out = np.zeros((n_shards * n_shards, stride), dtype=np.int32)
        dst_out = np.zeros((n_shards * n_shards, stride), dtype=np.int32)
        mask_out = np.zeros((n_shards * n_shards, stride), dtype=np.float32)
        starts = np.concatenate([[0], np.cumsum(pair_counts)])
        for p in range(n_shards * n_shards):
            lo, hi = int(starts[p]), int(starts[p + 1])
            c = hi - lo
            src_out[p, :c] = src_p[lo:hi]
            dst_out[p, :c] = dst_p[lo:hi] - (p // n_shards) * rows
            mask_out[p, :c] = 1.0
        return ShardedGraph(
            n=graph.n,
            n_padded=n_padded,
            n_shards=n_shards,
            rows_per_shard=rows,
            edges_per_shard=n_shards * stride,
            src=src_out.reshape(-1),
            dst_local=dst_out.reshape(-1),
            edge_mask=mask_out.reshape(-1),
            perm=perm,
            bucket_stride=stride,
        )

    counts = np.bincount(shard_of, minlength=n_shards)
    e_max = int(counts.max(initial=1))
    src_out = np.zeros((n_shards, e_max), dtype=np.int32)
    dst_out = np.zeros((n_shards, e_max), dtype=np.int32)
    mask_out = np.zeros((n_shards, e_max), dtype=np.float32)
    starts = np.concatenate([[0], np.cumsum(np.bincount(shard_s, minlength=n_shards))])
    for s in range(n_shards):
        lo, hi = int(starts[s]), int(starts[s + 1])
        c = hi - lo
        src_out[s, :c] = src_s[lo:hi]
        dst_out[s, :c] = dst_s[lo:hi] - s * rows
        mask_out[s, :c] = 1.0
    return ShardedGraph(
        n=graph.n,
        n_padded=n_padded,
        n_shards=n_shards,
        rows_per_shard=rows,
        edges_per_shard=e_max,
        src=src_out.reshape(-1),
        dst_local=dst_out.reshape(-1),
        edge_mask=mask_out.reshape(-1),
        perm=perm,
    )


#: The most elements of ``M_s`` one ``index_add_`` call addresses: past
#: 2**31 the CUDA kernel switches to 64-bit index arithmetic, several times
#: slower on an H100 (``PERF.md``), so larger states are updated in blocks
#: of rows.
INDEX_ADD_ELEMENTS = 2**31 - 1


def _pad_cols(c: int, batch: int) -> int:
    return ((c + batch - 1) // batch) * batch


def _streamed_stage_tables(table, column_batch: int):
    """Re-bucket one stage's split table by passive-column batch.

    Returns ``(ent_out, ent_ia, ent_ip_local, ent_valid)`` shaped
    ``(n_batches, cap)`` (padded per batch), the reference's arrays: for
    batch ``bi`` the streamed schedule applies exactly the (out, split)
    entries whose passive column falls in that batch.  A batch's valid
    entries come first, in (out, split) order.
    """
    n_out, n_splits = table.idx_a.shape
    flat_out = np.repeat(np.arange(n_out, dtype=np.int32), n_splits)
    flat_ia = table.idx_a.reshape(-1).astype(np.int32)
    flat_ip = table.idx_p.reshape(-1).astype(np.int32)
    c_p = binom(table.k, table.m_p)
    n_batches = (c_p + column_batch - 1) // column_batch
    bucket = flat_ip // column_batch
    order = np.argsort(bucket, kind="stable")
    flat_out, flat_ia, flat_ip, bucket = (
        flat_out[order], flat_ia[order], flat_ip[order], bucket[order],
    )
    counts = np.bincount(bucket, minlength=n_batches)
    cap = int(counts.max(initial=1))
    ent_out = np.zeros((n_batches, cap), np.int32)
    ent_ia = np.zeros((n_batches, cap), np.int32)
    ent_ip = np.zeros((n_batches, cap), np.int32)
    ent_valid = np.zeros((n_batches, cap), np.float32)
    starts = np.concatenate([[0], np.cumsum(counts)])
    for b in range(n_batches):
        lo, hi = int(starts[b]), int(starts[b + 1])
        c = hi - lo
        ent_out[b, :c] = flat_out[lo:hi]
        ent_ia[b, :c] = flat_ia[lo:hi]
        ent_ip[b, :c] = flat_ip[lo:hi] - b * column_batch
        ent_valid[b, :c] = 1.0
    return ent_out, ent_ia, ent_ip, ent_valid


def build_streamed_tables(plan: CountingPlan, column_batch: int):
    """Per-stage split tables re-bucketed by passive-column batch:
    ``{stage: (ent_out, ent_ia, ent_ip_local, ent_valid)}`` with host
    arrays shaped ``(n_batches, cap)`` (:func:`_streamed_stage_tables`).

    The streamed schedule consumes each all-gathered SpMM column batch at
    once: for batch ``bi`` it applies every (out, split) entry whose passive
    column falls in the batch, so the aggregate ``B`` never exists."""
    return {
        i: _streamed_stage_tables(t, column_batch)
        for i, t in enumerate(plan.tables)
        if t is not None
    }


def _run_slots(ent_out, ent_ia, ent_ip, ent_valid, device):
    """One stage's streamed tables as slots, per batch: slot ``s`` holds the
    ``s``-th entry of every output that has more than ``s`` entries in the
    batch, as ``(outs, ia, ip)`` long tensors with ``outs`` unique and
    ascending.  Applying a batch's slots in order adds each output's entries
    in table order, and no slot writes an output column twice, so the
    scatter needs no atomics."""
    def dev(a):
        return torch.as_tensor(a.astype(np.int64), device=device)

    out = []
    for b in range(ent_out.shape[0]):
        c = int(ent_valid[b].sum())  # valid entries come first
        eo, ia, ip = ent_out[b, :c], ent_ia[b, :c], ent_ip[b, :c]
        first = np.ones(c, dtype=bool)
        first[1:] = eo[1:] != eo[:-1]
        starts = np.flatnonzero(first)
        slot = np.arange(c) - starts[np.cumsum(first) - 1]
        order = np.lexsort((eo, slot))
        bounds = np.searchsorted(slot[order], np.arange(int(slot.max(initial=-1)) + 2))
        out.append(tuple(
            (dev(eo[sel]), dev(ia[sel]), dev(ip[sel]))
            for sel in (order[bounds[s]:bounds[s + 1]] for s in range(len(bounds) - 1))
        ))
    return tuple(out)


# ---------------------------------------------------------------------------
# the process group and its collectives
# ---------------------------------------------------------------------------


def resolve_group(mesh):
    """The ``torch.distributed`` process group behind ``mesh=``: a 1-D
    ``DeviceMesh`` (its group) or a ``ProcessGroup``.  Raises ``ValueError``
    for ``None``, a mesh of more than one dimension, or when
    ``torch.distributed`` has no initialised default group (the caller
    initialises it: NCCL with one rank per card, gloo on the CPU)."""
    if mesh is None:
        raise ValueError(
            "backend='mesh' needs an initialised torch.distributed group "
            "(mesh=<1-D DeviceMesh or ProcessGroup>)"
        )
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(
            "backend='mesh' needs torch.distributed initialised "
            "(init_process_group) before the engine is built"
        )
    if hasattr(mesh, "get_group"):  # a DeviceMesh
        if mesh.ndim != 1:
            raise ValueError(f"backend='mesh' rings a 1-D mesh, got {mesh.ndim} dimensions")
        return mesh.get_group()
    return mesh


class MeshComm:
    """The mesh path's collectives over one process group: the all-gather
    of a column batch, one ring hop, and the all-reduce of the totals.

    One implementation, over ``torch.distributed``; tensors stay on the
    device they are given (the group's backend must take them)."""

    def __init__(self, group):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        ranks = dist.get_process_group_ranks(group)  # group rank -> global rank
        self._next = ranks[(self.rank + 1) % self.size]
        self._prev = ranks[(self.rank - 1) % self.size]

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` stacked on dim 0 in rank order."""
        x = x.contiguous()
        out = x.new_empty((self.size * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=self.group)
        return out

    def ring_hop(self, cur: torch.Tensor, nxt: torch.Tensor) -> List:
        """Start sending ``cur`` to rank ``+1`` and receiving rank ``-1``'s
        slice into ``nxt``; returns the works to wait on.  ``cur`` must stay
        alive and unchanged until they complete."""
        return dist.batch_isend_irecv([
            dist.P2POp(dist.isend, cur, self._next, self.group),
            dist.P2POp(dist.irecv, nxt, self._prev, self.group),
        ])

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the ranks, in place; every rank gets the result."""
        dist.all_reduce(x, group=self.group)
        return x


@dataclass(frozen=True)
class _Bucket:
    """One segment-sum operand: row indices into a gathered block, sorted
    by local destination, and the edge count of every local row."""

    src: torch.Tensor      # (E_valid,) long, rows of the block
    lengths: torch.Tensor  # (rows,) long


def _bucket(src: np.ndarray, dst_local: np.ndarray, mask: np.ndarray, rows: int, device) -> _Bucket:
    keep = mask > 0  # pad slots carry mask 0: they add nothing
    src, dst_local = src[keep], dst_local[keep]
    order = np.argsort(dst_local, kind="stable")
    return _Bucket(
        src=torch.as_tensor(src[order].astype(np.int64), device=device),
        lengths=torch.as_tensor(np.bincount(dst_local, minlength=rows).astype(np.int64),
                                device=device),
    )


# ---------------------------------------------------------------------------
# the count function
# ---------------------------------------------------------------------------


def make_batched_count_fn(
    plans: Sequence[CountingPlan],
    mesh,
    n_padded: int,
    edges_per_shard: int,
    *,
    column_batch: Optional[int] = 128,
    ema_mode: str = "streamed",
    gather_dtype: Optional[torch.dtype] = None,
    canons: Optional[Sequence[Sequence[str]]] = None,
    plan_ir=None,
    store_dtype: torch.dtype = torch.float32,
    accum_dtype: torch.dtype = torch.float32,
    comm_mode: str = "blocking",
    comm_schedule: Optional[Mapping[Tuple[int, int], str]] = None,
    bucket_stride: Optional[int] = None,
    device=None,
    ema_block: Optional[int] = None,
) -> "BatchedCount":
    """Build this rank's mesh count over a batched chunk of colorings.

    The compute core of the engine's ``mesh`` backend.  The returned
    :class:`BatchedCount` is called as the reference's function is::

      (colors (B, n_padded) int, src (S*E,), dst_local (S*E,), edge_mask (S*E,))
          -> (B, T) fp32 raw colorful totals, replicated on every rank

    with the :class:`ShardedGraph`'s whole arrays; each rank reads its own
    ``E`` edges and ``rows`` colors.  :meth:`BatchedCount.bind` sorts a
    rank's edges once, and :meth:`BatchedCount.run` runs on a bound layout
    (what the engine does).  Split tables are built here once, de-duplicated
    by ``(k, m, m_a)``.

    Args:
      plans: one or more same-``k`` :class:`CountingPlan`; DP states are
        shared across plans by rooted canonical form.
      mesh: a 1-D ``DeviceMesh`` or a ``ProcessGroup`` (:func:`resolve_group`).
      n_padded / edges_per_shard: the :class:`ShardedGraph` geometry.
      column_batch: passive columns all-gathered per collective; ``None``
        gathers a state's whole width at once (not with ``"streamed"``;
        states are then padded to 128 columns, as the reference pads).
      ema_mode: ``"streamed"`` (every gathered column batch is consumed at
        once by the eMA entries that read it; ``B`` never exists) or
        ``"loop"`` (the paper's Algorithm 5: the batched SpMM into ``B``,
        then the eMA; ``B`` memoised per passive canonical form) or
        ``"vectorized"`` (the reference's probe mode: ``B`` as in
        ``"loop"``, then each stage's eMA as one gather-FMA over all its
        splits, ``einsum("rbos,rbos->rbo")`` of ``index_select``s of
        ``M_a`` and ``B``; the launch tooling's subgraph probe cells use
        it).
      gather_dtype: wire dtype of the all-gather and the ring (e.g.
        ``torch.bfloat16``); accumulation stays fp32.
      canons / plan_ir: the DP schedule (canonical sharing and liveness);
        the engine passes its bound plan, legacy callers omit both.
      store_dtype / accum_dtype: the engine's dtype policy.
      comm_mode: ``"blocking"`` (one all-gather per column batch) or
        ``"pipelined"`` (the double-buffered ring: per-rank row slices of
        the batch circulate to rank ``+1``, the next hop in flight while the
        current slice's edge bucket is reduced).  Pipelined needs the
        ``bucket_by_src`` layout, >= 2 ranks and the streamed eMA.  With
        that layout blocking folds the same per-source-shard bucket sums in
        the same ring order, reading each owner's rows out of its one
        gathered buffer, so the two modes are bitwise equal.
      comm_schedule: per-stage override map ``(plan_idx, sub_idx) -> mode``.
      bucket_stride: the ``bucket_by_src`` layout's ``bucket_stride``.
      device: where this rank's tensors live (``None``: the CUDA card).
      ema_block: output columns per streamed-eMA step; ``None`` bounds the
        step's two ``(rows, B, block)`` temporaries per coloring by the
        collective scratch :meth:`~repro_torch.plan.cost.CostModel.
        mesh_transient_elements` prices, ``(n_padded + edges_per_shard) *
        column_batch``, so the eMA never needs more than the SpMM half.
    """
    from repro_torch.device import resolve_device

    if not plans:
        raise ValueError("make_batched_count_fn needs at least one plan")
    ks = {p.k for p in plans}
    if len(ks) != 1:
        raise ValueError(f"all plans must share one k, got {sorted(ks)}")
    if ema_mode not in ("streamed", "loop", "vectorized"):
        raise ValueError(f"unknown ema_mode {ema_mode!r}")
    if comm_mode not in ("blocking", "pipelined"):
        raise ValueError(f"unknown comm_mode {comm_mode!r}")
    if column_batch is None and ema_mode == "streamed":
        raise ValueError("ema_mode='streamed' needs a finite column_batch")
    if column_batch is not None and column_batch < 1:
        raise ValueError(f"column_batch must be a positive int or None, got {column_batch!r}")
    comm = MeshComm(resolve_group(mesh))
    n_shards = comm.size
    if n_padded % n_shards:
        raise ValueError(f"n_padded={n_padded} does not split over {n_shards} ranks")
    comm_schedule = dict(comm_schedule or {})
    bad = {m for m in comm_schedule.values() if m not in ("blocking", "pipelined")}
    if bad:
        raise ValueError(f"unknown comm_schedule mode(s) {sorted(bad)}")
    if comm_mode == "pipelined" or "pipelined" in comm_schedule.values():
        if ema_mode != "streamed":
            raise ValueError(
                f"comm_mode='pipelined' requires ema_mode='streamed' (got {ema_mode!r}) "
                "— the ring consumes each slice inside the fused SpMM+eMA sweep"
            )
        if n_shards < 2:
            raise ValueError("comm_mode='pipelined' needs >= 2 shards")
        if bucket_stride is None or n_shards * bucket_stride != edges_per_shard:
            raise ValueError(
                "comm_mode='pipelined' needs the bucket_by_src edge layout: "
                f"bucket_stride={bucket_stride!r} with edges_per_shard="
                f"{edges_per_shard} and n_shards={n_shards}"
            )
    track_products = ema_mode != "streamed"
    if canons is not None:
        free_at = schedule_liveness(plans, canons, track_products=track_products)
    else:
        if plan_ir is None:
            from repro_torch.plan.ir import build_template_plan

            plan_ir = build_template_plan([p.template for p in plans], plans=plans)
        canons = plan_ir.canons
        free_at = plan_ir.liveness(track_products=track_products)
    rows = n_padded // n_shards
    if ema_block is None:
        ema_block = max(1, (n_padded + edges_per_shard) * (column_batch or 128) // (2 * rows))
    return BatchedCount(
        plans=tuple(plans),
        canons=tuple(tuple(c) for c in canons),
        free_at=free_at,
        comm=comm,
        n_padded=n_padded,
        edges_per_shard=edges_per_shard,
        column_batch=column_batch,
        ema_mode=ema_mode,
        gather_dtype=gather_dtype,
        store_dtype=store_dtype,
        accum_dtype=accum_dtype,
        comm_mode=comm_mode,
        comm_schedule=comm_schedule,
        bucket_stride=bucket_stride,
        device=resolve_device(device),
        ema_block=int(ema_block),
    )


class BatchedCount:
    """One rank's mesh count (built by :func:`make_batched_count_fn`)."""

    def __init__(self, *, plans, canons, free_at, comm, n_padded, edges_per_shard,
                 column_batch, ema_mode, gather_dtype, store_dtype, accum_dtype,
                 comm_mode, comm_schedule, bucket_stride, device, ema_block):
        self.plans, self.canons, self.free_at, self.comm = plans, canons, free_at, comm
        self.k = plans[0].k
        self.n_padded, self.edges_per_shard = n_padded, edges_per_shard
        self.n_shards, self.rank = comm.size, comm.rank
        self.rows = n_padded // comm.size
        self.column_batch, self.ema_mode = column_batch, ema_mode
        self.pad_unit = column_batch or 128
        self.gather_dtype = gather_dtype
        self.store_dtype, self.accum_dtype = store_dtype, accum_dtype
        self.comm_mode, self.comm_schedule = comm_mode, comm_schedule
        self.bucket_stride, self.device, self.ema_block = bucket_stride, device, ema_block
        # the bucketed consume is shared by the ring and the blocking path,
        # so the two modes fold bit-identically
        self.bucket_fold = bucket_stride is not None and comm.size >= 2
        self.stage_table_key: Dict[Tuple[int, int], Tuple[int, int, int]] = {}
        self.tables: Dict[Tuple[int, int, int], object] = {}
        for p_idx, plan in enumerate(plans):
            for i, t in enumerate(plan.tables):
                if t is None:
                    continue
                key = (t.k, t.m, t.m_a)
                self.stage_table_key[(p_idx, i)] = key
                if key in self.tables:
                    continue
                if ema_mode == "streamed":
                    self.tables[key] = _run_slots(*_streamed_stage_tables(t, column_batch),
                                                  device)
                else:
                    self.tables[key] = tuple(
                        torch.as_tensor(np.asarray(a).astype(np.int64), device=device)
                        for a in (t.idx_a, t.idx_p)
                    )

    # -- edges ----------------------------------------------------------------

    def bind(self, src, dst_local, edge_mask) -> Tuple[_Bucket, ...]:
        """This rank's edges from the :class:`ShardedGraph`'s whole arrays,
        as segment-sum buckets: one per source shard (in owner order) on the
        bucketed layout with >= 2 ranks, else one over all its edges (with
        global source ids)."""
        e = self.edges_per_shard
        lo = self.rank * e
        src = np.asarray(src)[lo:lo + e]
        dst_local = np.asarray(dst_local)[lo:lo + e]
        mask = np.asarray(edge_mask)[lo:lo + e]
        if not self.bucket_fold:
            return (_bucket(src, dst_local, mask, self.rows, self.device),)
        s = self.bucket_stride
        return tuple(
            _bucket(src[o * s:(o + 1) * s] - o * self.rows, dst_local[o * s:(o + 1) * s],
                    mask[o * s:(o + 1) * s], self.rows, self.device)
            for o in range(self.n_shards)
        )

    def __call__(self, colors_batch, src, dst_local, edge_mask) -> torch.Tensor:
        return self.run(colors_batch, self.bind(src, dst_local, edge_mask))

    # -- SpMM -----------------------------------------------------------------

    def _wire(self, cols: torch.Tensor) -> torch.Tensor:
        cols = cols if self.gather_dtype is None else cols.to(self.gather_dtype)
        return cols.contiguous()

    def _partial(self, block: torch.Tensor, bucket: _Bucket) -> torch.Tensor:
        """One bucket's segment sum over a gathered block: ``(rows, B, cb)``
        in accum dtype, each row's edges added in a fixed order."""
        msgs = block.index_select(0, bucket.src).to(self.accum_dtype)
        return torch.segment_reduce(msgs, "sum", lengths=bucket.lengths, axis=0)

    def _fold(self, get_block, buckets) -> torch.Tensor:
        """Per-source-shard bucket sums folded in ring order (``owner = (rank
        - d) mod D``), shared by both comm modes: ``get_block(d, owner)``
        supplies owner's rows of the batch."""
        bcol = None
        for d in range(self.n_shards):
            owner = (self.rank - d) % self.n_shards
            part = self._partial(get_block(d, owner), buckets[owner])
            bcol = part if bcol is None else bcol + part
        return bcol

    def _spmm_blocking(self, cols, buckets) -> torch.Tensor:
        full = self.comm.all_gather(self._wire(cols))
        if not self.bucket_fold:
            return self._partial(full, buckets[0])
        rows = self.rows
        return self._fold(lambda d, owner: full[owner * rows:(owner + 1) * rows], buckets)

    def _spmm_ring(self, cols, buckets) -> torch.Tensor:
        """Double-buffered ring over one column batch: after ``d`` hops this
        rank holds rank ``(rank - d) mod D``'s slice, and hop ``d + 1`` is
        started before hop ``d``'s bucket is reduced.  Two slices live at a
        time; the gathered buffer never exists."""
        state = {"cur": self._wire(cols), "works": ()}

        def block(d, owner):
            for w in state["works"]:
                w.wait()
            cur = state["cur"]
            if d + 1 < self.n_shards:  # start the next hop now
                nxt = torch.empty_like(cur)
                state["works"] = self.comm.ring_hop(cur, nxt)
                state["cur"] = nxt
            else:
                state["works"] = ()
            return cur

        bcol = self._fold(block, buckets)
        for w in state["works"]:
            w.wait()
        return bcol

    def spmm_batched(self, m_p, buckets) -> torch.Tensor:
        """Column-batched all-gather SpMM of the whole ``(rows, B, C_pad)``
        passive state, in accum dtype (the ``loop`` and ``vectorized`` eMA
        modes' ``B``); one gather of the whole width without a column
        batch."""
        cb = self.column_batch
        if cb is None:
            return self._spmm_blocking(m_p, buckets)
        return torch.cat([
            self._spmm_blocking(m_p[:, :, lo:lo + cb], buckets)
            for lo in range(0, m_p.shape[2], cb)
        ], dim=2)

    # -- eMA ------------------------------------------------------------------

    def _output(self, bsz: int, n_out: int, device) -> torch.Tensor:
        """A stage's zeroed accumulator, already padded to the column batch:
        in fp32 it becomes the stored state without a padded copy beside
        it (the pad columns stay zero)."""
        return torch.zeros((self.rows, bsz, _pad_cols(n_out, self.pad_unit)),
                           dtype=self.accum_dtype, device=device)

    def _fma(self, m_s, m_a, bcol, outs, ia, ip) -> None:
        """``m_s[:, :, outs] += m_a[:, :, ia] * bcol[:, :, ip]`` over blocks
        of ``ema_block`` outputs (``outs`` unique, or ``None`` for all of
        ``m_s``'s columns in order)."""
        for lo in range(0, ia.shape[0], self.ema_block):
            hi = lo + self.ema_block
            prod = m_a.index_select(2, ia[lo:hi]).to(self.accum_dtype)
            prod.mul_(bcol.index_select(2, ip[lo:hi]))
            if outs is None:
                m_s[:, :, lo:lo + prod.shape[2]].add_(prod)
                continue
            step = max(1, INDEX_ADD_ELEMENTS // (m_s.shape[1] * m_s.shape[2]))
            for r in range(0, m_s.shape[0], step):
                m_s[r:r + step].index_add_(2, outs[lo:hi], prod[r:r + step])

    def spmm_ema_streamed(self, m_p, m_a, n_out, slots, buckets, mode) -> torch.Tensor:
        """Fused per-batch SpMM -> eMA: gather a column batch, reduce it, and
        add its entries into ``M_s`` at once (``B`` never exists).  Peak
        scratch per coloring: the gathered batch and its edge messages (or
        two ring slices and one bucket's), and the eMA's two ``(rows,
        ema_block)`` temporaries."""
        cb = self.column_batch
        m_s = self._output(m_p.shape[1], n_out, m_p.device)
        spmm = self._spmm_ring if mode == "pipelined" else self._spmm_blocking
        for b_idx, batch in enumerate(slots):
            bcol = spmm(m_p[:, :, b_idx * cb:(b_idx + 1) * cb], buckets)
            for outs, ia, ip in batch:
                self._fma(m_s, m_a, bcol, outs, ia, ip)
            del bcol
        return m_s

    def ema_vectorized(self, m_a, b, idx_a, idx_p) -> torch.Tensor:
        """The whole stage's eMA as one gather-FMA over its ``(outputs,
        splits)`` tables: ``(rows, B, n_out)``, in accum dtype."""
        shape = (m_a.shape[0], m_a.shape[1]) + tuple(idx_a.shape)
        return torch.einsum(
            "rbos,rbos->rbo",
            m_a.index_select(2, idx_a.reshape(-1)).view(shape).to(self.accum_dtype),
            b.index_select(2, idx_p.reshape(-1)).view(shape),
        )

    def ema_loop(self, m_a, b, idx_a, idx_p) -> torch.Tensor:
        """Vertex-local eMA over the fused ``(rows, B, C)`` state
        (Algorithm 5), one split at a time."""
        m_s = self._output(m_a.shape[1], idx_a.shape[0], m_a.device)
        for t in range(idx_a.shape[1]):
            self._fma(m_s, m_a, b, None, idx_a[:, t], idx_p[:, t])
        return m_s

    # -- the DP walk ----------------------------------------------------------

    def run(self, colors_batch, buckets) -> torch.Tensor:
        """``(B, n_padded)`` colorings -> ``(B, T)`` fp32 totals, summed over
        the ranks (see :func:`make_batched_count_fn`)."""
        colors_batch = torch.as_tensor(colors_batch, device=self.device)
        lo = self.rank * self.rows
        local = colors_batch[:, lo:lo + self.rows].long()
        cb = self.pad_unit

        def pad_c(m):
            c = m.shape[-1]
            return m if c % cb == 0 else torch.nn.functional.pad(m, (0, _pad_cols(c, cb) - c))

        def free(pos, slots, prods):
            for key in self.free_at.get(pos, ()):
                if isinstance(key, tuple):
                    prods.pop(key[1], None)
                else:
                    slots.pop(key, None)

        leaf = pad_c(torch.nn.functional.one_hot(local.t(), self.k).to(self.store_dtype))
        executed = set()
        slots: Dict[str, torch.Tensor] = {}
        prods: Dict[str, torch.Tensor] = {}
        totals = []
        pos = 0
        for p_idx, plan in enumerate(self.plans):
            pc = self.canons[p_idx]
            for i, sub in enumerate(plan.partition.subs):
                ckey = pc[i]
                if ckey in executed:
                    continue
                executed.add(ckey)
                if sub.is_leaf:
                    slots[ckey] = leaf
                else:
                    m_a, m_p = slots[pc[sub.active]], slots[pc[sub.passive]]
                    tables = self.tables[self.stage_table_key[(p_idx, i)]]
                    if self.ema_mode == "streamed":
                        m_s = self.spmm_ema_streamed(
                            m_p, m_a, plan.tables[i].n_out, tables, buckets,
                            self.comm_schedule.get((p_idx, i), self.comm_mode),
                        )
                    else:
                        p_key = pc[sub.passive]
                        if p_key not in prods:
                            prods[p_key] = self.spmm_batched(m_p, buckets)
                        ema = self.ema_vectorized if self.ema_mode == "vectorized" else self.ema_loop
                        m_s = ema(m_a, prods[p_key], *tables)
                    slots[ckey] = pad_c(m_s.to(self.store_dtype))
                free(pos, slots, prods)
                pos += 1
            root = slots[pc[plan.partition.root_index]].to(self.accum_dtype)
            # colour sets first, then this rank's vertices, then the ranks
            totals.append(root.sum(dim=2).sum(dim=0))
            free(pos, slots, prods)
            pos += 1
        out = torch.stack(totals, dim=1).to(torch.float32).contiguous()
        return self.comm.all_reduce(out)  # (B, T), replicated


def make_distributed_count_fn(
    plan: CountingPlan,
    mesh,
    n_padded: int,
    edges_per_shard: int,
    column_batch: Optional[int] = 128,
    ema_mode: str = "loop",
    gather_dtype: Optional[torch.dtype] = None,
    device=None,
) -> Callable:
    """One-coloring, one-template distributed count (the reference's compat
    surface): a ``B = 1`` wrapper over :func:`make_batched_count_fn`::

      (colors (n_padded,) int, src (S*E,), dst_local (S*E,), edge_mask (S*E,))
          -> 0-d fp32 raw colorful total

    Estimation runs should use the engine's ``mesh`` backend, which batches
    chunks of colorings into each collective."""
    batched = make_batched_count_fn(
        [plan], mesh, n_padded, edges_per_shard,
        column_batch=column_batch, ema_mode=ema_mode, gather_dtype=gather_dtype,
        device=device,
    )

    def count(colors, src, dst_local, edge_mask):
        colors = torch.as_tensor(colors)
        return batched(colors[None, :], src, dst_local, edge_mask)[0, 0]

    return count


def distributed_input_specs(n_padded: int, n_shards: int, edges_per_shard: int):
    """The one-coloring distributed count's arguments as ``meta`` tensors:
    colors ``(n_padded,)`` int32, and the global src, local dst and edge
    mask ``(n_shards * edges_per_shard,)`` (int32, int32, fp32)."""
    e_total = n_shards * edges_per_shard
    return (
        torch.empty((n_padded,), dtype=torch.int32, device="meta"),
        torch.empty((e_total,), dtype=torch.int32, device="meta"),
        torch.empty((e_total,), dtype=torch.int32, device="meta"),
        torch.empty((e_total,), dtype=torch.float32, device="meta"),
    )
