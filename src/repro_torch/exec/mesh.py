"""Mesh execution backend: the DP over ranks of a ``torch.distributed`` group.

The port of ``repro.exec.mesh``.  Wraps the column-batched all-gather SpMM
and streamed eMA of :mod:`repro_torch.core.distributed`: vertices are 1-D
row-partitioned over the group's ranks, each DP stage broadcasts the
passive state in ``column_batch``-column slices (each collective serving
all ``B`` chunked colorings at once), and the eMA stays vertex-local.  The
DP schedule (canonical sharing, liveness) comes from the engine's bound
:class:`~repro_torch.plan.ir.TemplatePlan`.

Every rank builds the engine with the same arguments and calls it with the
same keys; each computes the whole coloring, keeps its own rows, and gets
the replicated totals.  The group is the caller's: NCCL with one rank per
card (``cuda:{local_rank}``), gloo on the CPU with ``device="cpu"``.

Each stage's collective runs in one of two modes, decided at plan time by
``CostModel.comm_schedule`` (overridden by ``REPRO_MESH_COMM`` or the
``mesh_comm=`` engine argument):

* ``blocking``: one all-gather per column batch, then the edge segment sums
  over the gathered buffer (the paper's synchronous scheme);
* ``pipelined``: the double-buffered ring, per-rank row slices circulating
  to rank ``+1`` with the next hop in flight while the current slice's edge
  bucket is reduced.  Bitwise equal to blocking: on the bucketed layout
  both fold the same per-source-shard sums in the same ring order.
"""

from __future__ import annotations

from typing import Optional

import torch

from .base import EngineBackend
from .select import mesh_comm_mode

__all__ = ["MeshBackend", "BagPlanUnsupported"]


class BagPlanUnsupported(NotImplementedError):
    """The mesh backend cannot execute bag (non-tree) plans.

    Structured for the serving layer: ``invalid_request`` routes it to the
    ``invalid`` failure family (``serve.resilience.classify_failure``), a
    malformed *query* and not a poisoned engine key, so quarantine never
    strikes for it.
    """

    invalid_request = True

    def __init__(self, decomposition_widths):
        self.decomposition_widths = tuple(decomposition_widths)
        super().__init__(
            "backend='mesh' does not execute bag (non-tree) plans yet — "
            f"plan decomposition widths {self.decomposition_widths} include "
            "non-tree bags (width > 1); multi-axis bag states need a 2-D "
            "sharding story. Use a local backend for non-tree templates."
        )


class MeshBackend(EngineBackend):
    """Distributed backend (see module docstring).

    Args (via ``CountingEngine(...)``):
      mesh: a 1-D ``DeviceMesh`` or a ``ProcessGroup`` (required; an
        initialised default group must exist).
      column_batch: passive columns per collective; ``None``: the cost
        model's ``min(128, max passive columns)``.
      ema_mode: ``"streamed"`` (default: fused per-batch SpMM -> eMA) or
        ``"loop"`` (Algorithm 5 with the SpMM product memoised per
        canonical passive form).
      gather_dtype: optional wire dtype of the collectives (e.g.
        ``torch.bfloat16``); accumulation stays fp32.
      balance_degrees: relabel vertices round-robin by degree rank before
        sharding; colorings follow the relabel, so counts are unchanged.
        Default True: the always-on src-bucketed layout pads every bucket to
        the largest one, and an unbalanced hub shard inflates that stride.
      comm: ``"blocking"`` | ``"pipelined"`` | ``None`` (auto).  Explicit
        beats ``REPRO_MESH_COMM`` beats the cost model's per-stage
        decision.  A ``pipelined`` the geometry cannot run (one rank, the
        ``loop`` eMA) falls back to blocking with the reason in
        :meth:`describe_comm`.
    """

    name = "mesh"

    # every chunk launch dispatches collectives; the pipelined path visits
    # the site once per ring step (collective_dispatches)
    fault_sites = ("launch", "collective")

    def __init__(
        self,
        engine,
        mesh,
        *,
        column_batch: Optional[int] = None,
        ema_mode: str = "streamed",
        gather_dtype: Optional[torch.dtype] = None,
        balance_degrees: bool = True,
        comm: Optional[str] = None,
    ):
        super().__init__(engine)
        if engine.plan_ir.has_bag_stages:
            raise BagPlanUnsupported(engine.plan_ir.decomposition_widths)
        if comm not in (None, "blocking", "pipelined"):
            raise ValueError(f"unknown mesh comm mode {comm!r}")
        from repro_torch.core.distributed import (
            make_batched_count_fn,
            resolve_group,
            shard_graph,
        )

        self.group = resolve_group(mesh)
        self.mesh = mesh
        self.ema_mode = ema_mode
        self.gather_dtype = gather_dtype
        n_shards = torch.distributed.get_world_size(self.group)
        # always the src-bucketed layout: blocking and pipelined engines run
        # over the same edge arrays, and either mode can bind per stage
        self.sharded = shard_graph(
            engine.graph, n_shards, balance_degrees=balance_degrees, bucket_by_src=True
        )
        if column_batch is None:
            column_batch = engine.cost.pick_mesh_column_batch()
        self.column_batch = int(column_batch)

        # -- comm resolution: explicit > env > cost model --------------------
        forced, source = comm, "explicit" if comm is not None else None
        if forced is None:
            forced = mesh_comm_mode()
            if forced is not None:
                source = "env"
        if source is None:
            source = "cost-model"
        eligible, why = self._pipeline_eligibility(n_shards)
        self.comm_fallback_reason = None
        if forced == "pipelined" and not eligible:
            self.comm_fallback_reason = why
            forced = "blocking"
        schedules = self._schedules(n_shards, forced)
        if forced is None and not eligible:
            # the auto decision may not pick pipelined for this geometry
            # either: force blocking and record why
            if any(s.mode == "pipelined" for s in schedules.values()):
                self.comm_fallback_reason = why
            schedules = self._schedules(n_shards, "blocking")
        self.comm_source = source
        self.comm_schedules = schedules
        # leader decisions expand to every member stage
        stage_modes = {}
        for leader, sched in schedules.items():
            for member in engine.plan_ir.exec_groups[leader]:
                stage_modes[member] = sched.mode
        self.stage_comm_modes = stage_modes
        any_pipelined = "pipelined" in stage_modes.values()
        self.comm = "pipelined" if any_pipelined else "blocking"
        #: fault-seam dispatch multiplicity: the pipelined path crosses the
        #: ``collective`` injection site once per ring step
        self.collective_dispatches = n_shards if any_pipelined else 1

        self._count_fn = make_batched_count_fn(
            engine.plans,
            self.group,
            self.sharded.n_padded,
            self.sharded.edges_per_shard,
            column_batch=self.column_batch,
            ema_mode=ema_mode,
            gather_dtype=gather_dtype,
            plan_ir=engine.plan_ir,
            store_dtype=engine.policy.store_dtype,
            accum_dtype=engine.policy.accum_dtype,
            comm_mode="blocking",
            comm_schedule=stage_modes,
            bucket_stride=self.sharded.bucket_stride,
            device=engine.device,
            # the eMA's two (rows, block) temporaries stay within the
            # collective scratch the cost model prices for this comm mode
            ema_block=max(1, self.transient_elements() // (2 * self.sharded.rows_per_shard)),
        )
        self._edges = self._count_fn.bind(
            self.sharded.src, self.sharded.dst_local, self.sharded.edge_mask
        )
        # colorings follow the degree-balancing relabel (scatter old -> new;
        # new ids range over [0, n_padded) with pad slots interleaved)
        self._perm = (
            None if self.sharded.perm is None
            else torch.as_tensor(self.sharded.perm, dtype=torch.long, device=engine.device)
        )

    def _schedules(self, n_shards: int, forced: Optional[str]):
        return self.engine.cost.mesh_comm_schedules(
            n_shards,
            column_batch=self.column_batch,
            rows_per_shard=self.sharded.rows_per_shard,
            edges_per_shard=self.sharded.edges_per_shard,
            forced=forced,
        )

    def _pipeline_eligibility(self, n_shards: int):
        """Whether this geometry can run the ring at all: ``(ok, why)``."""
        if self.ema_mode != "streamed":
            return False, (
                f"ema_mode={self.ema_mode!r} — the ring consumes slices "
                "inside the fused streamed sweep only"
            )
        if n_shards < 2:
            return False, "single shard — nothing to overlap"
        return True, None

    def describe_comm(self) -> dict:
        """The resolved comm plan, for ``describe()`` and the inspector."""
        out = {
            "mode": self.comm,
            "source": self.comm_source,
            "collective_dispatches": self.collective_dispatches,
            "bucket_stride": self.sharded.bucket_stride,
            "schedule": [s.describe() for _, s in sorted(self.comm_schedules.items())],
        }
        if self.comm_fallback_reason:
            out["fallback_reason"] = self.comm_fallback_reason
        return out

    def counts_for_colors(self, colors: torch.Tensor) -> torch.Tensor:
        n_padded = self.sharded.n_padded
        if self._perm is not None:
            padded = colors.new_zeros((colors.shape[0], n_padded))
            padded[:, self._perm] = colors
        else:
            padded = torch.nn.functional.pad(colors, (0, n_padded - colors.shape[1]))
        return self._count_fn.run(padded, self._edges)

    # -- memory-model geometry (per shard) ------------------------------------

    def transient_elements(self) -> int:
        """Per-shard collective scratch per coloring.  Blocking: one
        all-gathered column batch (``n_padded * column_batch``) plus the
        shard's edge messages (``edges_per_shard * column_batch``).
        Pipelined: the two ring slots (``2 * rows_per_shard *
        column_batch``) and one source-shard bucket's messages."""
        cost, sh = self.engine.cost, self.sharded
        if self.comm == "pipelined":
            return cost.mesh_transient_elements(
                2 * sh.rows_per_shard, max(1, sh.edges_per_shard // sh.n_shards),
                self.column_batch,
            )
        return cost.mesh_transient_elements(sh.n_padded, sh.edges_per_shard, self.column_batch)

    def resident_elements(self) -> int:
        """Per-shard live DP state: local rows times the liveness-aware peak
        of padded M columns under the shared multi-template schedule."""
        return self.engine.cost.mesh_resident_elements(
            self.sharded.rows_per_shard, self.column_batch, self.ema_mode
        )
