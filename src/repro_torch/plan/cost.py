"""The cost model: resource predictions for the single-device targets.

The port of ``repro.plan.cost``.  One :class:`CostModel` per (plan, graph,
dtype) owns:

* the **resident** figure — ``n * TemplatePlan.peak_columns`` live M-matrix
  elements per coloring;
* the **transient** formulas per target — one fused ``column_batch``-wide
  slice of the backend's gather scratch (edge messages, padded rows, SELL
  groups), or one stage's staging width on the ``blocked`` target;
* the **mesh** target, per shard: the all-gather buffer and edge messages
  of one column batch, the padded resident state, and the **comm model**
  (:class:`CommSchedule`, :meth:`CostModel.comm_schedule`): blocking
  all-gather or the pipelined ring, per exec group, from the wire time the
  ring can hide under the stage's per-shard compute;
* **column-batch picking** and **chunk picking** — the largest coloring
  chunk whose live footprint fits the memory budget;
* the serving layer's prices: :func:`admission_estimate` (a query's
  footprint from its plan alone) and :func:`degradation_ladder` (the
  retreat a memory failure walks);
* the tuner's **candidate lattice** (:meth:`CostModel.candidate_lattice`):
  every (budget, backend, column batch, chunk) configuration plus greedy
  per-group mixes, ranked by a per-stage work model scaled by the
  per-backend measured/predicted ratios the tuner itself persists
  (:func:`load_backend_calibration`).

Plans with bag stages (non-tree templates) hold states of ``n**r`` rows
over ``r`` vertex axes, so their resident figure is the plan's
element-level liveness peak and their transient takes the bag ops' scratch
into account (:meth:`CostModel.bag_transient_elements`).

**Fusion slack.**  As in the reference, the byte model is corrected by a
fusion-slack factor: the geometric mean of measured predicted/actual
ratios, ``memory_model`` rows that
:meth:`repro_torch.core.engine.CountingEngine.compiled_memory_analysis`
feeds (effective bytes = analytic bytes / slack).  Two rules are the
port's own, as the tuning cache's are: the rows live in the port's file
(default ``build/memory/BENCH_counting.json``, never the reference's
``BENCH_counting.json``, whose rows are XLA:CPU's), and every row carries
the device kind it was measured on, so a cost model reads only its
engine device's rows.  A CPU engine therefore prices with 1.0, as the
reference does with its slack pinned, and a card's rows never size a query
on another card.  The time calibration is the tuner's: the ratios come
from the port's own tuning cache, filled by stopwatch measurements on the
engine's device.

Two lattice decisions are the port's own.  ``blocked`` is a candidate on
a CUDA card (the reference offers it only on a TPU) and never on the CPU,
where both kernels run their plain versions, a correctness path.  And on
``blocked`` the lattice prices the work the port runs: neither kernel
reads ``column_batch`` and an exec group runs as a per-stage loop, so each
member stage pays its own gather and one launch, and the lattice holds one
``blocked`` candidate per (budget, chunk) with ``column_batch=None``.

The comm model's link rate is the reference's nominal
:data:`MESH_LINK_BYTES_PER_US` (4,000 B/us) and its environment knob
:data:`MESH_LINK_ENV_VAR`; no card's link rate has been measured for it.
Its compute half prices an element at :func:`work_element_us` of the cost
model's device type, as the local pricing does, so on the CPU every mesh
figure equals the reference's.
"""

from __future__ import annotations

import json
import logging
import math
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core.colorsets import binom
from repro_torch.device import as_device_kind

__all__ = [
    "CostModel",
    "AdmissionEstimate",
    "admission_estimate",
    "LadderRung",
    "degradation_ladder",
    "RankedCandidate",
    "CommSchedule",
    "load_backend_calibration",
    "load_fusion_slack",
    "fusion_slack_factor",
    "memory_model_row",
    "pick_chunk_size",
    "DEFAULT_MEMORY_BUDGET_BYTES",
    "MAX_CHUNK_SIZE",
    "LOCAL_COLUMN_BATCH",
    "MESH_COLUMN_BATCH",
    "MESH_LINK_BYTES_PER_US",
    "MESH_LINK_ENV_VAR",
    "RING_STEP_OVERHEAD_US",
    "mesh_link_bytes_per_us",
    "CALIBRATION_CLAMP",
    "SLACK_CLAMP",
    "BENCH_ENV_VAR",
    "WORK_ELEMENT_US",
    "WORK_ELEMENT_US_CUDA",
    "work_element_us",
    "SWEEP_OVERHEAD_US",
    "LAUNCH_OVERHEAD_US",
]

logger = logging.getLogger("repro_torch.plan")

#: Default live-footprint budget for one chunk of colorings (bytes).  Sized
#: for small graphs; on the card pass a budget sized to its memory.
DEFAULT_MEMORY_BUDGET_BYTES = 32 * 1024 * 1024

#: Hard cap on colorings fused into one chunk (diminishing returns beyond).
MAX_CHUNK_SIZE = 64

#: Default passive columns per fused SpMM+eMA slice on the plain local
#: backends.  The reference's value, tuned on XLA:CPU; a starting point to
#: re-measure on the card, not a measurement of it.
LOCAL_COLUMN_BATCH = 16

#: Default passive columns per all-gather collective on the mesh target
#: (the reference's value).
MESH_COLUMN_BATCH = 128

#: Fusion-slack factors outside this band are treated as measurement noise
#: (a wildly off row must not starve or blow the chunk picker).
SLACK_CLAMP = (0.5, 2.0)

#: Environment override for the file the fusion slack is read from
#: (default: ``build/memory/BENCH_counting.json`` under the repository root,
#: a git-ignored directory).
BENCH_ENV_VAR = "REPRO_FUSION_SLACK_BENCH"

#: Per-backend calibration ratios outside this band are treated as noise —
#: the lattice is a *ranker*, a 100x ratio would let one bad probe freeze a
#: backend out of every future candidate set.
CALIBRATION_CLAMP = (0.1, 10.0)

#: Nominal cost of one gathered/FMA'd element in the per-stage work model
#: (microseconds; absolute scale is arbitrary — the lattice only ranks).
#: The reference's value, XLA:CPU's scale; the CPU lattice keeps it.
WORK_ELEMENT_US = 1e-3

#: The same on a CUDA card (``platform="cuda"``).  At XLA:CPU's scale the
#: H100's measured/predicted ratios were 0.024-0.158 (``u5-1`` on rmat2k
#: and rmat8k, PERF.md), mostly under :data:`CALIBRATION_CLAMP`'s floor, so
#: every backend loaded the floor and the card's lattice kept its
#: uncalibrated order.  A 32x cheaper element (about the ratios' geometric
#: mean, ~0.03 ns) moves those ratios inside the clamp; the fixed launch and
#: sweep costs stay.
WORK_ELEMENT_US_CUDA = WORK_ELEMENT_US / 32


def work_element_us(platform: Optional[str] = None) -> float:
    """The work model's cost of one element on ``platform`` (``"cuda"`` or
    anything else, priced as the reference's XLA:CPU scale)."""
    return WORK_ELEMENT_US_CUDA if platform == "cuda" else WORK_ELEMENT_US


#: Fixed cost per fused column-batch sweep call, and per kernel launch on
#: ``blocked`` — what makes narrow column batches predictedly worse.
SWEEP_OVERHEAD_US = 12.0

#: Fixed per-chunk-launch cost, amortized over the chunk's colorings —
#: what makes tiny chunks predictedly worse.
LAUNCH_OVERHEAD_US = 150.0

#: Nominal mesh link bandwidth (bytes per microsecond) for the comm model:
#: the reference's ~4 GB/s single-NIC figure, not a measurement of any
#: card's link.  Calibrate with :data:`MESH_LINK_ENV_VAR`; the scale only
#: moves the blocking/pipelined crossover.
MESH_LINK_BYTES_PER_US = 4000.0

#: Environment override (float, bytes/us) for the link-bandwidth constant.
MESH_LINK_ENV_VAR = "REPRO_MESH_LINK_BYTES_PER_US"

#: Fixed cost per ring step (one send/receive hop and its bookkeeping): the
#: term that keeps narrow stages on the blocking path, where one all-gather
#: beats ``n_shards`` tiny hops.
RING_STEP_OVERHEAD_US = 2.0


def mesh_link_bytes_per_us() -> float:
    """The comm model's link bandwidth, from :data:`MESH_LINK_ENV_VAR` when
    it holds a positive float.  A bad value warns once and falls back to
    the default: cost modelling must not crash on a typo'd variable."""
    raw = os.environ.get(MESH_LINK_ENV_VAR, "").strip()
    if not raw:
        return MESH_LINK_BYTES_PER_US
    try:
        val = float(raw)
        if val > 0:
            return val
    except ValueError:
        pass
    if raw not in _BAD_LINK_VALUES_WARNED:
        _BAD_LINK_VALUES_WARNED.add(raw)
        logger.warning(
            "%s=%r is not a positive float — using the default %.0f bytes/us",
            MESH_LINK_ENV_VAR, raw, MESH_LINK_BYTES_PER_US,
        )
    return MESH_LINK_BYTES_PER_US


_BAD_LINK_VALUES_WARNED: set = set()


#: memoized slack factors: (path, device kind) -> (file fingerprint, factor)
_SLACK_CACHE: Dict[Tuple[str, str], Tuple[Optional[Tuple[int, int]], float]] = {}


def _default_bench_path() -> str:
    env = os.environ.get(BENCH_ENV_VAR, "").strip()
    if env:
        return env
    # src/repro_torch/plan/cost.py -> repository root
    root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    )
    return os.path.join(root, "build", "memory", "BENCH_counting.json")


def memory_model_row(name: str, analysis: Dict, device, applied_fusion_slack: float) -> Dict:
    """One ``memory_model`` row as the reference's ``bench_counting`` writes
    it (``name`` ending in ``/memory_model``, the
    :meth:`~repro_torch.core.engine.CountingEngine.compiled_memory_analysis`
    report of an engine that priced with ``applied_fusion_slack``), tagged
    with the device kind it was measured on."""
    actual, ratio = analysis["actual_temp_bytes"], analysis["ratio"]
    return {
        "name": name,
        "device": as_device_kind(device),
        "us_per_call": 0.0,
        "derived": (
            f"predicted_bytes={analysis['predicted_bytes']:.0f};"
            f"actual_temp_bytes={'%.0f' % actual if actual else 'n/a'};"
            f"predicted_over_actual={'%.3f' % ratio if ratio else 'n/a'};"
            f"applied_fusion_slack={applied_fusion_slack:.4f}"
        ),
    }


def _slack_ratios(bench, kind: str) -> List[float]:
    """The raw analytic-model ratios of ``kind``'s ``memory_model`` rows."""
    ratios = []
    rows = bench.get("rows", []) if isinstance(bench, dict) else []
    for row in rows:
        if not isinstance(row, dict) or "memory_model" not in str(row.get("name", "")):
            continue
        if row.get("device") != kind:
            continue
        fields = {}
        for part in str(row.get("derived", "")).split(";"):
            if "=" in part:
                name, _, val = part.partition("=")
                fields[name] = val
        try:
            # a row written by a calibrated picker folds its slack into the
            # prediction; multiplying it back out keeps the loader on the
            # raw analytic ratio (re-measuring with calibration on does not
            # double-correct)
            ratio = float(fields["predicted_over_actual"])
            ratio *= float(fields.get("applied_fusion_slack", 1.0))
        except (KeyError, ValueError):
            continue
        if ratio > 0:  # rounded zeros would poison the mean
            ratios.append(ratio)
    return ratios


def load_fusion_slack(path: Optional[str] = None, device=None) -> float:
    """Empirical fusion-slack factor from the ``memory_model`` rows of one
    device kind (``device``: a device kind string, or a device;
    ``None``: the CUDA card).

    The factor is the geometric mean of the rows' raw predicted/actual
    ratios, clamped to :data:`SLACK_CLAMP`; ``< 1`` means the analytic
    model under-predicts, so the picker inflates its byte estimates by
    ``1 / slack``.  **Safe default**: 1.0 whenever the file or this
    device's rows are missing or unparsable.  Rows without a device kind,
    as the reference's are, never apply.  Memoized by (path, device kind)
    and the file's modification time and size; applied calibration is
    logged on the ``repro_torch.plan`` logger."""
    resolved = path if path is not None else _default_bench_path()
    kind = as_device_kind(device)
    try:
        st = os.stat(resolved)
        fingerprint: Optional[Tuple[int, int]] = (st.st_mtime_ns, st.st_size)
    except OSError:
        fingerprint = None
    hit = _SLACK_CACHE.get((resolved, kind))
    if hit is not None and hit[0] == fingerprint:
        return hit[1]
    slack, ratios = 1.0, []
    try:
        with open(resolved) as fh:
            ratios = _slack_ratios(json.load(fh), kind)
    except (OSError, ValueError) as exc:
        logger.debug("fusion-slack rows unavailable (%s); defaulting to 1.0", exc)
    if ratios:
        mean_log = sum(math.log(r) for r in ratios) / len(ratios)
        slack = min(max(math.exp(mean_log), SLACK_CLAMP[0]), SLACK_CLAMP[1])
        logger.info(
            "fusion-slack calibration applied: factor=%.4f from %d memory_model rows "
            "of %s (%s)", slack, len(ratios), kind, resolved,
        )
    _SLACK_CACHE[(resolved, kind)] = (fingerprint, slack)
    return slack


def fusion_slack_factor(device=None) -> float:
    """The default file's slack for ``device``'s kind (what engines
    constructed without an explicit ``fusion_slack`` use)."""
    return load_fusion_slack(None, device)


def load_backend_calibration(path: Optional[str] = None) -> Dict[str, float]:
    """Per-backend measured/predicted cost ratios from the port's tuning
    cache (:func:`repro_torch.tune.cache.load_calibration`), clamped to
    :data:`CALIBRATION_CLAMP`.

    Every tuning run records, for each uniform candidate it measured, the
    ratio of measured us-per-coloring to the lattice's raw (uncalibrated)
    prediction; :meth:`CostModel.candidate_lattice` multiplies each
    backend's predicted cost by its ratio.  A missing or corrupt cache
    yields ``{}`` (the uncalibrated analytic ranking)."""
    # local import: repro_torch.tune.cache is a leaf over tune.config only
    from repro_torch.tune.cache import load_calibration

    return {
        name: min(max(float(ratio), CALIBRATION_CLAMP[0]), CALIBRATION_CLAMP[1])
        for name, ratio in load_calibration(path).items()
    }


def _dense_work_advantage() -> int:
    # exec.select owns the constant (it imports nothing from plan)
    from repro_torch.exec.select import DENSE_WORK_ADVANTAGE

    return DENSE_WORK_ADVANTAGE


@dataclass(frozen=True)
class RankedCandidate:
    """One point of the tuner's candidate lattice.

    ``predicted_us`` is the calibrated per-coloring cost estimate used for
    ranking; ``raw_us`` is the same figure *without* per-backend
    calibration (what measured ratios are computed against, so calibration
    reaches a fixed point instead of compounding run over run).
    """

    config: object  # TuningConfig (typed loosely: repro_torch.tune is downstream)
    predicted_us: float
    raw_us: float


def pick_chunk_size(
    bytes_per_coloring: int,
    memory_budget_bytes: int,
    max_chunk: int = MAX_CHUNK_SIZE,
) -> int:
    """Largest chunk whose live footprint stays under the budget (>= 1)."""
    if bytes_per_coloring <= 0:
        return max_chunk
    return max(1, min(max_chunk, int(memory_budget_bytes // bytes_per_coloring)))


@dataclass(frozen=True)
class AdmissionEstimate:
    """Predicted footprint of one query, for serving-layer load shedding.

    Computed from the plan alone (no engine, no device operands), so a
    query is priced at submit time.  ``resident_bytes`` is the per-coloring
    live DP state; ``chunk_bytes`` is what one launch of the engine that
    would serve the query keeps live (``chunk_size * resident_bytes``).
    The backend's gather transient is left out: it is only known once an
    engine binds.
    """

    resident_elements: int
    resident_bytes: int  # per coloring
    chunk_size: int
    chunk_bytes: int  # resident_bytes * chunk_size
    peak_columns: int


def admission_estimate(
    graph,
    templates,
    *,
    store_dtype: torch.dtype = torch.float32,
    chunk_size: Optional[int] = None,
    memory_budget_bytes: int = DEFAULT_MEMORY_BUDGET_BYTES,
    device=None,
) -> AdmissionEstimate:
    """Price a ``(graph, templates)`` query without building an engine: the
    :class:`CostModel` resident formula, calibrated for ``device`` as the
    engine that would serve the query is, with the chunk picked against
    ``memory_budget_bytes`` as an engine construction would (unless
    ``chunk_size`` is given)."""
    from .ir import build_template_plan  # local: keeps import cycles out

    plan = build_template_plan(list(templates))
    cm = CostModel(plan, graph, store_dtype, device=device)
    resident = cm.resident_elements()
    per_coloring = cm.bytes_per_coloring(0, resident)
    chunk = int(chunk_size) if chunk_size else cm.pick_chunk_size(per_coloring, memory_budget_bytes)
    return AdmissionEstimate(
        resident_elements=resident,
        resident_bytes=per_coloring,
        chunk_size=chunk,
        chunk_bytes=per_coloring * chunk,
        peak_columns=plan.peak_columns,
    )


@dataclass(frozen=True)
class CommSchedule:
    """One exec group's plan-time communication decision on the mesh target.

    ``mode`` is ``"blocking"`` (one all-gather per column batch) or
    ``"pipelined"`` (the double-buffered ring: ``ring_steps == n_shards``
    send/receive hops per batch, the next row slice in flight while the
    current one's edge messages are reduced).  ``wire_bytes`` is the
    per-shard, per-coloring bytes on the wire for the whole stage;
    ``comm_us`` / ``compute_us`` are its modelled transfer and per-shard
    SpMM+eMA times; ``overlap_efficiency`` is the fraction of the wire time
    the ring hides under compute (``min(1, compute_step / comm_step)``).
    ``reason`` records why the mode was picked (or forced).
    """

    stage: Tuple[int, int]  # exec-group leader (plan_idx, sub_idx)
    mode: str
    ring_steps: int  # 1 for blocking, n_shards for pipelined
    slice_rows: int  # rows_per_shard: the circulated slice height
    slice_cols: int  # column_batch: the circulated slice width
    wire_bytes: int
    comm_us: float
    compute_us: float
    overlap_efficiency: float
    reason: str

    def describe(self) -> Dict:
        return {
            "stage": list(self.stage),
            "mode": self.mode,
            "ring_steps": self.ring_steps,
            "slice_rows": self.slice_rows,
            "slice_cols": self.slice_cols,
            "wire_bytes": self.wire_bytes,
            "comm_us": round(self.comm_us, 3),
            "compute_us": round(self.compute_us, 3),
            "overlap_efficiency": round(self.overlap_efficiency, 4),
            "reason": self.reason,
        }


@dataclass(frozen=True)
class LadderRung:
    """One step of the memory degradation ladder (:func:`degradation_ladder`)."""

    chunk_size: int
    column_batch: Optional[int]  # None = keep the engine's pick
    action: str  # "halve_chunk" | "shrink_columns"


def degradation_ladder(
    chunk_size: int, column_batch: Optional[int], backend: str
) -> List[LadderRung]:
    """The ordered retreat a memory failure walks before a query fails,
    cheapest first: halve ``chunk_size`` down to 1 (estimates do not depend
    on the chunk size); then, where the backend's passive sweep is cut into
    ``column_batch`` slices (every backend but ``blocked``, whose kernels
    read no column batch), halve ``column_batch`` down to 1 at chunk 1.
    Returns the rungs below the given configuration; none left means the
    query cannot fit.

    Unlike the reference, no rung falls back to the ``edges`` backend: on
    the card that would send the query around the kernels to the plain
    PyTorch path."""
    rungs = []
    chunk = int(chunk_size)
    while chunk > 1:
        chunk //= 2
        rungs.append(LadderRung(chunk_size=chunk, column_batch=None, action="halve_chunk"))
    if backend != "blocked":
        cb = int(column_batch) if column_batch else LOCAL_COLUMN_BATCH
        while cb > 1:
            cb //= 2
            rungs.append(LadderRung(chunk_size=1, column_batch=cb, action="shrink_columns"))
    return rungs


class CostModel:
    """Resource predictions for one ``TemplatePlan`` on one graph.

    All element counts are *store-dtype elements per coloring*; byte
    figures multiply by the store itemsize and divide by the fusion-slack
    factor.  ``fusion_slack=None`` reads the factor of ``device``'s kind
    (:func:`fusion_slack_factor`); a model bound to no device
    (``device=None``, as a plan-only caller's is) prices with 1.0.  A factor
    outside :data:`SLACK_CLAMP` is rejected, not clamped.  ``device``'s type
    (``platform``) also sets the comm model's per-element compute cost.
    """

    def __init__(
        self,
        plan,
        graph,
        store_dtype: torch.dtype = torch.float32,
        *,
        fusion_slack: Optional[float] = None,
        device=None,
    ):
        self.plan = plan
        self.graph = graph
        self.itemsize = store_dtype.itemsize
        self.platform = None if device is None else torch.device(device).type
        if fusion_slack is None:
            fusion_slack = 1.0 if device is None else fusion_slack_factor(device)
        self.fusion_slack = float(fusion_slack)
        if not SLACK_CLAMP[0] <= self.fusion_slack <= SLACK_CLAMP[1]:
            raise ValueError(f"fusion_slack {self.fusion_slack} outside sane band {SLACK_CLAMP}")

    def pick_local_column_batch(self) -> int:
        """Fused-slice width for the single-device backends."""
        return min(LOCAL_COLUMN_BATCH, self.plan.max_passive_columns)

    def pick_mesh_column_batch(self) -> int:
        """Columns per all-gather collective on the mesh target."""
        return min(MESH_COLUMN_BATCH, max(self.plan.max_passive_columns, self.plan.k))

    def resident_elements(self) -> int:
        """Live DP-state elements one coloring keeps resident: ``n`` rows
        times the plan's liveness-aware peak columns, or, with bag stages,
        the plan's element-level liveness peak (a bag state over ``r`` axes
        holds ``n**r * C(k, m)`` elements)."""
        if self.plan.has_bag_stages:
            return self.plan.peak_elements(self.graph.n)
        return self.graph.n * self.plan.peak_columns

    def transient_elements(
        self,
        target: str,
        column_batch: int,
        *,
        sell_padded_slots: Optional[int] = None,
    ) -> int:
        """Widest per-stage scratch one coloring needs on ``target``: the
        backend's gather intermediate plus the aggregated
        ``(n, column_batch)`` slice — never the full passive width.  With
        bag stages, the larger of that and the bag ops' scratch."""
        g = self.graph
        if target in ("edges", "custom"):
            out = (g.num_directed + g.n) * column_batch
        elif target == "ell":
            out = (g.n * max(g.max_degree(), 1) + g.n) * column_batch
        elif target == "sell":
            if sell_padded_slots is None:
                raise ValueError("sell transient needs the built SELL geometry")
            out = (sell_padded_slots + g.n) * column_batch
        elif target == "dense":
            out = g.n * column_batch
        elif target == "blocked":
            # one stage's operands + output; the fused kernel keeps the
            # aggregate in shared memory, so no (n, C_p) intermediate exists
            out = g.n * self.plan.max_stage_columns
        else:
            raise ValueError(f"unknown cost target {target!r}")
        if self.plan.has_bag_stages:
            out = max(out, self.bag_transient_elements(target, sell_padded_slots=sell_padded_slots))
        return out

    def bag_transient_elements(
        self, target: str, *, sell_padded_slots: Optional[int] = None
    ) -> int:
        """Widest bag-op scratch one coloring needs on ``target``: the
        extend's neighbor sum runs the backend's gather over the flattened
        width ``n**(r_in - 1) * C(k, m_in)`` (not column-batched), and an
        extend's or join's term loop holds two gathered operands and the
        accumulator, three states of ``n**r_out * C(k, m_out)`` elements."""
        g = self.graph
        if target in ("edges", "custom"):
            per_col = g.num_directed + g.n
        elif target == "ell":
            per_col = g.n * max(g.max_degree(), 1) + g.n
        elif target == "sell":
            if sell_padded_slots is None:
                raise ValueError("sell transient needs the built SELL geometry")
            per_col = sell_padded_slots + g.n
        elif target in ("dense", "blocked"):
            per_col = g.n
        else:
            raise ValueError(f"unknown cost target {target!r}")
        worst = 0
        for cplan in self.plan.counting_plans:
            if cplan.partition is not None:
                continue
            ops = cplan.bag_program.ops
            for op in ops:
                if op.kind == "leaf":
                    continue
                if op.kind == "extend" and op.spmm_vertex is not None:
                    src = ops[op.inputs[0]]
                    flat = g.n ** (len(src.axes) - 1) * binom(cplan.k, src.m)
                    worst = max(worst, per_col * flat)
                r_out = len(op.axes) + len(op.forget_vertices)
                worst = max(worst, 3 * g.n**r_out * binom(cplan.k, op.m))
        return worst

    # -- mesh target (per shard) -----------------------------------------------

    def mesh_transient_elements(
        self, n_padded: int, edges_per_shard: int, column_batch: int
    ) -> int:
        """Per-shard collective scratch: one all-gathered column batch plus
        the per-shard edge message gather."""
        return (n_padded + edges_per_shard) * column_batch

    def mesh_resident_elements(
        self, rows_per_shard: int, column_batch: int, ema_mode: str = "streamed"
    ) -> int:
        """Per-shard live DP state: local rows times the liveness-aware peak
        of padded M columns (memoised SpMM products count too outside the
        streamed eMA mode)."""
        peak = self.plan.padded_peak_columns(
            pad_unit=column_batch, track_products=(ema_mode != "streamed")
        )
        return rows_per_shard * peak

    def comm_schedule(
        self,
        leader,
        n_shards: int,
        *,
        column_batch: int,
        rows_per_shard: Optional[int] = None,
        edges_per_shard: Optional[int] = None,
        link_bytes_per_us: Optional[float] = None,
        forced: Optional[str] = None,
    ) -> CommSchedule:
        """Blocking vs pipelined for one exec group's mesh SpMM sweeps.

        Per stage, per shard, per coloring the collective moves
        ``(n_shards - 1) * rows * C_p_padded`` store elements whichever the
        mode; the ring buys back the part of that transfer it can hide under
        the stage's per-shard compute (edge-bucket gather + eMA, priced at
        :func:`work_element_us` of :attr:`platform`).  Pipeline iff the
        predicted hidden time exceeds the ring's own overhead
        (``n_batches * n_shards * RING_STEP_OVERHEAD_US``).  ``forced``
        (``"blocking"`` | ``"pipelined"``) records an env or caller override
        verbatim; the model still fills in the other fields."""
        p_idx, i = leader
        cplan = self.plan.counting_plans[p_idx]
        sub = cplan.partition.subs[i]
        passive_cols = binom(cplan.k, cplan.partition.subs[sub.passive].size)
        cb = max(1, int(column_batch))
        n_batches = max(1, math.ceil(passive_cols / cb))
        padded_cols = n_batches * cb
        rows = (
            int(rows_per_shard)
            if rows_per_shard
            else max(1, -(-self.graph.n // max(1, n_shards)))
        )
        edges = (
            int(edges_per_shard)
            if edges_per_shard
            else max(1, -(-self.graph.num_directed // max(1, n_shards)))
        )
        link = link_bytes_per_us or mesh_link_bytes_per_us()
        wire_bytes = (n_shards - 1) * rows * padded_cols * self.itemsize
        comm_us = wire_bytes / link
        # per-shard compute: the edge-bucket gather over the stage's padded
        # passive width plus this shard's share of the group's eMA work
        gather = edges * padded_cols
        ema = 0
        for q, j in self.plan.exec_groups[leader]:
            mplan = self.plan.counting_plans[q]
            msub = mplan.partition.subs[j]
            ema += rows * binom(mplan.k, msub.size) * binom(
                msub.size, mplan.partition.subs[msub.active].size
            )
        compute_us = (gather + ema) * work_element_us(self.platform)
        if n_shards >= 2:
            comm_step = comm_us / (n_shards - 1)
            compute_step = compute_us / n_shards
            overlap = min(1.0, compute_step / comm_step) if comm_step > 0 else 1.0
        else:
            overlap = 0.0
        hidden_us = overlap * comm_us
        ring_cost_us = n_batches * n_shards * RING_STEP_OVERHEAD_US
        if forced in ("blocking", "pipelined"):
            mode = forced
            reason = f"forced {forced} (env/caller override)"
        elif n_shards < 2:
            mode = "blocking"
            reason = "single shard — nothing to overlap"
        elif hidden_us > ring_cost_us:
            mode = "pipelined"
            reason = f"hidden {hidden_us:.1f}us > ring overhead {ring_cost_us:.1f}us"
        else:
            mode = "blocking"
            reason = f"hidden {hidden_us:.1f}us <= ring overhead {ring_cost_us:.1f}us"
        return CommSchedule(
            stage=(p_idx, i),
            mode=mode,
            ring_steps=n_shards if mode == "pipelined" else 1,
            slice_rows=rows,
            slice_cols=cb,
            wire_bytes=int(wire_bytes),
            comm_us=comm_us,
            compute_us=compute_us,
            overlap_efficiency=overlap,
            reason=reason,
        )

    def mesh_comm_schedules(
        self,
        n_shards: int,
        *,
        column_batch: int,
        rows_per_shard: Optional[int] = None,
        edges_per_shard: Optional[int] = None,
        link_bytes_per_us: Optional[float] = None,
        forced: Optional[str] = None,
    ) -> Dict[Tuple[int, int], CommSchedule]:
        """The per-stage comm plan: one :class:`CommSchedule` per tree
        exec-group leader (the unit one passive sweep serves)."""
        return {
            leader: self.comm_schedule(
                leader,
                n_shards,
                column_batch=column_batch,
                rows_per_shard=rows_per_shard,
                edges_per_shard=edges_per_shard,
                link_bytes_per_us=link_bytes_per_us,
                forced=forced,
            )
            for leader in self.tree_group_leaders()
        }

    def bytes_per_coloring(self, transient_elements: int, resident_elements: int) -> int:
        """Live bytes one coloring contributes to a chunk."""
        raw = (transient_elements + resident_elements) * self.itemsize
        return int(math.ceil(raw / self.fusion_slack))

    def pick_chunk_size(
        self,
        bytes_per_coloring: int,
        memory_budget_bytes: int = DEFAULT_MEMORY_BUDGET_BYTES,
        max_chunk: int = MAX_CHUNK_SIZE,
    ) -> int:
        return pick_chunk_size(bytes_per_coloring, memory_budget_bytes, max_chunk)

    def describe(self) -> Dict:
        out = {
            "fusion_slack": self.fusion_slack,
            "itemsize": self.itemsize,
            "peak_columns": self.plan.peak_columns,
            "resident_elements": self.resident_elements(),
        }
        if self.plan.has_bag_stages:
            out["peak_elements"] = self.plan.peak_elements(self.graph.n)
            out["max_bag_axes"] = self.plan.max_bag_axes
        return out

    # -- tuning candidate lattice --------------------------------------------

    def feasible_backends(self, platform: Optional[str] = None) -> List[str]:
        """Local backends worth *probing* for this (graph, plan): the
        reference's set (no ELL whose hub-row padding blows up, no dense
        adjacency past 8192 vertices), with ``blocked`` on a CUDA card.  On
        the CPU the kernels' plain versions are a correctness path, not a
        candidate, as the reference's interpret mode is."""
        g = self.graph
        edges = max(g.num_directed, 1)
        out = ["edges"]
        if g.n * max(g.max_degree(), 1) <= 8 * edges:
            out.append("ell")
        out.append("sell")
        if g.n <= 8192:  # n^2 adjacency: 256 MB fp32 at 8k vertices
            out.append("dense")
        if platform == "cuda":
            out.append("blocked")
        return out

    def sell_padded_slots(self) -> int:
        """Host-built SELL geometry (memoized — the lattice prices the
        ``sell`` target per exec group, the probe engines rebuild it)."""
        cached = getattr(self, "_sell_padded_slots", None)
        if cached is None:
            from repro_torch.core.graph import build_sell  # local: cycle-free

            cached = build_sell(self.graph).padded_slots
            self._sell_padded_slots = cached
        return cached

    def spmm_work_elements(self, target: str) -> int:
        """Gathered/reduced elements per passive DP column on ``target``
        (the backend-dependent half of a stage's work)."""
        g = self.graph
        edges = max(g.num_directed, 1)
        if target in ("edges", "custom", "blocked"):
            return edges
        if target == "ell":
            return g.n * max(g.max_degree(), 1)
        if target == "sell":
            return self.sell_padded_slots()
        if target == "dense":
            # n^2 MACs at matmul throughput ~= n^2 / advantage gather-grade
            # element visits (the constant select_backend compares with)
            return max(1, g.n**2 // _dense_work_advantage())
        raise ValueError(f"unknown work target {target!r}")

    def group_cost_us(
        self, leader, backend: str, column_batch: Optional[int], platform: Optional[str] = None
    ) -> float:
        """Raw (uncalibrated) predicted us for one exec group on
        ``platform`` (:func:`work_element_us`).

        On the streamed backends one group is one passive column-batch
        sweep shared by every member stage: the backend's gather over
        ``C(k, m_p)`` passive columns, each member's eMA contraction
        (``n * n_out * n_splits`` FMAs) and a fixed cost per fused slice.
        On ``blocked`` each member stage is its own kernel launch, which
        gathers the passive state again and reads no ``column_batch``."""
        p_idx, i = leader
        cplan = self.plan.counting_plans[p_idx]
        sub = cplan.partition.subs[i]
        passive_cols = binom(cplan.k, cplan.partition.subs[sub.passive].size)
        gather = self.spmm_work_elements(backend) * passive_cols
        members = self.plan.exec_groups[leader]
        ema = 0
        for q, j in members:
            mplan = self.plan.counting_plans[q]
            msub = mplan.partition.subs[j]
            m = msub.size
            m_a = mplan.partition.subs[msub.active].size
            ema += self.graph.n * binom(mplan.k, m) * binom(m, m_a)
        unit = work_element_us(platform)
        if backend == "blocked":
            return (len(members) * gather + ema) * unit + len(members) * SWEEP_OVERHEAD_US
        cb = max(1, min(int(column_batch), passive_cols))
        sweeps = math.ceil(passive_cols / cb)
        return (gather + ema) * unit + sweeps * SWEEP_OVERHEAD_US

    def tree_group_leaders(self) -> list:
        """Exec-group leaders of *tree* stages — the addresses a mixed
        config can bind (bag programs run through the uniform default)."""
        return [
            leader
            for leader in sorted(self.plan.exec_groups)
            if self.plan.counting_plans[leader[0]].partition is not None
        ]

    def predict_config_us(
        self,
        config,
        *,
        chunk_size: int,
        calibration: Optional[Dict[str, float]] = None,
        platform: Optional[str] = None,
        mesh_shards: Optional[int] = None,
    ) -> Tuple[float, float]:
        """``(calibrated_us, raw_us)`` per coloring for one
        :class:`~repro_torch.tune.config.TuningConfig`.

        Calibration multiplies each group's cost by its backend's
        measured/predicted ratio; ``raw_us`` skips that (it is what new
        measurements are ratioed against).  Bag ops enter only through the
        launch term: the lattice ranks on the tree groups it can rebind.
        ``default_backend == "mesh"`` configs route through the comm model
        (:meth:`predict_mesh_config_us`; ``mesh_shards`` is the ring size)."""
        calibration = calibration or {}
        if config.default_backend == "mesh":
            return self.predict_mesh_config_us(
                config, chunk_size=chunk_size, n_shards=mesh_shards or 1,
                calibration=calibration,
            )
        bindings = config.bindings()
        cb = config.column_batch or self.pick_local_column_batch()
        raw = calibrated = LAUNCH_OVERHEAD_US / max(1, int(chunk_size))
        for leader in self.tree_group_leaders():
            backend = bindings.get(leader, config.default_backend)
            cost = self.group_cost_us(leader, backend, cb, platform)
            raw += cost
            calibrated += cost * calibration.get(backend, 1.0)
        return calibrated, raw

    def predict_mesh_config_us(
        self,
        config,
        *,
        chunk_size: int,
        n_shards: int,
        calibration: Optional[Dict[str, float]] = None,
    ) -> Tuple[float, float]:
        """``(calibrated_us, raw_us)`` per coloring for a mesh config: per
        stage, the per-shard compute plus the wire time the config's comm
        mode leaves visible, plus the per-sweep and (pipelined) per-ring-step
        overheads — the figures :meth:`comm_schedule` compares, summed."""
        calibration = calibration or {}
        cb = config.column_batch or self.pick_mesh_column_batch()
        raw = LAUNCH_OVERHEAD_US / max(1, int(chunk_size))
        for leader in self.tree_group_leaders():
            sched = self.comm_schedule(
                leader, n_shards, column_batch=cb, forced=config.mesh_comm
            )
            per_slice = max(0, n_shards - 1) * sched.slice_rows * sched.slice_cols * self.itemsize
            n_batches = max(1, round(sched.wire_bytes / per_slice)) if per_slice else 1
            pipelined = sched.ring_steps > 1
            visible_comm = (
                sched.comm_us * (1.0 - sched.overlap_efficiency) if pipelined else sched.comm_us
            )
            step_overhead = (
                n_batches * sched.ring_steps * RING_STEP_OVERHEAD_US if pipelined else 0.0
            )
            raw += sched.compute_us + visible_comm + n_batches * SWEEP_OVERHEAD_US + step_overhead
        return raw * calibration.get("mesh", 1.0), raw

    def candidate_lattice(
        self,
        *,
        platform: Optional[str] = None,
        calibration: Optional[Dict[str, float]] = None,
        memory_budget_bytes: int = DEFAULT_MEMORY_BUDGET_BYTES,
        chunk_size: Optional[int] = None,
        include_mixed: bool = True,
        mesh_shards: Optional[int] = None,
    ) -> List[RankedCandidate]:
        """Ranked tuning candidates, cheapest-predicted first.

        The reference's cross product of memory budgets (the given one and
        its half, floored at 1 MiB) x feasible backends x column batches
        (4, the picked width, 64, capped at the widest passive) x chunk
        sizes (each backend's own pick under the budget, and its half),
        plus (``include_mixed``) one greedy mixed candidate per (budget,
        column batch) binding each tree exec group to its cheapest backend.
        ``blocked`` candidates carry ``column_batch=None``, one per (budget,
        chunk).  With ``mesh_shards`` (the tuner ran with a ``mesh=``), mesh
        candidates join per budget with the comm mode (``blocking`` |
        ``pipelined``) as their axis, priced by the comm model, at the mesh
        column batch and the chunk the resident footprint picks.  Two
        budgets that land on the same runtime configuration keep only the
        better-ranked."""
        from repro_torch.tune.config import TuningConfig  # local: cycle-free

        if calibration is None:
            calibration = load_backend_calibration()
        backends = self.feasible_backends(platform)
        resident = self.resident_elements()
        picked_cb = self.pick_local_column_batch()
        max_cb = max(1, self.plan.max_passive_columns)
        col_batches = sorted({min(4, max_cb), min(picked_cb, max_cb), min(64, max_cb)})
        budget = int(memory_budget_bytes)
        budgets = sorted({budget, max(budget // 2, 1 << 20)})
        leaders = self.tree_group_leaders()
        candidates = []
        seen = set()

        def _add(config):
            if config.key_fragment() in seen:
                return
            seen.add(config.key_fragment())
            calibrated, raw = self.predict_config_us(
                config, chunk_size=config.chunk_size, calibration=calibration,
                platform=platform, mesh_shards=mesh_shards,
            )
            candidates.append(RankedCandidate(config=config, predicted_us=calibrated, raw_us=raw))

        for bud in budgets:
            for cb in col_batches:
                # per-backend chunk sets: each backend is probed at the
                # chunk its own byte model picks under this budget, and its
                # half
                chunks_by_backend = {}
                for b in backends:
                    if chunk_size:
                        chunks_by_backend[b] = {int(chunk_size)}
                        continue
                    per = self.bytes_per_coloring(
                        self.transient_elements(
                            b, cb,
                            sell_padded_slots=self.sell_padded_slots() if b == "sell" else None,
                        ),
                        resident,
                    )
                    picked = self.pick_chunk_size(per, bud)
                    chunks_by_backend[b] = {picked, max(1, picked // 2)}
                for b in backends:
                    for chunk in sorted(chunks_by_backend[b]):
                        _add(TuningConfig(
                            default_backend=b,
                            column_batch=None if b == "blocked" else cb,
                            chunk_size=chunk,
                            memory_budget_bytes=bud,
                        ))
                if include_mixed and len(backends) > 1 and leaders:
                    greedy = tuple(
                        (
                            leader,
                            min(
                                backends,
                                key=lambda b: self.group_cost_us(leader, b, cb, platform)
                                * calibration.get(b, 1.0),
                            ),
                        )
                        for leader in leaders
                    )
                    names = {b for _, b in greedy}
                    if len(names) > 1:
                        # the default serves bag ops and plain spmm: the
                        # cheapest gather-per-column backend among the bound
                        # (ties broken by the feasible order, not set order)
                        default = min(
                            names, key=lambda b: (self.spmm_work_elements(b), backends.index(b))
                        )
                        for chunk in sorted(chunks_by_backend[default]):
                            _add(TuningConfig(
                                default_backend=default,
                                group_backends=greedy,
                                column_batch=cb,
                                chunk_size=chunk,
                                memory_budget_bytes=bud,
                            ))
            if mesh_shards:
                # the comm mode is the swept axis; the chunk comes from the
                # resident footprint (the dominant per-shard term)
                per = self.bytes_per_coloring(0, resident)
                picked = int(chunk_size) if chunk_size else self.pick_chunk_size(per, bud)
                for comm in ("blocking", "pipelined"):
                    _add(TuningConfig(
                        default_backend="mesh",
                        column_batch=self.pick_mesh_column_batch(),
                        chunk_size=picked,
                        memory_budget_bytes=bud,
                        mesh_comm=comm,
                    ))
        candidates.sort(key=lambda c: (c.predicted_us, repr(c.config.key_fragment())))
        unique, seen_runtime = [], set()
        for cand in candidates:
            cfg = cand.config
            runtime = (cfg.default_backend, cfg.group_backends, cfg.column_batch,
                       cfg.chunk_size, cfg.mesh_comm)
            if runtime in seen_runtime:
                continue
            seen_runtime.add(runtime)
            unique.append(cand)
        return unique
