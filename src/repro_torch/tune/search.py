"""The measurement-driven search: prune by prediction, decide by stopwatch.

The port of ``repro.tune.search``.  Protocol:

1. :meth:`repro_torch.plan.cost.CostModel.candidate_lattice` ranks the
   config space (budgets x backends x column batches x chunk sizes +
   greedy mixed configs; ``blocked`` joins on a CUDA card) by calibrated
   predicted cost — the analytic model's job is *pruning*;
2. only the top-N predicted candidates are ever built: each binds a probe
   :class:`~repro_torch.core.engine.CountingEngine` on the tuning device
   and is measured with one warm-up ``count_keys_chunk`` launch followed
   by ``probes`` timed launches, scored by the **median** us per coloring.
   Each probe engine is freed before the next is built (two live probe
   engines at a 48 GiB budget can exhaust the card), and a candidate
   whose kernel fails to build or launch raises — it is never skipped;
3. the winner (min measured; ties break to the better-predicted, then the
   lattice order) is persisted in the port's
   :class:`~repro_torch.tune.cache.TuningCache` under ``(graph signature,
   plan canons, device kind)``, and every *uniform* candidate's
   measured/raw-predicted ratio is folded into the cache's per-backend
   ``calibration`` map.

Uniform probe engines pass their backend **explicitly** — explicit beats
the ``REPRO_ENGINE_BACKEND`` env override, so a set env var cannot poison
the measurements.

With ``mesh=`` every rank of the group runs :func:`tune` with the same
arguments: mesh candidates join the lattice (the comm mode as their axis)
and their probe engines bind the group, each rank measures every probe,
the ranks take the slowest rank's time per candidate (one ``all_reduce``)
so they agree on the winner, and rank 0 alone writes the cache.  ``measure_fn`` is injectable so tests can replay canned
measurements and assert the search is a pure function of them.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .cache import TuningCache, canons_digest, device_kind, entry_key
from .config import TuningConfig

__all__ = ["tune", "TuneResult", "MeasuredCandidate", "measure_engine_us"]

logger = logging.getLogger("repro_torch.tune")

#: Default number of predicted-best candidates that get compiled/measured.
DEFAULT_TOP_N = 5

#: Default timed launches per candidate (after one untimed warmup).
DEFAULT_PROBES = 5


@dataclass(frozen=True)
class MeasuredCandidate:
    """One probed lattice point: the config, both predictions, the clock."""

    config: TuningConfig
    predicted_us: float  # calibrated (what the ranking used)
    raw_us: float  # uncalibrated (what the new ratio is computed against)
    measured_us: float  # median us per coloring over the timed launches


@dataclass(frozen=True)
class TuneResult:
    """Everything one tuning run decided and observed."""

    config: TuningConfig  # the winner
    measured: Tuple[MeasuredCandidate, ...]  # probe order (lattice rank)
    calibration: Dict[str, float]  # per-backend measured/raw ratios, this run
    graph_signature: str
    canons_digest: str
    device: str
    cache_path: Optional[str]  # where the winner was persisted (None: not saved)
    lattice_size: int  # candidates ranked (measured = top-N of these)
    heuristic_backend: str  # what the analytic ladder would have picked
    meta: Dict = field(default_factory=dict)

    @property
    def winner(self) -> MeasuredCandidate:
        for m in self.measured:
            if m.config == self.config:
                return m
        raise LookupError("winner not in measured set")  # pragma: no cover


def measure_engine_us(engine, probes: int) -> float:
    """Median wall-clock microseconds **per coloring** over ``probes``
    chunk launches, after one untimed warm-up launch (kernel loads, operand
    set-up, allocator growth).

    The keys are ``split(prng_key(0), chunk)`` on the engine's device, and
    ``count_keys_chunk`` — the serving increment — returns a host array,
    so each timed call ends on the host: what the tuner times is exactly
    what the service replays.
    """
    from repro_torch.core.prng import prng_key, split

    keys = split(prng_key(0, engine.device), engine.chunk_size)
    engine.count_keys_chunk(keys)  # warm-up
    samples = []
    for _ in range(max(1, int(probes))):
        t0 = time.perf_counter()
        engine.count_keys_chunk(keys)  # returns a host array: synchronous
        samples.append(time.perf_counter() - t0)
    samples.sort()
    median_s = samples[len(samples) // 2]
    return median_s * 1e6 / max(1, engine.chunk_size)


def _geomean(vals: Sequence[float]) -> float:
    import math

    logs = [math.log(v) for v in vals if v > 0]
    return math.exp(sum(logs) / len(logs)) if logs else 1.0


def tune(
    graph,
    templates,
    *,
    top_n: int = DEFAULT_TOP_N,
    probes: int = DEFAULT_PROBES,
    dtype_policy="fp32",
    memory_budget_bytes: Optional[int] = None,
    device=None,
    cache_path: Optional[str] = None,
    save: bool = True,
    measure_fn: Optional[Callable] = None,
    mesh=None,
) -> TuneResult:
    """Tune one ``(graph, template set)`` pair on ``device`` (``None``: the
    CUDA card; ``"cpu"`` only when asked).

    Builds the ranked candidate lattice for the device's platform,
    measures its ``top_n`` entries (``probes`` timed launches each),
    persists the winner + per-backend calibration in the tuning cache
    (unless ``save=False``), and returns the full :class:`TuneResult`.
    The lattice sweeps ``memory_budget_bytes`` and its half; each probe
    engine runs under the budget it was priced at, and the winner carries
    it in its ``key_fragment()``.  With a fixed ``measure_fn`` the same
    inputs give the identical :class:`TuningConfig`.  With ``mesh=`` (a
    1-D ``DeviceMesh`` or ``ProcessGroup``; see the module docstring) mesh
    candidates join the lattice and every rank returns the same winner.
    """
    from repro_torch.core.engine import CountingEngine, DtypePolicy, _dtype_name
    from repro_torch.device import resolve_device
    from repro_torch.exec.select import heuristic_backend
    from repro_torch.plan.cost import (
        DEFAULT_MEMORY_BUDGET_BYTES,
        CostModel,
        load_backend_calibration,
    )
    from repro_torch.plan.ir import build_template_plan

    if measure_fn is None:
        measure_fn = measure_engine_us
    dev = resolve_device(device)
    platform = dev.type
    budget = (
        DEFAULT_MEMORY_BUDGET_BYTES
        if memory_budget_bytes is None
        else int(memory_budget_bytes)
    )
    templates = list(templates)
    plan = build_template_plan(templates)
    policy = DtypePolicy.resolve(dtype_policy)
    cost = CostModel(plan, graph, policy.store_dtype, device=dev)
    calibration = load_backend_calibration(cache_path)
    group = mesh_shards = None
    if mesh is not None:
        from repro_torch.core.distributed import resolve_group

        group = resolve_group(mesh)
        mesh_shards = dist.get_world_size(group)
    lattice = cost.candidate_lattice(
        platform=platform, calibration=calibration, memory_budget_bytes=budget,
        mesh_shards=mesh_shards,
    )
    if not lattice:  # pragma: no cover - lattice always has >= 1 backend
        raise RuntimeError("empty candidate lattice")
    heur_name, _ = heuristic_backend(graph, platform)
    sig = graph.signature()
    probed = lattice[: max(1, int(top_n))]
    logger.info(
        "tuning %d templates on n=%d graph (%s): measuring top %d of %d "
        "candidates (%d probes each)",
        len(templates), graph.n, dev, len(probed), len(lattice), probes,
    )
    measured: List[MeasuredCandidate] = []
    for rank, cand in enumerate(probed):
        cfg = cand.config
        # explicit backend=: stronger than the env override, so a set
        # REPRO_ENGINE_BACKEND cannot poison the probe measurements
        engine = CountingEngine(
            graph,
            templates,
            device=dev,
            backend=cfg.backend_name,
            tuning=cfg if cfg.backend_name == "mixed" else None,
            dtype_policy=policy,
            chunk_size=cfg.chunk_size,
            column_batch=cfg.column_batch,
            memory_budget_bytes=cfg.memory_budget_bytes or budget,
            mesh=mesh if cfg.backend_name == "mesh" else None,
            mesh_comm=cfg.mesh_comm if cfg.backend_name == "mesh" else None,
        )
        us = float(measure_fn(engine, probes))
        # free the probe engine before the next one is built
        del engine
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        measured.append(
            MeasuredCandidate(
                config=cfg, predicted_us=cand.predicted_us, raw_us=cand.raw_us, measured_us=us
            )
        )
        logger.info(
            "  [%d/%d] %-7s cb=%s chunk=%s predicted=%.1fus measured=%.1fus",
            rank + 1, len(probed), cfg.backend_name, cfg.column_batch, cfg.chunk_size,
            cand.predicted_us, us,
        )
    if group is not None:
        # every rank must pick the same winner: the slowest rank's time
        times = torch.tensor([m.measured_us for m in measured], dtype=torch.float64, device=dev)
        dist.all_reduce(times, op=dist.ReduceOp.MAX, group=group)
        measured = [
            MeasuredCandidate(config=m.config, predicted_us=m.predicted_us, raw_us=m.raw_us,
                              measured_us=float(t))
            for m, t in zip(measured, times.tolist())
        ]
        save = save and dist.get_rank(group) == 0
    # winner: min measured; ties break to the prediction, then lattice rank
    win_idx = min(
        range(len(measured)),
        key=lambda i: (measured[i].measured_us, measured[i].predicted_us, i),
    )
    winner = measured[win_idx]
    # per-backend calibration from the UNIFORM candidates (a mixed config's
    # time cannot be attributed to one backend) against raw predictions
    ratios: Dict[str, List[float]] = {}
    for m in measured:
        if not m.config.mixed and m.raw_us > 0:
            ratios.setdefault(m.config.default_backend, []).append(m.measured_us / m.raw_us)
    run_calibration = {name: _geomean(vals) for name, vals in ratios.items()}
    kind = device_kind(dev)
    meta = {
        "measured_us": winner.measured_us,
        "predicted_us": winner.predicted_us,
        "heuristic_backend": heur_name,
        "probes": int(probes),
        "top_n": len(probed),
        "lattice_size": len(lattice),
        "templates": [t.name for t in templates],
        "dtype_policy": _dtype_name(policy.store_dtype),
    }
    path = None
    if save:
        cache = TuningCache.load(cache_path)
        cache.put(sig, plan.canons, winner.config, device=kind, meta=meta)
        cache.merge_calibration(run_calibration)
        path = cache.save()
        logger.info(
            "tuned config persisted: %s -> %s (%s)",
            entry_key(sig, plan.canons, kind), winner.config.describe(), path,
        )
    return TuneResult(
        config=winner.config,
        measured=tuple(measured),
        calibration=run_calibration,
        graph_signature=sig,
        canons_digest=canons_digest(plan.canons),
        device=kind,
        cache_path=path,
        lattice_size=len(lattice),
        heuristic_backend=heur_name,
        meta=meta,
    )
