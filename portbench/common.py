"""What the traffic drivers share: the cell a driver runs, the context a
per-layer metric's reader reads, and small helpers."""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

GIB = 2**30
#: seconds a query may still take after the window before it counts as lost
DRAIN_S = 60.0


@dataclass
class Cell:
    """One run of one cell, as the harness hands it to its traffic's driver
    (``drivers/<kind>.py``, ``run(cell) -> (Context, checks)``).

    ``graph`` is the port's ``Graph``; ``src`` and ``dst`` are the same edges
    on ``device``, which the reference reads.  A driver writes what it
    records into ``out``: ``setup_end`` (the clock, ``time.perf_counter``,
    when the window's first timed call begins), ``attempted``, ``failed``,
    ``metrics_e2e`` (its end-to-end values by name) and
    ``memory_peak_bytes``, besides its own readings.  ``checks`` maps each
    number compared to ``(value, limit)``.
    """

    cfg: Dict
    traffic: Dict
    check: Dict
    graph: object
    src: object
    dst: object
    seed: int
    seconds: float
    trace_on: bool
    device: object
    out: Dict


@dataclass
class Context:
    """What a per-layer metric's reader may read."""

    n: int
    e: int  # directed edges
    templates: list  # portbench.shapes.Shape, the traffic's set
    chunk_size: Optional[int] = None  # colorings each launch carries, padding included
    chunks: int = 0  # launches the window made (estimates)
    trace: object = None  # portbench.trace.TraceSummary
    counters: Dict[str, float] = field(default_factory=dict)


def templates_of(config: Dict, names: List[str]):
    """``(program templates, their frozen shapes, edge lists)`` by name."""
    from repro_torch.core.templates import Template

    from .shapes import shape_of

    edges = [tuple(tuple(e) for e in config["templates"][t]) for t in names]
    return ([Template(t, e) for t, e in zip(names, edges)],
            [shape_of(config, t) for t in names], edges)


def synchronize(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least ``q``
    percent of the values at or below it."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100.0 * len(ordered)) - 1)]


def rel_gap(got: float, want: float) -> float:
    if want == 0.0:
        return 0.0 if got == 0.0 else math.inf
    return abs(got - want) / abs(want)
