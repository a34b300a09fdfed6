"""Elastic scaling: the mesh a shrunken (or grown) set of devices can hold.

The decision logic of restore-based elasticity (checkpoint, shrink,
restore): ``plan_elastic_mesh`` picks the largest valid ``(data, model)``
shape from the surviving device count, and ``survivors_after_failure``
drops the failed devices.  Placing a restored tree on the new mesh needs
the LM's partition specs, which come with the launch tooling (ROADMAP
queue 1 item 14b).
"""

from __future__ import annotations

from typing import Sequence, Tuple

__all__ = ["plan_elastic_mesh", "survivors_after_failure"]


def survivors_after_failure(devices: Sequence, failed_indices: Sequence[int]) -> list:
    failed = set(failed_indices)
    return [d for i, d in enumerate(devices) if i not in failed]


def plan_elastic_mesh(
    n_devices: int,
    axis_names: Tuple[str, ...] = ("data", "model"),
    model_parallel: int = 2,
) -> Tuple[int, ...]:
    """Largest ``(data, model)`` shape with ``model_parallel`` fixed and data
    as large as the surviving devices allow (the remainder is dropped).
    Raises if fewer than one model-parallel group survives."""
    if n_devices < model_parallel:
        raise ValueError(f"{n_devices} devices cannot host model_parallel={model_parallel}")
    return (n_devices // model_parallel, model_parallel)
