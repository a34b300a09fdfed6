"""Backend auto-selection: graph statistics -> execution strategy name.

The port of ``repro.exec.select``.  The resolution ladder is explicit
``backend=`` > ``REPRO_ENGINE_BACKEND`` > the analytic heuristic.  The
reference's tuned-config rung waits for the tuning slice (ROADMAP queue 1
item 9), and its ``tpu`` rung becomes a ``cuda`` rung: on a card, graphs of
at least :data:`BLOCKED_MIN_VERTICES` vertices run the CUDA kernels of the
``blocked`` backend.  The other thresholds are the reference's, measured on
XLA:CPU; they are starting values, not measurements of the port.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Tuple

__all__ = [
    "select_backend",
    "heuristic_backend",
    "resolve_backend_config",
    "ENGINE_BACKENDS",
    "BACKEND_ENV_VAR",
    "DENSE_MAX_VERTICES",
    "ELL_PAD_FACTOR",
    "BLOCKED_MIN_VERTICES",
    "SELL_MIN_SCATTER_WORK",
    "DENSE_WORK_ADVANTAGE",
]

logger = logging.getLogger("repro_torch.engine")

#: Graphs at or below this vertex count use the dense-adjacency backend.
DENSE_MAX_VERTICES = 256

#: ELL is chosen only when ``n * max_deg <= ELL_PAD_FACTOR * |E|``.
ELL_PAD_FACTOR = 1.5

#: On a CUDA device, graphs at least this large route to ``blocked``.
BLOCKED_MIN_VERTICES = 4096

#: Environment variable overriding the auto-selected local backend.
BACKEND_ENV_VAR = "REPRO_ENGINE_BACKEND"

#: Above this ``n * |E_directed|`` product skewed graphs route to SELL.
SELL_MIN_SCATTER_WORK = 5 * 10**8

#: Dense adjacency wins when ``DENSE_WORK_ADVANTAGE * |E| >= n^2``.
DENSE_WORK_ADVANTAGE = 16

ENGINE_BACKENDS = (
    "edges", "ell", "sell", "dense", "blocked", "mixed", "mesh", "custom"
)

_LOCAL_BACKENDS = ("edges", "ell", "sell", "dense", "blocked")


def _env_backend() -> Optional[str]:
    """The validated ``REPRO_ENGINE_BACKEND`` override, or ``None``."""
    env = os.environ.get(BACKEND_ENV_VAR, "").strip()
    if not env:
        return None
    if env not in _LOCAL_BACKENDS:
        raise ValueError(
            f"{BACKEND_ENV_VAR}={env!r} is not a local backend "
            "(edges | ell | sell | dense | blocked)"
        )
    return env


def select_backend(graph, platform: str = "cuda", explain: bool = False):
    """Pick the local backend from graph statistics (env override first).

    ``platform`` is the device type the engine runs on (``"cuda"`` or
    ``"cpu"``).  ``explain=True`` returns ``(name, reason)``.
    """
    env = _env_backend()
    if env is not None:
        name, reason = env, f"{BACKEND_ENV_VAR} env override"
    else:
        name, reason = heuristic_backend(graph, platform)
    logger.debug(
        "select_backend: %s for n=%d edges=%d (%s)",
        name, graph.n, graph.num_directed, reason,
    )
    return (name, reason) if explain else name


def resolve_backend_config(graph, *, backend: str = "auto", platform: str = "cuda"):
    """The resolution ladder: ``(name, source, reason, None)``.

    The trailing ``None`` stands where the reference returns a tuned
    config; this slice has no tuning layer.
    """
    if backend != "auto":
        return backend, "explicit", "backend= given by caller", None
    env = _env_backend()
    if env is not None:
        return env, "env", f"{BACKEND_ENV_VAR} env override", None
    name, reason = heuristic_backend(graph, platform)
    return name, "heuristic", reason, None


def heuristic_backend(graph, platform: str = "cuda") -> Tuple[str, str]:
    """The analytic pick ``(name, reason)`` from graph statistics alone."""
    if graph.n <= DENSE_MAX_VERTICES:
        return "dense", f"n={graph.n} <= {DENSE_MAX_VERTICES} (tiny graph)"
    if platform == "cuda" and graph.n >= BLOCKED_MIN_VERTICES:
        return "blocked", f"cuda and n={graph.n} >= {BLOCKED_MIN_VERTICES}"
    edges = max(graph.num_directed, 1)
    if DENSE_WORK_ADVANTAGE * edges >= graph.n**2:
        return "dense", (
            f"{DENSE_WORK_ADVANTAGE}*|E|={DENSE_WORK_ADVANTAGE * edges} >= "
            f"n^2={graph.n**2} (work-dense graph)"
        )
    max_deg = graph.max_degree()
    if graph.n * max_deg <= ELL_PAD_FACTOR * edges:
        return "ell", (
            f"n*max_deg={graph.n * max_deg} <= {ELL_PAD_FACTOR}*|E| "
            "(flat degrees, padding bounded)"
        )
    if graph.n * edges >= SELL_MIN_SCATTER_WORK:
        return "sell", (
            f"n*|E|={graph.n * edges} >= {SELL_MIN_SCATTER_WORK} "
            "(the reference's XLA:CPU scatter-cliff threshold)"
        )
    return "edges", "skewed degrees below the scatter-cliff threshold"
