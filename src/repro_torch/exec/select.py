"""Backend auto-selection: graph statistics -> execution strategy name.

The port of ``repro.exec.select``.  The resolution ladder is the
reference's: explicit ``backend=`` > ``REPRO_ENGINE_BACKEND`` > a tuned
config (passed in, or found in the port's tuning cache for the engine's
device under ``REPRO_TUNE``) > the analytic heuristic.  The heuristic's
``tpu`` rung becomes a ``cuda`` rung: on a card, graphs of at least
:data:`BLOCKED_MIN_VERTICES` vertices run the CUDA kernels of the
``blocked`` backend.  The other thresholds are the reference's, measured on
XLA:CPU; they are starting values, not measurements of the port (the tuner
measures the candidates on the card instead).
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Tuple

import torch

__all__ = [
    "select_backend",
    "heuristic_backend",
    "resolve_backend_config",
    "consult_tuning",
    "tune_mode",
    "mesh_comm_mode",
    "ENGINE_BACKENDS",
    "BACKEND_ENV_VAR",
    "TUNE_MODE_ENV_VAR",
    "TUNE_MODES",
    "MESH_COMM_ENV_VAR",
    "MESH_COMM_MODES",
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

#: How engine builds use the tuning cache: ``off`` never consults it,
#: ``cached`` (default) applies persisted winners, ``full`` additionally
#: lets the serving layer schedule background tunes for un-tuned keys.
TUNE_MODE_ENV_VAR = "REPRO_TUNE"

TUNE_MODES = ("off", "cached", "full")

#: Environment override forcing the mesh backend's collective scheme:
#: ``blocking`` (one all-gather per column batch) or ``pipelined`` (the
#: double-buffered ring).  Unset = the cost model's per-stage decision.
MESH_COMM_ENV_VAR = "REPRO_MESH_COMM"

MESH_COMM_MODES = ("blocking", "pipelined")

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


def tune_mode() -> str:
    """The ``REPRO_TUNE`` mode (``off`` | ``cached`` | ``full``).

    An unrecognized value warns once and behaves as ``cached`` — engine
    builds and service stats must never crash on a typo'd env var."""
    raw = os.environ.get(TUNE_MODE_ENV_VAR, "").strip().lower()
    if not raw:
        return "cached"
    if raw in TUNE_MODES:
        return raw
    if raw not in _BAD_TUNE_MODES_WARNED:
        _BAD_TUNE_MODES_WARNED.add(raw)
        logger.warning(
            "%s=%r is not one of %s — defaulting to 'cached'",
            TUNE_MODE_ENV_VAR, raw, "|".join(TUNE_MODES),
        )
    return "cached"


_BAD_TUNE_MODES_WARNED: set = set()


def mesh_comm_mode() -> Optional[str]:
    """The validated ``REPRO_MESH_COMM`` override, or ``None`` (let the cost
    model's per-stage ``comm_schedule`` decide).  An unrecognised value
    warns once and behaves as unset."""
    raw = os.environ.get(MESH_COMM_ENV_VAR, "").strip().lower()
    if not raw:
        return None
    if raw in MESH_COMM_MODES:
        return raw
    if raw not in _BAD_MESH_COMM_WARNED:
        _BAD_MESH_COMM_WARNED.add(raw)
        logger.warning(
            "%s=%r is not one of %s — ignoring the override",
            MESH_COMM_ENV_VAR, raw, "|".join(MESH_COMM_MODES),
        )
    return None


_BAD_MESH_COMM_WARNED: set = set()


def consult_tuning(graph, canons, *, device, signature=None, path=None):
    """Tuned config for ``(graph, canons)`` measured on ``device``'s kind,
    or ``None``.

    Honors ``REPRO_TUNE=off``; any cache trouble (missing, corrupt, wrong
    version, unreadable) degrades to ``None`` — the caller then falls
    through to the heuristic."""
    if canons is None or tune_mode() == "off":
        return None
    try:
        # local import: repro_torch.tune.cache is downstream of the exec layer
        from repro_torch.tune.cache import consult

        sig = signature if signature is not None else graph.signature()
        return consult(sig, canons, device=torch.device(device), path=path)
    except Exception as exc:  # pragma: no cover - defensive
        logger.debug("tuning consult failed (%s) — using heuristic", exc)
        return None


def resolve_backend_config(
    graph,
    *,
    backend: str = "auto",
    device="cuda",
    canons=None,
    tuning=None,
    signature=None,
):
    """The full backend resolution ladder: ``(name, source, reason, config)``.

    Precedence (strongest first):

    1. **explicit** — a concrete ``backend=`` argument.  ``backend="mixed"``
       requires ``tuning`` (the per-group bindings).
    2. **env** — ``REPRO_ENGINE_BACKEND`` beats tuned configs too: the
       operator's escape hatch must not be overridable by a cache file.
    3. **tuned** — a :class:`~repro_torch.tune.config.TuningConfig` passed
       as ``tuning`` or found in the tuning cache for ``(graph, canons)``
       on ``device``'s kind.
    4. **heuristic** — the analytic pick from graph statistics for
       ``device``'s type (``"cuda"`` or ``"cpu"``).

    ``config`` is the :class:`TuningConfig` to bind (``None`` for
    env/heuristic/plain-explicit resolutions).
    """
    if backend != "auto":
        if backend == "mixed" and tuning is None:
            raise ValueError(
                "backend='mixed' needs a TuningConfig (tuning=...) for its "
                "per-group bindings"
            )
        cfg = tuning if backend == "mixed" else None
        return backend, "explicit", "backend= given by caller", cfg
    env = _env_backend()
    if env is not None:
        return env, "env", f"{BACKEND_ENV_VAR} env override", None
    cfg = tuning
    if cfg is None:
        cfg = consult_tuning(graph, canons, device=device, signature=signature)
    if cfg is not None:
        reason = (
            f"tuned config (default={cfg.default_backend}, "
            f"{len(cfg.group_backends)} group bindings, "
            f"column_batch={cfg.column_batch}, chunk_size={cfg.chunk_size})"
        )
        return cfg.backend_name, "tuned", reason, cfg
    name, reason = heuristic_backend(graph, torch.device(device).type)
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
