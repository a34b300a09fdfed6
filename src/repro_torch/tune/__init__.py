"""repro_torch.tune: measurement-driven autotuning for the counting engine.

The port of ``repro.tune``.  The config space the analytic
:class:`~repro_torch.plan.cost.CostModel` only *guesses* at — per-exec-group
backend (mixed backends within one plan included; ``blocked``, the CUDA
kernels, on a card), fused-slice column batch, coloring chunk size, memory
budget — searched by on-device measurement and persisted per ``(graph
signature, plan canons, device kind)``:

* :mod:`repro_torch.tune.config` — :class:`TuningConfig`, the frozen value
  object engines bind (``CountingEngine(..., tuning=cfg)``);
* :mod:`repro_torch.tune.cache` — the versioned JSON :class:`TuningCache`
  (default file: ``build/tuning/TUNED_counting.json``, override with
  ``REPRO_TUNE_CACHE``) plus the memoized ``consult`` read path backend
  resolution uses;
* :mod:`repro_torch.tune.search` — :func:`tune`: rank the candidate
  lattice, measure the top-N with ``count_keys_chunk`` probes, persist the
  winner and per-backend calibration ratios;
* ``python -m repro_torch.tune`` — the CLI (measured-vs-predicted table).

Serve-time behavior is governed by ``REPRO_TUNE`` (``off`` | ``cached`` |
``full``) and always loses to an explicit ``backend=`` argument or the
``REPRO_ENGINE_BACKEND`` env override — see
:func:`repro_torch.exec.select.resolve_backend_config`.
"""

from .cache import (
    TUNE_CACHE_ENV_VAR,
    TuningCache,
    canons_digest,
    consult,
    default_cache_path,
    device_kind,
    entry_key,
    invalidate_entry,
    load_calibration,
)
from .config import TUNING_SCHEMA_VERSION, TuningConfig
from .search import MeasuredCandidate, TuneResult, measure_engine_us, tune

__all__ = [
    "TuningConfig",
    "TuningCache",
    "TuneResult",
    "MeasuredCandidate",
    "tune",
    "measure_engine_us",
    "consult",
    "load_calibration",
    "invalidate_entry",
    "canons_digest",
    "entry_key",
    "device_kind",
    "default_cache_path",
    "TUNE_CACHE_ENV_VAR",
    "TUNING_SCHEMA_VERSION",
]
