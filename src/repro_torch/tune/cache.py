"""TuningCache: versioned JSON persistence of tuned engine configs.

The port of ``repro.tune.cache``.  Winners of a tuning run are keyed by
``(graph signature, plan canon sequence, device kind)`` — the graph half
and template half of the engine cache key plus the hardware the
measurements were taken on — so a cached config is only ever applied to
the exact workload it was measured for.  The device kind is the engine
device's own: ``torch.cuda.get_device_name(device)`` on a CUDA card (so an
H100's measurements never rank candidates on another card) and ``"cpu"``
on the CPU.  :func:`consult` and :func:`entry_key` take the engine's
device, never a process-wide default.

The file is the port's own (default ``build/tuning/TUNED_counting.json``
under the repository root, override with ``REPRO_TUNE_CACHE``), never the
reference's ``TUNED_counting.json``; its JSON layout is the reference's::

    {
      "version": 2,
      "entries": {
        "<sig>|<canons-digest>|<device kind>": {
          "config": {... TuningConfig.to_json() ...},
          "meta":   {"measured_us": ..., "predicted_us": ..., ...}
        }
      },
      "calibration": {"edges": 1.07, "blocked": 0.83, ...}
    }

``calibration`` carries the measured/predicted per-backend cost ratios the
tuner observed: :func:`repro_torch.plan.cost.load_backend_calibration`
folds them back into the candidate lattice, so predictions improve
machine by machine even for workloads never tuned directly.

Reads are memoized by ``(path, mtime, size)`` — :func:`consult`, called
from backend resolution on every engine cache-key computation, costs one
``os.stat`` when the file is unchanged.  Corrupt files, stale versions and
malformed entries all degrade to "no tuned config" with one logged
warning; they never raise into an engine build.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import tempfile
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.device import device_kind

from .config import TUNING_SCHEMA_VERSION, TuningConfig

__all__ = [
    "TuningCache",
    "TUNE_CACHE_ENV_VAR",
    "default_cache_path",
    "canons_digest",
    "entry_key",
    "device_kind",
    "consult",
    "load_calibration",
    "invalidate_entry",
]

logger = logging.getLogger("repro_torch.tune")

#: Environment override for the cache file path (default:
#: ``build/tuning/TUNED_counting.json`` under the repository root, a
#: git-ignored directory).
TUNE_CACHE_ENV_VAR = "REPRO_TUNE_CACHE"

#: memoized parsed caches keyed by path -> (stat fingerprint, TuningCache).
_LOAD_CACHE: Dict[str, Tuple[Optional[Tuple[int, int]], "TuningCache"]] = {}

#: paths already warned about (corrupt / version mismatch) — warn once.
_WARNED: set = set()

#: A device kind (a string, used verbatim) or a device to take it from.
DeviceLike = Union[str, torch.device, None]


def default_cache_path() -> str:
    env = os.environ.get(TUNE_CACHE_ENV_VAR, "").strip()
    if env:
        return env
    # src/repro_torch/tune/cache.py -> repository root
    root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    )
    return os.path.join(root, "build", "tuning", "TUNED_counting.json")


def canons_digest(canons) -> str:
    """Stable digest of a plan's template-set canon sequence (the schedule
    identity — see ``TemplatePlan.canons``)."""
    return hashlib.sha1(repr(tuple(map(tuple, canons))).encode()).hexdigest()


def _kind(device: DeviceLike) -> str:
    """A string is already a device kind; a device (or ``None``, the
    default device) gives its :func:`device_kind`."""
    return device if isinstance(device, str) else device_kind(device)


def entry_key(graph_signature: str, canons, device: DeviceLike = None) -> str:
    """``"<signature>|<canons digest>|<device kind>"``; ``device`` is a
    device kind string or the engine's device."""
    return "|".join((str(graph_signature), canons_digest(canons), _kind(device)))


class TuningCache:
    """In-memory view of one cache file; load/modify/save explicitly.

    Thread-compatibility note: instances are plain dict holders — the
    serving layer mutates them only from its single scheduler thread.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path if path is not None else default_cache_path()
        self.entries: Dict[str, Dict] = {}
        self.calibration: Dict[str, float] = {}

    # -- persistence ---------------------------------------------------------

    @classmethod
    def load(cls, path: Optional[str] = None) -> "TuningCache":
        """Parse the file at ``path`` (default-resolved).  A missing file
        yields an empty cache; a corrupt or version-mismatched file yields
        an empty cache with ONE warning — never an exception."""
        cache = cls(path)
        resolved = cache.path
        try:
            with open(resolved) as fh:
                data = json.load(fh)
        except FileNotFoundError:
            return cache
        except (OSError, json.JSONDecodeError, ValueError) as exc:
            _warn_once(resolved, f"unreadable tuning cache ({exc}) — ignoring it")
            return cache
        if not isinstance(data, dict):
            _warn_once(resolved, "tuning cache is not a JSON object — ignoring it")
            return cache
        version = data.get("version")
        if version != TUNING_SCHEMA_VERSION:
            _warn_once(
                resolved,
                f"tuning cache version {version!r} != supported "
                f"{TUNING_SCHEMA_VERSION} — ignoring it (re-tune to refresh)",
            )
            return cache
        entries = data.get("entries", {})
        if isinstance(entries, dict):
            cache.entries = {
                str(k): v for k, v in entries.items() if isinstance(v, dict)
            }
        calib = data.get("calibration", {})
        if isinstance(calib, dict):
            out = {}
            for name, ratio in calib.items():
                try:
                    ratio = float(ratio)
                except (TypeError, ValueError):
                    continue
                if ratio > 0:
                    out[str(name)] = ratio
            cache.calibration = out
        return cache

    def save(self, path: Optional[str] = None) -> str:
        """Atomic write (tmp + rename); returns the path written.  Also
        refreshes the read memo so a consult right after a save sees the
        new entries without waiting for an mtime tick."""
        target = path if path is not None else self.path
        payload = {
            "version": TUNING_SCHEMA_VERSION,
            "entries": self.entries,
            "calibration": self.calibration,
        }
        d = os.path.dirname(os.path.abspath(target)) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix=".tuned-", dir=d)
        try:
            with os.fdopen(fd, "w") as fh:
                json.dump(payload, fh, indent=2, sort_keys=True)
            os.replace(tmp, target)
        finally:
            if os.path.exists(tmp):  # pragma: no cover - error path
                os.unlink(tmp)
        _LOAD_CACHE[target] = (_fingerprint(target), self)
        return target

    # -- entry access --------------------------------------------------------

    def get(
        self, graph_signature: str, canons, device: DeviceLike = None
    ) -> Optional[TuningConfig]:
        entry = self.entries.get(entry_key(graph_signature, canons, device))
        if entry is None:
            return None
        try:
            return TuningConfig.from_json(entry.get("config"))
        except (ValueError, TypeError, KeyError) as exc:
            _warn_once(
                self.path, f"malformed tuned entry ({exc}) — ignoring it"
            )
            return None

    def meta(
        self, graph_signature: str, canons, device: DeviceLike = None
    ) -> Optional[Dict]:
        entry = self.entries.get(entry_key(graph_signature, canons, device))
        return None if entry is None else dict(entry.get("meta", {}))

    def put(
        self,
        graph_signature: str,
        canons,
        config: TuningConfig,
        *,
        device: DeviceLike = None,
        meta: Optional[Dict] = None,
    ) -> str:
        key = entry_key(graph_signature, canons, device)
        self.entries[key] = {"config": config.to_json(), "meta": dict(meta or {})}
        return key

    def invalidate(
        self, graph_signature: str, canons, device: DeviceLike = None
    ) -> bool:
        return (
            self.entries.pop(entry_key(graph_signature, canons, device), None)
            is not None
        )

    def merge_calibration(self, ratios: Dict[str, float]) -> None:
        """Fold a tuning run's per-backend measured/predicted ratios in
        (newest run wins per backend — ratios are already medians)."""
        for name, ratio in ratios.items():
            if ratio > 0:
                self.calibration[str(name)] = float(ratio)


# ---------------------------------------------------------------------------
# Memoized read-side helpers (the engine-resolution hot path)
# ---------------------------------------------------------------------------


def _fingerprint(path: str) -> Optional[Tuple[int, int]]:
    try:
        st = os.stat(path)
        return (st.st_mtime_ns, st.st_size)
    except OSError:
        return None


def _load_memoized(path: Optional[str]) -> "TuningCache":
    resolved = path if path is not None else default_cache_path()
    fp = _fingerprint(resolved)
    hit = _LOAD_CACHE.get(resolved)
    if hit is not None and hit[0] == fp:
        return hit[1]
    cache = TuningCache.load(resolved)
    _LOAD_CACHE[resolved] = (fp, cache)
    return cache


def consult(
    graph_signature: str,
    canons,
    *,
    device: DeviceLike = None,
    path: Optional[str] = None,
) -> Optional[TuningConfig]:
    """The read path backend resolution uses: tuned config or ``None``.

    One ``os.stat`` when the file is unchanged; never raises (any failure
    degrades to ``None`` so an engine build falls through to the analytic
    heuristic)."""
    try:
        return _load_memoized(path).get(graph_signature, canons, device)
    except Exception as exc:  # pragma: no cover - defensive
        logger.debug("tuning cache consult failed: %s", exc)
        return None


def load_calibration(path: Optional[str] = None) -> Dict[str, float]:
    """The persisted per-backend measured/predicted cost ratios (empty dict
    when the cache is missing/corrupt — the lattice then runs uncalibrated)."""
    try:
        return dict(_load_memoized(path).calibration)
    except Exception:  # pragma: no cover - defensive
        return {}


def invalidate_entry(
    graph_signature: str,
    canons,
    *,
    device: DeviceLike = None,
    path: Optional[str] = None,
) -> bool:
    """Load-modify-save removal of one tuned entry (the quarantine path:
    a key failing deterministically must not be re-picked from the cache).
    Returns True when an entry was actually removed."""
    cache = _load_memoized(path)
    if not cache.invalidate(graph_signature, canons, device):
        return False
    cache.save()
    logger.info(
        "tuned entry invalidated for graph %s on %s (quarantine/interop)",
        str(graph_signature)[:12],
        _kind(device),
    )
    return True


def _warn_once(path: str, message: str) -> None:
    if path not in _WARNED:
        _WARNED.add(path)
        logger.warning("%s: %s", path, message)
