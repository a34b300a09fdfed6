"""Compiled-engine LRU cache for the counting service.

A copy of ``repro.serve.cache``.  A
:class:`~repro_torch.core.engine.CountingEngine` is expensive twice over:
device operand construction (edge lists, SELL tables, dense adjacency, the
kernels' partition, shipped to the device) and the build of its chunk
function.  Both are keyed
entirely by :func:`repro_torch.core.engine.engine_cache_key` — graph signature,
template-set canonical forms, backend, dtype policy, and the chunk spec —
so repeat and near-repeat queries (same key, different seeds / iteration
targets / epsilon) must never pay them again.  The cache holds the warm
engines behind that key with LRU eviction and hit/miss/evict counters for
observability.

Thread safety: every operation (get/peek/keys/counters/clear) runs under
one internal re-entrant lock, so the cache can be shared between the
front-end scheduler thread, background pre-warming, and ad-hoc inspection
without torn LRU order or drifting counters.  The lock is held *across the
miss-path* ``factory()`` call on purpose: two threads racing on the same
cold key must build the engine once, not twice — the second thread blocks
and then hits.  (Engine builds for *different* keys therefore serialize
too; the front-end routes all builds through its single scheduler thread,
so this costs nothing there.)
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Dict, Hashable, Optional, Tuple

__all__ = ["EngineCache"]


class EngineCache:
    """LRU map ``engine_cache_key -> warm CountingEngine``.

    ``get(key, factory)`` returns the cached engine (hit: moves it to the
    MRU end) or builds one via ``factory()`` (miss: inserts, evicting the
    LRU entry beyond ``capacity``).  Evicted engines are simply dropped —
    their device operands are freed with the last reference, and a
    re-query rebuilds through the same factory path.
    """

    def __init__(self, capacity: int = 8):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._store: "OrderedDict[Hashable, object]" = OrderedDict()
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.build_failures = 0
        self.invalidations = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._store)

    def __contains__(self, key: Hashable) -> bool:
        with self._lock:
            return key in self._store

    def get(self, key: Hashable, factory: Callable[[], object]):
        """Cached engine for ``key``, building (and possibly evicting) on miss.

        Atomic under the cache lock — concurrent gets for one cold key
        build exactly once (the losers of the race block, then hit).

        A ``factory()`` that raises leaves the cache exactly as it was: no
        entry under ``key`` (the next ``get`` re-runs a fresh factory), no
        held lock state (the RLock unwinds with the exception), and only
        the ``build_failures`` counter advanced.
        """
        with self._lock:
            if key in self._store:
                self.hits += 1
                self._store.move_to_end(key)
                return self._store[key]
            self.misses += 1
            try:
                engine = factory()
            except BaseException:
                # miss-path poisoning guard: never insert a placeholder or
                # partial entry for a build that failed
                self.build_failures += 1
                raise
            self._store[key] = engine
            while len(self._store) > self.capacity:
                self._store.popitem(last=False)
                self.evictions += 1
            return engine

    def peek(self, key: Hashable) -> Optional[object]:
        """The cached engine without touching counters or LRU order."""
        with self._lock:
            return self._store.get(key)

    def invalidate(self, key: Hashable) -> bool:
        """Drop ``key``'s entry (True if one existed).

        The degradation-ladder path uses this: a memory-failed engine is
        evicted so the next ``get`` rebuilds it at the new rung's
        chunk/column-batch/backend configuration.
        """
        with self._lock:
            existed = self._store.pop(key, None) is not None
            if existed:
                self.invalidations += 1
            return existed

    def keys(self) -> Tuple[Hashable, ...]:
        """Cached keys, LRU first."""
        with self._lock:
            return tuple(self._store.keys())

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "build_failures": self.build_failures,
                "invalidations": self.invalidations,
                "size": len(self._store),
                "capacity": self.capacity,
            }

    def clear(self) -> None:
        with self._lock:
            self._store.clear()
