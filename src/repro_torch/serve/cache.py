"""LRU + TTL session cache for the serving plane.

Counterpart of ``repro.serve.cache`` (pure Python, the port's own copy).
The personalized-pagerank cache in ``serve/graph.py`` holds live
:class:`~repro_torch.core.engine.EngineSession` objects — each one cost a
full push-mode convergence to build, so eviction policy is real money:

  * **LRU under capacity pressure** — a hot restart vertex must never be
    evicted to make room for a one-off query.
  * **TTL idle expiry** — a session untouched for ``ttl`` seconds is
    dropped on next access (or ``sweep()``); the clock is injectable so
    expiry is unit-testable without sleeping.
  * **invalidate, don't drop** — a graph delta makes every cached
    session stale, but the pagerank residual repair is
    restart-independent: the right response is to mark entries for
    repair and keep them warm, not to flush the cache.
    :meth:`invalidate` applies a caller-supplied marker to every live
    entry in place.

Counters (hits / misses / expirations / evictions / invalidations) feed
the ``QueryServer`` stats snapshot.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from typing import Any, Callable, Iterator, Optional


class LRUTTLCache:
    """Least-recently-used cache with idle-TTL expiry and an injectable
    clock.  ``ttl=None`` disables expiry; ``get`` refreshes both the
    recency order and the idle stamp (a hot entry never idles out —
    delta freshness is the invalidation path's job, not the TTL's)."""

    def __init__(self, capacity: int = 16, ttl: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.ttl = ttl
        self.clock = clock
        self._od: "OrderedDict[Any, tuple[Any, float]]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.expirations = 0
        self.evictions = 0
        self.invalidations = 0

    # ------------------------------------------------------------------
    def _expired(self, stamp: float) -> bool:
        return self.ttl is not None and (self.clock() - stamp) > self.ttl

    def get(self, key) -> Optional[Any]:
        """Value for ``key`` or None.  Counts a hit (and refreshes
        LRU order + idle stamp) or a miss; an idled-out entry is dropped
        and counts as BOTH an expiration and a miss."""
        entry = self._od.get(key)
        if entry is None:
            self.misses += 1
            return None
        value, stamp = entry
        if self._expired(stamp):
            del self._od[key]
            self.expirations += 1
            self.misses += 1
            return None
        self._od.move_to_end(key)
        self._od[key] = (value, self.clock())
        self.hits += 1
        return value

    def peek(self, key) -> Optional[Any]:
        """Value for ``key`` without touching order, stamp, or counters
        (expired entries read as absent but are not dropped)."""
        entry = self._od.get(key)
        if entry is None or self._expired(entry[1]):
            return None
        return entry[0]

    def put(self, key, value) -> None:
        """Insert/overwrite ``key`` as most-recently-used, evicting the
        LRU entry when over capacity."""
        if key in self._od:
            self._od.move_to_end(key)
        self._od[key] = (value, self.clock())
        while len(self._od) > self.capacity:
            self._od.popitem(last=False)
            self.evictions += 1

    def pop(self, key) -> Optional[Any]:
        entry = self._od.pop(key, None)
        return entry[0] if entry is not None else None

    def sweep(self) -> int:
        """Drop every idled-out entry; returns how many were dropped."""
        dead = [k for k, (_, stamp) in self._od.items()
                if self._expired(stamp)]
        for k in dead:
            del self._od[k]
        self.expirations += len(dead)
        return len(dead)

    def invalidate(self, mark: Callable[[Any], None]) -> int:
        """Apply ``mark`` to every live entry IN PLACE (stale-but-warm:
        entries stay cached, recency order unchanged).  Returns the
        number of entries marked."""
        n = 0
        for key, (value, stamp) in list(self._od.items()):
            if self._expired(stamp):
                continue
            mark(value)
            n += 1
        self.invalidations += n
        return n

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._od)

    def __contains__(self, key) -> bool:
        return self.peek(key) is not None

    def keys(self) -> Iterator:
        return iter(list(self._od.keys()))

    def items(self) -> Iterator:
        """Live (key, value) pairs, LRU first (no counter effects)."""
        return iter([(k, v) for k, (v, stamp) in self._od.items()
                     if not self._expired(stamp)])

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {"size": len(self._od), "capacity": self.capacity,
                "hits": self.hits, "misses": self.misses,
                "expirations": self.expirations,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
                "hit_rate": (self.hits / total) if total else 0.0}
