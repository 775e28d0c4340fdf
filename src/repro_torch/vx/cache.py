"""The unified spec-keyed LRU plan cache (a copy of ``repro``'s
``vx/cache.py``).

The port keeps its own copy so it never imports the reference package;
nothing here waits for a later slice.

Compiled routing state once lived in three unrelated places:
``functools.lru_cache`` on every plan constructor in ``core/shiftplan.py``,
a second pair of ``lru_cache`` banks in ``core/accessfuse.py``, and ad-hoc
executor closures rebuilt per call in ``kernels/``.  All of it now lives in
ONE bounded LRU (:data:`PLANS`) keyed by tagged tuples — dispatch-level
entries are keyed by ``AccessSpec.key()`` which includes dtype and vl, so
entries can never collide across element types.

Import discipline: this module must stay dependency-free (stdlib only) —
``core/shiftplan.py`` and ``core/accessfuse.py`` import it at module scope.
"""
from __future__ import annotations

import collections
import functools
import threading
from typing import Any, Callable


class PlanCache:
    """Thread-safe bounded LRU.  ``get`` builds on miss.

    The builder runs OUTSIDE the lock: plan compilation can be expensive
    (a Benes decomposition is host-side NumPy) and builders recurse into
    the cache (segment strategy plans consult per-field plans), so holding
    the lock across a build would serialize every concurrent access.  Two
    threads racing the same miss may both build; the first insert wins
    (plans are deterministic pure data, so the duplicate is discarded)."""

    def __init__(self, maxsize: int = 4096):
        self.maxsize = maxsize
        self._data: "collections.OrderedDict[tuple, Any]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key: tuple, builder: Callable[[], Any]) -> Any:
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
                self.hits += 1
                return self._data[key]
            self.misses += 1
        value = builder()
        with self._lock:
            if key in self._data:          # lost a build race: keep first
                self._data.move_to_end(key)
                return self._data[key]
            self._data[key] = value
            while len(self._data) > self.maxsize:
                self._data.popitem(last=False)
                self.evictions += 1
            return value

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key: tuple) -> bool:
        with self._lock:
            return key in self._data

    def keys(self) -> list[tuple]:
        with self._lock:
            return list(self._data)

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            self.hits = self.misses = self.evictions = 0

    def stats(self) -> dict:
        """Hit/miss/evict counters — the steady-state health check: a
        serving loop that keeps missing after warmup is recompiling plans
        every step (an unstable cache key), which tests/test_torch_serve.py
        asserts against."""
        with self._lock:
            return {"size": len(self._data), "hits": self.hits,
                    "misses": self.misses, "evictions": self.evictions,
                    "maxsize": self.maxsize}


#: The process-wide plan cache: shift plans, plan banks, segment strategy
#: picks, and vx executor closures all live here.
PLANS = PlanCache()


def memoize(kind: str) -> Callable:
    """Decorator replacing per-function ``functools.lru_cache`` for plan
    constructors: entries land in :data:`PLANS` under ``(kind, *args)``.
    Positional args must be hashable (plan constructors take only ints and
    tuples); keyword args are folded in sorted order."""

    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            key = (kind, *args)
            if kwargs:
                key += tuple(sorted(kwargs.items()))
            return PLANS.get(key, lambda: fn(*args, **kwargs))

        wrapper.cache = PLANS  # type: ignore[attr-defined]
        return wrapper

    return deco
