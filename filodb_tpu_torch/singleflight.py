"""Keyed single-flight: one build per key under concurrency (counterpart
of ``filodb_tpu/singleflight.py``).

A miss takes the key's flight lock, re-checks its cache and only then
builds, so N racing identical cold requests make exactly one expensive
construction (a superblock's concatenation and upload, a regroup) while the
others wait and reuse it. Flight locks are made on demand and pruned
opportunistically; a racer holding a pruned lock only degrades to a
duplicate build, never to corruption.
"""

from __future__ import annotations

import threading
from collections import OrderedDict


class KeyedSingleFlight:
    """Per-key build serialization with a bounded, self-pruning lock table.
    ``alive`` (optional) is a predicate over keys consulted at prune time:
    locks of keys still of interest survive, the rest go. Without it an
    oversized table is cleared."""

    def __init__(self, max_keys: int = 256, alive=None):
        self.max_keys = max_keys
        self._alive = alive
        self._lock = threading.Lock()
        self._locks: dict = {}

    def lock(self, key) -> threading.Lock:
        """The flight lock for ``key`` (created on demand)."""
        with self._lock:
            lk = self._locks.get(key)
            if lk is None:
                if len(self._locks) >= self.max_keys:
                    if self._alive is not None:
                        self._locks = {k: v for k, v in self._locks.items() if self._alive(k)}
                    if len(self._locks) >= self.max_keys:
                        self._locks.clear()
                lk = threading.Lock()
                self._locks[key] = lk
            return lk

    def __len__(self) -> int:
        with self._lock:
            return len(self._locks)


# process-wide flight table for memo dicts attached to objects: keys embed
# id(obj), so distinct blocks never contend
_MEMO_FLIGHT = KeyedSingleFlight(max_keys=512)


def memo_on(obj, attr: str, key, build):
    """Get-or-build ``key`` in a memo dict attached to ``obj`` as ``attr``:
    one lock-free probe on a hit, a single-flight build on a miss. A build
    that raises caches nothing."""
    cache = obj.__dict__.setdefault(attr, {})
    hit = cache.get(key)
    if hit is not None:
        return hit
    with _MEMO_FLIGHT.lock((id(obj), attr, key)):
        hit = cache.get(key)
        if hit is None:
            hit = build()
            cache[key] = hit
        return hit


class SingleFlightLRU:
    """Bounded LRU cache whose misses build single-flight per key: hits
    refresh recency under one lock; a miss builds outside it, inside the
    key's flight lock, then inserts and evicts oldest first."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._d: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        self._flight = KeyedSingleFlight(max_keys=max(4 * capacity, 16),
                                         alive=lambda k: k in self._d)

    def _probe(self, key):
        with self._lock:
            if key in self._d:
                self._d.move_to_end(key)
                return self._d[key]
            return None

    def get_or_build(self, key, ctor):
        hit = self._probe(key)
        if hit is not None:
            return hit
        with self._flight.lock(key):
            hit = self._probe(key)
            if hit is not None:
                return hit
            v = ctor()
            with self._lock:
                self._d[key] = v
                while len(self._d) > self.capacity:
                    self._d.popitem(last=False)
            return v

    def pop(self, key):
        with self._lock:
            return self._d.pop(key, None)

    def clear(self) -> None:
        with self._lock:
            self._d.clear()

    def keys(self) -> list:
        with self._lock:
            return list(self._d)

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._d
