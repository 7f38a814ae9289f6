"""The engine's query pool and identical-query coalescing (counterpart of
``filodb_tpu/coordinator/scheduler.py``; reference QueryScheduler.scala).

- ``QueryScheduler``: at most ``parallelism`` queries execute at once on a
  shared pool, up to ``max_queued`` more wait for a slot, and past that a
  submission fails fast with ``QueryRejected``. A caller that stops
  waiting (its deadline) frees the slot of a query that never started; a
  started one runs on to its end (device work cannot be interrupted).
- ``SingleFlight``: concurrent identical queries share one execution and
  its exception. In flight only: nothing is kept after it completes.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout

from ..metrics import REGISTRY
from ..query.exec.transformers import QueryDeadlineExceeded, QueryError


class QueryRejected(QueryError):
    """The pool and its queue are full."""


class SingleFlight:
    """Coalesce concurrent identical queries into one execution.

    The first arrival for a key leads and executes; followers that arrive
    while it runs wait for its result (or its exception). The key is
    deregistered before the result is published, so an arrival after
    completion runs its own flight: sharing is for concurrent queries,
    never a cache. A follower whose deadline is shorter than the leader's
    run gives up with ``QueryDeadlineExceeded``.

    ``singleflight.KeyedSingleFlight`` cannot serve here: it serializes
    builds behind a per-key lock so the later ones find the first one's
    entry in a cache, whereas a query result must reach the followers
    without ever being cached."""

    def __init__(self):
        self._lock = threading.Lock()
        self._flights: dict = {}

    def run(self, key, fn, timeout_s: float):
        with self._lock:
            fut = self._flights.get(key)
            leader = fut is None
            if leader:
                fut = Future()
                self._flights[key] = fut
        if not leader:
            REGISTRY.counter("filodb_queries_coalesced").inc()
            try:
                return fut.result(timeout=timeout_s)
            except FutureTimeout:
                REGISTRY.counter("filodb_queries_deadline_exceeded").inc()
                raise QueryDeadlineExceeded(
                    f"query exceeded deadline: {timeout_s:.1f}s (coalesced)") from None
        try:
            result = fn()
        except BaseException as e:
            with self._lock:
                self._flights.pop(key, None)
            fut.set_exception(e)
            raise
        with self._lock:
            self._flights.pop(key, None)
        fut.set_result(result)
        return result


class QueryScheduler:
    """The bounded shared query pool (see the module docstring)."""

    def __init__(self, parallelism: int | None = None, max_queued: int = 64):
        self.parallelism = parallelism or min(8, os.cpu_count() or 4)
        self.max_queued = max_queued
        self._pool = ThreadPoolExecutor(max_workers=self.parallelism,
                                        thread_name_prefix="filodb-query")
        # slots = running + queued, taken without blocking at submission
        self._slots = threading.BoundedSemaphore(self.parallelism + max_queued)
        self._in_flight = 0
        self.peak_in_flight = 0
        self._lock = threading.Lock()

    @property
    def in_flight(self) -> int:
        return self._in_flight

    def run(self, fn, deadline_s: float):
        """Run ``fn()`` on the pool and wait at most ``deadline_s``. Raises
        ``QueryRejected`` when saturated, ``QueryDeadlineExceeded`` past
        the deadline."""
        if not self._slots.acquire(blocking=False):
            REGISTRY.counter("filodb_queries_rejected").inc()
            raise QueryRejected(
                f"query rejected: {self.parallelism} running + {self.max_queued} queued")

        def job():
            with self._lock:
                self._in_flight += 1
                self.peak_in_flight = max(self.peak_in_flight, self._in_flight)
            try:
                return fn()
            finally:
                with self._lock:
                    self._in_flight -= 1
                self._slots.release()

        fut = self._pool.submit(job)
        try:
            return fut.result(timeout=deadline_s)
        except FutureTimeout:
            if fut.cancel():  # never started: job's finally will not run
                self._slots.release()
            REGISTRY.counter("filodb_queries_deadline_exceeded").inc()
            raise QueryDeadlineExceeded(f"query exceeded deadline: {deadline_s:.1f}s") from None

    def shutdown(self):
        self._pool.shutdown(wait=False, cancel_futures=True)
