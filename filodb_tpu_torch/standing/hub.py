"""Subscription hub (counterpart of ``filodb_tpu/standing/hub.py``): one
rendered payload fanned out to every subscriber of a standing query.

The maintainer renders each refresh once; ``SubscriptionHub.publish``
hands the same bytes object to every subscriber's queue, so N dashboard
clients cost one render and N socket writes. Subscribers are bounded per
query (``standing.max_subscribers``): past the bound a subscription sheds
with ``SubscriptionLimit`` (429 at the SSE edge). Each queue is bounded
too: when it is full the oldest frame drops (dashboards want the newest
frame), counted in ``filodb_standing_pushes_total{outcome="dropped"}``.
"""

from __future__ import annotations

import queue
import threading

from ..metrics import REGISTRY

# delivered on close, so a blocked SSE writer wakes and ends its stream
CLOSED = object()


class SubscriptionLimit(Exception):
    """A subscription shed: the standing query is at its subscriber bound."""


class Subscription:
    """One subscriber's bounded frame queue."""

    __slots__ = ("qid", "_q", "closed")

    def __init__(self, qid: str, depth: int = 8):
        self.qid = qid
        self._q: queue.Queue = queue.Queue(maxsize=max(int(depth), 1))
        self.closed = False

    def get(self, timeout: float | None = None):
        """The next payload (bytes), ``CLOSED`` once the hub closed the
        subscription; raises ``queue.Empty`` on timeout."""
        return self._q.get(timeout=timeout)

    def _offer(self, payload) -> bool:
        """Enqueue, the newest winning: a full queue drops its oldest frame
        first. False when a frame was dropped."""
        dropped = False
        while True:
            try:
                self._q.put_nowait(payload)
                return not dropped
            except queue.Full:
                try:
                    self._q.get_nowait()
                    dropped = True
                except queue.Empty:
                    pass


class SubscriptionHub:
    """Subscribers by standing query, with publish-once fan-out."""

    def __init__(self, max_subscribers: int = 64, queue_depth: int = 8):
        self.max_subscribers = max(int(max_subscribers), 1)
        self.queue_depth = max(int(queue_depth), 1)
        self._subs: dict[str, list[Subscription]] = {}
        self._lock = threading.Lock()

    def subscribe(self, qid: str) -> Subscription:
        with self._lock:
            subs = self._subs.setdefault(qid, [])
            if len(subs) >= self.max_subscribers:
                raise SubscriptionLimit(
                    f"standing query {qid} at max_subscribers={self.max_subscribers}")
            sub = Subscription(qid, self.queue_depth)
            subs.append(sub)
        REGISTRY.gauge("filodb_standing_subscribers").set(float(self.total()))
        return sub

    def unsubscribe(self, sub: Subscription) -> None:
        with self._lock:
            subs = self._subs.get(sub.qid)
            if subs is not None:
                if sub in subs:
                    subs.remove(sub)
                if not subs:
                    self._subs.pop(sub.qid, None)
        sub.closed = True
        REGISTRY.gauge("filodb_standing_subscribers").set(float(self.total()))

    def publish(self, qid: str, payload: bytes) -> int:
        """Fan one rendered payload out to every subscriber of ``qid`` (the
        same bytes object in every queue); returns how many it reached."""
        with self._lock:
            subs = list(self._subs.get(qid, ()))
        dropped = 0
        for sub in subs:
            if not sub._offer(payload):
                dropped += 1
        if subs:
            REGISTRY.counter("filodb_standing_pushes", outcome="sent").inc(len(subs))
        if dropped:
            REGISTRY.counter("filodb_standing_pushes", outcome="dropped").inc(dropped)
        return len(subs)

    def close(self, qid: str) -> None:
        """End every subscription of ``qid`` (unregister, demotion): blocked
        SSE writers receive ``CLOSED``."""
        with self._lock:
            subs = self._subs.pop(qid, [])
        for sub in subs:
            sub.closed = True
            sub._offer(CLOSED)
        if subs:
            REGISTRY.gauge("filodb_standing_subscribers").set(float(self.total()))

    def count(self, qid: str) -> int:
        with self._lock:
            return len(self._subs.get(qid, ()))

    def total(self) -> int:
        with self._lock:
            return sum(len(s) for s in self._subs.values())

    def snapshot(self) -> dict:
        with self._lock:
            return {qid: len(subs) for qid, subs in self._subs.items()}
