"""Standing-query registry (counterpart of ``filodb_tpu/standing/registry.py``):
the PromQL expressions this process keeps evaluated.

A ``StandingQuery`` is one registered expression and its maintenance
state: the retained ``[G, J]`` partials the delta path splices into, the
shard version vector they cover, and the grid and staging ranges that
keep one superblock cache entry across refreshes. Entries arrive as
``manual`` (``POST /api/v1/standing/register``), ``promoted`` (the
promoter saw a hot recurring key in the dispatch scheduler's
``KeyStatsRing``), ``rule`` (a recording rule, ``POST
/api/v1/rules/record``: its newest closed steps write back as a series)
or ``alert`` (a query whose newest closed step goes to ``alert_sink``).

Demotion is remembered: a key demoted as ``standing_nondecomposable``
(topk, quantile and histogram_quantile epilogues, which cannot splice per
step) never promotes again; an idle demotion ages out, so the key may
promote once it is hot again (promotion needs a burst, demotion a long
idle).
"""

from __future__ import annotations

import threading
import time
import uuid
from dataclasses import dataclass, field

import numpy as np

from ..metrics import REGISTRY

# demotion reasons (/debug/standing); standing_nondecomposable is also a
# reason of the fused-fallback taxonomy (metrics.FUSED_FALLBACK_REASONS):
# every full refresh of such a query counts there
DEMOTE_REASONS = frozenset({
    "standing_nondecomposable",  # the epilogue cannot splice: never promotes again
    "idle",                      # recurrence stopped and no subscriber remains
    "unregistered",              # unregistered over the API
    "error",                     # registration failed
})


def _new_qid() -> str:
    return uuid.uuid4().hex[:12]


@dataclass
class StandingQuery:
    """One registered standing query and its delta state. The maintenance
    fields are guarded by ``lock`` (one refresh at a time; the maintainer
    is the only writer)."""

    qid: str
    promql: str
    dataset: str
    step_ms: int
    span_ms: int
    source: str = "manual"  # manual | promoted | rule | alert
    key: object = None  # the KeyStatsRing key of a promoted entry
    # decided at registration from the planned exec
    # (aggregations.standing_delta_eligible): "delta" splices retained
    # partials; "full" re-dispatches the whole grid each refresh
    mode: str = "delta"
    mode_reason: str | None = None
    ws: str = "unknown"
    ns: str = "unknown"
    # a recording rule writes its results back as rule_name{group labels}
    rule_name: str | None = None
    eval_interval_s: float | None = None
    # called as alert_sink(sq, end_ms, [(labels, value), ...]) after each
    # refresh, with the newest closed step's column
    alert_sink: object = field(default=None, repr=False)
    created_s: float = field(default_factory=time.time)
    # set under ``lock`` by StandingRegistry.remove: a refresh racing the
    # unregister returns instead of growing state the ledger credited back
    removed: bool = False

    # -- maintenance state (lock-guarded, the maintainer's) ----------------
    lock: threading.Lock = field(default_factory=threading.Lock, repr=False)
    retained: np.ndarray | None = field(default=None, repr=False)  # [G, J]
    labels: list | None = field(default=None, repr=False)  # [G] group labels
    grid_start_ms: int = 0  # out_t of retained[:, 0]
    grid_end_ms: int = 0
    raw_range: tuple | None = None  # the aligned (lo, hi) staging range
    versions: tuple | None = None  # the shard versions the partials cover
    shard_nums: tuple = ()
    window_ms: int = 0
    offset_ms: int = 0
    seq: int = 0  # refresh number (in every pushed payload)
    last_refresh_s: float = 0.0
    last_eval_duration_s: float = 0.0
    last_error: str | None = None
    last_payload: bytes | None = field(default=None, repr=False)
    last_rule_write_ms: int = 0
    stats: dict = field(default_factory=lambda: {
        "refreshes": 0, "delta": 0, "full": 0, "retained": 0, "reset": 0,
        "errors": 0, "steps_computed": 0, "steps_retained": 0, "renders": 0,
    })

    def num_steps(self) -> int:
        if self.grid_end_ms < self.grid_start_ms:
            return 0
        return int((self.grid_end_ms - self.grid_start_ms) // self.step_ms) + 1

    def state_nbytes(self) -> int:
        """The retained partials' bytes (the ledger's ``standing_state``)."""
        return int(self.retained.nbytes) if self.retained is not None else 0

    def snapshot(self) -> dict:
        return {
            "id": self.qid, "promql": self.promql, "dataset": self.dataset,
            "source": self.source, "mode": self.mode, "mode_reason": self.mode_reason,
            "step_ms": self.step_ms, "span_ms": self.span_ms, "window_ms": self.window_ms,
            "ws": self.ws, "ns": self.ns, "rule_name": self.rule_name,
            "eval_interval_s": self.eval_interval_s, "seq": self.seq,
            "groups": len(self.labels) if self.labels is not None else 0,
            "steps": self.num_steps(), "state_bytes": self.state_nbytes(),
            "last_refresh_s": self.last_refresh_s, "last_error": self.last_error,
            "stats": dict(self.stats),
        }


def _standing_state_walker(registry) -> int:
    """Every registered query's retained bytes, counted cold (the ledger's
    drift check of ``standing_state``)."""
    return sum(sq.state_nbytes() for sq in registry.list())


class StandingRegistry:
    """The registered standing queries of one engine, and the demotion
    memory the promoter's hysteresis reads."""

    def __init__(self, max_standing: int = 64):
        from ..ledger import LEDGER

        self.max_standing = max(int(max_standing), 1)
        self._queries: dict[str, StandingQuery] = {}
        self._by_key: dict = {}  # ring key -> qid (promoted entries)
        # key -> {"reason", "at_s"}: sticky reasons never promote again,
        # idle demotions age out (the engine's demote_retry_s)
        self.demoted: dict = {}
        self._lock = threading.Lock()
        self.ledger = LEDGER.register(self, "standing_state", _standing_state_walker,
                                      name="standing")

    def add(self, sq: StandingQuery) -> StandingQuery:
        with self._lock:
            if len(self._queries) >= self.max_standing:
                raise ValueError(f"standing registry at max_standing={self.max_standing}")
            self._queries[sq.qid] = sq
            if sq.key is not None:
                self._by_key[sq.key] = sq.qid
        self._publish_gauges()
        return sq

    def remove(self, qid: str) -> StandingQuery | None:
        with self._lock:
            sq = self._queries.pop(qid, None)
            if sq is not None and sq.key is not None:
                self._by_key.pop(sq.key, None)
        if sq is not None:
            # a refresh in flight holds sq.lock and settles the account when
            # it commits: credit the state back after it, and mark the query
            # removed so later refreshes return without growing it again
            with sq.lock:
                sq.removed = True
                nb = sq.state_nbytes()
                sq.retained = None
                sq.labels = None
            if nb:
                self.ledger.free(nb, reason="drop", count=0)
            self._publish_gauges()
        return sq

    def account_state(self, old_nbytes: int, new_nbytes: int) -> None:
        """Debit or credit the ledger for a resize of retained partials
        (byte adjustments, never entry counts)."""
        if new_nbytes > old_nbytes:
            self.ledger.alloc(new_nbytes - old_nbytes, count=0)
        elif old_nbytes > new_nbytes:
            self.ledger.free(old_nbytes - new_nbytes, reason="replace", count=0)

    def get(self, qid: str) -> StandingQuery | None:
        with self._lock:
            return self._queries.get(qid)

    def by_key(self, key) -> StandingQuery | None:
        with self._lock:
            qid = self._by_key.get(key)
            return self._queries.get(qid) if qid is not None else None

    def list(self) -> list[StandingQuery]:
        with self._lock:
            return list(self._queries.values())

    def rules(self) -> list[StandingQuery]:
        return [sq for sq in self.list() if sq.rule_name]

    def note_demoted(self, key, reason: str) -> None:
        if key is None:
            return
        with self._lock:
            self.demoted[key] = {"reason": reason, "at_s": time.time()}
            while len(self.demoted) > 256:  # the oldest memories go first
                self.demoted.pop(next(iter(self.demoted)))

    def demoted_reason(self, key) -> str | None:
        with self._lock:
            e = self.demoted.get(key)
            return e["reason"] if e else None

    def forget_demoted(self, key) -> None:
        with self._lock:
            self.demoted.pop(key, None)

    def _publish_gauges(self) -> None:
        with self._lock:
            by_mode: dict[str, int] = {}
            for sq in self._queries.values():
                by_mode[sq.mode] = by_mode.get(sq.mode, 0) + 1
        for mode in ("delta", "full"):
            REGISTRY.gauge("filodb_standing_queries", mode=mode).set(float(by_mode.get(mode, 0)))

    def snapshot(self) -> dict:
        with self._lock:
            queries = [sq.snapshot() for sq in self._queries.values()]
            demoted = [{"key": repr(k), **v} for k, v in self.demoted.items()]
        return {"queries": queries, "count": len(queries), "max_standing": self.max_standing,
                "demoted": demoted}
