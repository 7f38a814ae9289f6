"""Query dispatch scheduling: per-tenant admission and cross-query
micro-batching of fused launches (counterpart of
``filodb_tpu/query/scheduler.py``).

- ``AdmissionController``: per-tenant token-bucket rate and concurrency
  quotas (config ``query.tenant_quotas``, tenants from
  ``metering.tenant_of_plan``) and a global queue-depth bound, consulted
  by ``QueryEngine`` before execution. A shed raises
  ``AdmissionRejected``, which the HTTP edge answers with 429, a
  ``Retry-After`` header and a structured warning. Buckets run in
  device-seconds priced by the cost model (``query/costmodel.py``).
- ``DispatchScheduler``: concurrent ``FusedAggregateExec`` launches over
  the same superblock with the same function and epilogue signature
  collect for a short window (``query.batch_window_ms``) and run as ONE
  launch of the rung's lane mode (``ops/aggregations.fused_batched_scalar``
  / ``fused_batched_hist``): the unique windows' range grids once each,
  every lane's epilogue with its own group ids. Identical dispatch specs
  share one lane; a sealing leader merges the still-open groups that
  differ only in the window triple into its launch.

Unlike the JAX package, a batched launch is never wrapped in a fallback:
whether a group can batch is decided before the launch, by predicates
(``aggregations.batch_variant_supported`` before grouping; block identity
by ``is`` and every lane's rung at execute time, ``batch_lanes_ok``). A
group that a predicate declines runs each lane solo, counted under the
outcome ``fallback``; a batched launch that fails reaches every lane's
caller, counted as ``error``.

Pre-warm: an engine registers a closure (``register_prewarmer``) that runs
one recurrence-ring descriptor off the serving path; ``prewarm_tick``
picks the keys seen ``prewarm_min_count`` times and runs each once, so
its kernel module is loaded, its superblock cached and its group ids
built before the first real poll. A failed pre-warm is counted
(``filodb_prewarm_total{outcome="error"}``) and kept in ``snapshot()``;
it changes no path the query takes.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeout
from dataclasses import dataclass
from typing import Any, Callable

from ..metrics import REGISTRY
from ..ops.group_acc import MAX_LANES
from .costmodel import DEFAULT_PRIOR_COST_S
from .exec.transformers import QueryDeadlineExceeded, QueryError

# -- admission control ---------------------------------------------------------


class AdmissionRejected(QueryError):
    """A query shed by admission control (an over-quota tenant or a
    saturated global queue): HTTP 429 with ``Retry-After:
    <retry_after_s>``."""

    retryable = False
    endpoint_failure = True

    def __init__(self, message: str, retry_after_s: float = 1.0, ws: str = "unknown",
                 ns: str = "unknown", outcome: str = "shed_rate",
                 predicted_cost_s: float = 0.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)
        self.ws = ws
        self.ns = ns
        self.outcome = outcome
        self.predicted_cost_s = float(predicted_cost_s)

    def warning(self) -> dict:
        """The structured warning of the error envelope."""
        return {
            "reason": "admission_rejected",
            "outcome": self.outcome,
            "ws": self.ws,
            "ns": self.ns,
            "retry_after_s": round(self.retry_after_s, 3),
            "predicted_cost_s": round(self.predicted_cost_s, 6),
            "error": str(self),
        }


class TokenBucket:
    """Token bucket with an injectable clock: ``rate`` tokens a second
    refill up to ``burst``; ``try_take`` returns 0.0 on success or the
    seconds until enough tokens accrue. A cost above the capacity is
    clamped to it, so the returned wait is always an achievable drain time
    (shed, wait the advertised seconds, admit). ``min_burst`` floors the
    capacity."""

    def __init__(self, rate: float, burst: float, clock: Callable[[], float] = time.monotonic,
                 min_burst: float = 1.0):
        self.rate = float(rate)
        self.burst = max(float(burst), float(min_burst))
        self._clock = clock
        self._tokens = self.burst
        self._last = clock()
        self._lock = threading.Lock()

    def _refill(self, now: float) -> None:
        if now > self._last:
            self._tokens = min(self.burst, self._tokens + (now - self._last) * self.rate)
            self._last = now

    def try_take(self, cost: float = 1.0) -> float:
        with self._lock:
            c = min(max(float(cost), 0.0), self.burst)
            now = self._clock()
            self._refill(now)
            # a nanosecond of tolerance: refill accumulates float error at
            # large clock values, and the Retry-After contract must hold
            if self._tokens >= c - 1e-9:
                self._tokens = max(self._tokens - c, 0.0)
                return 0.0
            if self.rate <= 0:
                return float("inf")
            return (c - self._tokens) / self.rate

    def balance(self) -> float:
        with self._lock:
            self._refill(self._clock())
            return self._tokens


@dataclass(frozen=True)
class TenantQuota:
    """One tenant's quota. Buckets run in device-seconds
    (``rate_device_s`` a second up to ``burst_device_s``); legacy
    query-count quotas (``rate``/``burst``) convert at the cost model's
    flat prior. A rate <= 0 disables the bucket, ``max_concurrent`` <= 0
    the concurrency cap."""

    rate: float = 0.0
    burst: float = 0.0
    max_concurrent: int = 0
    rate_device_s: float = 0.0
    burst_device_s: float = 0.0

    @classmethod
    def from_config(cls, cfg: dict) -> "TenantQuota":
        return cls(
            rate=float(cfg.get("rate", 0.0) or 0.0),
            burst=float(cfg.get("burst", 0.0) or 0.0),
            max_concurrent=int(cfg.get("max_concurrent", 0) or 0),
            rate_device_s=float(cfg.get("rate_device_s", 0.0) or 0.0),
            burst_device_s=float(cfg.get("burst_device_s", 0.0) or 0.0),
        )

    def device_rate(self, prior_cost_s: float) -> float:
        if self.rate_device_s > 0:
            return self.rate_device_s
        return self.rate * prior_cost_s

    def device_burst(self, prior_cost_s: float) -> float:
        if self.burst_device_s > 0:
            return self.burst_device_s
        if self.rate_device_s > 0:
            return max(self.rate_device_s, prior_cost_s)
        q_burst = self.burst if self.burst > 0 else max(self.rate, 1.0)
        return q_burst * prior_cost_s


class _TenantState:
    __slots__ = ("bucket", "quota", "in_flight", "shed")

    def __init__(self, quota: TenantQuota | None, clock, prior_cost_s: float = 1.0):
        self.quota = quota
        self.bucket = None
        if quota is not None and (quota.rate > 0 or quota.rate_device_s > 0):
            # capacity floor: one prior-priced query
            self.bucket = TokenBucket(quota.device_rate(prior_cost_s),
                                      quota.device_burst(prior_cost_s), clock,
                                      min_burst=prior_cost_s)
        self.in_flight = 0
        self.shed = 0


class AdmissionController:
    """Per-tenant quotas and a global queue-depth bound in front of query
    execution. ``quotas`` maps ``"ws/ns"`` (or ``"*"``, the default of
    every tenant without an entry, ``unknown`` included) to quota dicts;
    ``max_queued`` bounds admitted unfinished queries process-wide (0:
    unbounded). Outcomes count in ``filodb_admission_total{outcome,ws,ns}``
    under ``metering.MAX_TENANT_PAIRS``."""

    def __init__(self, quotas: dict | None = None, max_queued: int = 0,
                 clock: Callable[[], float] = time.monotonic,
                 retry_after_default_s: float = 1.0, prior_cost_s: float | None = None):
        self._quotas = {
            k: (q if isinstance(q, TenantQuota) else TenantQuota.from_config(q))
            for k, q in (quotas or {}).items()
        }
        self.max_queued = int(max_queued)
        self._clock = clock
        self.retry_after_default_s = float(retry_after_default_s)
        self.prior_cost_s = max(float(prior_cost_s if prior_cost_s is not None
                                      else DEFAULT_PRIOR_COST_S), 1e-6)
        self._states: dict[str, _TenantState] = {}
        self._in_flight = 0
        self._shed_total = 0
        self._lock = threading.Lock()

    def _quota_for(self, key: str) -> TenantQuota | None:
        return self._quotas.get(key) or self._quotas.get("*")

    def _state(self, key: str) -> _TenantState:
        st = self._states.get(key)
        if st is None:
            st = self._states[key] = _TenantState(self._quota_for(key), self._clock,
                                                  self.prior_cost_s)
        return st

    def _count(self, outcome: str, ws: str, ns: str) -> None:
        REGISTRY.counter("filodb_admission", outcome=outcome, ws=ws, ns=ns).inc()

    def _shed(self, st: _TenantState, outcome: str, ws: str, ns: str) -> None:
        st.shed += 1
        self._shed_total += 1
        self._count(outcome, ws, ns)

    def admit(self, ws: str, ns: str, cost_s: float | None = None):
        """Admit or shed one query of tenant (ws, ns), draining its bucket
        by ``cost_s`` (the flat prior when None). Returns a context manager
        that holds the tenant's and the global slots; raises
        ``AdmissionRejected`` with the bucket's drain time as
        ``retry_after_s``."""
        from ..metering import bounded_tenant_pair

        cost = float(cost_s) if cost_s is not None and cost_s > 0 else self.prior_cost_s
        ws, ns = bounded_tenant_pair(ws, ns)
        key = f"{ws}/{ns}"
        with self._lock:
            st = self._state(key)
            quota = st.quota
            if (quota is not None and quota.max_concurrent > 0
                    and st.in_flight >= quota.max_concurrent):
                self._shed(st, "shed_concurrency", ws, ns)
                raise AdmissionRejected(
                    f"tenant {key} at max_concurrent={quota.max_concurrent}",
                    retry_after_s=self.retry_after_default_s, ws=ws, ns=ns,
                    outcome="shed_concurrency")
            if self.max_queued > 0 and self._in_flight >= self.max_queued:
                self._shed(st, "shed_queue", ws, ns)
                raise AdmissionRejected(
                    f"query queue depth {self._in_flight} at bound {self.max_queued}",
                    retry_after_s=self.retry_after_default_s, ws=ws, ns=ns,
                    outcome="shed_queue")
            if st.bucket is not None:
                charge = cost
                if quota is not None and quota.rate_device_s <= 0:
                    # a query-count quota never charges less than one query
                    charge = max(cost, self.prior_cost_s)
                wait_s = st.bucket.try_take(charge)
                if wait_s > 0:
                    self._shed(st, "shed_rate", ws, ns)
                    raise AdmissionRejected(
                        f"tenant {key} over device-second quota "
                        f"({st.bucket.rate:g} dev-s/s; query predicted {cost:g} dev-s)",
                        retry_after_s=(min(wait_s, 60.0) if wait_s != float("inf")
                                       else self.retry_after_default_s),
                        ws=ws, ns=ns, outcome="shed_rate", predicted_cost_s=cost)
            st.in_flight += 1
            self._in_flight += 1
        self._count("admitted", ws, ns)
        return _Admitted(self, key)

    def _release(self, key: str) -> None:
        with self._lock:
            st = self._states.get(key)
            if st is not None and st.in_flight > 0:
                st.in_flight -= 1
            self._in_flight = max(0, self._in_flight - 1)

    def snapshot(self) -> dict:
        """Global depth and per-tenant balances, in-flight counts and shed
        totals (``/debug/scheduler``)."""
        with self._lock:
            tenants = {
                key: {
                    "in_flight": st.in_flight,
                    "shed": st.shed,
                    "tokens": round(st.bucket.balance(), 3) if st.bucket is not None else None,
                    "rate": st.quota.rate if st.quota else None,
                    "rate_device_s": (round(st.bucket.rate, 6)
                                      if st.bucket is not None else None),
                    "burst_device_s": (round(st.bucket.burst, 6)
                                       if st.bucket is not None else None),
                    "max_concurrent": st.quota.max_concurrent if st.quota else None,
                }
                for key, st in self._states.items()
            }
            return {
                "in_flight": self._in_flight,
                "max_queued": self.max_queued,
                "shed_total": self._shed_total,
                "unit": "device_seconds",
                "prior_cost_s": self.prior_cost_s,
                "tenants": tenants,
            }


class _Admitted:
    """A held admission slot, released on exit."""

    __slots__ = ("_ctl", "_key")

    def __init__(self, ctl: AdmissionController, key: str):
        self._ctl = ctl
        self._key = key

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._ctl._release(self._key)
        return False


# -- per-key recurrence ring ---------------------------------------------------


class KeyStatsRing:
    """Bounded per-key recurrence ring over fused-dispatch keys: a count,
    first/last-seen times, a short deque of recent observations and the
    latest descriptor per key, LRU-bounded. Observed on every fused
    dispatch, batching on or off. Its consumers (standing-query promotion,
    executable pre-warm) are ROADMAP A5b."""

    RECENT_MAX = 32

    __slots__ = ("max_entries", "_entries", "_lock", "_clock")

    def __init__(self, max_entries: int = 512, clock: Callable[[], float] = time.time):
        self.max_entries = max(int(max_entries), 1)
        self._entries: dict[Any, dict] = {}
        self._lock = threading.Lock()
        self._clock = clock

    def observe(self, key, desc: dict | None = None) -> None:
        now = self._clock()
        with self._lock:
            e = self._entries.pop(key, None)
            if e is None:
                e = {"count": 0, "first_s": now, "recent": deque(maxlen=self.RECENT_MAX),
                     "desc": None}
            e["count"] += 1
            e["last_s"] = now
            e["recent"].append(now)
            if desc is not None:
                e["desc"] = desc
            self._entries[key] = e
            while len(self._entries) > self.max_entries:
                self._entries.pop(next(iter(self._entries)))

    @staticmethod
    def _copy(e: dict) -> dict:
        return {"count": e["count"], "first_s": e["first_s"], "last_s": e["last_s"],
                "recent": tuple(e["recent"]), "desc": e.get("desc")}

    def entries(self) -> list[tuple[Any, dict]]:
        with self._lock:
            return [(k, self._copy(e)) for k, e in self._entries.items()]

    def get(self, key) -> dict | None:
        with self._lock:
            e = self._entries.get(key)
            return self._copy(e) if e is not None else None

    def snapshot(self, limit: int = 64) -> list[dict]:
        now = self._clock()
        out = []
        items = self.entries()
        for key, e in reversed(items[-limit:] if limit else items):
            recent = e["recent"]
            out.append({
                "key": repr(key), "count": e["count"],
                "age_s": round(now - e["first_s"], 3), "idle_s": round(now - e["last_s"], 3),
                "recent": len(recent),
                "recent_span_s": round(recent[-1] - recent[0], 3) if len(recent) > 1 else 0.0,
                "desc": e.get("desc"),
            })
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


# -- micro-batching dispatch ---------------------------------------------------


@dataclass
class FusedRequest:
    """One fused launch a query wants, built by ``FusedAggregateExec``
    after superblock resolution and group-id memoization, so batching never
    bypasses limits, stats or cache maintenance: only the launch is
    shared. ``gids_dev`` is the lane's grouping: the int64 [S_pad] group
    ids of ``agg``/``hist`` lanes, ``zero_gids`` for ``topk``, the
    ``order_stats.Members`` for ``quantile`` (memoized on the block, so its
    identity is stable for the block's life)."""

    block: Any
    func: str
    kind: str  # "agg" | "topk" | "quantile" | "hist"
    epilogue: tuple  # ("agg", op) | ("topk", k, bottom) | ("quantile",) | ()
    gids_dev: Any
    G: int
    qv: float  # quantile q or histogram quantile q; 0.0 otherwise
    params: Any  # RangeParams
    j_pad: int
    is_counter: bool
    is_delta: bool
    les_dev: Any = None
    hist_q: bool = False
    run_single: Callable[[], Any] = None
    timeout_s: float = 60.0
    predicted_cost_s: float = 0.0
    # the group's launch wall seconds, stamped by the executing leader
    # before the future resolves (shared by every lane of a batch)
    exec_seconds: float | None = None

    def family(self) -> str:
        return self.kind

    def g_bucket(self) -> int:
        """Power-of-two bucket of the lane's group count: heavy and light
        group-bys batch apart."""
        from ..ops.aggregations import _pow2

        return _pow2(self.G)

    def group_key(self) -> tuple:
        """Coalescing key: block identity (checked again by ``is`` at
        execute time), the grid triple, function, epilogue statics and the
        group-count bucket."""
        p = self.params
        return (id(self.block), self.func, self.kind, self.epilogue, self.j_pad,
                p.start_ms, p.step_ms, p.window_ms, self.g_bucket(), self.is_counter,
                self.is_delta, self.hist_q)

    def merge_key(self) -> tuple:
        """``group_key`` without the grid triple: groups agreeing on it run
        one launch whose lane table routes each lane to its window."""
        return (id(self.block), self.func, self.kind, self.epilogue, self.j_pad,
                self.g_bucket(), self.is_counter, self.is_delta, self.hist_q)

    def lane_key(self) -> tuple:
        """Dedup key within a group: requests equal on every per-query
        dynamic share one lane."""
        p = self.params
        return (p.start_ms, p.step_ms, p.num_steps, p.window_ms, float(self.qv),
                id(self.gids_dev), self.G)

    def lane(self) -> tuple:
        """The ops layer's lane: (grouping, G, q, params)."""
        return (self.gids_dev, self.G, self.qv, self.params)


def batch_lanes_ok(requests: list[FusedRequest]) -> bool:
    """Whether one lane-mode launch may serve ``requests``: they share the
    block object and every lane's solo run takes the same rung with a lane
    mode (``aggregations.lanes_variant``)."""
    from ..ops import aggregations as AGG

    r0 = requests[0]
    if any(r.block is not r0.block for r in requests[1:]):
        return False  # id reuse after GC, or a superblock swapped mid-window
    return AGG.lanes_variant(r0.block, r0.func, r0.kind, r0.is_delta,
                             [r.params for r in requests]) is not None


def _run_batch(requests: list[FusedRequest]) -> list:
    """One lane-mode launch for the group; each request's output in
    ``run_single``'s shape. Lanes go in a canonical order (the lane key),
    so a recurring composition reuses its memoized stacks."""
    from ..ops import aggregations as AGG

    r0 = requests[0]
    order = sorted(range(len(requests)), key=lambda i: requests[i].lane_key())
    lanes = [requests[i].lane() for i in order]
    if r0.kind == "hist":
        out = AGG.fused_batched_hist(r0.func, r0.block, lanes, r0.les_dev, r0.hist_q,
                                     r0.is_delta)
    else:
        out = AGG.fused_batched_scalar(r0.func, r0.epilogue, r0.block, lanes,
                                       r0.is_counter, r0.is_delta)
    results: list = [None] * len(requests)
    for pos, i in enumerate(order):
        results[i] = out[pos]
    return results


class _Group:
    # sealed exactly when no longer in the scheduler's _open table (removed
    # under its lock); ``stolen``: absorbed into another leader's launch
    __slots__ = ("lanes", "closed", "last_join", "mkey", "stolen")

    def __init__(self, mkey: tuple = ()):
        self.lanes: dict[tuple, tuple[FusedRequest, Future]] = {}
        self.closed = threading.Event()
        self.last_join = time.monotonic()
        self.mkey = mkey
        self.stolen = False


class DispatchScheduler:
    """Micro-batching dispatcher (see the module docstring).

    ``window_ms`` is the collection window a group's leader holds open (0:
    batching disabled, every dispatch runs as before). ``max_batch``
    closes a group early and bounds a merged launch; it is capped at the
    lane modes' ``MAX_LANES`` (the JAX scheduler has no cap), and a join
    that finds its group closed opens a new one. ``waiter`` (tests)
    receives the group's close event and the window seconds and returns
    when the window ends. With ``window_cap_ms`` > ``window_ms`` > 0 the
    window is adaptive: the cap scaled by the decayed predicted queue cost
    over ``load_ref_cost_s``."""

    def __init__(self, window_ms: float = 0.0, max_batch: int = 32,
                 waiter: Callable[[threading.Event, float], Any] | None = None,
                 key_ring_max: int = 512, window_cap_ms: float = 0.0,
                 load_ref_cost_s: float = 0.25, prior_cost_s: float | None = None,
                 prewarm_min_count: int = 3, clock: Callable[[], float] = time.monotonic):
        self.base_window_s = max(float(window_ms), 0.0) / 1e3
        self.window_cap_s = max(float(window_cap_ms), 0.0) / 1e3
        self.adaptive = self.window_cap_s > self.base_window_s > 0
        self.load_ref_cost_s = max(float(load_ref_cost_s), 1e-6)
        self.prior_cost_s = max(float(prior_cost_s if prior_cost_s is not None
                                      else DEFAULT_PRIOR_COST_S), 1e-6)
        self.max_batch = min(max(int(max_batch), 1), MAX_LANES)
        self._waiter = waiter
        self._open: dict[tuple, _Group] = {}
        self._lock = threading.Lock()
        self._queued = 0
        # decayed predicted queue cost; its own lock, never nested under _lock
        self._clock = clock
        self._load_lock = threading.Lock()
        self._load_tau_s = 2.0
        self._load_cost_s = 0.0
        self._load_stamp = clock()
        self.key_ring = KeyStatsRing(key_ring_max)
        # pre-warm: the engine's executor, the keys already run, the bar
        self._prewarm_exec: Callable[[dict], Any] | None = None
        self._prewarmed: dict = {}
        self.prewarm_min_count = max(int(prewarm_min_count), 1)
        self.prewarm_last_error: str | None = None
        self.stats = {"queries": 0, "batched": 0, "solo": 0, "fallback": 0, "error": 0,
                      "coalesced": 0, "dispatches": 0, "merged_windows": 0, "prewarmed": 0,
                      "prewarm_errors": 0}

    def observe_key(self, key, desc: dict | None = None) -> None:
        self.key_ring.observe(key, desc)

    @property
    def enabled(self) -> bool:
        return self.base_window_s > 0

    @property
    def window_s(self) -> float:
        """The effective collection window."""
        if not self.adaptive:
            return self.base_window_s
        return self.window_cap_s * min(self._load() / self.load_ref_cost_s, 1.0)

    def _load(self) -> float:
        with self._load_lock:
            dt = self._clock() - self._load_stamp
            return self._load_cost_s * (math.exp(-dt / self._load_tau_s) if dt > 0 else 1.0)

    def _note_load(self, cost_s: float) -> None:
        with self._load_lock:
            now = self._clock()
            dt = now - self._load_stamp
            if dt > 0:
                self._load_cost_s *= math.exp(-dt / self._load_tau_s)
                self._load_stamp = now
            self._load_cost_s += max(float(cost_s), 0.0)

    def register_prewarmer(self, fn: Callable[[dict], Any]) -> None:
        """Install the closure that runs one ring descriptor off the serving
        path; the first registration wins (the primary engine is built
        first)."""
        if self._prewarm_exec is None:
            self._prewarm_exec = fn

    def prewarm_tick(self, limit: int = 2, storms: dict | None = None) -> list:
        """One pre-warm pass: run up to ``limit`` ring keys seen at least
        ``prewarm_min_count`` times (once, if ``storms`` holds any
        recompile-storm annotation) through the registered executor, each
        key once. The port has no kernel registry yet (ROADMAP A6), so
        ``storms`` None is ``{}``. Returns the keys warmed."""
        if self._prewarm_exec is None:
            return []
        min_count = 1 if storms else self.prewarm_min_count
        picks = []
        for key, e in self.key_ring.entries():
            if key in self._prewarmed or e["count"] < min_count:
                continue
            desc = e.get("desc")
            if not desc or not desc.get("promql"):
                continue
            picks.append((key, desc))
            if len(picks) >= max(int(limit), 1):
                break
        warmed = []
        for key, desc in picks:
            self._prewarmed[key] = True
            while len(self._prewarmed) > 4 * self.key_ring.max_entries:
                self._prewarmed.pop(next(iter(self._prewarmed)))
            try:
                self._prewarm_exec(desc)
            except Exception as e:  # noqa: BLE001 -- advisory: counted and kept, never rerouted
                with self._lock:
                    self.stats["prewarm_errors"] += 1
                self.prewarm_last_error = f"{type(e).__name__}: {e}"
                REGISTRY.counter("filodb_prewarm", outcome="error").inc()
                continue
            with self._lock:
                self.stats["prewarmed"] += 1
            REGISTRY.counter("filodb_prewarm", outcome="ok").inc()
            warmed.append(key)
        return warmed

    def dispatch(self, request: FusedRequest):
        """Submit one fused dispatch and return its output: the group's
        leader executes for every lane, followers wait."""
        if not self.enabled:
            return request.run_single()
        self._note_load(request.predicted_cost_s if request.predicted_cost_s > 0
                        else self.prior_cost_s)
        fam = request.family()
        key = request.group_key()
        lane = request.lane_key()
        with self._lock:
            self.stats["queries"] += 1
            group = self._open.get(key)
            leader = group is None or group.closed.is_set()
            if leader:
                group = _Group(mkey=request.merge_key())
                self._open[key] = group
            have = group.lanes.get(lane)
            group.last_join = time.monotonic()
            if have is None:
                fut = Future()
                group.lanes[lane] = (request, fut)
                self._queued += 1
            else:
                fut = have[1]
                self.stats["coalesced"] += 1
            if len(group.lanes) >= self.max_batch:
                group.closed.set()
            queued = self._queued
        REGISTRY.counter("filodb_batch_queries", family=fam).inc()
        REGISTRY.gauge("filodb_batch_queue_depth").set(float(queued))
        if leader:
            if self._waiter is not None:
                self._waiter(group.closed, self.window_s)
            else:
                self._collect(group)
            merged = 0
            with self._lock:
                if group.stolen:
                    lanes = None  # another leader absorbed this group
                else:
                    if self._open.get(key) is group:
                        del self._open[key]
                    lanes = list(group.lanes.values())
                    # absorb still-open groups that differ only in the
                    # window triple, within max_batch
                    for k2 in [k for k, g in self._open.items() if g.mkey == group.mkey]:
                        g2 = self._open[k2]
                        if len(lanes) + len(g2.lanes) > self.max_batch:
                            continue
                        del self._open[k2]
                        g2.stolen = True
                        g2.closed.set()
                        lanes.extend(g2.lanes.values())
                        merged += 1
                    self._queued -= len(lanes)
                    self.stats["merged_windows"] += merged
                queued = self._queued
            if lanes is not None:
                if merged:
                    REGISTRY.counter("filodb_batch_merged_windows", family=fam).inc(merged)
                REGISTRY.gauge("filodb_batch_queue_depth").set(float(queued))
                self._execute(fam, lanes)
        try:
            return fut.result(timeout=max(request.timeout_s, 0.001))
        except FutureTimeout:
            raise QueryDeadlineExceeded(
                f"query exceeded deadline: {request.timeout_s:.1f}s waiting on batched "
                "dispatch") from None

    def _collect(self, group: _Group) -> None:
        """Hold the window open until it elapses, the group reaches
        max_batch, or joins go quiet for a quarter of the window (so a
        round of resubmitting clients dispatches as soon as it has
        joined, and a lone query waits only the gap)."""
        w = self.window_s
        deadline = time.monotonic() + w
        gap = w / 4
        while True:
            now = time.monotonic()
            if group.closed.is_set() or now >= deadline:
                return
            idle = now - group.last_join
            if idle >= gap:
                return
            group.closed.wait(min(deadline - now, gap - idle))

    @staticmethod
    def _run_solo(lanes: list) -> None:
        for req, fut in lanes:
            t0 = time.perf_counter()
            try:
                out = req.run_single()
            except Exception as e:  # noqa: BLE001 — delivered to the caller
                req.exec_seconds = time.perf_counter() - t0
                fut.set_exception(e)
                continue
            req.exec_seconds = time.perf_counter() - t0
            fut.set_result(out)

    def _execute(self, fam: str, lanes: list) -> None:
        """One lane-mode launch for more than one lane, the solo dispatch
        for one; a group ``batch_lanes_ok`` declines runs every lane solo
        (``fallback``); a failed batched launch reaches every lane
        (``error``)."""
        reqs = [req for req, _ in lanes]
        if len(lanes) == 1:
            outcome = "solo"
            self._run_solo(lanes)
        elif not batch_lanes_ok(reqs):
            outcome = "fallback"
            self._run_solo(lanes)
        else:
            outcome = "batched"
            t0 = time.perf_counter()
            try:
                results = _run_batch(reqs)
            except Exception as e:  # noqa: BLE001 — every lane's caller sees it
                outcome = "error"
                for req, fut in lanes:
                    req.exec_seconds = time.perf_counter() - t0
                    fut.set_exception(e)
            else:
                batch_s = time.perf_counter() - t0
                for req in reqs:
                    req.exec_seconds = batch_s
                for (_, fut), res in zip(lanes, results):
                    fut.set_result(res)
        with self._lock:
            self.stats[outcome] += 1
            self.stats["dispatches"] += 1
        REGISTRY.counter("filodb_batch_dispatches", family=fam, outcome=outcome).inc()

    def snapshot(self) -> dict:
        """Window config, live queue state and cumulative outcomes
        (``/debug/scheduler``)."""
        eff_ms = self.window_s * 1e3  # takes the load lock: outside _lock
        load = self._load()
        with self._lock:
            out = {
                "window_ms": eff_ms,
                "base_window_ms": self.base_window_s * 1e3,
                "window_cap_ms": self.window_cap_s * 1e3,
                "adaptive": self.adaptive,
                "load_cost_s": round(load, 6),
                "max_batch": self.max_batch,
                "open_groups": len(self._open),
                "queued_lanes": self._queued,
                **self.stats,
            }
        out["standing_keys"] = len(self.key_ring)
        out["prewarm_last_error"] = self.prewarm_last_error
        return out
