"""Metrics and tracing of the port (counterpart of ``filodb_tpu/metrics.py``;
reference FilodbMetrics.scala Kamon facade and Kamon spans).

- ``Registry``: counters, gauges and histograms (``MicroHistogram`` for
  the index's microsecond lookups) with their Prometheus text
  exposition (served at /metrics by ``api/http.py``), plus scrape-time
  collectors for gauges refreshed on demand (the device ledger's, the
  shards').
- ``span`` / ``Span`` / ``TraceContext``: spans carrying (trace_id,
  span_id, parent_id) and tags; ``trace_to_dict`` renders a query's tree
  for ``?trace=true``.
- ``SlowQueryLog``: the ring of queries past the slow-query threshold
  (/debug/slow_queries).
- ``record_fused_fallback``: the fused path's fallback and degraded-kernel
  reasons (``filodb_fused_fallback_total{reason}``).
- ``record_superblock_event`` / ``superblock_events``: the superblock
  cache's maintenance outcomes, as a counter family and as a dict that
  tests and ``chip_smoke.py`` read.

The query observatories of the JAX package (``obs/*``: querylog, kernels,
SLOs, alerting) and its sampling profiler are not ported yet (ROADMAP A6).
"""

from __future__ import annotations

import bisect
import contextlib
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field


class Counter_:
    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0):
        with self._lock:
            self.value += amount


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float):
        self.value = v


class Histogram:
    """Fixed-bucket latency histogram (seconds)."""

    BOUNDS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

    def __init__(self):
        self.counts = [0] * (len(self.BOUNDS) + 1)
        self.sum = 0.0
        self.total = 0
        # last exemplar per bucket: (labels dict, value, unix_ts) — rendered
        # on OpenMetrics bucket lines so a spiking latency bucket links
        # straight to its trace (and through it the slow-query log)
        self.exemplars: list = [None] * (len(self.BOUNDS) + 1)
        self._lock = threading.Lock()

    def observe(self, v: float, exemplar: dict | None = None):
        i = bisect.bisect_left(self.BOUNDS, v)
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            self.total += 1
            if exemplar:
                self.exemplars[i] = (dict(exemplar), float(v), time.time())


class MicroHistogram(Histogram):
    """Histogram with sub-millisecond bounds for host paths that complete in
    microseconds (index lookups): the standard bounds start at 1 ms."""

    BOUNDS = (5e-6, 1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4,
              1e-3, 5e-3, 2.5e-2, 0.1, 0.5)


def escape_label_value(v) -> str:
    """Prometheus text-format label escaping: backslash, double-quote and
    newline must be escaped or the exposition line is unparseable."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def escape_help(v: str) -> str:
    """# HELP line escaping (backslash and newline only, per the spec)."""
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


# help text per metric family the port emits (the registered name: counters
# without the ``_total`` suffix the exposition appends)
HELP_TEXTS: dict[str, str] = {
    "filodb_queries": "Queries served, per dataset (coalesced followers included).",
    "filodb_query_latency_seconds": "End-to-end query latency.",
    "filodb_slow_queries": "Queries over the slow-query threshold (see /debug/slow_queries).",
    "filodb_fused_fallback": "Fused single-dispatch aggregates delegated to the reference tree, by reason.",
    "filodb_superblock_maintenance": "Version-stale superblock maintenance outcomes (revalidate|extend|extend_abort|restage).",
    "filodb_shard_partitions": "Live partitions per shard.",
    "filodb_shard_rows_ingested": "Rows ingested per shard.",
    "filodb_device_bytes": "Live device bytes per ledger kind (staged_block|superblock|compile_cache|standing_state|index_postings|rollup).",
    "filodb_device_alloc": "Ledger debits (entries pinned) per kind.",
    "filodb_device_alloc_bytes": "Bytes debited to the device ledger per kind.",
    "filodb_device_free": "Ledger credits per kind and reason (evict|invalidate|replace|drop).",
    "filodb_device_free_bytes": "Bytes credited back to the device ledger per kind and reason.",
    "filodb_device_leaked_bytes": "Bytes held by ledger accounts whose cache died without releasing.",
    "filodb_http_responses": "HTTP API responses by status code and class (2xx|4xx|shed|5xx|stream_abort).",
    "filodb_render_seconds": "Result-body encode seconds per format (json-native|json-numpy JSON tiers, arrow peer frames).",
    "filodb_response_bytes": "Uncompressed result-body bytes sent per format (json|arrow).",
    "filodb_render_stream_stalls": "Streamed-render encoder waits on a device->host block (D2H the double-buffer failed to hide).",
    "filodb_index_lookup_seconds": "Part-key index lookup latency by matcher cost class (eq|in|prefix|regex|neg).",
    "filodb_index_postings_bytes": "Host posting-bitmap footprint of the part-key index, per shard.",
    "filodb_index_device_staged_bytes": "Posting bitmaps staged to the device by the index's opt-in hot tier, per shard.",
    "filodb_index_dictionary_size": "Distinct (label, value) dictionary entries in the part-key index, per shard.",
}


class Registry:
    def __init__(self):
        self._metrics: dict[tuple[str, tuple], object] = {}
        # scrape-time collectors: keyed callbacks run at the top of expose()
        # to refresh gauges that mirror live state (per-shard stats etc.) —
        # ONE exposition path instead of handlers hand-rolling text
        self._collectors: dict[str, object] = {}
        self._help: dict[str, str] = {}
        self._lock = threading.Lock()

    def register_collector(self, key: str, fn) -> None:
        """Register (or replace) a zero-arg callback invoked at scrape time
        before rendering. Keyed so re-created servers replace, not stack."""
        with self._lock:
            self._collectors[key] = fn

    def unregister_collector(self, key: str) -> None:
        with self._lock:
            self._collectors.pop(key, None)

    def _get(self, cls, name: str, labels: dict | None):
        key = (name, tuple(sorted((labels or {}).items())))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls()
                self._metrics[key] = m
            return m

    def counter(self, name: str, **labels) -> Counter_:
        return self._get(Counter_, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def micro_histogram(self, name: str, **labels) -> MicroHistogram:
        """Histogram with microsecond buckets (a family keeps one layout:
        this or ``histogram``, never both)."""
        return self._get(MicroHistogram, name, labels)

    def _render_exemplar(self, ex) -> str:
        labels, value, ts = ex
        inner = ",".join(
            f'{k}="{escape_label_value(v)}"' for k, v in labels.items()
        )
        return f" # {{{inner}}} {value:g} {ts:.3f}"

    def expose(self, openmetrics: bool = False) -> str:
        """Prometheus text exposition of everything registered, with
        ``# HELP``/``# TYPE`` per family. ``openmetrics=True`` renders
        OpenMetrics 1.0 instead: family names lose the ``_total`` suffix in
        metadata lines, histogram bucket lines carry trace-id exemplars,
        and the payload ends with ``# EOF``."""
        with self._lock:
            collectors = list(self._collectors.values())
        for fn in collectors:
            try:
                fn()
            except Exception:  # noqa: BLE001 — a sick collector must not kill /metrics
                pass
        lines = []
        with self._lock:
            items = sorted(self._metrics.items(), key=lambda kv: kv[0][0])
            help_map = dict(self._help)
        seen_families: set[str] = set()

        def header(name: str, mtype: str):
            # text format 0.0.4 names counter families WITH the _total
            # suffix samples carry; OpenMetrics strips it
            family = (
                name if (openmetrics or mtype != "counter") else f"{name}_total"
            )
            if family in seen_families:
                return
            seen_families.add(family)
            help_text = help_map.get(name, HELP_TEXTS.get(name))
            if help_text:
                lines.append(f"# HELP {family} {escape_help(help_text)}")
            lines.append(f"# TYPE {family} {mtype}")

        for (name, labels), m in items:
            lbl = (
                "{" + ",".join(f'{k}="{escape_label_value(v)}"' for k, v in labels) + "}"
                if labels else ""
            )
            if isinstance(m, Counter_):
                header(name, "counter")
                lines.append(f"{name}_total{lbl} {m.value:g}")
            elif isinstance(m, Gauge):
                header(name, "gauge")
                lines.append(f"{name}{lbl} {m.value:g}")
            elif isinstance(m, Histogram):
                header(name, "histogram")
                base = [f'{k}="{escape_label_value(v)}"' for k, v in labels]
                cum = 0
                for i, (b, c) in enumerate(zip(m.BOUNDS, m.counts)):
                    cum += c
                    inner = ",".join(base + [f'le="{b:g}"'])
                    ex = m.exemplars[i] if openmetrics else None
                    suffix = self._render_exemplar(ex) if ex else ""
                    lines.append(f"{name}_bucket{{{inner}}} {cum}{suffix}")
                inner = ",".join(base + ['le="+Inf"'])
                ex = m.exemplars[-1] if openmetrics else None
                suffix = self._render_exemplar(ex) if ex else ""
                lines.append(f"{name}_bucket{{{inner}}} {m.total}{suffix}")
                lines.append(f"{name}_sum{lbl} {m.sum:g}")
                lines.append(f"{name}_count{lbl} {m.total}")
        if openmetrics:
            lines.append("# EOF")
        return "\n".join(lines) + "\n"


REGISTRY = Registry()


# -- tracing ----------------------------------------------------------------

_trace_local = threading.local()

def new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


@dataclass(frozen=True)
class TraceContext:
    """The portable identity of an active span: what crosses thread pools
    (by reference, via ``current_span``/``activate``) and process
    boundaries (by value, via gRPC call metadata / HTTP headers)."""

    trace_id: str
    span_id: str
    parent_id: str | None = None

    # wire names, shared by the gRPC metadata keys and HTTP headers
    TRACE_ID_HEADER = "X-FiloDB-Trace-Id"
    PARENT_SPAN_HEADER = "X-FiloDB-Parent-Span"


@dataclass
class Span:
    name: str
    start_ns: int
    end_ns: int = 0
    children: list = field(default_factory=list)
    trace_id: str = ""
    span_id: str = field(default_factory=new_span_id)
    parent_id: str | None = None
    # free-form annotations (retries, breaker states, lost children, plan
    # args); must stay JSON-serializable — they cross the wire in to_dict()
    tags: dict = field(default_factory=dict)
    # per-node QueryStats delta (series/samples scanned, bytes staged, ...)
    stats: dict = field(default_factory=dict)

    @property
    def duration_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    def context(self) -> TraceContext:
        return TraceContext(self.trace_id, self.span_id, self.parent_id)

    def to_dict(self) -> dict:
        """JSON form: the EXPLAIN ANALYZE / slow-query-log rendering and the
        in-band cross-node trace payload (durations, never raw clocks — the
        perf counters of two processes do not compare)."""
        d = {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "duration_ms": round(self.duration_ms, 3),
        }
        if self.tags:
            d["tags"] = self.tags
        if self.stats:
            d["stats"] = self.stats
        d["children"] = [c.to_dict() for c in self.children]
        return d

_UNSET = object()


@contextlib.contextmanager
def span(name: str, parent=_UNSET, **tags):
    """Nested timing spans (Kamon.runWithSpan analog). The thread-local
    current span is the default parent; an explicit ``parent=`` Span wires a
    span into a trace across thread hops. The root span of a thread is
    retrievable via current_trace()."""
    cur = getattr(_trace_local, "current", None)
    eff_parent = cur if cur is not None else (None if parent is _UNSET else parent)
    s = Span(name, time.perf_counter_ns())
    if tags:
        s.tags.update(tags)
    if eff_parent is not None:
        s.trace_id = eff_parent.trace_id
        s.parent_id = eff_parent.span_id
        eff_parent.children.append(s)
    else:
        s.trace_id = new_trace_id()
        _trace_local.root = s
    _trace_local.current = s
    try:
        yield s
    finally:
        s.end_ns = time.perf_counter_ns()
        _trace_local.current = cur


def trace_to_dict(trace) -> dict | None:
    """Normalize a QueryResult.trace (local Span or already-rendered dict
    from a remote peer) to its JSON form."""
    if trace is None:
        return None
    return trace.to_dict() if isinstance(trace, Span) else trace


# -- slow-query log ---------------------------------------------------------




class SlowQueryLog:
    """Ring buffer of queries that exceeded the slow-query threshold, each
    entry carrying the PromQL, duration, QueryStats and the rendered trace
    tree (served at /debug/slow_queries; counted as
    filodb_slow_queries_total in /metrics)."""

    def __init__(self, max_entries: int = 64):
        self._entries: deque = deque(maxlen=max_entries)
        self._lock = threading.Lock()

    def configure(self, max_entries: int) -> None:
        with self._lock:
            self._entries = deque(self._entries, maxlen=max(1, int(max_entries)))

    def record(self, promql: str, duration_s: float, dataset: str = "",
               trace=None, stats: dict | None = None,
               query_id: str | None = None) -> None:
        entry = {
            "time": time.time(),
            "dataset": dataset,
            "promql": promql,
            "duration_s": round(float(duration_s), 6),
            "stats": stats or {},
            "trace": trace_to_dict(trace),
        }
        if query_id:
            # link to the query observatory: the same execution's
            # exemplar-level cost record (obs/querylog.py) is one GET away
            # instead of a disjoint debug surface
            entry["query_id"] = query_id
            entry["profile"] = f"/api/v1/query_profile?id={query_id}"
        with self._lock:
            self._entries.append(entry)
        REGISTRY.counter("filodb_slow_queries", dataset=dataset).inc()

    def entries(self) -> list[dict]:
        """Newest first."""
        with self._lock:
            return list(reversed(self._entries))

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


SLOW_QUERY_LOG = SlowQueryLog()


# the fused path's fallback reason taxonomy (the JAX package's): the tree
# fallbacks delegate to the reference tree; the grid_* entries are
# degraded-kernel reasons, where the dispatch stays one launch on a rung
# without the grid's own variant
FUSED_FALLBACK_REASONS = frozenset({
    "partial_results", "dispatcher", "mixed_schemas", "hist_scheme",
    "hist_op", "hist_func", "hist_quantile_scalar", "mesh_unsupported",
    "grid_jitter", "grid_holes", "standing_nondecomposable",
    "rollup_ineligible", "stage_span",
})


def record_fused_fallback(reason: str) -> None:
    """A FusedAggregateExec delegated to its reference scatter tree at
    runtime — or, for the ``grid_*`` reasons, degraded a jittered/holey
    grid to the general fused kernel. Exposed as
    ``filodb_fused_fallback_total{reason=...}`` so operators see
    fused-path coverage at aggregate level (the reason was previously only
    a span tag, visible per-query only); doc/perf.md documents the reason
    taxonomy, and an unknown reason label is a bug caught here rather than
    minted as an undashboarded series."""
    if reason not in FUSED_FALLBACK_REASONS:
        reason = "unknown"
    REGISTRY.counter("filodb_fused_fallback", reason=reason).inc()


SUPERBLOCK_OUTCOMES = ("revalidate", "extend", "extend_abort", "restage")

# outcome -> count of version-stale superblock maintenance events
SUPERBLOCK_EVENTS: dict[str, int] = dict.fromkeys(SUPERBLOCK_OUTCOMES, 0)
_LOCK = threading.Lock()


def record_superblock_event(outcome: str) -> None:
    """Count one maintenance outcome of a version-stale cached superblock,
    in ``SUPERBLOCK_EVENTS`` and as
    ``filodb_superblock_maintenance_total{outcome}``:

    - ``revalidate``: the ingest since the entry was built was provably
      disjoint from its range; the entry was re-stamped and served as is;
    - ``extend``: overlapping live-edge appends were absorbed by extending
      the superblock;
    - ``extend_abort``: an extension raced a conflicting ingest and was
      discarded;
    - ``restage``: the extension's preconditions failed; a full rebuild."""
    if outcome not in SUPERBLOCK_EVENTS:
        raise ValueError(f"unknown superblock outcome {outcome!r}")
    with _LOCK:
        SUPERBLOCK_EVENTS[outcome] += 1
    REGISTRY.counter("filodb_superblock_maintenance", outcome=outcome).inc()


def superblock_events() -> dict[str, int]:
    """A snapshot of the counts (callers read differences between two)."""
    with _LOCK:
        return dict(SUPERBLOCK_EVENTS)
