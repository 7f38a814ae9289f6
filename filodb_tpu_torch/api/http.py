"""Prometheus-compatible HTTP API of the port (counterpart of
``filodb_tpu/api/http.py``; reference L6 PrometheusApiRoute.scala:43-130,
AdminRoutes health).

A stdlib ``ThreadingHTTPServer``: queries run on the engine's device (the
card unless the engine was made with ``device="cpu"``); the handler pulls
their result grids to the host and renders them (``api/promjson.py``).

Served:
  GET/POST /api/v1/query_range, /api/v1/query
  GET      /api/v1/labels, /api/v1/label/<name>/values, /api/v1/series,
           /api/v1/metadata, /api/v1/status/buildinfo, /api/v1/status/flags
           (and /config: the JAX defaults the port holds off),
           /api/v1/cardinality, /api/v1/query_exemplars (the OpenMetrics
           exemplars /ingest/prom keeps), /admin/health
  GET      /metrics (Prometheus text or OpenMetrics), /debug/slow_queries,
           /debug/superblocks, /debug/resources (the device ledger),
           /debug/index (the part-key index: per-label cardinality and
           postings bytes, the device tier's staged bitmaps, ?label=
           drill-down)
  POST     /ingest (JSON lines), /ingest/prom, /ingest/influx,
           /api/v1/write (remote write), /api/v1/read (remote read),
           /admin/flush (the server's flush, when it attached one)
  with a standing engine (``standing=``): POST /api/v1/standing/register,
           /api/v1/standing/unregister, /api/v1/rules/record; GET
           /api/v1/standing, /debug/standing, /api/v1/standing/subscribe
           (SSE: the current frame, then every refresh's one render); and a
           query_range that a registered delta query covers is answered
           from its retained matrix (``stats.servedFrom: "standing"``)

Every other route of the JAX handler belongs to a subsystem the port has
not got yet and answers 501 with a Prometheus-style error body naming its
ROADMAP item (``UNPORTED``). The Arrow peer edge is never offered: a
request for it gets JSON, as the JAX handler answers without pyarrow.
Bearer auth and gzip work as in the JAX handler. Each query answer carries
a ``Server-Timing`` header with the handler's host phases in ms: ``plan``
(parse and materialize), ``execute`` (the plan's run, kernel launches
included), ``transfer`` (device to host) and ``render``.
"""

from __future__ import annotations

import json
import math
import re
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..coordinator.planner import QueryEngine
from ..core.filters import ColumnFilter
from ..query.exec.transformers import QueryError
from ..query.promql import Parser as PromParser
from ..query.promql import PromQLError
from . import promjson as J

# route -> the ROADMAP item that brings its subsystem to the port
UNPORTED = {
    "/__members": "A9 (federation and the cluster)",
    "/debug/querylog": "A6 (observability: the query log)",
    "/api/v1/query_profile": "A6 (observability: the query log)",
    "/debug/kernels": "A6 (observability: the kernel observatory)",
    "/debug/costmodel": "A6 (observability: the cost model)",
    "/debug/cluster": "A9 (federation and the cluster)",
    "/debug/profile": "A6 (observability: the sampling profiler)",
    "/api/v1/rules/alert": "A6 (observability: the alerting plane)",
    "/api/v1/rules": "A6 (observability: the alerting plane)",
    "/api/v1/alerts": "A6 (observability: the alerting plane)",
    "/debug/rollups": "A7 (downsampling and rollups)",
}


def _parse_time(s: str, default: float | None = None) -> float:
    if s is None:
        if default is None:
            raise ValueError("missing time parameter")
        return default
    try:
        return float(s)
    except ValueError:
        import datetime as dt

        return dt.datetime.fromisoformat(s.replace("Z", "+00:00")).timestamp()


def _parse_step(s: str) -> float:
    if s is None:
        return 15.0
    try:
        return float(s)
    except ValueError:
        from ..query.promql import parse_duration_ms

        return parse_duration_ms(s) / 1000.0


def _matchers_from(expr: str) -> list[ColumnFilter]:
    """Parse a series matcher like {job="x"} or metric{a="b"}."""
    from ..core.schemas import METRIC_TAG

    node = PromParser(expr).selector()
    filters = list(node.matchers)
    if node.metric:
        filters.append(ColumnFilter(METRIC_TAG, "=", node.metric))
    return [
        ColumnFilter(METRIC_TAG, f.op, f.value) if f.column == "__name__" else f
        for f in filters
    ]


def _pull_grids(res) -> float:
    """Fetch every result grid's real rows and steps to the host, in place;
    returns the seconds it took (the transfer phase)."""
    t0 = time.perf_counter()
    for g in res.grids:
        g.values = J._host_rows(g.values, 0, g.n_series, g.num_steps)
        if g.hist is not None:
            g.hist = g.hist_np()
    return time.perf_counter() - t0


class PromApiHandler(BaseHTTPRequestHandler):
    engine: QueryEngine = None  # set by make_server
    auth_token: str | None = None  # optional bearer auth (make_server)
    # the server's zero-argument flush (FiloServer.flush_now) behind POST
    # /admin/flush (reference AdminRoutes)
    flush_hook = None
    standing = None  # the server's StandingEngine (standing/maintainer.py)
    protocol_version = "HTTP/1.1"
    GZIP_MIN_BYTES = 1024
    STREAM_MIN_SAMPLES = 200_000  # above this, query_range streams chunked
    # series rows per device->host block on the streaming path
    STREAM_BLOCK_ROWS = 512

    # -- plumbing ---------------------------------------------------------

    def log_message(self, fmt, *args):  # quiet by default
        pass

    @staticmethod
    def _observe_render(fmt: str, render_s: float, nbytes: int, stalls: int = 0) -> None:
        from ..metrics import REGISTRY

        REGISTRY.histogram("filodb_render_seconds", format=fmt).observe(render_s)
        REGISTRY.counter("filodb_response_bytes", format=fmt).inc(nbytes)
        if stalls:
            REGISTRY.counter("filodb_render_stream_stalls").inc(stalls)

    @staticmethod
    def _count_response(code: int) -> None:
        from ..metrics import REGISTRY

        klass = ("shed" if code == 429 else "5xx" if code >= 500
                 else "4xx" if code >= 400 else "2xx")
        REGISTRY.counter("filodb_http_responses", code=str(code),
                         **{"class": klass}).inc()

    def _send(self, code: int, payload: dict, headers: dict | None = None):
        return self._send_body(code, json.dumps(payload).encode(), headers)

    def _send_body(self, code: int, body: bytes, headers: dict | None = None,
                   content_type: str = "application/json"):
        """Send one body (gzip when the client accepts it and the body is
        large); returns the uncompressed byte count."""
        raw_len = len(body)
        self._count_response(code)
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        if (
            len(body) >= self.GZIP_MIN_BYTES
            and "gzip" in (self.headers.get("Accept-Encoding") or "")
        ):
            import gzip

            body = gzip.compress(body, compresslevel=1)
            self.send_header("Content-Encoding", "gzip")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)
        return raw_len

    def _send_chunked(self, code: int, chunks, headers: dict | None = None):
        """Stream byte chunks with chunked transfer encoding; a producer
        error after the status line ends the stream with a newline-delimited
        error envelope and a clean terminator, as the JAX handler does.
        Returns the bytes streamed."""
        self._count_response(code)
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Transfer-Encoding", "chunked")
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        total = 0
        try:
            for chunk in chunks:
                if chunk:
                    self.wfile.write(f"{len(chunk):X}\r\n".encode() + chunk + b"\r\n")
                    total += len(chunk)
        except (BrokenPipeError, ConnectionResetError):
            raise
        except Exception as e:  # noqa: BLE001 -- the producer died mid-stream
            from ..metrics import REGISTRY

            marker = (b'\n{"status":"error","errorType":"stream_aborted",'
                      + b'"error":' + json.dumps(f"{type(e).__name__}: {e}").encode()
                      + b"}\n")
            self.wfile.write(f"{len(marker):X}\r\n".encode() + marker + b"\r\n")
            total += len(marker)
            REGISTRY.counter("filodb_http_responses", code=str(code),
                             **{"class": "stream_abort"}).inc()
        self.wfile.write(b"0\r\n\r\n")
        return total

    def _read_body(self) -> str:
        length = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(length).decode() if length else ""

    def _read_raw(self) -> bytes:
        length = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(length) if length else b""

    def _params(self) -> dict:
        parsed = urllib.parse.urlparse(self.path)
        qs = urllib.parse.parse_qs(parsed.query)
        if self.command == "POST":
            body = self._read_body()
            ctype = self.headers.get("Content-Type", "")
            # urllib clients default to the form content-type even for raw
            # payloads; only parse as a form when it actually looks like one
            if "urlencoded" in ctype and "=" in body and "\n" not in body:
                for k, v in urllib.parse.parse_qs(body).items():
                    qs.setdefault(k, v)
            elif body:
                qs["__body__"] = [body]
        return {k: v for k, v in qs.items()}

    def _q(self, params, name, default=None):
        v = params.get(name)
        return v[0] if v else default

    def _allow_partial(self, params) -> bool | None:
        """Tri-state: None = the engine's default, else the request's."""
        v = self._q(params, "allow_partial_results")
        if v is None:
            return None
        return v.lower() in ("1", "true", "yes")

    def _trace_requested(self, params) -> bool:
        """``?trace=true`` / ``?explain=analyze``: the span tree rides along."""
        v = self._q(params, "trace")
        if v is not None and v.lower() in ("1", "true", "yes"):
            return True
        return (self._q(params, "explain") or "").lower() == "analyze"

    def _trace_parent(self) -> tuple[str | None, str | None]:
        from ..metrics import TraceContext

        return (self.headers.get(TraceContext.TRACE_ID_HEADER),
                self.headers.get(TraceContext.PARENT_SPAN_HEADER))

    @staticmethod
    def _timing(phases: dict) -> dict:
        """The ``Server-Timing`` header of a query answer (ms per phase)."""
        return {"Server-Timing": ", ".join(
            f"{name};dur={1e3 * s:.3f}" for name, s in phases.items())}

    # -- routing ----------------------------------------------------------

    def do_GET(self):
        self._route()

    def do_POST(self):
        self._route()

    def _route(self):
        path = urllib.parse.urlparse(self.path).path
        if self.auth_token and path != "/admin/health":
            import hmac

            got = self.headers.get("Authorization") or ""
            if not hmac.compare_digest(got, f"Bearer {self.auth_token}"):
                # drain the body: leftover bytes would desync a keep-alive
                # connection's next request
                length = int(self.headers.get("Content-Length") or 0)
                while length > 0:
                    chunk = self.rfile.read(min(length, 65536))
                    if not chunk:
                        break
                    length -= len(chunk)
                return self._send(401, J.error("unauthorized", "missing or bad bearer token"))
        try:
            if path == "/api/v1/query_range":
                return self._query_range()
            if path == "/api/v1/query":
                return self._query()
            if path == "/api/v1/labels":
                return self._labels()
            m = re.fullmatch(r"/api/v1/label/([^/]+)/values", path)
            if m:
                return self._label_values(m.group(1))
            if path == "/api/v1/series":
                return self._series()
            if path == "/api/v1/metadata":
                return self._send(
                    200, J.success(self.engine.memstore.metric_metadata(self.engine.dataset)))
            if path == "/api/v1/status/buildinfo":
                from .. import __version__

                return self._send(200, J.success({"version": __version__,
                                                  "application": "filodb-tpu"}))
            if path == "/admin/flush" and self.command == "POST":
                if self.flush_hook is None:
                    return self._send(404, J.error("not_found", "no flusher attached"))
                self._read_raw()  # drain: keep-alive connections desync otherwise
                res = self.flush_hook()
                return self._send(200, J.success({"chunks_written": res.chunks_written,
                                                  "partkeys_written": res.partkeys_written}))
            if path == "/api/v1/query_exemplars":
                return self._query_exemplars()
            if path == "/admin/health":
                return self._send(200, {"status": "healthy",
                                        "shards": len(self.engine.memstore.shards(
                                            self.engine.dataset))})
            if path == "/metrics":
                return self._metrics()
            if path == "/debug/slow_queries":
                from ..metrics import SLOW_QUERY_LOG

                return self._send(200, J.success(SLOW_QUERY_LOG.entries()))
            if path == "/debug/resources":
                return self._resources()
            if path == "/debug/superblocks":
                return self._superblocks()
            if path == "/debug/scheduler":
                return self._scheduler()
            if path == "/debug/index":
                return self._index_debug()
            if path == "/api/v1/cardinality":
                return self._cardinality()
            if path == "/api/v1/standing/register" and self.command == "POST":
                return self._standing_register()
            if path == "/api/v1/standing/unregister" and self.command == "POST":
                return self._standing_unregister()
            if path == "/api/v1/standing/subscribe":
                return self._standing_subscribe()
            if path == "/api/v1/rules/record" and self.command == "POST":
                return self._rules_record()
            if path in ("/api/v1/standing", "/debug/standing"):
                if self.standing is None:
                    return self._send(404, J.error("not_found", "standing engine disabled"))
                return self._send(200, J.success(
                    self.standing.registry.snapshot() if path == "/api/v1/standing"
                    else self.standing.snapshot()))
            if path == "/ingest":
                return self._ingest()
            if path == "/ingest/prom":
                return self._ingest_prom()
            if path == "/ingest/influx":
                return self._ingest_influx()
            if path == "/api/v1/write":
                return self._remote_write()
            if path == "/api/v1/read":
                return self._remote_read()
            if path in ("/api/v1/status/flags", "/api/v1/status/config"):
                from ..config import PORT_OFF

                return self._send(200, J.success({
                    ".".join(p): f"{json.dumps(v)} (off in the port: {why})"
                    for p, v, why in PORT_OFF}))
            if path in UNPORTED:
                self._read_raw()  # drain: keep-alive connections desync otherwise
                return self._send(501, J.error(
                    "not_implemented",
                    f"{path} is not ported to filodb_tpu_torch yet (ROADMAP {UNPORTED[path]})"))
            self._send(404, J.error("not_found", f"unknown path {path}"))
        except NotImplementedError as e:
            self._send(501, J.error("not_implemented", str(e)))
        except (PromQLError, QueryError, ValueError) as e:
            from ..coordinator.scheduler import QueryRejected
            from ..query.scheduler import AdmissionRejected

            if isinstance(e, AdmissionRejected):
                # an admission shed: 429, back off for the bucket's drain
                # time (Retry-After), with the structured warning
                payload = J.error("throttled", str(e))
                payload["warnings"] = [e.warning()]
                self._send(429, payload,
                           headers={"Retry-After": str(max(1, math.ceil(e.retry_after_s)))})
            elif isinstance(e, QueryRejected):  # the query pool is saturated
                self._send(503, J.error("unavailable", str(e)))
            elif str(e).startswith("query exceeded deadline"):
                self._send(503, J.error("timeout", str(e)))
            else:
                self._send(400, J.error("bad_data", str(e)))
        except Exception as e:  # noqa: BLE001 -- the API edge must not die
            self._send(500, J.error("internal", f"{type(e).__name__}: {e}"))

    # -- endpoints --------------------------------------------------------

    def _scheduler(self):
        """The dispatch scheduler's window, queue and batching outcomes and
        the admission controller's per-tenant balances and sheds (each
        None where the engine has none)."""
        params = self.engine.planner.params
        sched, adm = params.dispatch_scheduler, params.admission
        return self._send(200, J.success({
            "batch": sched.snapshot() if sched is not None else None,
            "admission": adm.snapshot() if adm is not None else None,
        }))

    def _query_range(self):
        p = self._params()
        query = self._q(p, "query")
        if not query:
            return self._send(400, J.error("bad_data", "missing query"))
        start = _parse_time(self._q(p, "start"))
        end = _parse_time(self._q(p, "end"))
        step = _parse_step(self._q(p, "step"))
        if step <= 0:
            return self._send(
                400, J.error("bad_data", "zero or negative query resolution step"))
        if end < start:
            return self._send(400, J.error("bad_data", "end timestamp before start"))
        from ..metrics import trace_to_dict

        trace_id, parent_span = self._trace_parent()
        res = None
        if self.standing is not None and not self._trace_requested(p):
            # a registered standing query holds this answer as retained
            # partials (a trace request runs the engine: they have no spans)
            res = self.standing.serve_range(query, start, end, step)
        served_standing = res is not None
        if res is None:
            res = self.engine.query_range(
                query, start, end, step, allow_partial_results=self._allow_partial(p),
                trace_id=trace_id, parent_span_id=parent_span)
        trace = trace_to_dict(res.trace) if self._trace_requested(p) else None
        warnings = res.warnings or None
        fmt = "json-" + J.active_render_format()
        phases = dict(res.phases)
        if res.result_type == "scalar":
            # a range query over a scalar renders as a matrix of the scalar
            sc = res.scalar
            data = {
                "resultType": "matrix",
                "result": [{
                    "metric": {},
                    "values": [
                        [t / 1000.0, J._fmt(v)]
                        for t, v in zip(sc.start_ms + np.arange(sc.num_steps) * sc.step_ms,
                                        sc.values)
                    ],
                }] if sc is not None else [],
            }
            if trace is not None:
                data["trace"] = trace
            return self._send(200, J.success(data, warnings=warnings, partial=res.partial),
                              headers=self._timing(phases))
        stats = {
            "seriesScanned": res.stats.series_scanned,
            "samplesScanned": res.stats.samples_scanned,
            "cpuNanos": res.stats.cpu_ns,
            "bytesStaged": res.stats.bytes_staged,
            "kernelSeconds": round(res.stats.kernel_ns / 1e9, 9),
            "cacheHits": res.stats.cache_hits,
            "cacheMisses": res.stats.cache_misses,
            "cacheExtends": res.stats.cache_extends,
        }
        if served_standing:
            stats["servedFrom"] = "standing"
        n_samples = sum(g.n_series * g.num_steps for g in res.grids)
        if res.raw is not None:
            n_samples += sum(len(t) for _, t, _ in res.raw)
        if n_samples >= self.STREAM_MIN_SAMPLES:
            # large answers stream chunked: the grids are fetched in blocks
            # on a helper thread while earlier blocks are encoded
            stream_phases: dict = {}
            t_r = time.perf_counter()
            nbytes = self._send_chunked(
                200, J.stream_matrix(res, stats, warnings=warnings, trace=trace,
                                     partial=res.partial,
                                     block_rows=self.STREAM_BLOCK_ROWS or None,
                                     phases=stream_phases),
                headers=self._timing(phases))
            total_s = time.perf_counter() - t_r
            self._observe_render(fmt, max(total_s - stream_phases.get("stall_s", 0.0), 0.0),
                                 nbytes, stalls=stream_phases.get("stalls", 0))
            return
        phases["transfer"] = _pull_grids(res)
        t_r = time.perf_counter()
        body = b"".join(J.stream_matrix(res, stats, warnings=warnings, trace=trace,
                                        partial=res.partial))
        phases["render"] = time.perf_counter() - t_r
        nbytes = self._send_body(200, body, headers=self._timing(phases))
        self._observe_render(fmt, phases["render"], nbytes)

    # -- standing queries and recording rules (standing/) ------------------

    def _json_body(self, params) -> dict:
        """The POSTed JSON object (``_params`` keeps a non-form body)."""
        body = self._q(params, "__body__") or ""
        if not body:
            return {}
        try:
            out = json.loads(body)
        except ValueError as e:
            raise ValueError(f"invalid JSON body: {e}") from None
        if not isinstance(out, dict):
            raise ValueError("JSON body must be an object")
        return out

    def _standing_register(self):
        """Register a standing query: ``{"query", "step", "range"?}`` (step
        and range in seconds or PromQL durations); answers its snapshot (id,
        mode delta|full, grid)."""
        if self.standing is None:
            return self._send(404, J.error("not_found", "standing engine disabled"))
        p = self._params()
        body = self._json_body(p)
        query = body.get("query") or self._q(p, "query")
        if not query:
            return self._send(400, J.error("bad_data", "missing query"))
        step_ms = int(_parse_step(str(body.get("step") or self._q(p, "step") or 15)) * 1000)
        rng = body.get("range") or self._q(p, "range")
        span_ms = int(_parse_step(str(rng)) * 1000) if rng else None
        sq = self.standing.register(query, step_ms, span_ms=span_ms)
        return self._send(200, J.success(sq.snapshot()))

    def _standing_unregister(self):
        if self.standing is None:
            return self._send(404, J.error("not_found", "standing engine disabled"))
        p = self._params()
        qid = self._json_body(p).get("id") or self._q(p, "id")
        if not qid:
            return self._send(400, J.error("bad_data", "missing id"))
        if self.standing.unregister(str(qid)) is None:
            return self._send(404, J.error("not_found", f"no standing query {qid}"))
        return self._send(200, J.success({"unregistered": qid}))

    def _rules_record(self):
        """Register a recording rule: ``{"name", "expr", "interval",
        "range"?}``, a standing query whose newest closed steps write back
        as the series ``name{group labels}``."""
        if self.standing is None:
            return self._send(404, J.error("not_found", "standing engine disabled"))
        p = self._params()
        body = self._json_body(p)
        name = body.get("name") or self._q(p, "name")
        expr = body.get("expr") or self._q(p, "expr")
        if not name or not expr:
            return self._send(400, J.error("bad_data", "missing name or expr"))
        if not re.fullmatch(r"[a-zA-Z_:][a-zA-Z0-9_:]*", str(name)):
            return self._send(400, J.error("bad_data", f"invalid rule name {name!r}"))
        interval_s = _parse_step(str(body.get("interval") or self._q(p, "interval") or 15))
        step_ms = int(interval_s * 1000)
        rng = body.get("range") or self._q(p, "range")
        span_ms = int(_parse_step(str(rng)) * 1000) if rng else 4 * step_ms
        sq = self.standing.register(str(expr), step_ms, span_ms=span_ms, source="rule",
                                    rule_name=str(name), eval_interval_s=float(interval_s))
        return self._send(200, J.success(sq.snapshot()))

    def _standing_subscribe(self):
        """The SSE stream of one standing query: its current frame, then every
        refresh's payload, the same rendered bytes every subscriber gets.
        Past ``standing.max_subscribers`` it sheds with 429."""
        import queue

        from ..standing.hub import CLOSED, SubscriptionLimit

        if self.standing is None:
            return self._send(404, J.error("not_found", "standing engine disabled"))
        p = self._params()
        qid = self._q(p, "id")
        sq = self.standing.get(str(qid)) if qid else None
        if sq is None:
            return self._send(404, J.error("not_found", f"no standing query {qid}"))
        try:
            sub = self.standing.hub.subscribe(sq.qid)
        except SubscriptionLimit as e:
            return self._send(429, J.error("throttled", str(e)), headers={"Retry-After": "5"})
        if self.standing.get(sq.qid) is None:
            # an unregister raced the subscribe: its close already ran
            self.standing.hub.unsubscribe(sub)
            return self._send(404, J.error("not_found", f"no standing query {qid}"))
        self._count_response(200)
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.close_connection = True
        self.end_headers()
        try:
            first = sq.last_payload
            if first:
                self.wfile.write(b"data: " + first + b"\n\n")
                self.wfile.flush()
            while not sub.closed:
                try:
                    item = sub.get(timeout=15.0)
                except queue.Empty:
                    self.wfile.write(b": keep-alive\n\n")
                    self.wfile.flush()
                    continue
                if item is CLOSED:
                    break
                self.wfile.write(b"data: " + item + b"\n\n")
                self.wfile.flush()
        except (BrokenPipeError, ConnectionError, OSError):
            pass  # the client went away: the usual end of an SSE stream
        finally:
            self.standing.hub.unsubscribe(sub)

    def _query(self):
        p = self._params()
        query = self._q(p, "query")
        if not query:
            return self._send(400, J.error("bad_data", "missing query"))
        t = _parse_time(self._q(p, "time"), default=time.time())
        trace_id, parent_span = self._trace_parent()
        res = self.engine.query_instant(
            query, t, allow_partial_results=self._allow_partial(p),
            trace_id=trace_id, parent_span_id=parent_span)
        phases = dict(res.phases)
        phases["transfer"] = _pull_grids(res)
        t_r = time.perf_counter()
        if res.result_type == "scalar":
            data = J.render_scalar(res, t)
        elif res.raw is not None:
            data = J.render_matrix(res)
        else:
            data = J.render_vector(res, t)
        if self._trace_requested(p):
            from ..metrics import trace_to_dict

            data["trace"] = trace_to_dict(res.trace)
        payload = J.success(data, warnings=res.warnings or None, partial=res.partial)
        phases["render"] = time.perf_counter() - t_r
        return self._send(200, payload, headers=self._timing(phases))

    def _labels(self):
        p = self._params()
        start = _parse_time(self._q(p, "start"), 0.0)
        end = _parse_time(self._q(p, "end"), time.time() + 1e9)
        limit = self._q(p, "limit")
        match = p.get("match[]", [])
        filters = _matchers_from(match[0]) if match else []
        names = self.engine.label_names(filters, int(start * 1000), int(end * 1000))
        names = ["__name__" if n == "_metric_" else n for n in names]
        if limit:
            names = names[: int(limit)]
        return self._send(200, J.success(names))

    def _label_values(self, label: str):
        p = self._params()
        if label == "__name__":
            label = "_metric_"
        start = _parse_time(self._q(p, "start"), 0.0)
        end = _parse_time(self._q(p, "end"), time.time() + 1e9)
        match = p.get("match[]", [])
        limit = self._q(p, "limit")
        filters = _matchers_from(match[0]) if match else []
        vals = self.engine.label_values(filters, label, int(start * 1000), int(end * 1000),
                                        limit=int(limit) if limit else None)
        return self._send(200, J.success(vals))

    def _series(self):
        p = self._params()
        start = _parse_time(self._q(p, "start"), 0.0)
        end = _parse_time(self._q(p, "end"), time.time() + 1e9)
        limit = self._q(p, "limit")
        out = []
        for expr in p.get("match[]", []):
            filters = _matchers_from(expr)
            for tags in self.engine.series(filters, int(start * 1000), int(end * 1000),
                                           limit=int(limit) if limit else 10000):
                out.append(J._labels_out(dict(tags)))
        if limit:
            out = out[: int(limit)]
        return self._send(200, J.success(out))

    def _metrics(self):
        """Prometheus exposition of the registry (OpenMetrics when the
        Accept header names it); the per-shard gauges and the device
        ledger's are refreshed by scrape-time collectors."""
        from ..metrics import REGISTRY

        openmetrics = "application/openmetrics-text" in (self.headers.get("Accept") or "")
        body = REGISTRY.expose(openmetrics=openmetrics).encode()
        ctype = ("application/openmetrics-text; version=1.0.0; charset=utf-8"
                 if openmetrics else "text/plain; version=0.0.4")
        self._count_response(200)
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _resources(self):
        """The device ledger: per-kind bytes, the drift of every account
        against a cold walk of its cache (zero when the books are right),
        and the bytes per kind and device."""
        from ..ledger import LEDGER

        verify = LEDGER.verify()
        devices: dict = {}
        for (kind, dev), n in LEDGER.device_balances().items():
            devices.setdefault(kind, {})[dev] = n
        return self._send(200, J.success({
            "device_bytes": LEDGER.balances(),
            "kinds": verify["kinds"],
            "accounts": verify["accounts"],
            "devices": devices,
            "engine_device": str(self.engine.device),
        }))

    def _superblocks(self):
        """The superblock cache: one entry per cached superblock (key, bytes,
        age, hits, last maintenance outcome, the device it lies on), the
        bytes per device, and this cache's ledger balance."""
        cache = getattr(self.engine.memstore, "_superblock_cache", None)
        entries = cache.snapshot() if cache is not None else []
        device_bytes: dict = {}
        for e in entries:
            dev = e.get("device")
            if dev is not None:
                device_bytes[dev] = device_bytes.get(dev, 0) + int(e["bytes"])
        return self._send(200, J.success({
            "entries": entries,
            "count": len(entries),
            "bytes": sum(e["bytes"] for e in entries),
            "device_bytes": device_bytes,
            "ledger_bytes": cache.ledger.bytes if cache is not None else 0,
        }))

    def _index_debug(self):
        """Part-key index introspection: per-label cardinality and postings
        footprint per shard, the label dictionary rolled up over shards, the
        device tier's staged bitmaps where it is on, and with ``?label=`` the
        top values of that label by series count."""
        from ..memstore.cardinality import label_top_values

        p = self._params()
        drill_label = self._q(p, "label")
        ds = self.engine.dataset
        shards = []
        labels_rollup: dict[str, dict] = {}
        drill: dict[str, int] = {}
        total_bytes = device_bytes = 0
        for sh in self.engine.memstore.shards(ds):
            st = sh.index_stats()
            if drill_label:
                for rec in label_top_values(sh.index, drill_label, k=50):
                    drill[rec["value"]] = drill.get(rec["value"], 0) + rec["series"]
            for k, rec in st.get("labels", {}).items():
                slot = labels_rollup.setdefault(k, {"values": 0, "postings_bytes": 0})
                slot["values"] += rec["values"]
                slot["postings_bytes"] += rec["postings_bytes"]
            total_bytes += st.get("postings_bytes", 0)
            dev = st.get("device")
            if dev:
                device_bytes += dev.get("staged_bytes", 0)
            shards.append({
                "shard": sh.shard_num,
                "part_keys": st.get("num_part_keys", 0),
                "postings_bytes": st.get("postings_bytes", 0),
                "dictionary_size": st.get("dictionary_size", 0),
                "lookups": st.get("lookups", 0),
                "device": dev,
            })
        return self._send(200, J.success({
            "dataset": ds,
            "shards": shards,
            # a label's values summed over shards (its cross-shard
            # cardinality is at most this sum)
            "labels": dict(sorted(labels_rollup.items(),
                                  key=lambda kv: -kv[1]["postings_bytes"])),
            "postings_bytes": total_bytes,
            "device_staged_bytes": device_bytes,
            "label_values": (sorted(({"value": v, "series": n} for v, n in drill.items()),
                                    key=lambda r: (-r["series"], r["value"]))[:50]
                             if drill_label else None),
        }))

    def _cardinality(self):
        """Per-shard-key-prefix cardinality (reference TsCardinalities)."""
        p = self._params()
        prefix = [x for x in (self._q(p, "prefix", "") or "").split(",") if x]
        depth = int(self._q(p, "depth", str(len(prefix) + 1)))
        return self._send(200, J.success(self.engine.ts_cardinalities(prefix, depth)))

    def _query_exemplars(self):
        """Prometheus /api/v1/query_exemplars: the exemplars of the series a
        query's selectors match, within [start, end]."""
        from ..query.logical import leaf_raw_series
        from ..query.promql import query_to_logical_plan

        p = self._params()
        query = self._q(p, "query")
        if not query:
            return self._send(400, J.error("bad_data", "missing query"))
        start = _parse_time(self._q(p, "start") or "0")
        end = _parse_time(self._q(p, "end") or str(2**31))
        out = []
        for leaf in leaf_raw_series(query_to_logical_plan(query, end)):
            out.extend(self.engine.memstore.query_exemplars(
                self.engine.dataset, leaf.filters, int(start * 1000), int(end * 1000)))
        return self._send(200, J.success(out))

    def _ingest_prom(self):
        """Prometheus text exposition ingest (counters route to the
        prom-counter schema by their # TYPE comments); OpenMetrics
        exemplars ride beside their samples and are kept on their series."""
        from ..gateway.parsers import prom_text_to_batches_and_exemplars

        text = self._read_body()
        n = 0
        batches, exemplars = prom_text_to_batches_and_exemplars(text, int(time.time() * 1000))
        for batch in batches:
            n += self.engine.memstore.ingest_routed(self.engine.dataset, batch, spread=3)
        if exemplars:
            self.engine.memstore.add_exemplars(self.engine.dataset, 3, exemplars)
        return self._send(200, J.success({"ingested": n}))

    def _ingest_influx(self):
        """Influx line protocol over HTTP."""
        from ..gateway.parsers import influx_to_batch

        batch = influx_to_batch(self._read_body(), int(time.time() * 1000))
        n = self.engine.memstore.ingest_routed(self.engine.dataset, batch, spread=3)
        return self._send(200, J.success({"ingested": n}))

    def _remote_write(self):
        """Prometheus remote write receiver (snappy + protobuf)."""
        from .remote_storage import parse_write_request

        n = 0
        for batch in parse_write_request(self._read_raw()):
            n += self.engine.memstore.ingest_routed(self.engine.dataset, batch, spread=3)
        self._count_response(204)
        self.send_response(204)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def _remote_read(self):
        """Prometheus remote read (snappy + protobuf, raw samples)."""
        from .remote_storage import handle_read_request

        out = handle_read_request(self._read_raw(), self.engine.memstore, self.engine.dataset)
        self._count_response(200)
        self.send_response(200)
        self.send_header("Content-Type", "application/x-protobuf")
        self.send_header("Content-Encoding", "snappy")
        self.send_header("Content-Length", str(len(out)))
        self.end_headers()
        self.wfile.write(out)

    def _ingest(self):
        """JSON lines of {tags, ts_ms, value} (gauges), grouped by metric."""
        from ..core.records import gauge_batch

        p = self._params()
        body = self._q(p, "__body__", "")
        samples = []
        for line in body.splitlines():
            if not line.strip():
                continue
            rec = json.loads(line)
            samples.append((rec.get("tags", {}), int(rec["ts_ms"]), float(rec["value"])))
        by_metric: dict[str, list] = {}
        for tags, ts, v in samples:
            by_metric.setdefault(tags.get("__name__", tags.get("_metric_", "unknown")),
                                 []).append((tags, ts, v))
        for metric, recs in by_metric.items():
            self.engine.memstore.ingest_routed(self.engine.dataset, gauge_batch(metric, recs),
                                               spread=3)
        return self._send(200, J.success({"ingested": len(samples)}))


def register_shard_stats_collector(engine: QueryEngine) -> None:
    """Scrape-time per-shard gauges (``filodb_shard_partitions``, rows
    ingested and skipped, partitions evicted, chunks flushed, and the
    index's ``filodb_index_postings_bytes``, ``filodb_index_dictionary_size``
    and ``filodb_index_device_staged_bytes``) in the
    registry, keyed per engine; the closure holds the memstore weakly and
    unregisters itself once the store is gone."""
    import weakref

    from ..metrics import REGISTRY

    ds = engine.dataset
    key = f"shard_stats:{ds}:{id(engine.memstore)}"
    memstore_ref = weakref.ref(engine.memstore)

    def collect():
        memstore = memstore_ref()
        if memstore is None:
            REGISTRY.unregister_collector(key)
            return
        for sh in memstore.shards(ds):
            ist = sh.index_stats()
            dev = ist.get("device") or {}
            for name, v in (("filodb_shard_partitions", sh.num_partitions),
                            ("filodb_shard_rows_ingested", sh.stats.rows_ingested),
                            ("filodb_shard_rows_skipped", sh.stats.rows_skipped),
                            ("filodb_shard_partitions_evicted", sh.stats.partitions_evicted),
                            ("filodb_shard_chunks_flushed", sh.stats.chunks_flushed),
                            ("filodb_index_postings_bytes", ist.get("postings_bytes", 0)),
                            ("filodb_index_dictionary_size", ist.get("dictionary_size", 0)),
                            ("filodb_index_device_staged_bytes", dev.get("staged_bytes", 0))):
                REGISTRY.gauge(name, dataset=ds, shard=str(sh.shard_num)).set(float(v))

    REGISTRY.register_collector(key, collect)


def make_server(engine: QueryEngine, host: str = "127.0.0.1", port: int = 9090,
                auth_token: str | None = None, result_plane: dict | None = None,
                flush_hook=None, standing=None) -> ThreadingHTTPServer:
    """An HTTP server over ``engine`` (not started). ``result_plane`` takes
    the config's ``stream_min_samples`` and ``stream_block_rows``;
    ``flush_hook`` answers POST /admin/flush; ``standing`` (a
    ``StandingEngine``) serves the standing routes."""
    from .. import ledger  # noqa: F401 -- registers the ledger's /metrics collector

    register_shard_stats_collector(engine)
    attrs = {"engine": engine, "auth_token": auth_token, "standing": standing,
             "flush_hook": staticmethod(flush_hook) if flush_hook else None}
    if result_plane:
        attrs["STREAM_MIN_SAMPLES"] = int(
            result_plane.get("stream_min_samples", PromApiHandler.STREAM_MIN_SAMPLES))
        attrs["STREAM_BLOCK_ROWS"] = int(
            result_plane.get("stream_block_rows", PromApiHandler.STREAM_BLOCK_ROWS))
    handler = type("BoundHandler", (PromApiHandler,), attrs)
    srv = ThreadingHTTPServer((host, port), handler)
    srv.daemon_threads = True
    return srv


def serve_background(engine: QueryEngine, host: str = "127.0.0.1", port: int = 0,
                     auth_token: str | None = None, result_plane: dict | None = None,
                     flush_hook=None, standing=None):
    """Start the API server on a thread; returns (server, actual_port).
    ``server.shutdown()`` then ``server.server_close()`` stop it."""
    srv = make_server(engine, host, port, auth_token, result_plane, flush_hook, standing)
    t = threading.Thread(target=srv.serve_forever, daemon=True, name="filodb-http")
    t.start()
    return srv, srv.server_address[1]
