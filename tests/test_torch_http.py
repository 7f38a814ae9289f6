"""The port's HTTP API against the JAX package's over the same seeded store:
both ``serve_background`` servers (bound to 127.0.0.1:0, read with a
timeout, shut down by the fixtures) get the same requests on the routes the
port serves. Status codes and ``errorType`` are equal, bad requests
included; labels, series and metadata equal exactly; values within rtol
2e-4 / atol 1e-4 with the same timestamps. The port's JSON render is byte
for byte the JAX numpy tier on grids with NaN, the infinities, -0 and
extreme exponents. Every route the port has not got answers 501 naming its
ROADMAP item; bearer auth and gzip behave as the JAX handler's; eight
concurrent identical cold requests answer alike after one superblock
build."""

import gzip
import json
import threading
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest

from filodb_tpu.api import http as JHTTP
from filodb_tpu.api import promjson as JJ
from filodb_tpu.coordinator.planner import QueryEngine as JaxEngine
from filodb_tpu_torch.api import http as HTTP
from filodb_tpu_torch.api import promjson as PJ
from filodb_tpu_torch.coordinator.planner import QueryEngine
from filodb_tpu_torch.ops import staging as ST
from tests.test_torch_engine import BASE, END_S, START_S, STEP_S, build_stores, make_data

RTOL, ATOL = 2e-4, 1e-4
GRID = f"&start={START_S}&end={END_S}&step={STEP_S}"


def get(base: str, path: str, data: bytes | None = None, headers: dict | None = None):
    """(status, headers, body) of one request, errors included."""
    req = urllib.request.Request(base + path, data=data, headers=headers or {},
                                 method="POST" if data is not None else "GET")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def serve(engine, module, **kw):
    srv, port = module.serve_background(engine, port=0, **kw)
    return srv, f"http://127.0.0.1:{port}"


@pytest.fixture(scope="module")
def servers():
    jms, pms = build_stores(make_data("regular", seed=3))
    jsrv, jbase = serve(JaxEngine(jms, "prometheus"), JHTTP)
    psrv, pbase = serve(QueryEngine(pms, "prometheus", device="cpu"), HTTP)
    yield jbase, pbase
    for srv in (jsrv, psrv):
        srv.shutdown()
        srv.server_close()


def both(servers, path, data=None, headers=None):
    jbase, pbase = servers
    return get(jbase, path, data, headers), get(pbase, path, data, headers)


def series_of(payload: dict) -> dict:
    out = {}
    for r in payload["data"]["result"]:
        pts = r["values"] if "values" in r else [r["value"]]
        out[tuple(sorted(r["metric"].items()))] = (
            [round(float(t) * 1000) for t, _ in pts], np.array([float(v) for _, v in pts]))
    return out


def assert_same_answer(want_body: bytes, got_body: bytes, what: str):
    want, got = json.loads(want_body), json.loads(got_body)
    assert got["status"] == want["status"] == "success", what
    assert got["data"]["resultType"] == want["data"]["resultType"], what
    w, g = series_of(want), series_of(got)
    assert sorted(g) == sorted(w), what
    for k, (wt, wv) in w.items():
        gt, gv = g[k]
        assert gt == wt, (what, k)
        np.testing.assert_allclose(gv, wv, rtol=RTOL, atol=ATOL, err_msg=f"{what} {k}")


RANGE_QUERIES = [
    "sum(rate(http_requests_total[5m]))",
    "sum by (zone) (rate(http_requests_total[5m]))",
    "rate(http_requests_total[5m])",
    "topk(2, rate(http_requests_total[5m]))",
    "max(avg_over_time(node_temp[5m]))",
    "node_temp",
    "1 + 1",
]


@pytest.mark.parametrize("query", RANGE_QUERIES)
def test_query_range_matches_jax(servers, query):
    (ws, _, wb), (gs, gh, gb) = both(servers, f"/api/v1/query_range?query="
                                              f"{urllib.parse.quote(query)}{GRID}")
    assert gs == ws == 200
    assert_same_answer(wb, gb, query)
    assert {p.split(";")[0].strip() for p in gh["Server-Timing"].split(",")} >= {"plan",
                                                                                 "execute"}


@pytest.mark.parametrize("query", ["sum(rate(http_requests_total[5m]))", "time()",
                                   "http_requests_total[5m]", "node_temp > 60"])
def test_instant_query_matches_jax(servers, query):
    path = f"/api/v1/query?query={urllib.parse.quote(query)}&time={END_S}"
    (ws, _, wb), (gs, _, gb) = both(servers, path)
    assert gs == ws == 200
    want, got = json.loads(wb), json.loads(gb)
    assert got["data"]["resultType"] == want["data"]["resultType"]
    if want["data"]["resultType"] == "scalar":
        assert got["data"]["result"] == want["data"]["result"]
    else:
        assert_same_answer(wb, gb, query)


BAD = [
    "/api/v1/query_range?query=sum(rate(" + GRID,
    "/api/v1/query_range?query=" + GRID,
    f"/api/v1/query_range?query=up&start={START_S}&end={END_S}&step=0",
    f"/api/v1/query_range?query=up&start={END_S}&end={START_S}&step=60",
    "/api/v1/query_range?query=up&end=1&step=60",
    "/api/v1/query?query=rate(http_requests_total)",
    "/api/v1/query?query=sum%20by%20(",
    "/api/v1/series?match[]=%7B",
    "/api/v1/nope",
]


@pytest.mark.parametrize("path", BAD)
def test_bad_requests_fail_as_jax(servers, path):
    (ws, _, wb), (gs, _, gb) = both(servers, path)
    assert gs == ws and ws >= 400, (ws, gs)
    assert json.loads(gb)["errorType"] == json.loads(wb)["errorType"]


@pytest.mark.parametrize("path", [
    "/api/v1/labels",
    "/api/v1/labels?match[]=node_temp",
    "/api/v1/label/zone/values",
    "/api/v1/label/__name__/values",
    "/api/v1/label/instance/values?limit=3",
    f"/api/v1/series?match[]={urllib.parse.quote('http_requests_total{zone=~\"z[12]\"}')}",
    "/api/v1/series?match[]=node_temp&match[]=http_requests_total",
    "/api/v1/metadata",
    "/api/v1/status/buildinfo",
    "/api/v1/cardinality?prefix=demo&depth=2",
    "/admin/health",
])
def test_metadata_routes_equal_jax(servers, path):
    (ws, _, wb), (gs, _, gb) = both(servers, path)
    assert gs == ws == 200
    want, got = json.loads(wb), json.loads(gb)
    if path.startswith("/api/v1/series"):  # shard order may differ: compare as sets
        key = lambda d: sorted(d.items())  # noqa: E731
        assert sorted(got["data"], key=key) == sorted(want["data"], key=key)
    elif path.startswith("/api/v1/cardinality"):
        key = lambda d: json.dumps(d, sort_keys=True)  # noqa: E731
        assert sorted(got["data"], key=key) == sorted(want["data"], key=key)
    else:
        assert got == want


def test_ingest_routes_then_queries_equal_jax(servers):
    t = BASE + 2_000_000
    prom = "# TYPE web_hits_total counter\n" + "".join(
        f'web_hits_total{{page="p{i}"}} {i * 7} {t + k * 15_000}\n'
        for k in range(30) for i in range(5))
    lines = "\n".join(json.dumps({"tags": {"__name__": "json_temp", "room": f"r{i}"},
                                  "ts_ms": t + k * 15_000, "value": 20.0 + i + k / 10})
                      for i in range(3) for k in range(30))
    influx = "\n".join(f"cpu,host=h{i} usage={i + k / 3},idle={k} {(t + k * 15_000) * 10**6}"
                       for i in range(3) for k in range(30))
    for path, body in (("/ingest/prom", prom.encode()), ("/ingest", lines.encode()),
                       ("/ingest/influx", influx.encode())):
        (ws, _, wb), (gs, _, gb) = both(servers, path, data=body,
                                        headers={"Content-Type": "text/plain"})
        assert gs == ws == 200 and json.loads(gb) == json.loads(wb), path
    end = (t + 29 * 15_000) / 1000
    for q in ("sum(rate(web_hits_total[2m]))", "avg by (room) (json_temp)",
              "max(cpu_usage)", "sum(cpu_idle)"):
        path = (f"/api/v1/query_range?query={urllib.parse.quote(q)}&start={end - 300}"
                f"&end={end}&step=30")
        (ws, _, wb), (gs, _, gb) = both(servers, path)
        assert gs == ws == 200
        assert_same_answer(wb, gb, q)
        assert series_of(json.loads(gb)), q


def test_remote_write_and_read_over_http_equal_jax(servers):
    from filodb_tpu_torch.api import prompb, snappy

    t = BASE + 3_000_000
    written = [prompb.TimeSeries([("__name__", "rw_metric"), ("job", f"j{i}")],
                                 [(float(i * k), t + k * 10_000) for k in range(6)])
               for i in range(4)]
    body = snappy.compress(prompb.encode_write_request(written))
    (ws, _, _), (gs, _, _) = both(servers, "/api/v1/write", data=body,
                                  headers={"Content-Type": "application/x-protobuf"})
    assert gs == ws == 204
    read = snappy.compress(prompb.encode_read_request([prompb.Query(
        t, t + 60_000, [prompb.LabelMatcher(0, "__name__", "rw_metric")])]))
    (ws, wh, wb), (gs, gh, gb) = both(servers, "/api/v1/read", data=read)
    assert gs == ws == 200 and gh["Content-Encoding"] == wh["Content-Encoding"] == "snappy"

    def canon(b):
        (res,) = prompb.decode_read_response(snappy.decompress(b))
        return sorted((tuple(s.labels), tuple(s.samples)) for s in res)

    assert canon(gb) == canon(wb) == sorted((tuple(s.labels), tuple(s.samples))
                                            for s in written)


def test_metrics_and_debug_routes(servers):
    _, pbase = servers
    get(pbase, f"/api/v1/query_range?query=sum(rate(http_requests_total[5m])){GRID}")
    status, headers, body = get(pbase, "/metrics")
    text = body.decode()
    assert status == 200 and headers["Content-Type"].startswith("text/plain")
    for family in ("filodb_queries_total", "filodb_query_latency_seconds_bucket",
                   "filodb_device_bytes", "filodb_http_responses_total"):
        assert family in text, family
    status, headers, body = get(pbase, "/metrics",
                                headers={"Accept": "application/openmetrics-text"})
    assert body.decode().rstrip().endswith("# EOF")
    sb = json.loads(get(pbase, "/debug/superblocks")[2])["data"]
    assert sb["count"] >= 1 and sb["ledger_bytes"] == sb["bytes"]
    assert set(sb["device_bytes"]) == {"cpu"}
    res = json.loads(get(pbase, "/debug/resources")[2])["data"]
    assert all(k["drift"] == 0 for k in res["kinds"].values())
    assert res["engine_device"] == "cpu" and res["devices"]["superblock"]
    assert json.loads(get(pbase, "/debug/slow_queries")[2])["status"] == "success"
    flags = json.loads(get(pbase, "/api/v1/status/flags")[2])["data"]
    assert "standing.enabled" in flags and "ROADMAP A5" in flags["standing.enabled"]


@pytest.mark.parametrize("path", sorted(HTTP.UNPORTED))
def test_unported_routes_answer_501(servers, path):
    _, pbase = servers
    status, _, body = get(pbase, path, data=b"{}" if "register" in path or "rules/" in path
                          else None)
    payload = json.loads(body)
    assert status == 501 and payload["status"] == "error"
    assert payload["errorType"] == "not_implemented" and "ROADMAP A" in payload["error"]


def test_bearer_auth_and_gzip_as_jax():
    jms, pms = build_stores(make_data("regular", seed=4))
    pair = [serve(JaxEngine(jms, "prometheus"), JHTTP, auth_token="s3cret"),
            serve(QueryEngine(pms, "prometheus", device="cpu"), HTTP, auth_token="s3cret")]
    try:
        path = f"/api/v1/query_range?query=rate(http_requests_total[5m]){GRID}"
        answers = []
        for _, base in pair:
            assert get(base, path)[0] == 401
            assert json.loads(get(base, path, headers={"Authorization": "Bearer no"})[2])[
                "errorType"] == "unauthorized"
            assert get(base, "/admin/health")[0] == 200
            status, headers, body = get(base, path, headers={
                "Authorization": "Bearer s3cret", "Accept-Encoding": "gzip"})
            assert status == 200 and headers["Content-Encoding"] == "gzip"
            answers.append(gzip.decompress(body))
        assert_same_answer(answers[0], answers[1], "gzip")
    finally:
        for srv, _ in pair:
            srv.shutdown()
            srv.server_close()


def test_concurrent_identical_requests_build_once(monkeypatch):
    """Eight concurrent identical cold requests: equal answers, one
    superblock build (the cache's single flight)."""
    _, pms = build_stores(make_data("irregular", seed=5))
    builds = []
    real = ST.concat_blocks
    monkeypatch.setattr(ST, "concat_blocks", lambda *a, **k: builds.append(1) or real(*a, **k))
    srv, base = serve(QueryEngine(pms, "prometheus", device="cpu"), HTTP)
    try:
        path = f"/api/v1/query_range?query=sum(rate(http_requests_total[5m])){GRID}"
        out = [None] * 8
        start = threading.Barrier(8)

        def fetch(i):
            start.wait()
            out[i] = get(base, path)

        threads = [threading.Thread(target=fetch, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert all(o is not None and o[0] == 200 for o in out)
        bodies = [json.loads(o[2])["data"]["result"] for o in out]
        assert all(b == bodies[0] for b in bodies)
        assert len(builds) == 1
    finally:
        srv.shutdown()
        srv.server_close()


def odd_grid():
    rng = np.random.default_rng(9)
    vals = rng.normal(0, 1, (6, 40)) * 10.0 ** rng.integers(-300, 300, (6, 40))
    vals[0, ::3] = np.nan
    vals[1, ::5] = np.inf
    vals[1, 1::5] = -np.inf
    vals[2, :] = -0.0
    vals[3, :4] = [5e-324, 1.7976931348623157e308, -2.5e-7, 123456789.123456789]
    vals[4, :] = np.nan
    with np.errstate(over="ignore"):
        vals[5] = vals[5].astype(np.float32)  # f32 values, past its range made infinite
    ts = (BASE + 1_500 + np.arange(40) * 15_000) / 1e3
    ts[0] = -0.5
    return ts, vals


def test_render_is_byte_identical_to_the_jax_numpy_tier():
    ts, vals = odd_grid()
    want = JJ._rows_numpy(JJ._ts_decorated(ts), vals)
    assert PJ.render_rows(ts, vals) == want
    for i in range(len(vals)):
        assert PJ._values_fragment(ts, vals[i]) == want[i]
        with np.errstate(over="ignore"):
            v32 = vals[i].astype(np.float32)
        assert PJ._values_fragment(ts, v32) == JJ._rows_numpy(
            JJ._ts_decorated(ts), v32.astype(np.float64)[None, :])[0]
    assert PJ._ts3(-0.5) == JJ._ts3(-0.5) and PJ._fmt(-0.0) == JJ._fmt(-0.0)
