"""The port's metadata plans and raw export against the JAX package's on
mirrored memstores: ``label_values``, ``label_names`` and ``series``
through both engines (``=``, ``!=``, ``=~`` and ``!~`` filters, time
ranges that leave out the series that start late, ``limit``) and at the
memstore level, ``ts_cardinalities`` at several shard-key prefixes and
depths, a top-level range selector ``m[w]`` exported raw on range and
instant queries (``offset``, ``m_sum`` / ``m_bucket`` of a native
histogram), ``_filodb_chunkmeta_all`` over sealed chunks, and a planner
given peers, which the port refuses. Answers must be equal: lists in the
same order, raw samples bit-equal."""

import numpy as np
import pytest

from filodb_tpu.coordinator.planner import QueryEngine as JaxEngine
from filodb_tpu.core import schemas as JS
from filodb_tpu.core.filters import ColumnFilter as JaxFilter
from filodb_tpu.core.records import SeriesBatch as JaxSeriesBatch
from filodb_tpu.memstore.memstore import TimeSeriesMemStore as JaxMemStore
from filodb_tpu.memstore.shard import StoreConfig as JaxStoreConfig
from filodb_tpu_torch.coordinator.planner import PlannerParams, QueryEngine
from filodb_tpu_torch.core import schemas as S
from filodb_tpu_torch.core.filters import ColumnFilter
from filodb_tpu_torch.core.records import SeriesBatch
from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore
from filodb_tpu_torch.memstore.shard import StoreConfig
from filodb_tpu_torch.query.exec import plans as P
from test_torch_engine import hist_store  # noqa: F401 (a fixture)

BASE = 1_600_000_000_000
N_SHARDS, SPREAD, CHUNK = 4, 1, 64
START_S, END_S, STEP_S = (BASE + 600_000) / 1000, (BASE + 1_800_000) / 1000, 60
WORKSPACES = ("demo", "prod")
NAMESPACES = ("App-1", "App-2", "App-3")


def make_data(seed: int = 0):
    """(tags, schema, ts, values): counters and gauges of two workspaces x
    three namespaces, one in three series starting 20 minutes late, one
    in five without a ``zone``."""
    rng = np.random.default_rng(seed)
    out = []
    for w, ws in enumerate(WORKSPACES):
        for n, ns in enumerate(NAMESPACES[: 2 + w]):
            for metric, schema in (("http_requests_total", "prom-counter"),
                                   ("node_temp", "gauge")):
                for i in range(3 + n):
                    late = 1_200_000 if i % 3 == 2 else 0
                    ts = BASE + late + np.cumsum(rng.integers(5_000, 15_001, 150)).astype(
                        np.int64)
                    vals = (np.cumsum(rng.uniform(0, 10, 150)) if schema == "prom-counter"
                            else 50 + 20 * rng.standard_normal(150))
                    tags = {S.METRIC_TAG: metric, "_ws_": ws, "_ns_": ns,
                            "instance": f"host-{i}"}
                    if (i + n) % 5:
                        tags["zone"] = f"z{i % 3}"
                    out.append((tags, schema, ts, vals))
    return out


@pytest.fixture(scope="module")
def stores():
    jms = JaxMemStore(JaxStoreConfig(max_chunk_size=CHUNK))
    pms = TimeSeriesMemStore(StoreConfig(max_chunk_size=CHUNK))
    jms.setup(JS.Dataset("prometheus"), range(N_SHARDS))
    pms.setup(S.Dataset("prometheus"), range(N_SHARDS))
    for tags, schema, ts, vals in make_data():
        col = "count" if schema == "prom-counter" else "value"
        shard = S.shard_for(tags, SPREAD, N_SHARDS)
        jms.shard("prometheus", shard).ingest_series(JaxSeriesBatch(
            schema=JS.SCHEMAS[schema], tags=tags, timestamps=ts, values={col: vals}))
        pms.shard("prometheus", shard).ingest_series(SeriesBatch(
            schema=S.SCHEMAS[schema], tags=tags, timestamps=ts, values={col: vals}))
    return jms, pms


def engines(stores):
    jms, pms = stores
    return JaxEngine(jms, "prometheus"), QueryEngine(pms, "prometheus", device="cpu")


FILTERS = {
    "none": [],
    "metric": [("_metric_", "=", "node_temp")],
    "not-zone": [("zone", "!=", "z1")],
    "regex": [("_ns_", "=~", "App-[12]"), ("instance", "=~", "host-.*")],
    "not-regex": [("_metric_", "!~", "node.*"), ("_ws_", "=", "prod")],
    "no-zone": [("zone", "=", "")],
    "none-match": [("_metric_", "=", "no_such_metric")],
}
RANGES = {"all": (0, 2**62), "early": (BASE, BASE + 600_000), "late": (BASE + 1_500_000, 2**62)}


def filters(kind: str, jax: bool):
    cls = JaxFilter if jax else ColumnFilter
    return [cls(c, op, v) for c, op, v in FILTERS[kind]]


@pytest.mark.parametrize("rng", sorted(RANGES))
@pytest.mark.parametrize("kind", sorted(FILTERS))
def test_label_values_and_names_match_jax(stores, kind, rng):
    je, pe = engines(stores)
    lo, hi = RANGES[rng]
    for label in ("zone", "instance", "_ns_", "_metric_", "absent_label"):
        for limit in (None, 2):
            want = je.label_values(filters(kind, True), label, lo, hi, limit=limit)
            got = pe.label_values(filters(kind, False), label, lo, hi, limit=limit)
            assert got == want, (label, limit)
    assert pe.label_names(filters(kind, False), lo, hi) == je.label_names(
        filters(kind, True), lo, hi)


@pytest.mark.parametrize("rng", sorted(RANGES))
@pytest.mark.parametrize("kind", sorted(FILTERS))
def test_series_match_jax(stores, kind, rng):
    je, pe = engines(stores)
    lo, hi = RANGES[rng]
    for limit in (None, 3, 1000):
        want = je.series(filters(kind, True), lo, hi, limit=limit)
        got = pe.series(filters(kind, False), lo, hi, limit=limit)
        assert [dict(t) for t in got] == [dict(t) for t in want], limit


@pytest.mark.parametrize("kind", ["none", "metric", "regex", "not-regex"])
def test_memstore_calls_match_jax(stores, kind):
    jms, pms = stores
    lo, hi = RANGES["all"]
    for label in ("_metric_", "zone", "_ws_"):
        assert pms.label_values("prometheus", filters(kind, False), label, lo, hi) == (
            jms.label_values("prometheus", filters(kind, True), label, lo, hi))
        assert pms.label_values("prometheus", filters(kind, False), label, lo, hi, 1) == (
            jms.label_values("prometheus", filters(kind, True), label, lo, hi, 1))
    assert pms.label_names("prometheus", filters(kind, False), lo, hi) == jms.label_names(
        "prometheus", filters(kind, True), lo, hi)
    for limit in (None, 4):
        assert [dict(t) for t in pms.series("prometheus", filters(kind, False), lo, hi, limit)] \
            == [dict(t) for t in jms.series("prometheus", filters(kind, True), lo, hi, limit)]


@pytest.mark.parametrize("prefix, depth", [
    ((), None), ((), 1), ((), 2), ((), 3), (("demo",), None), (("prod",), 3),
    (("prod", "App-3"), None), (("prod", "App-3", "node_temp"), None), (("nope",), None),
])
def test_ts_cardinalities_match_jax(stores, prefix, depth):
    je, pe = engines(stores)
    want = je.ts_cardinalities(prefix, depth)
    got = pe.ts_cardinalities(prefix, depth)
    assert got == want
    # the scan's counts: the prefixes' series in a direct count of the partitions
    jms, pms = stores
    tags = [p.tags for sh in pms.shards("prometheus") for p in sh.partitions.values()]
    for rec in got:
        n = sum(all(t.get(k, "") == v for k, v in zip(S.SHARD_KEY_TAGS, rec["prefix"]))
                for t in tags)
        assert rec["ts_count"] == rec["active"] == n


def raw_answer(res):
    return res.result_type, None if res.raw is None else [
        (labels, ts, vals) for labels, ts, vals in res.raw]


def assert_raw_equal(got, want) -> None:
    assert got[0] == want[0]
    assert (got[1] is None) == (want[1] is None)
    assert len(got[1] or []) == len(want[1] or [])
    for (gl, gt, gv), (wl, wt, wv) in zip(got[1] or [], want[1] or []):
        assert gl == wl
        assert gt.dtype == wt.dtype and np.array_equal(gt, wt)
        assert gv.dtype == wv.dtype and np.array_equal(gv, wv, equal_nan=True)


@pytest.mark.parametrize("query", [
    "http_requests_total[5m]", "node_temp[10m] offset 3m", 'node_temp{zone=~"z[01]"}[2m]',
    "no_such_metric[5m]", 'http_requests_total{_ws_="prod", instance="host-0"}[1m]',
])
def test_raw_export_matches_jax(stores, query):
    je, pe = engines(stores)
    assert_raw_equal(raw_answer(pe.query_range(query, START_S, END_S, STEP_S)),
                     raw_answer(je.query_range(query, START_S, END_S, STEP_S)))
    got = raw_answer(pe.query_instant(query, END_S))
    assert_raw_equal(got, raw_answer(je.query_instant(query, END_S)))
    assert got[0] == "vector"


@pytest.mark.parametrize("query", [
    "http_request_latency[5m]", "http_request_latency_sum[5m]",
    'http_request_latency_bucket{le="0.5"}[5m]', "http_request_latency[3m] offset 1m",
])
def test_raw_export_of_histograms_matches_jax(hist_store, query):  # noqa: F811
    jms, pms = hist_store
    je, pe = JaxEngine(jms, "prometheus"), QueryEngine(pms, "prometheus", device="cpu")
    for run in (lambda e: e.query_range(query, START_S, END_S, STEP_S),
                lambda e: e.query_instant(query, END_S)):
        assert_raw_equal(raw_answer(run(pe)), raw_answer(run(je)))


def test_raw_export_plans_one_leaf_per_shard(stores):
    _, pe = engines(stores)
    from filodb_tpu_torch.query.promql import query_range_to_logical_plan

    plan = pe.planner.materialize(query_range_to_logical_plan("node_temp[5m]", START_S, END_S,
                                                              STEP_S))
    assert isinstance(plan, P.DistConcatExec)
    assert all(isinstance(c, P.RawChunkExportExec) for c in plan.children())
    assert sorted(c.shard_num for c in plan.children()) == list(range(N_SHARDS))


@pytest.mark.parametrize("query", [
    "_filodb_chunkmeta_all(node_temp)", '_filodb_chunkmeta_all(http_requests_total{_ws_="prod"})',
    "_filodb_chunkmeta_all(no_such_metric)",
])
def test_chunkmeta_matches_jax(stores, query):
    je, pe = engines(stores)
    want = je.query_range(query, START_S, END_S, STEP_S)
    got = pe.query_range(query, START_S, END_S, STEP_S)
    assert got.result_type == want.result_type == "metadata"
    assert got.metadata == want.metadata
    assert any(r["chunks"] for r in got.metadata) or "no_such" in query
    assert all(c["encodedBytes"] == 0 for r in got.metadata for c in r["chunks"])


def test_chunkmeta_needs_one_selector(stores):
    _, pe = engines(stores)
    from filodb_tpu_torch.query.exec.transformers import QueryError

    with pytest.raises(QueryError, match="exactly one selector"):
        pe.query_range("_filodb_chunkmeta_all(node_temp + http_requests_total)", START_S, END_S,
                       STEP_S)


def test_a_planner_given_peers_raises(stores):
    _, pms = stores
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        QueryEngine(pms, "prometheus", device="cpu",
                    params=PlannerParams(peer_endpoints=("http://peer:9090",)))
