"""The port's QueryEngine against the JAX package's on the same memstore
contents: the slice's query shapes over irregular and regular grids, with
the JAX side on its general/MXU rungs and, with FILODB_PALLAS=1, on its
Pallas rung in interpret mode. Group labels must be equal, NaN masks
identical and values within rtol 2e-4 / atol 1e-4 (as tests/test_pallas.py:
f32 sums are taken in another order)."""

import dataclasses

import numpy as np
import pytest

from filodb_tpu.coordinator.planner import QueryEngine as JaxEngine
from filodb_tpu.core.records import SeriesBatch as JaxSeriesBatch
from filodb_tpu.core import schemas as JS
from filodb_tpu.memstore.memstore import TimeSeriesMemStore as JaxMemStore
from filodb_tpu.ops import aggregations as JAGG
from filodb_tpu.query.promql import query_range_to_logical_plan as jax_plan
from filodb_tpu_torch.coordinator.planner import QueryEngine
from filodb_tpu_torch.core import schemas as S
from filodb_tpu_torch.core.records import SeriesBatch
from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore
from filodb_tpu_torch.query.promql import query_range_to_logical_plan as port_plan

BASE = 1_600_000_000_000
N_SERIES, N_SAMPLES, N_SHARDS, SPREAD = 40, 200, 4, 1
START_S = (BASE + 400_000) / 1000
END_S = (BASE + 1_800_000) / 1000
STEP_S = 60

QUERIES = [
    "sum(rate(http_requests_total[5m]))",
    "sum by (zone) (rate(http_requests_total[5m]))",
    "avg by (zone) (increase(http_requests_total[5m]))",
    "min by (zone) (delta(http_requests_total[5m]))",
    "max by (zone) (rate(http_requests_total[2m]))",
    "max(avg_over_time(node_temp[5m]))",
    "count by (zone) (max_over_time(node_temp[5m]))",
    "sum by (zone) (node_temp)",
    'avg(node_temp{zone=~"z[01]"})',
]


def make_data(grid: str, seed: int = 0):
    """(tags, schema name, ts, values) per series: counters with a reset and
    gauges, on irregular (5-15 s apart) or regular (10 s) timestamps."""
    rng = np.random.default_rng(seed)
    out = []
    for metric, schema in (("http_requests_total", "prom-counter"), ("node_temp", "gauge")):
        for i in range(N_SERIES // 2):
            if grid == "irregular":
                ts = BASE + np.cumsum(rng.integers(5000, 15000, N_SAMPLES)).astype(np.int64)
            else:
                ts = BASE + 3_000 + np.arange(N_SAMPLES, dtype=np.int64) * 10_000
            if schema == "prom-counter":
                vals = np.cumsum(rng.uniform(0, 10, N_SAMPLES)) + 1e6
                vals[N_SAMPLES // 2:] -= vals[N_SAMPLES // 2] - 3.0
            else:
                vals = 50 + 20 * rng.standard_normal(N_SAMPLES)
            tags = {S.METRIC_TAG: metric, "_ws_": "demo", "_ns_": "App-2",
                    "instance": f"host-{i}", "zone": f"z{i % 4}"}
            out.append((tags, schema, ts, vals))
    return out


def build_stores(data):
    jms, pms = JaxMemStore(), TimeSeriesMemStore()
    jms.setup(JS.Dataset("prometheus"), range(N_SHARDS))
    pms.setup(S.Dataset("prometheus"), range(N_SHARDS))
    for tags, schema, ts, vals in data:
        col = "count" if schema == "prom-counter" else "value"
        shard = S.shard_for(tags, SPREAD, N_SHARDS)
        assert shard == JS.shard_for(tags, SPREAD, N_SHARDS)
        jms.shard("prometheus", shard).ingest_series(JaxSeriesBatch(
            schema=JS.SCHEMAS[schema], tags=tags, timestamps=ts, values={col: vals}))
        pms.shard("prometheus", shard).ingest_series(SeriesBatch(
            schema=S.SCHEMAS[schema], tags=tags, timestamps=ts, values={col: vals}))
    return jms, pms


@pytest.fixture(scope="module")
def stores():
    return {grid: build_stores(make_data(grid)) for grid in ("irregular", "regular")}


class _Counted:
    """Counts calls to a jit-compiled function (and keeps its cache API)."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **k):
        self.calls += 1
        return self.fn(*a, **k)

    def _cache_size(self):
        return self.fn._cache_size()


def as_rows(res):
    assert len(res.grids) == 1
    g = res.grids[0]
    return g.labels, g.values_np()


@pytest.mark.parametrize("query", QUERIES)
@pytest.mark.parametrize("rung", ["irregular-general", "irregular-pallas", "regular-mxu"])
def test_engine_matches_jax(stores, query, rung, monkeypatch):
    grid, jax_rung = rung.split("-")
    jms, pms = stores[grid]
    pallas = _Counted(JAGG._fused_pallas_jit)
    mxu = _Counted(JAGG._fused_mxu_jit)
    monkeypatch.setattr(JAGG, "_fused_pallas_jit", pallas)
    monkeypatch.setattr(JAGG, "_fused_mxu_jit", mxu)
    if jax_rung == "pallas":
        monkeypatch.setenv("FILODB_PALLAS", "1")
    else:
        monkeypatch.delenv("FILODB_PALLAS", raising=False)
    want_labels, want = as_rows(JaxEngine(jms, "prometheus").query_range(
        query, START_S, END_S, STEP_S))
    assert pallas.calls == (1 if jax_rung == "pallas" else 0)
    # the regular grid takes the MXU rung for the functions it models
    func = getattr(port_plan(query, START_S, END_S, STEP_S).inner, "function", "last")
    assert mxu.calls == (1 if jax_rung == "mxu" and func in JAGG.FUSED_MXU_FUNCS else 0)
    res = QueryEngine(pms, "prometheus", device="cpu").query_range(query, START_S, END_S, STEP_S)
    got_labels, got = as_rows(res)
    assert got_labels == want_labels
    assert got.shape == want.shape == (len(want_labels), 24)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    m = ~np.isnan(want)
    assert m.any()
    np.testing.assert_allclose(got[m], want[m], rtol=2e-4, atol=1e-4)


def test_instant_query_matches_jax(stores):
    jms, pms = stores["irregular"]
    q, t = "sum by (zone) (rate(http_requests_total[5m]))", END_S
    want = JaxEngine(jms, "prometheus").query_instant(q, t)
    got = QueryEngine(pms, "prometheus", device="cpu").query_instant(q, t)
    assert got.result_type == want.result_type == "vector"
    np.testing.assert_allclose(as_rows(got)[1], as_rows(want)[1], rtol=2e-4, atol=1e-4)


@pytest.mark.parametrize("query", [
    "topk(3, rate(http_requests_total[5m]))",
    "quantile(0.9, rate(http_requests_total[5m]))",
    "sum(irate(http_requests_total[5m]))",
    "sum(rate(http_requests_total[5m] offset 1m))",
    "sum(rate(http_requests_total[5m] @ 1600000600))",
    "sum(rate(http_requests_total[5m])) * 2",
    "rate(http_requests_total[5m])",
])
def test_unsupported_shapes_raise(stores, query):
    engine = QueryEngine(stores["irregular"][1], "prometheus", device="cpu")
    with pytest.raises(NotImplementedError):
        engine.query_range(query, START_S, END_S, STEP_S)


def test_default_device_is_the_card(stores, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        QueryEngine(stores["irregular"][1], "prometheus")


PLAN_QUERIES = QUERIES + [
    "sum(rate(http_requests_total[5m] offset 1m))",
    'topk(3, sum by (zone, instance) (rate(m{a!="b", c=~"d.*"}[1m])))',
    "histogram_quantile(0.9, sum by (le) (rate(h_bucket[5m])))",
    "rate(m[5m]) / on (zone) group_left sum by (zone) (m)",
    "sum_over_time(m[10m:1m])",
    "-abs(m) > bool 3",
    'label_replace(m, "a", "$1", "b", "(.*)")',
]


@pytest.mark.parametrize("query", PLAN_QUERIES)
def test_logical_plans_equal_jax(query):
    want = jax_plan(query, START_S, END_S, STEP_S)
    got = port_plan(query, START_S, END_S, STEP_S)
    assert repr(got) == repr(want)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_result_reports_fused_window_stats_path(stores):
    from filodb_tpu_torch.query.promql import query_range_to_logical_plan

    engine = QueryEngine(stores["irregular"][1], "prometheus", device="cpu")
    plan = query_range_to_logical_plan(QUERIES[1], START_S, END_S, STEP_S)
    ctx = engine.context()
    res = engine.planner.materialize(plan).execute(ctx)
    assert ctx.obs == {"path": "fused", "variant": "window_stats"}
    assert res.stats.series_scanned == N_SERIES // 2
    assert res.stats.samples_scanned > 0
