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
from filodb_tpu_torch.ops import aggregations as AGG
from filodb_tpu_torch.ops.mxu_kernels import FUSED_MXU_FUNCS
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

# functions of the regular rung that window stats cannot express: on any
# other grid they take the general rung (B4)
REGULAR_ONLY_QUERIES = [
    "sum(irate(http_requests_total[5m]))",
    "max by (zone) (idelta(http_requests_total[2m]))",
    "avg by (zone) (stddev_over_time(node_temp[5m]))",
    "sum(stdvar_over_time(node_temp[5m]))",
    "min by (zone) (z_score(node_temp[5m]))",
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


def port_variants(monkeypatch) -> list:
    """Records the rung the port's ladder picks for each dispatch."""
    seen = []
    real = AGG.grid_variant

    def recording(*a, **k):
        seen.append(real(*a, **k))
        return seen[-1]

    monkeypatch.setattr(AGG, "grid_variant", recording)
    return seen


def assert_matches_jax(jms, pms, query):
    want_labels, want = as_rows(JaxEngine(jms, "prometheus").query_range(
        query, START_S, END_S, STEP_S))
    res = QueryEngine(pms, "prometheus", device="cpu").query_range(query, START_S, END_S, STEP_S)
    got_labels, got = as_rows(res)
    assert got_labels == want_labels
    assert got.shape == want.shape == (len(want_labels), 24)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    m = ~np.isnan(want)
    assert m.any()
    np.testing.assert_allclose(got[m], want[m], rtol=2e-4, atol=1e-4)


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
    seen = port_variants(monkeypatch)
    assert_matches_jax(jms, pms, query)
    assert pallas.calls == (1 if jax_rung == "pallas" else 0)
    # the regular grid takes the MXU rung for the functions it models, in
    # both packages
    func = getattr(port_plan(query, START_S, END_S, STEP_S).inner, "function", None) or "last"
    on_mxu = jax_rung == "mxu" and func in JAGG.FUSED_MXU_FUNCS
    assert mxu.calls == (1 if on_mxu else 0)
    assert seen == ["mxu" if on_mxu else "window_stats"]
    assert (func in FUSED_MXU_FUNCS) == (func in JAGG.FUSED_MXU_FUNCS)


@pytest.mark.parametrize("query", REGULAR_ONLY_QUERIES)
def test_regular_only_functions_match_jax(stores, query, monkeypatch):
    jms, pms = stores["regular"]
    mxu = _Counted(JAGG._fused_mxu_jit)
    monkeypatch.setattr(JAGG, "_fused_mxu_jit", mxu)
    seen = port_variants(monkeypatch)
    assert_matches_jax(jms, pms, query)
    assert mxu.calls == 1
    assert seen == ["mxu"]


@pytest.mark.parametrize("query", REGULAR_ONLY_QUERIES)
def test_regular_only_functions_raise_on_irregular_grid(stores, query, monkeypatch):
    """They raised off the regular grid until the general rung (B4) was
    ported; now they answer there, on that rung, as the JAX package does."""
    jms, pms = stores["irregular"]
    seen = port_variants(monkeypatch)
    assert_matches_jax(jms, pms, query)
    assert seen == ["general"]


def test_instant_query_matches_jax(stores):
    jms, pms = stores["irregular"]
    q, t = "sum by (zone) (rate(http_requests_total[5m]))", END_S
    want = JaxEngine(jms, "prometheus").query_instant(q, t)
    got = QueryEngine(pms, "prometheus", device="cpu").query_instant(q, t)
    assert got.result_type == want.result_type == "vector"
    np.testing.assert_allclose(as_rows(got)[1], as_rows(want)[1], rtol=2e-4, atol=1e-4)


@pytest.fixture(scope="module")
def hist_store():
    """JAX and port memstores of the same native histograms
    (``http_request_latency``)."""
    from filodb_tpu.testkit import histogram_batch
    from filodb_tpu_torch.core.records import RecordBatch

    jb = histogram_batch(n_series=6, n_samples=120, start_ms=BASE,
                         metric="http_request_latency")
    jms, pms = JaxMemStore(), TimeSeriesMemStore()
    jms.setup(JS.Dataset("prometheus"), range(N_SHARDS))
    pms.setup(S.Dataset("prometheus"), range(N_SHARDS))
    jms.ingest_routed("prometheus", jb, SPREAD)
    pms.ingest_routed("prometheus", RecordBatch(S.SCHEMAS[jb.schema.name], jb.timestamps,
                                                dict(jb.values), jb.tags,
                                                bucket_les=jb.bucket_les), SPREAD)
    return jms, pms


def hist_answer(run):
    """("ok", rows and buckets by labels) of a query, or ("error", type
    name, text)."""
    try:
        res = run()
    except Exception as e:  # the JAX package's errors are part of its answer
        return ("error", type(e).__name__, str(e))
    out = {}
    for g in res.grids:
        h = g.hist_np()
        for i, (lbls, v) in enumerate(zip(g.labels, g.values_np())):
            out[tuple(sorted(lbls.items()))] = (np.asarray(v, np.float64),
                                                None if h is None else np.asarray(h[i]))
    return ("ok", out)


# the shapes the port once refused: the tree over native histograms and
# subqueries, now answered as the JAX engine answers them (values, buckets
# and errors)
@pytest.mark.parametrize("query, store", [
    ("rate(http_request_latency[5m])", "hist"),
    ("stddev(rate(http_request_latency[5m]))", "hist"),
    ("histogram_fraction(0, 0.5, rate(http_request_latency[5m]))", "hist"),
    ("histogram_bucket(0.5, rate(http_request_latency[5m]))", "hist"),
    ("abs(rate(http_request_latency[5m]))", "hist"),
    ("topk by (zone) (3, rate(http_request_latency[5m]))", "hist"),
    ('count_values("c", rate(http_request_latency[5m]))', "hist"),
    ("max_over_time(rate(http_requests_total[5m])[10m:1m])", "irregular"),
    ("rate(http_requests_total[5m])[30m:1m]", "irregular"),
])
def test_unsupported_shapes_raise(stores, hist_store, query, store):
    jms, pms = hist_store if store == "hist" else stores[store]
    want = hist_answer(lambda: JaxEngine(jms, "prometheus").query_range(
        query, START_S, END_S, STEP_S))
    got = hist_answer(lambda: QueryEngine(pms, "prometheus", device="cpu").query_range(
        query, START_S, END_S, STEP_S))
    assert got[0] == want[0], (got, want)
    if want[0] == "error":
        assert got[1:] == want[1:]
        return
    assert sorted(got[1]) == sorted(want[1])
    for k, (w, wh) in want[1].items():
        g, gh = got[1][k]
        for a, b in ((g, w), (gh, wh)):
            assert (a is None) == (b is None)
            if b is None:
                continue
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
            m = ~np.isnan(b)
            np.testing.assert_allclose(a[m], b[m], rtol=2e-4, atol=1e-4)


# the eight scalar shapes the port refused before its tree had an aggregate
# part, operators and instant functions: now answered, as the JAX engine does
@pytest.mark.parametrize("query", [
    "topk by (zone) (3, rate(http_requests_total[5m]))",
    "stddev(rate(http_requests_total[5m]))",
    "sum(quantile_over_time(0.5, http_requests_total[5m]))",
    "sum(predict_linear(http_requests_total[5m], 60))",
    "sum(rate(http_requests_total[5m] @ 1600000600))",
    "sum(rate(http_requests_total[5m])) * 2",
    "abs(rate(http_requests_total[5m]))",
    "http_requests_total * 2",
])
def test_once_unsupported_shapes_match_jax(stores, query):
    jms, pms = stores["irregular"]

    def by_labels(res):
        return {tuple(sorted(l.items())): np.asarray(v, np.float64) for g in res.grids
                for l, v in zip(g.labels, g.values_np())}

    want = by_labels(JaxEngine(jms, "prometheus").query_range(query, START_S, END_S, STEP_S))
    got = by_labels(QueryEngine(pms, "prometheus", device="cpu").query_range(
        query, START_S, END_S, STEP_S))
    assert sorted(got) == sorted(want) and want
    for k, w in want.items():
        np.testing.assert_array_equal(np.isnan(got[k]), np.isnan(w))
        m = ~np.isnan(w)
        assert m.any()
        np.testing.assert_allclose(got[k][m], w[m], rtol=2e-4, atol=1e-4)


@pytest.mark.parametrize("grid", ["irregular", "regular"])
@pytest.mark.parametrize("query", ["rate(http_requests_total[5m])", "node_temp"])
def test_unaggregated_queries_match_jax(stores, grid, query):
    """Once refused above, a bare rate and a selector now run on the
    reference tree (one leaf per shard): the JAX engine's rows, by labels,
    NaN masks equal, values within rtol 2e-4 / atol 1e-4."""
    jms, pms = stores[grid]

    def by_labels(res):
        return {tuple(sorted(l.items())): v for g in res.grids
                for l, v in zip(g.labels, g.values_np())}

    want = by_labels(JaxEngine(jms, "prometheus").query_range(query, START_S, END_S, STEP_S))
    got = by_labels(QueryEngine(pms, "prometheus", device="cpu").query_range(
        query, START_S, END_S, STEP_S))
    assert sorted(got) == sorted(want) and len(want) == N_SERIES // 2
    for k, w in want.items():
        np.testing.assert_array_equal(np.isnan(got[k]), np.isnan(w))
        m = ~np.isnan(w)
        assert m.any()
        np.testing.assert_allclose(got[k][m], w[m], rtol=2e-4, atol=1e-4)


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


def test_result_reports_fused_mxu_path(stores):
    from filodb_tpu_torch.ops.staging import grid_class
    from filodb_tpu_torch.query.promql import query_range_to_logical_plan

    engine = QueryEngine(stores["regular"][1], "prometheus", device="cpu")
    plan = query_range_to_logical_plan(QUERIES[1], START_S, END_S, STEP_S)
    ctx = engine.context()
    ex = engine.planner.materialize(plan)
    res = ex.execute(ctx)
    assert ctx.obs == {"path": "fused", "variant": "mxu"}
    assert grid_class(ex.superblock(engine.context()).block) == "regular"
    assert res.stats.series_scanned == N_SERIES // 2
    assert res.stats.samples_scanned > 0


# -- the untyped and delta-counter schemas ------------------------------------------------


@pytest.mark.parametrize("name", ["untyped", "delta-counter"])
def test_schema_matches_the_jax_registry(name):
    """The two scalar schemas the port lacked, with the JAX package's
    columns (the downsampling specs wait for A7)."""
    want, got = JS.SCHEMAS[name], S.SCHEMAS[name]
    assert got.value_column == want.value_column
    assert [(c.name, c.ctype.value, c.is_counter, c.is_delta) for c in got.columns] == [
        (c.name, c.ctype.value, c.is_counter, c.is_delta) for c in want.columns]


def delta_data(grid: str, seed: int = 4):
    """``delta-counter`` (per-interval increases) and ``untyped`` series on
    each grid class: exact 10 s, +-5 % jitter, that with missed scrapes,
    or irregular 5-15 s."""
    rng = np.random.default_rng(seed)
    nominal = BASE + 3_000 + np.arange(N_SAMPLES, dtype=np.int64) * 10_000
    out = []
    for metric, schema in (("http_requests_total", "delta-counter"), ("node_load", "untyped")):
        for i in range(N_SERIES // 2):
            if grid == "irregular":
                ts = BASE + np.cumsum(rng.integers(5_000, 15_000, N_SAMPLES)).astype(np.int64)
            elif grid == "regular":
                ts = nominal
            else:
                ts = nominal + np.rint(rng.uniform(-0.05, 0.05, N_SAMPLES) * 1e4).astype(np.int64)
            vals = rng.uniform(0, 10, N_SAMPLES)
            if grid == "holes":
                keep = np.ones(N_SAMPLES, bool)
                keep[rng.choice(np.arange(1, N_SAMPLES - 1), 2, replace=False)] = False
                ts, vals = ts[keep], vals[keep]
            tags = {S.METRIC_TAG: metric, "_ws_": "demo", "_ns_": "App-2",
                    "instance": f"host-{i}", "zone": f"z{i % 4}"}
            out.append((tags, schema, ts, vals))
    return out


DELTA_GRIDS = {"regular": "mxu", "jitter": "jitter", "holes": "masked",
               "irregular": "window_stats"}
DELTA_QUERIES = [
    ("sum(rate(http_requests_total[5m]))", None),
    ("sum by (zone) (increase(http_requests_total[5m]))", None),
    ("sum(sum_over_time(http_requests_total[5m]))", None),
    ("sum(irate(http_requests_total[5m]))", "general"),
    ("max(idelta(http_requests_total[5m]))", "general"),
    ("sum(rate_over_delta(http_requests_total[5m]))", None),
    ("sum(increase_over_delta(http_requests_total[5m]))", None),
    ("rate(http_requests_total[5m])", None),
    ("irate(http_requests_total[5m])", "general"),
    ("avg by (zone) (node_load)", None),
    ("max(max_over_time(node_load[5m]))", None),
]


def build_schema_stores(data):
    """``build_stores`` with each series in its schema's value column."""
    jms, pms = JaxMemStore(), TimeSeriesMemStore()
    jms.setup(JS.Dataset("prometheus"), range(N_SHARDS))
    pms.setup(S.Dataset("prometheus"), range(N_SHARDS))
    for tags, schema, ts, vals in data:
        col = S.SCHEMAS[schema].value_column
        shard = S.shard_for(tags, SPREAD, N_SHARDS)
        jms.shard("prometheus", shard).ingest_series(JaxSeriesBatch(
            schema=JS.SCHEMAS[schema], tags=tags, timestamps=ts, values={col: vals}))
        pms.shard("prometheus", shard).ingest_series(SeriesBatch(
            schema=S.SCHEMAS[schema], tags=tags, timestamps=ts, values={col: vals}))
    return jms, pms


@pytest.fixture(scope="module")
def delta_stores():
    return {grid: build_schema_stores(delta_data(grid)) for grid in DELTA_GRIDS}


@pytest.mark.parametrize("grid", sorted(DELTA_GRIDS))
@pytest.mark.parametrize("query,rung", DELTA_QUERIES, ids=[q for q, _ in DELTA_QUERIES])
def test_delta_counters_and_untyped_match_jax(delta_stores, query, rung, grid):
    """Delta counters and untyped series ingest and answer as in the JAX
    engine on every rung: rate/increase/sum_over_time (and the _over_delta
    aliases) on the grid's own rung, irate/idelta excluded from the
    regular, jitter and masked rungs (the general one)."""
    jms, pms = delta_stores[grid]
    want = JaxEngine(jms, "prometheus").query_range(query, START_S, END_S, STEP_S)
    got = QueryEngine(pms, "prometheus", device="cpu").query_range(query, START_S, END_S, STEP_S)
    if rung is None and "node_load" not in query:
        rung = DELTA_GRIDS[grid]
    if rung is not None:
        assert set(got.stats.rungs) == {rung}, got.stats.rungs
    want_rows = {tuple(sorted(l.items())): v for g in want.grids
                 for l, v in zip(g.labels, g.values_np())}
    got_rows = {tuple(sorted(l.items())): v for g in got.grids
                for l, v in zip(g.labels, g.values_np())}
    assert sorted(got_rows) == sorted(want_rows) and want_rows
    for k, w in want_rows.items():
        np.testing.assert_array_equal(np.isnan(got_rows[k]), np.isnan(w), err_msg=query)
        m = ~np.isnan(w)
        np.testing.assert_allclose(got_rows[k][m], w[m], rtol=2e-4, atol=1e-4, err_msg=query)
