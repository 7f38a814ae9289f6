"""The reference tree's first part in the port against the JAX package's
on mirrored memstores: the planner's tree plans (one leaf per shard under a
DistConcatExec, time slices under a StitchRvsExec), every range function
the JAX ladder answers on scalar columns over irregular, regular and
jittered stores, bare selectors, ``offset`` and ``@``, ``m_bucket{le=...}``
over native histograms, the series and sample limits, a 30-day selection
cut in time (unaggregated and ``sum(rate)``), the ladder's rung per
function and grid, and the staging cache's device copies (a warm repeat
stages and uploads nothing).

Rows are matched by labels; NaN masks must be equal and values within
rtol 2e-4 / atol 1e-4 (tests/test_pallas.py's tolerance), ``timestamp``
exactly (f64 on the host in both). Where ROADMAP C documents a difference
-- deriv/predict_linear sum in f64 in the port and in f32 in the JAX
package; the stddev family's mean is the window's own sum in the port -- a
value is held to the JAX package where the JAX value agrees with a float64
oracle over the raw samples (rtol 2e-4 / atol 1e-4), else to the oracle."""

import numpy as np
import pytest

from filodb_tpu.coordinator.planner import PlannerParams as JaxParams
from filodb_tpu.coordinator.planner import QueryEngine as JaxEngine
from filodb_tpu.core import schemas as JS
from filodb_tpu.core.records import SeriesBatch as JaxSeriesBatch
from filodb_tpu.memstore.memstore import TimeSeriesMemStore as JaxMemStore
from filodb_tpu.ops import kernels as JK
from filodb_tpu.query.promql import query_range_to_logical_plan as jax_logical
from filodb_tpu.testkit import histogram_batch
from filodb_tpu_torch.coordinator.planner import PlannerParams, QueryEngine
from filodb_tpu_torch.core import schemas as S
from filodb_tpu_torch.core.records import RecordBatch, SeriesBatch
from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore
from filodb_tpu_torch.ops import kernels as K
from filodb_tpu_torch.ops import staging as ST
from filodb_tpu_torch.query.exec import plans as P
from filodb_tpu_torch.query.promql import query_range_to_logical_plan as port_logical

BASE = 1_600_000_000_000
N_SERIES, N_SAMPLES, N_SHARDS, SPREAD = 16, 150, 4, 1
START_S = (BASE + 400_000) / 1000
END_S = (BASE + 1_400_000) / 1000
STEP_S = 60
AT_S = 1_600_000_700
RTOL, ATOL = 2e-4, 1e-4
GRIDS = ("irregular", "regular", "jitter")

C, G = "http_requests_total", "node_temp"
# every range function of query/functions.RANGE_FUNCTIONS the JAX ladder
# serves on scalar columns, with its arguments, over a counter (C) or a gauge (G)
QUERIES = [
    f"rate({C}[5m])", f"increase({C}[5m])", f"delta({G}[5m])", f"idelta({C}[2m])",
    f"irate({C}[5m])", f"resets({C}[5m])", f"changes({G}[5m])", f"deriv({G}[5m])",
    f"predict_linear({G}[5m], 600)", f"avg_over_time({G}[5m])", f"min_over_time({G}[5m])",
    f"max_over_time({C}[5m])", f"sum_over_time({G}[3m])", f"count_over_time({C}[5m])",
    f"stddev_over_time({G}[5m])", f"stdvar_over_time({G}[5m])", f"last_over_time({C}[5m])",
    f"first_over_time({G}[5m])", f"present_over_time({G}[5m])", f"absent_over_time({C}[1m])",
    f"quantile_over_time(0.9, {G}[5m])", f"quantile_over_time(0.25, {C}[5m])",
    f"mad_over_time({G}[5m])", f"median_absolute_deviation_over_time({C}[5m])",
    f"holt_winters({G}[5m], 0.3, 0.1)", f"double_exponential_smoothing({C}[5m], 0.5, 0.5)",
    f"timestamp_of_last_sample({G}[5m])", f"z_score({G}[5m])",
    f"last_over_time_is_mad_outlier(1, 1, {G}[5m])", f"avg_with_sum_and_count_over_time({G}[5m])",
    C, G, f"rate({C}[5m] offset 1m)", f"{G} offset 2m", f"rate({C}[5m] @ {AT_S})",
    f"{G} @ {AT_S}", f"quantile_over_time(0.5, {G}[5m] @ {AT_S})",
]
# functions whose values are held to the JAX-or-oracle rule (ROADMAP C)
ORACLE_FUNCS = {"deriv", "predict_linear", "stddev_over_time", "stdvar_over_time", "z_score"}


def make_data(grid: str, seed: int = 0, n_series: int = N_SERIES, n_samples: int = N_SAMPLES):
    """(tags, schema, ts, values): counters (a reset in every third) and
    gauges (repeated readings) on 10 s samples from BASE, exact, +-5 %
    (jitter) or irregular 5-15 s apart."""
    rng = np.random.default_rng(seed)
    nominal = BASE + 5_000 + np.arange(n_samples, dtype=np.int64) * 10_000
    out = []
    for metric, schema in ((C, "prom-counter"), (G, "gauge")):
        for i in range(n_series // 2):
            if grid == "irregular":
                ts = BASE + np.cumsum(rng.integers(5_000, 15_001, n_samples)).astype(np.int64)
            elif grid == "jitter":
                ts = nominal + np.rint(rng.uniform(-0.05, 0.05, n_samples) * 10_000).astype(
                    np.int64)
            else:
                ts = nominal
            if schema == "prom-counter":
                vals = np.cumsum(rng.uniform(0, 10, n_samples)) + 1e6
                if i % 3 == 0:
                    vals[n_samples // 2:] -= vals[n_samples // 2] - 3.0
            else:
                vals = 50 + 20 * rng.standard_normal(n_samples)
                vals[4::9] = vals[3::9][: len(vals[4::9])]
            tags = {S.METRIC_TAG: metric, "_ws_": "demo", "_ns_": "App-2",
                    "instance": f"host-{i}", "zone": f"z{i % 4}"}
            out.append((tags, schema, ts, vals))
    return out


def build_stores(data, shards=N_SHARDS):
    jms, pms = JaxMemStore(), TimeSeriesMemStore()
    jms.setup(JS.Dataset("prometheus"), range(shards))
    pms.setup(S.Dataset("prometheus"), range(shards))
    for tags, schema, ts, vals in data:
        col = "count" if schema == "prom-counter" else "value"
        shard = S.shard_for(tags, SPREAD, shards)
        jms.shard("prometheus", shard).ingest_series(JaxSeriesBatch(
            schema=JS.SCHEMAS[schema], tags=tags, timestamps=ts, values={col: vals}))
        pms.shard("prometheus", shard).ingest_series(SeriesBatch(
            schema=S.SCHEMAS[schema], tags=tags, timestamps=ts, values={col: vals}))
    return jms, pms


@pytest.fixture(scope="module")
def stores():
    return {grid: (build_stores(make_data(grid)), make_data(grid)) for grid in GRIDS}


def by_labels(res) -> dict:
    return {tuple(sorted(l.items())): np.asarray(v, np.float64)
            for g in res.grids for l, v in zip(g.labels, g.values_np())}


def oracle(func: str, data, metric: str, labels_key, step_times, window_ms: int,
           args) -> np.ndarray:
    """float64 deriv/predict_linear and the stddev family over one
    series' raw samples (``metric`` and the stripped labels ``labels_key``
    name it; tc rounded to f32 seconds as both packages round it)."""
    want = dict(labels_key, **{S.METRIC_TAG: metric})
    for tags, _, ts, vals in data:
        if tags == want:
            break
    out = np.full(len(step_times), np.nan)
    for j, t in enumerate(step_times):
        m = (ts > t - window_ms) & (ts <= t)
        w = np.asarray(vals, np.float64)[m]
        if not len(w):
            continue
        if func in ("deriv", "predict_linear"):
            tc = ((ts[m] - t).astype(np.float32) * np.float32(1e-3)).astype(np.float64)
            n = float(len(w))
            denom = n * (tc * tc).sum() - tc.sum() ** 2
            if n < 2 or abs(denom) < 1e-30:
                continue
            slope = (n * (tc * w).sum() - tc.sum() * w.sum()) / denom
            out[j] = slope if func == "deriv" else (w.sum() - slope * tc.sum()) / n + slope * args[0]
            continue
        var = ((w - w.mean()) ** 2).mean()
        out[j] = {"stdvar_over_time": var, "stddev_over_time": np.sqrt(var),
                  "z_score": (w[-1] - w.mean()) / max(np.sqrt(var), 1e-30)}[func]
    return out


def assert_rows_match(got: dict, want: dict, what: str, exact: bool = False,
                      oracle_of=None) -> None:
    assert sorted(got) == sorted(want), what
    assert want, what
    for k, w in want.items():
        g = got[k]
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=f"{what} {k}")
        m = ~np.isnan(w)
        if exact:
            np.testing.assert_array_equal(g[m], w[m], err_msg=what)
            continue
        if oracle_of is not None:
            o = oracle_of(k)
            jax_ok = ~m | np.isclose(w, o, rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(g[m & jax_ok], w[m & jax_ok], rtol=RTOL, atol=ATOL,
                                       err_msg=what)
            np.testing.assert_allclose(g[~jax_ok], o[~jax_ok], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{what} (oracle)")
            continue
        np.testing.assert_allclose(g[m], w[m], rtol=RTOL, atol=ATOL, err_msg=f"{what} {k}")


def func_of(query: str):
    return getattr(port_logical(query, START_S, END_S, STEP_S), "function", None)


# -- the range functions against the JAX engine ----------------------------------------


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("query", QUERIES)
def test_tree_query_matches_jax(stores, query, grid):
    (jms, pms), data = stores[grid]
    want_res = JaxEngine(jms, "prometheus").query_range(query, START_S, END_S, STEP_S)
    got_res = QueryEngine(pms, "prometheus", device="cpu").query_range(query, START_S, END_S,
                                                                        STEP_S)
    assert got_res.result_type == "matrix"
    assert len(got_res.grids) == len(want_res.grids)  # one per non-empty shard leaf
    func = func_of(query)
    oracle_of = None
    if func in ORACLE_FUNCS:
        plan = port_logical(query, START_S, END_S, STEP_S)
        steps = plan.start_ms + np.arange(
            (plan.end_ms - plan.start_ms) // plan.step_ms + 1) * plan.step_ms - plan.offset_ms

        metric = C if C in query else G

        def oracle_of(k):
            return oracle(func, data, metric, k, steps, plan.window_ms, plan.function_args)
    assert_rows_match(by_labels(got_res), by_labels(want_res), f"{query} {grid}",
                      exact=func == "timestamp", oracle_of=oracle_of)


def test_instant_tree_query_matches_jax(stores):
    (jms, pms), _ = stores["irregular"]
    q, t = f"quantile_over_time(0.9, {G}[5m])", END_S
    want = JaxEngine(jms, "prometheus").query_instant(q, t)
    got = QueryEngine(pms, "prometheus", device="cpu").query_instant(q, t)
    assert got.result_type == want.result_type == "vector"
    assert_rows_match(by_labels(got), by_labels(want), q)


# -- plans ---------------------------------------------------------------------------


def test_tree_plans_one_leaf_per_shard(stores):
    (_, pms), _ = stores["irregular"]
    eng = QueryEngine(pms, "prometheus", device="cpu")
    plan = eng.planner.materialize(port_logical(f"rate({C}[5m])", START_S, END_S, STEP_S))
    assert isinstance(plan, P.DistConcatExec)
    assert sorted(c.shard_num for c in plan.children()) == list(range(N_SHARDS))
    for leaf in plan.children():
        assert isinstance(leaf, P.SelectRawPartitionsExec)
        (mapper,) = leaf.transformers
        assert (mapper.function, mapper.window_ms) == ("rate", 300_000)
        assert P._counter_stage_mode(leaf.transformers) == "corrected"
    one = QueryEngine(pms, "prometheus", device="cpu", shard_nums=[2])
    assert isinstance(one.planner.materialize(port_logical(C, START_S, END_S, STEP_S)),
                      P.SelectRawPartitionsExec)
    none = QueryEngine(pms, "prometheus", device="cpu", shard_nums=[])
    plan = none.planner.materialize(port_logical(C, START_S, END_S, STEP_S))
    assert isinstance(plan, P.EmptyResultExec)
    assert none.query_range(C, START_S, END_S, STEP_S).grids == []


@pytest.mark.parametrize("func, mode", [
    ("rate", "corrected"), ("irate", "corrected"), ("delta", "shifted"),
    ("median_absolute_deviation_over_time", "shifted"), ("changes", "diff"),
    ("quantile_over_time", "raw"), ("timestamp", "raw"), (None, "raw"),
])
def test_leaf_counter_stage_mode_follows_jax(func, mode):
    from filodb_tpu.query.exec import plans as JP
    from filodb_tpu.query.exec.transformers import PeriodicSamplesMapper as JaxMapper
    from filodb_tpu_torch.query.exec.transformers import PeriodicSamplesMapper

    port = P._counter_stage_mode([PeriodicSamplesMapper(0, 60_000, 60_000, func, 300_000)])
    jax = JP._counter_stage_mode([JaxMapper(0, 60_000, 60_000, func, 300_000)])
    assert port == jax == mode


# -- the ladder's rungs --------------------------------------------------------------


LADDER_FUNCS = ["rate", "irate", "idelta", "changes", "resets", "deriv", "predict_linear",
                "min_over_time", "absent_over_time", "avg_over_time", "stddev_over_time",
                "quantile_over_time", "median_absolute_deviation_over_time",
                "double_exponential_smoothing", "timestamp"]
def port_rung(jvariant: str, func: str, args) -> str:
    """The port's rung of a JAX ladder variant: the same name, but JAX's
    ``general`` and ``pallas`` map to the general kernel for its functions
    and the functions with arguments, and to window stats for the rest."""
    from filodb_tpu_torch.ops import aggregations as AGG
    from filodb_tpu_torch.ops import general_range as GR

    if jvariant not in ("general", "pallas"):
        return jvariant
    return "general" if args or func in GR.ARG_FUNCS else AGG.general_rung(func)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("func", LADDER_FUNCS)
def test_ladder_maps_the_jax_rungs(stores, func, grid):
    """The rung that serves each function on each grid is the JAX
    package's tree ladder's (``port_rung``): ``mxu`` for its MXU functions on
    a regular grid (B5 included), ``jitter`` for the jitter functions
    without arguments on a jittered grid, sorted and host as in JAX. The
    values match the JAX dispatch's (rtol 2e-4 / atol 1e-4; the
    JAX-or-oracle rule needs raw data, so the ORACLE functions run on the
    gauge's rows only where JAX agrees with the port)."""
    from filodb_tpu.ops import staging as JST

    (_, pms), data = stores[grid]
    ts_list = [np.asarray(ts) for tags, schema, ts, _ in data if schema == "gauge"]
    vals_list = [np.asarray(v) for tags, schema, _, v in data if schema == "gauge"]
    series = list(zip(ts_list, vals_list))
    block = ST.stage_series(series, BASE, [(0, i) for i in range(len(series))])
    jblock = JST.stage_series(series, BASE)
    assert (block.regular_ts is not None) == (grid == "regular")
    dev = ST.device_copy(block, "cpu")
    args = (0.5,) if func == "quantile_over_time" else (
        (600.0,) if func == "predict_linear" else ((0.3, 0.1) if func.startswith("double") else ()))
    params = K.RangeParams(int(START_S * 1000), 60_000, 17, 300_000)
    got, variant = K._dispatch_range_function(func, dev, params, args=args)
    jparams = JK.RangeParams(int(START_S * 1000), 60_000, 17, 300_000)
    want, jvariant = JK._dispatch_range_function(func, jblock, jparams, args=args)
    assert variant == port_rung(jvariant, func, args), (func, variant, jvariant)
    assert variant == K.tree_rung(func, dev, params, args=args)
    if grid == "regular" and func not in ("quantile_over_time", "timestamp",
                                          "median_absolute_deviation_over_time",
                                          "double_exponential_smoothing"):
        assert variant == "mxu", func
    n = block.n_series
    g = np.asarray(got[:n, :17], np.float64)
    w = np.asarray(want, np.float64)[:n, :17]
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=func)
    m = ~np.isnan(w)
    close = np.isclose(g, w, rtol=RTOL, atol=ATOL)
    if func in ("deriv", "predict_linear", "stddev_over_time"):
        assert close[m].mean() > 0.9, func  # f32 vs f64 sums and means (ROADMAP C)
    else:
        assert close[m].all(), func


# -- histogram buckets, limits -------------------------------------------------------


@pytest.fixture(scope="module")
def hist_stores():
    jb = histogram_batch(n_series=8, n_samples=150, start_ms=BASE,
                         metric="http_request_latency")
    jms, pms = JaxMemStore(), TimeSeriesMemStore()
    jms.setup(JS.Dataset("prometheus"), range(N_SHARDS))
    pms.setup(S.Dataset("prometheus"), range(N_SHARDS))
    jms.ingest_routed("prometheus", jb, SPREAD)
    pms.ingest_routed("prometheus", RecordBatch(S.SCHEMAS[jb.schema.name], jb.timestamps,
                                                dict(jb.values), jb.tags,
                                                bucket_les=jb.bucket_les), SPREAD)
    return jms, pms


@pytest.mark.parametrize("query", [
    'rate(http_request_latency_bucket{le="0.5"}[5m])',
    'http_request_latency_bucket{le="+Inf"}',
    'increase(http_request_latency_bucket{le="10"}[5m])',
    'http_request_latency_bucket{le="0.3"}',  # no such bound: no rows
    "rate(http_request_latency_count[5m])",
    "http_request_latency_sum",
])
def test_classic_suffixes_match_jax(hist_stores, query):
    jms, pms = hist_stores
    want = by_labels(JaxEngine(jms, "prometheus").query_range(query, START_S, END_S, STEP_S))
    got = by_labels(QueryEngine(pms, "prometheus", device="cpu").query_range(
        query, START_S, END_S, STEP_S))
    if "0.3" in query:
        assert got == want == {}
        return
    assert_rows_match(got, want, query)


def test_native_histogram_tree_raises(hist_stores):
    """The tree over native histograms, once refused here, answers as the
    JAX engine does: every series' NaN placeholder values beside its
    per-bucket rates (tests/test_torch_hist_tree.py holds the rest of
    ROADMAP A2b)."""
    jms, pms = hist_stores
    q = "rate(http_request_latency[5m])"
    want = JaxEngine(jms, "prometheus").query_range(q, START_S, END_S, STEP_S)
    got = QueryEngine(pms, "prometheus", device="cpu").query_range(q, START_S, END_S, STEP_S)
    assert sorted(by_labels(got)) == sorted(by_labels(want))
    assert all(np.isnan(v).all() for v in by_labels(got).values())

    def buckets(res):
        return {tuple(sorted(l.items())): np.asarray(h, np.float64)
                for g in res.grids for l, h in zip(g.labels, g.hist_np())}

    b_got, b_want = buckets(got), buckets(want)
    assert sorted(b_got) == sorted(b_want) and b_want
    for k, w in b_want.items():
        np.testing.assert_array_equal(np.isnan(b_got[k]), np.isnan(w))
        m = ~np.isnan(w)
        np.testing.assert_allclose(b_got[k][m], w[m], rtol=RTOL, atol=ATOL)


def test_series_limit_matches_jax(stores):
    """A leaf past max_series raises the JAX engine's QueryError, message
    and the failing child's note included."""
    from filodb_tpu.query.exec.transformers import QueryError as JaxQueryError

    (jms, pms), _ = stores["irregular"]
    q = f"rate({C}[5m])"
    with pytest.raises(JaxQueryError) as want:
        JaxEngine(jms, "prometheus", params=JaxParams(max_series=1)).query_range(
            q, START_S, END_S, STEP_S)
    with pytest.raises(P.QueryError) as got:
        QueryEngine(pms, "prometheus", device="cpu", params=PlannerParams(max_series=1)).query_range(
            q, START_S, END_S, STEP_S)
    assert str(got.value) == str(want.value)


def test_sample_limit_matches_jax(stores):
    from filodb_tpu.query.exec import plans as JP
    from filodb_tpu.query.exec.transformers import QueryError as JaxQueryError

    (jms, pms), _ = stores["irregular"]
    q = f"rate({C}[5m])"
    jeng = JaxEngine(jms, "prometheus")
    jctx = jeng.context()
    jctx.max_samples = 100
    peng = QueryEngine(pms, "prometheus", device="cpu")
    pctx = peng.context()
    pctx.max_samples = 100
    with pytest.raises(JaxQueryError) as want:
        jeng.planner.materialize(jax_logical(q, START_S, END_S, STEP_S, 300_000)).execute(jctx)
    with pytest.raises(P.QueryError) as got:
        peng.planner.materialize(port_logical(q, START_S, END_S, STEP_S)).execute(pctx)
    assert str(got.value) == str(want.value)
    assert isinstance(jeng.planner.materialize(jax_logical(q, START_S, END_S, STEP_S, 300_000)),
                      JP.DistConcatExec)


# -- the staging cache's device copies -----------------------------------------------


def test_warm_tree_query_stages_and_uploads_nothing():
    """A leaf's block is its staging-cache entry's device copy: the cold
    query stages every shard once (a copy counted in the entry's bytes);
    the warm repeat hits every shard's entry and serves the same copy
    objects, staging nothing; a repair (an in-range ingest) drops the
    copy with the block it was made from."""
    jms, pms = build_stores(make_data("irregular", seed=4))
    eng = QueryEngine(pms, "prometheus", device="cpu")
    q = f"quantile_over_time(0.9, {G}[5m])"
    cold = eng.query_range(q, START_S, END_S, STEP_S)
    held = [s for s in range(N_SHARDS) if pms.shard("prometheus", s).stage_cache]
    assert len(held) == len(cold.grids) > 1  # the shards the series land on
    assert cold.stats.cache_misses == len(held) and cold.stats.bytes_staged > 0
    entries = {}
    for s in held:
        shard = pms.shard("prometheus", s)
        (entry,) = shard.stage_cache.values()
        assert entry.dev_block is not None and entry.dev_block.host_block is entry.block
        assert entry.nbytes == ST.staged_nbytes(entry.block) + ST.staged_nbytes(entry.dev_block)
        entries[s] = (entry, entry.dev_block)
    warm = eng.query_range(q, START_S, END_S, STEP_S)
    assert warm.stats.cache_hits == len(held)
    assert warm.stats.cache_misses == 0 and warm.stats.bytes_staged == 0
    for s, (entry, dev) in entries.items():
        assert entry.dev_block is dev
    assert_rows_match(by_labels(warm), by_labels(cold), "warm")
    # a new series in range: the shard drops its entry, and the next query
    # stages the shard afresh with a new copy
    tags = {S.METRIC_TAG: G, "_ws_": "demo", "_ns_": "App-2", "instance": "host-99",
            "zone": "z0"}
    shard_num = S.shard_for(tags, SPREAD, N_SHARDS)
    shard = pms.shard("prometheus", shard_num)
    shard.ingest_series(SeriesBatch(schema=S.SCHEMAS["gauge"], tags=tags,
                                    timestamps=np.array([BASE + 600_000, BASE + 610_000]),
                                    values={"value": np.array([51.0, 52.0])}))
    again = eng.query_range(q, START_S, END_S, STEP_S)
    assert shard_num in held
    assert again.stats.cache_misses == 1 and again.stats.cache_hits == len(held) - 1
    (entry,) = shard.stage_cache.values()
    assert entry.dev_block is not entries[shard_num][1]
    assert entry.dev_block.host_block is entry.block


# -- time slicing ----------------------------------------------------------------------

DAY_MS = 86_400_000
LONG_SERIES, LONG_SAMPLE_MS = 6, 300_000  # 30 days at one sample per 5 min


@pytest.fixture(scope="module")
def month_stores():
    rng = np.random.default_rng(7)
    n = 30 * DAY_MS // LONG_SAMPLE_MS
    data = []
    for i in range(LONG_SERIES):
        ts = BASE + np.arange(n, dtype=np.int64) * LONG_SAMPLE_MS
        vals = np.cumsum(rng.uniform(0, 10, n)) + 1e3
        tags = {S.METRIC_TAG: C, "_ws_": "demo", "_ns_": "App-2", "instance": f"host-{i}",
                "zone": f"z{i % 2}"}
        data.append((tags, "prom-counter", ts, vals))
    return build_stores(data, shards=2)


MONTH = ((BASE + 2 * 3_600_000) / 1000, (BASE + 30 * DAY_MS - 3_600_000) / 1000, 3_600)


@pytest.mark.parametrize("query", [f"rate({C}[1h])", f"sum(rate({C}[1h]))",
                                   f"sum by (zone) (rate({C}[1h]))"])
def test_thirty_days_stitch_and_match_jax(month_stores, query):
    """A 30-day range spans more than the int32 ms offsets of a staged
    block: both planners cut it into the same slices under a
    StitchRvsExec (the fused aggregate too), and the answers agree."""
    from filodb_tpu.query.exec import plans as JP

    jms, pms = month_stores
    start, end, step = MONTH
    jeng, peng = JaxEngine(jms, "prometheus"), QueryEngine(pms, "prometheus", device="cpu")
    jl, pl = jax_logical(query, start, end, step, 300_000), port_logical(query, start, end, step)
    slices = peng.planner._wide_range_slices(pl)
    assert slices is not None and len(slices) == 2
    assert slices == jeng.planner._wide_range_slices(jl)
    plan = peng.planner.materialize(pl)
    assert isinstance(plan, P.StitchRvsExec) and isinstance(jeng.planner.materialize(jl),
                                                             JP.StitchRvsExec)
    kinds = {type(c).__name__ for c in plan.children()}
    assert kinds == ({"FusedAggregateExec"} if query.startswith("sum") else {"DistConcatExec"})
    want = by_labels(jeng.query_range(query, start, end, step))
    got = by_labels(peng.query_range(query, start, end, step))
    assert_rows_match(got, want, query)
    assert all(np.isfinite(v).mean() > 0.99 for v in got.values())
