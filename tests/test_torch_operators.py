"""Instant functions, operators and the small mappers of the reference tree
in the port against the JAX package's on mirrored memstores: every
elementwise function and time component, clamp/clamp_min/clamp_max, round
(half to even), or_vector and timestamp; every arithmetic and comparison
operator between a vector and a scalar on either side, with and without
``bool``; vector joins (``on``, ``ignoring``, ``group_left`` /
``group_right`` with ``include``) and their errors, word for word;
and/or/unless; label_replace and label_join, sort and sort_desc, limit,
absent, ``scalar()``, ``vector()`` and ``time()``.

Inputs are made from a seed with numpy. Rows are matched by labels; NaN
masks must be equal and values within rtol 2e-4 / atol 1e-4 (infinities
equal); timestamps and time components exactly (f64 on the host in both).
"""

import numpy as np
import pytest

from filodb_tpu.coordinator.planner import QueryEngine as JaxEngine
from filodb_tpu.core import schemas as JS
from filodb_tpu.core.records import SeriesBatch as JaxSeriesBatch
from filodb_tpu.memstore.memstore import TimeSeriesMemStore as JaxMemStore
from filodb_tpu_torch.coordinator.planner import QueryEngine
from filodb_tpu_torch.core import schemas as S
from filodb_tpu_torch.core.records import SeriesBatch
from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore
from filodb_tpu_torch.query.exec import transformers as TR

BASE = 1_600_000_000_000
N_SERIES, N_SAMPLES, N_SHARDS, SPREAD = 16, 120, 4, 1
START_S = (BASE + 400_000) / 1000
END_S = (BASE + 1_100_000) / 1000
STEP_S = 60
RTOL, ATOL = 2e-4, 1e-4
C, G = "http_requests_total", "node_temp"


def make_data(seed: int = 0):
    """Counters and gauges (values to one decimal, so rounding meets exact
    halves; NaN gaps in one gauge) on irregular 5-15 s samples."""
    rng = np.random.default_rng(seed)
    out = []
    for metric, schema in ((C, "prom-counter"), (G, "gauge")):
        for i in range(N_SERIES // 2):
            ts = BASE + np.cumsum(rng.integers(5_000, 15_001, N_SAMPLES)).astype(np.int64)
            if schema == "prom-counter":
                vals = np.cumsum(rng.uniform(0, 10, N_SAMPLES)) + 1e6
            else:
                vals = np.round(50 + 20 * rng.standard_normal(N_SAMPLES), 1)
                if i == 1:
                    vals[30:50] = np.nan
            tags = {S.METRIC_TAG: metric, "_ws_": "demo", "_ns_": "App-2",
                    "instance": f"host-{i}", "zone": f"z{i % 4}", "dc": f"d{i % 2}"}
            out.append((tags, schema, ts, vals))
    return out


@pytest.fixture(scope="module")
def engines():
    jms, pms = JaxMemStore(), TimeSeriesMemStore()
    jms.setup(JS.Dataset("prometheus"), range(N_SHARDS))
    pms.setup(S.Dataset("prometheus"), range(N_SHARDS))
    for tags, schema, ts, vals in make_data():
        col = "count" if schema == "prom-counter" else "value"
        shard = S.shard_for(tags, SPREAD, N_SHARDS)
        jms.shard("prometheus", shard).ingest_series(JaxSeriesBatch(
            schema=JS.SCHEMAS[schema], tags=tags, timestamps=ts, values={col: vals}))
        pms.shard("prometheus", shard).ingest_series(SeriesBatch(
            schema=S.SCHEMAS[schema], tags=tags, timestamps=ts, values={col: vals}))
    return JaxEngine(jms, "prometheus"), QueryEngine(pms, "prometheus", device="cpu")


def by_labels(res) -> dict:
    return {tuple(sorted(l.items())): np.asarray(v, np.float64)
            for g in res.grids for l, v in zip(g.labels, g.values_np())}


def assert_same(got: dict, want: dict, what: str, exact: bool = False) -> None:
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        g = got[k]
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=f"{what} {k}")
        m = ~np.isnan(w)
        if exact:
            np.testing.assert_array_equal(g[m], w[m], err_msg=what)
        else:
            np.testing.assert_allclose(g[m], w[m], rtol=RTOL, atol=ATOL, err_msg=f"{what} {k}")


def both(engines, query: str, instant: bool = False):
    jax_engine, port_engine = engines
    if instant:
        return (jax_engine.query_instant(query, END_S), port_engine.query_instant(query, END_S))
    return (jax_engine.query_range(query, START_S, END_S, STEP_S),
            port_engine.query_range(query, START_S, END_S, STEP_S))


def check(engines, query: str, exact: bool = False, instant: bool = False):
    want, got = both(engines, query, instant)
    assert got.result_type == want.result_type, query
    assert_same(by_labels(got), by_labels(want), query, exact)
    return want, got


# -- instant functions ---------------------------------------------------------------------


@pytest.mark.parametrize("arg", [f"{G} / 100", f"{G} - 50", f"rate({C}[5m])"])
@pytest.mark.parametrize("func", sorted(TR._ELEMENTWISE))
def test_elementwise_functions_match_jax(engines, func, arg):
    check(engines, f"{func}({arg})")


@pytest.mark.parametrize("func", sorted(TR._TIME_COMPONENT) + ["timestamp"])
def test_time_functions_match_jax(engines, func):
    check(engines, f"{func}({G})", exact=True)


@pytest.mark.parametrize("query", [
    f"clamp({G}, 40, 60)", f"clamp({G}, 60, 40)", f"clamp_min({G}, 55.5)",
    f"clamp_max(rate({C}[5m]), 0.5)", f"round({G})", f"round({G}, 5)", f"round({G} / 3, 0.25)",
    f"round({G} - 0.5)",
])
def test_clamp_and_round_match_jax(engines, query):
    check(engines, query)


def test_or_vector_fills_absent_samples(engines):
    jax_engine, port_engine = engines
    from filodb_tpu.query.exec.transformers import InstantVectorFunctionMapper as JaxMapper
    from filodb_tpu.query.rangevector import Grid as JaxGrid
    from filodb_tpu_torch.query.rangevector import Grid

    vals = np.array([[1.5, np.nan, -2.0], [np.nan, np.nan, 0.0]], np.float32)
    labels = [{S.METRIC_TAG: "m", "a": "1"}, {S.METRIC_TAG: "m", "a": "2"}]
    (want,) = JaxMapper("or_vector", (7.25,)).apply([JaxGrid(labels, 0, 1, 3, vals)])
    (got,) = TR.InstantVectorFunctionMapper("or_vector", (7.25,)).apply(
        [Grid(labels, 0, 1, 3, vals)])
    assert got.labels == want.labels == [{"a": "1"}, {"a": "2"}]
    np.testing.assert_array_equal(got.values_np(), np.asarray(want.values))


def test_round_is_half_to_even(engines):
    from filodb_tpu_torch.query.rangevector import Grid

    vals = np.array([[0.5, 1.5, 2.5, -0.5, -1.5]], np.float32)
    (got,) = TR.InstantVectorFunctionMapper("round", ()).apply([Grid([{}], 0, 1, 5, vals)])
    np.testing.assert_array_equal(got.values_np(), [[0, 2, 2, -0, -2]])


@pytest.mark.parametrize("func", ["histogram_fraction", "histogram_bucket",
                                  "histogram_max_quantile", "hist_to_prom_vectors"])
def test_native_histogram_functions_raise(func):
    """Over a grid without buckets the native-histogram functions answer
    as the JAX package's mapper does: its errors (type and text), or the
    grid passed through (hist_to_prom_vectors)."""
    from filodb_tpu.query.exec import transformers as JTR
    from filodb_tpu.query.rangevector import Grid as JaxGrid
    from filodb_tpu_torch.query.rangevector import Grid

    args = (0.5, 1.0)

    def run(apply):
        try:
            (g,) = apply()
        except Exception as e:  # the JAX package's errors are part of its answer
            return type(e).__name__, str(e)
        return g.labels, g.values_np().tolist()

    got = run(lambda: TR.InstantVectorFunctionMapper(func, args).apply(
        [Grid([{"a": "b"}], 0, 1, 1, np.zeros((1, 1)))]))
    want = run(lambda: JTR.InstantVectorFunctionMapper(func, args).apply(
        [JaxGrid([{"a": "b"}], 0, 1, 1, np.zeros((1, 1)))]))
    assert got == want


# -- scalar operators -----------------------------------------------------------------------

ARITH = ["+", "-", "*", "/", "%", "^", "atan2"]
CMP = ["==", "!=", ">", "<", ">=", "<="]


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("op", ARITH)
def test_arithmetic_with_a_scalar_matches_jax(engines, op, side):
    operand = "1.5" if op == "^" else "7"
    vec = f"({G} / 10)" if op == "^" else G
    query = f"{vec} {op} {operand}" if side == "left" else f"{operand} {op} {vec}"
    check(engines, query)


@pytest.mark.parametrize("bool_", ["", "bool "])
@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("op", CMP)
def test_comparison_with_a_scalar_matches_jax(engines, op, side, bool_):
    query = f"{G} {op} {bool_}50" if side == "left" else f"50 {op} {bool_}{G}"
    want, got = check(engines, query)
    # the metric name stays only on a comparison's filter
    names = {l.get(S.METRIC_TAG) for g in got.grids for l in g.labels}
    assert names == ({G} if not bool_ else {None})


def test_modulo_is_floored_and_nan_at_zero(engines):
    check(engines, f"(-{G}) % 7")
    check(engines, f"{G} % 0")


@pytest.mark.parametrize("query", [
    "time()", "hour()", "day_of_week()", "2 * 3 + 1", "time() - 1600000000",
    f"{G} * time() / 1e9", f"{G} > bool scalar({C}{{instance=\"host-0\"}})",
    f"scalar(sum({G})) * {G}", f"vector(time())", "vector(4)",
])
def test_scalars_match_jax(engines, query):
    want, got = both(engines, query)
    assert got.result_type == want.result_type, query
    if want.scalar is not None:
        np.testing.assert_allclose(got.scalar.values, np.asarray(want.scalar.values),
                                   rtol=RTOL, atol=ATOL)
        assert (got.scalar.start_ms, got.scalar.step_ms, got.scalar.num_steps) == (
            want.scalar.start_ms, want.scalar.step_ms, want.scalar.num_steps)
    else:
        assert_same(by_labels(got), by_labels(want), query)


def test_scalar_of_many_series_is_nan(engines):
    want, got = both(engines, f"scalar({G})")
    assert np.isnan(got.scalar.values).all() and np.isnan(np.asarray(want.scalar.values)).all()


# -- vector joins ---------------------------------------------------------------------------


@pytest.mark.parametrize("query", [
    f"rate({C}[5m]) / irate({C}[5m])",
    f"{G} - on (instance, zone, dc) max_over_time({G}[5m])",
    f"{G} > ignoring (zone) min_over_time({G}[5m])",
    f"{G} > bool on (instance, dc, zone) avg_over_time({G}[5m])",
    f"rate({C}[5m]) / on (zone) group_left sum by (zone) (rate({C}[5m]))",
    f"sum by (zone) (rate({C}[5m])) / on (zone) group_right rate({C}[5m])",
    f"{G} * on (zone) group_left (dc) max by (zone, dc) ({G})",
    f"{G} + on (zone) group_left (dc, missing) sum by (zone) ({G})",
    f"{G} / ignoring (instance, dc) group_left sum by (zone, _ws_, _ns_) ({G})",
    f"max by (dc) ({G}) - on (dc) group_right (zone) {G}",
    f"{G} == on (instance, zone, dc) {G}",
])
def test_vector_joins_match_jax(engines, query):
    check(engines, query)


@pytest.mark.parametrize("query, message", [
    (f"{G} / on (zone) {C}",
     "many-to-many matching not allowed: use group_left/group_right"),
    (f"{G} / on (zone) sum by (zone) ({C})", "multiple matches for labels on left side"),
    (f"{G} / on (zone) group_left {C}",
     "multiple matches on the 'one' side of a grouped join"),
])
def test_join_errors_match_jax_word_for_word(engines, query, message):
    jax_engine, port_engine = engines
    with pytest.raises(ValueError) as want:
        jax_engine.query_range(query, START_S, END_S, STEP_S)
    with pytest.raises(TR.QueryError) as got:
        port_engine.query_range(query, START_S, END_S, STEP_S)
    assert str(got.value).split(" [child")[0] == str(want.value).split(" [child")[0] == message


@pytest.mark.parametrize("query", [
    f"{G} and {G} > 50", f"{G} unless {G} > 50", f"{G} > 60 or {G} < 40",
    f"{G} and on (zone) ({G} > 70)", f"{G} unless ignoring (instance) ({G} < 30)",
    f"rate({C}[5m]) or {G}", f"({G} > 55) or on (instance) {G}", f"{G} and {C}",
])
def test_set_operators_match_jax(engines, query):
    check(engines, query)


# -- labels, sort, limit, absent -------------------------------------------------------------


@pytest.mark.parametrize("query", [
    f'label_replace({G}, "host", "$1", "instance", "host-(.*)")',
    f'label_replace({G}, "zone", "", "instance", ".*")',
    f'label_replace({G}, "x", "$1-$2", "instance", "(h)ost-(.*)")',
    f'label_replace({G}, "x", "y", "instance", "nomatch")',
    f'label_join({G}, "zd", "/", "zone", "dc")',
    f'label_join(rate({C}[5m]), "all", "", "instance", "nothing", "zone")',
])
def test_label_functions_match_jax(engines, query):
    check(engines, query)


@pytest.mark.parametrize("query, plain", [
    (f'sum by (host) (label_replace(rate({C}[5m]), "host", "$1", "instance", "host-([0-3])"))',
     f"sum by (host) (rate({C}[5m]))"),
    (f'max by (zd) (label_join({G}, "zd", "-", "zone", "dc"))', f"max by (zd) (max_over_time({G}[5m]))"),
    (f'topk by (zd) (1, label_join({G}, "zd", "-", "zone", "dc"))', f"topk by (zd) (1, {G})"),
])
def test_aggregates_over_relabelled_leaves_match_jax(engines, query, plain):
    """On one shard (a single leaf, no concatenation) an aggregate groups
    the relabelled series, not by the grouping the leaf's block memoized
    for the same ``by`` over its original labels (``plain`` runs first)."""
    jax_engine, port_engine = engines
    shard = S.shard_for(make_data()[N_SERIES // 2][0], SPREAD, N_SHARDS)  # one with gauges
    single = (JaxEngine(jax_engine.memstore, "prometheus", shard_nums=[shard]),
              QueryEngine(port_engine.memstore, "prometheus", shard_nums=[shard], device="cpu"))
    check(single, plain)
    _, got = check(single, query)
    assert len({l.get("host") or l.get("zd") for g in got.grids for l in g.labels}) > 1


@pytest.mark.parametrize("query", [f"sort({G})", f"sort_desc({G})",
                                   f"sort_desc(rate({C}[5m]))", f"sort({G} > 55)"])
def test_sort_matches_jax_in_order(engines, query):
    want, got = check(engines, query, instant=True)
    order = [tuple(sorted(l.items())) for g in got.grids for l in g.labels]
    assert order == [tuple(sorted(l.items())) for g in want.grids for l in g.labels]


@pytest.mark.parametrize("query", [f"limit(3, {G})", f"limit(100, {G})",
                                   f"limit(1, rate({C}[5m]))"])
def test_limit_matches_jax(engines, query):
    want, got = check(engines, query)
    assert sum(g.n_series for g in got.grids) == sum(len(g.labels) for g in want.grids)


@pytest.mark.parametrize("query", [f"absent({G})", 'absent(nothing{zone="z9"})',
                                   f'absent({G} > 75)', f'absent({G}{{zone="z1"}} > 200)'])
def test_absent_matches_jax(engines, query):
    check(engines, query)


# -- sgn over absent steps -------------------------------------------------------------


@pytest.fixture(scope="module")
def nan_engines():
    """tests/test_torch_engine.py's stores on both grids with one sample in
    three set NaN and every fifth series cut short (absent steps)."""
    from tests.test_torch_engine import build_stores, make_data

    out = {}
    for grid in ("irregular", "regular"):
        data = []
        for i, (tags, schema, ts, vals) in enumerate(make_data(grid)):
            vals = vals.copy()
            vals[::3] = np.nan
            if i % 5 == 1:
                ts, vals = ts[: len(ts) // 2], vals[: len(vals) // 2]
            data.append((tags, schema, ts, vals))
        jms, pms = build_stores(data)
        out[grid] = (JaxEngine(jms, "prometheus"), QueryEngine(pms, "prometheus", device="cpu"))
    return out


@pytest.mark.parametrize("grid", ["irregular", "regular"])
@pytest.mark.parametrize("query", ["sgn(node_temp - 50)",
                                   "sgn(rate(http_requests_total[5m]) - 5)"])
def test_sgn_keeps_absent_steps_as_jax(nan_engines, query, grid):
    """``sgn`` of an absent step is absent (NaN), as ``jnp.sign`` keeps it;
    the JAX answer has absent steps, so the case is exercised."""
    from tests.test_torch_engine import END_S as E_END, START_S as E_START, STEP_S as E_STEP

    jax_engine, port_engine = nan_engines[grid]
    want = by_labels(jax_engine.query_range(query, E_START, E_END, E_STEP))
    got = by_labels(port_engine.query_range(query, E_START, E_END, E_STEP))
    assert any(np.isnan(w).any() for w in want.values())
    assert_same(got, want, query)
