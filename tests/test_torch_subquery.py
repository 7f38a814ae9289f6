"""Subqueries in the port against the JAX package's engine on mirrored
memstores: every range function the JAX ladder serves over a subquery
(with its arguments), sub-steps that do and do not divide the window,
``offset`` and ``@`` on the subquery, nested subqueries, subqueries over
aggregates, operators, ``vector(1)`` and native histograms (their answer
or their error), inner rows that are empty or all NaN, a window past the
int32 span of a staged block, and the top-level subquery as a range and as
an instant query.

Rows are matched by labels; NaN masks must be equal and values within
rtol 2e-4 / atol 1e-4 (tests/test_pallas.py's tolerance). Where ROADMAP C
documents a difference (deriv/predict_linear sum in f64 in the port, the
stddev family's mean is the window's own sum), a value is held to the JAX
package where the JAX value agrees with a float64 oracle over the inner
rows (the JAX engine's own inner answer), else to the oracle.

The re-staging of a subquery's inner rows (``staging.stage_step_rows``,
no loop per row) is held bit-equal to ``stage_series`` over the same
(times, values) pairs of each row: NaN runs, resets, signed zeros,
infinities, one-sample and empty rows, with and without counter
correction."""

import numpy as np
import pytest

import test_torch_tree as TT
from test_torch_engine import hist_store  # noqa: F401 (a fixture)
from filodb_tpu.coordinator.planner import QueryEngine as JaxEngine
from filodb_tpu_torch.coordinator.planner import QueryEngine, _plan_times
from filodb_tpu_torch.ops import staging as ST
from filodb_tpu_torch.query.exec import joins as J
from filodb_tpu_torch.query.promql import query_range_to_logical_plan as port_logical

C, G = TT.C, TT.G
START_S, END_S, STEP_S, AT_S = TT.START_S, TT.END_S, TT.STEP_S, TT.AT_S
RTOL, ATOL = 2e-4, 1e-4
RC = f"rate({C}[5m])"  # an inner expression of small, gapless values

# (outer function, its arguments before and after the range) of every
# range function the JAX ladder serves, over an inner expression that fits
# it: counters for the counter functions, the gauge or an inner rate else
RANGE_CASES = [
    ("rate", C), ("increase", C), ("irate", C), ("delta", G), ("idelta", G),
    ("resets", C), ("changes", G), ("deriv", G), ("predict_linear", G, ", 600"),
    ("avg_over_time", RC), ("min_over_time", G), ("max_over_time", RC),
    ("sum_over_time", G), ("count_over_time", RC), ("stddev_over_time", G),
    ("stdvar_over_time", RC), ("last_over_time", G), ("first_over_time", RC),
    ("present_over_time", G), ("absent_over_time", RC),
    ("quantile_over_time", G, "", "0.9, "), ("quantile_over_time", RC, "", "0.25, "),
    ("mad_over_time", G), ("median_absolute_deviation_over_time", RC),
    ("holt_winters", G, ", 0.3, 0.1"), ("double_exponential_smoothing", RC, ", 0.5, 0.5"),
    ("timestamp_of_last_sample", G), ("z_score", G),
    ("last_over_time_is_mad_outlier", G, "", "1, 1, "),
    ("avg_with_sum_and_count_over_time", G),
]


def range_query(case, window: str = "10m:1m") -> str:
    func, inner, after, before = (list(case) + ["", ""])[:4]
    return f"{func}({before}{inner}[{window}]{after})"


QUERIES = [range_query(c) for c in RANGE_CASES] + [
    # sub-steps that do not divide the window, and the default sub-step
    f"max_over_time({RC}[5m:45s])", f"avg_over_time({G}[7m:2m])", f"rate({C}[5m:40s])",
    f"sum_over_time({G}[10m:])",
    # offset and @ on the subquery
    f"max_over_time({RC}[10m:1m] offset 3m)", f"avg_over_time({G}[10m:1m] @ {AT_S})",
    f"rate({C}[10m:1m] offset 2m)",
    # nested subqueries
    f"max_over_time(avg_over_time({G}[5m:1m])[10m:2m])",
    f"min_over_time(max_over_time(rate({C}[2m:30s])[5m:1m])[10m:1m])",
    # over aggregates, operators, functions and vector(1)
    f"max_over_time(sum by (zone) ({RC})[10m:1m])",
    f"deriv(sum by (zone) ({RC})[30m:1m])",
    f"rate(sum({C})[10m:1m])",
    f"avg_over_time(({G} * 2 - 1)[10m:1m])",
    f"max_over_time(abs({G} - 50)[10m:1m])",
    f"max_over_time(({RC} > 0.5)[10m:1m])",
    f"sum(max_over_time({RC}[10m:1m]))",
    f"max_over_time({RC}[10m:1m]) / 2",
    "max_over_time(vector(1)[10m:1m])",
    # inner rows that are partly, wholly and always NaN, and no inner series
    f"avg_over_time(({G} > 60)[10m:1m])", f"count_over_time(({G} > 1000)[10m:1m])",
    f"rate(({C} > 1e12)[10m:1m])", "max_over_time(rate(no_such_metric[5m])[10m:1m])",
    # a window past the int32 span of a staged block
    f"avg_over_time({G}[30d:5m])",
    # top-level subqueries
    f"{RC}[10m:1m]", f"{G}[30m:1m]",
]

# functions held to the JAX-or-oracle rule (ROADMAP C)
ORACLE_FUNCS = {"deriv", "predict_linear", "stddev_over_time", "stdvar_over_time", "z_score"}


@pytest.fixture(scope="module")
def stores():
    return {grid: TT.build_stores(TT.make_data(grid)) for grid in ("irregular", "regular")}


def by_labels(res) -> dict:
    return {tuple(sorted(l.items())): np.asarray(v, np.float64)
            for g in res.grids for l, v in zip(g.labels, g.values_np())}


def answer(run):
    """("ok", result type, rows by labels) of a query, or ("error", type
    name, message)."""
    try:
        res = run()
    except Exception as e:  # the JAX package's errors are part of its answer
        return ("error", type(e).__name__, str(e))
    return ("ok", res.result_type, by_labels(res))


def subquery_oracle(func: str, inner_rows: dict, inner_times, steps, window_ms: int, args):
    """float64 deriv/predict_linear and the stddev family of each outer
    step's window over the inner rows (a dict by labels, as the JAX engine
    answered the inner expression)."""

    def of(k):
        row = inner_rows[k]
        keep = ~np.isnan(row)
        ts, w_all = inner_times[keep], row[keep]
        out = np.full(len(steps), np.nan)
        for j, t in enumerate(steps):
            m = (ts > t - window_ms) & (ts <= t)
            w = w_all[m]
            if not len(w):
                continue
            if func in ("deriv", "predict_linear"):
                tc = ((ts[m] - t).astype(np.float32) * np.float32(1e-3)).astype(np.float64)
                n = float(len(w))
                denom = n * (tc * tc).sum() - tc.sum() ** 2
                if n < 2 or abs(denom) < 1e-30:
                    continue
                slope = (n * (tc * w).sum() - tc.sum() * w.sum()) / denom
                out[j] = slope if func == "deriv" else (
                    (w.sum() - slope * tc.sum()) / n + slope * args[0])
                continue
            var = ((w - w.mean()) ** 2).mean()
            out[j] = {"stdvar_over_time": var, "stddev_over_time": np.sqrt(var),
                      "z_score": (w[-1] - w.mean()) / max(np.sqrt(var), 1e-30)}[func]
        return out
    return of


def assert_matches_jax(jms, pms, query: str, instant: bool = False) -> None:
    if instant:
        want = answer(lambda: JaxEngine(jms, "prometheus").query_instant(query, END_S))
        got = answer(lambda: QueryEngine(pms, "prometheus", device="cpu").query_instant(
            query, END_S))
    else:
        want = answer(lambda: JaxEngine(jms, "prometheus").query_range(query, START_S, END_S,
                                                                        STEP_S))
        got = answer(lambda: QueryEngine(pms, "prometheus", device="cpu").query_range(
            query, START_S, END_S, STEP_S))
    assert got[:2] == want[:2], (query, got[:2], want[:2])
    if want[0] == "error":
        assert got[2] == want[2]
        return
    oracle_of = None
    plan = port_logical(query, END_S if instant else START_S, END_S, 1 if instant else STEP_S)
    if getattr(plan, "function", None) in ORACLE_FUNCS and hasattr(plan, "sub_step_ms"):
        i_start, i_end, i_step = _plan_times(plan.inner)
        inner = by_labels(JaxEngine(jms, "prometheus").query_range(
            query[query.index("(") + 1: query.rindex("[")], i_start / 1000, i_end / 1000,
            i_step / 1000))
        inner_times = i_start + np.arange((i_end - i_start) // i_step + 1,
                                          dtype=np.int64) * i_step
        steps = plan.start_ms + np.arange(
            (plan.end_ms - plan.start_ms) // plan.step_ms + 1) * plan.step_ms - plan.offset_ms
        oracle_of = subquery_oracle(plan.function, inner, inner_times, steps, plan.window_ms,
                                    plan.function_args)
    g, w = got[2], want[2]
    assert sorted(g) == sorted(w), query
    for k, wv in w.items():
        gv = g[k]
        np.testing.assert_array_equal(np.isnan(gv), np.isnan(wv), err_msg=f"{query} {k}")
        m = ~np.isnan(wv)
        if oracle_of is None:
            np.testing.assert_allclose(gv[m], wv[m], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{query} {k}")
            continue
        o = oracle_of(k)
        jax_ok = ~m | np.isclose(wv, o, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(gv[m & jax_ok], wv[m & jax_ok], rtol=RTOL, atol=ATOL,
                                   err_msg=query)
        np.testing.assert_allclose(gv[~jax_ok], o[~jax_ok], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{query} (oracle)")


@pytest.mark.parametrize("grid", ["irregular", "regular"])
@pytest.mark.parametrize("query", QUERIES)
def test_subquery_matches_jax(stores, query, grid):
    jms, pms = stores[grid]
    assert_matches_jax(jms, pms, query)


@pytest.mark.parametrize("query", [
    f"{RC}[10m:1m]", f"max_over_time({RC}[10m:1m])", f"avg_over_time({G}[30d:5m])",
    f"avg_over_time({G}[25d:1h])", f"deriv(sum by (zone) ({RC})[30m:1m])",
])
def test_instant_subquery_matches_jax(stores, query):
    jms, pms = stores["irregular"]
    assert_matches_jax(jms, pms, query, instant=True)


@pytest.mark.parametrize("query", [
    "max_over_time(rate(http_request_latency[5m])[10m:1m])",
    "rate(http_request_latency[5m])[10m:1m]",
    "rate(sum(rate(http_request_latency[5m]))[10m:1m])",
    "max_over_time(http_request_latency_sum[10m:1m])",
])
def test_subquery_over_histograms_matches_jax(hist_store, query):  # noqa: F811
    jms, pms = hist_store
    assert_matches_jax(jms, pms, query)


def test_subquery_plans_one_launch_per_inner_grid(stores, monkeypatch):
    """A subquery re-stages its inner grids through ``stage_step_rows``
    (never ``stage_series``'s loop over rows) and runs one range function
    per inner grid, each on a block re-staged from start - window - offset;
    its host split lands on the context."""
    _, pms = stores["irregular"]
    eng = QueryEngine(pms, "prometheus", device="cpu")
    q = f"max_over_time({RC}[10m:1m] offset 3m)"
    plan = eng.planner.materialize(port_logical(q, START_S, END_S, STEP_S))
    assert isinstance(plan, J.SubqueryWindowExec)
    assert (plan.function, plan.window_ms, plan.sub_step_ms, plan.offset_ms) == (
        "max_over_time", 600_000, 60_000, 180_000)
    bases, calls = [], []
    real_run = J.K.run_range_function

    def run(func, block, params, **kw):
        if func == "max_over_time":  # not the inner leaves' rate
            bases.append(block.base_ms)
            calls.append(func)
        return real_run(func, block, params, **kw)

    def no_loop(*a, **k):
        raise AssertionError("a subquery re-stages without stage_series")

    plan.execute(eng.context())  # the inner leaves staged: the run below hits their caches
    monkeypatch.setattr(J.K, "run_range_function", run)
    monkeypatch.setattr(ST, "stage_series", no_loop)
    ctx = eng.context()
    res = plan.execute(ctx)
    n_grids = len(plan.child_plans[0].execute(eng.context()).grids)
    assert calls == ["max_over_time"] * n_grids and n_grids == len(res.grids) > 0
    assert set(bases) == {plan.start_ms - 600_000 - 180_000}
    (split,) = ctx.obs["subquery"]
    assert split["rows"] == sum(g.n_series for g in res.grids)
    assert set(split) == {"inner_ms", "fetch_ms", "restage_ms", "upload_ms", "launch_ms",
                          "rows"}


# -- the re-staging against stage_series ---------------------------------------------


def restage_rows(kind: str, seed: int) -> np.ndarray:
    """[n, J] f32 inner rows of one kind (NaN = an absent step)."""
    rng = np.random.default_rng(seed)
    n, steps = 37, 23
    v = np.cumsum(rng.uniform(0, 5, (n, steps)), axis=1).astype(np.float32) + 100
    if kind == "nan_runs":
        for i in range(n):
            a = rng.integers(0, steps)
            v[i, a: a + rng.integers(1, 8)] = np.nan
        v[::4, ::3] = np.nan
    elif kind == "resets":
        v[:, 7:] -= v[:, 7:8] - 1.0
        v[::3, 15:] -= v[::3, 15:16]
        v[1::5, 11] = np.nan
    elif kind == "signed_zeros":
        v[:, ::2] = 0.0
        v[:, 1::4] = -0.0
        v[::3, 0] = -0.0
    elif kind == "infinities":
        v[::2, 5] = np.inf
        v[1::3, 9] = -np.inf
        v[::5, 12:14] = np.inf
        v[2::7, 3] = np.nan
    elif kind == "one_and_empty":
        v[:] = np.nan
        v[::2, rng.integers(0, steps)] = 7.0
        v[1::4, 3] = -0.0
    elif kind == "all_empty":
        v[:] = np.nan
    elif kind == "shared_grid":
        v[:, 4::5] = np.nan  # every row on the same steps: a regular grid
    elif kind == "large":
        v = (v.astype(np.float64) * 1e9).astype(np.float32)
        v[:, 10:] -= v[:, 10:11]
    elif kind == "none":
        v = v[:0]
    return v


RESTAGE_KINDS = ["nan_runs", "resets", "signed_zeros", "infinities", "one_and_empty",
                 "all_empty", "shared_grid", "large", "none"]


def assert_same_block(got, want) -> None:
    for name in ("ts", "vals", "lens", "baseline", "raw", "regular_ts", "nominal_ts", "ts_dev",
                 "base64"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if b is not None:
            assert a.dtype == b.dtype and a.shape == b.shape, name
            # bit-equal, the signs of zeros and NaN payloads included
            assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), name
    assert (got.base_ms, got.n_series, got.maxdev_ms, got.part_refs) == (
        want.base_ms, want.n_series, want.maxdev_ms, want.part_refs)
    assert (got.cont is None) == (want.cont is None)
    for a, b in zip(got.cont or (), want.cont or ()):
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), "cont"


@pytest.mark.parametrize("corrected", [False, True], ids=["raw", "corrected"])
@pytest.mark.parametrize("kind", RESTAGE_KINDS)
def test_restage_is_bit_equal_to_stage_series(kind, corrected):
    v = restage_rows(kind, seed=RESTAGE_KINDS.index(kind))
    times = TT.BASE + 60_000 * np.arange(v.shape[1], dtype=np.int64)
    base = int(TT.BASE - 600_000)
    series = []
    for row in v:  # the JAX SubqueryWindowExec's pairs
        keep = ~np.isnan(row)
        series.append((times[keep].astype(np.int64), row[keep].astype(np.float64)))
    want = ST.stage_series(series, base, counter_corrected=corrected)
    got = ST.stage_step_rows(v, times, base, counter_corrected=corrected)
    assert_same_block(got, want)


def test_restage_wraps_past_the_int32_span_as_stage_series():
    """Inner steps more than MAX_STAGE_SPAN_MS after the base wrap in the
    int32 offsets exactly as ``stage_series``'s cast wraps them."""
    v = restage_rows("nan_runs", 3)
    times = TT.BASE + 3_600_000 * np.arange(v.shape[1], dtype=np.int64) * 40
    base = int(TT.BASE - 30 * 86_400_000)
    series = [(times[~np.isnan(r)], r[~np.isnan(r)].astype(np.float64)) for r in v]
    for corrected in (False, True):
        assert_same_block(ST.stage_step_rows(v, times, base, counter_corrected=corrected),
                          ST.stage_series(series, base, counter_corrected=corrected))


@pytest.mark.parametrize("query,instant", [
    (f"max_over_time({G}[30d:5m])", True), (f"max_over_time({G}[30d:5m])", False),
    (f"min_over_time({G}[25d:1h])", True), (f"absent_over_time({G}[30d:5m])", True),
])
def test_wide_window_minmax_answers_as_jax(stores, query, instant):
    """min/max_over_time and absent_over_time over a re-staged grid wider
    than the int32 span: the JAX package's MXU rung answers them, and the
    port's regular rung now takes them too (B5), so both answer alike
    where the window-stats rung raised."""
    jms, pms = stores["irregular"]
    run = (lambda: JaxEngine(jms, "prometheus").query_instant(query, END_S)) if instant else (
        lambda: JaxEngine(jms, "prometheus").query_range(query, START_S, END_S, STEP_S))
    assert answer(run)[0] == "ok"
    assert_matches_jax(jms, pms, query, instant=instant)
