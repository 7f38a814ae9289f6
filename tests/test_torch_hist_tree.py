"""The reference tree over native histograms in the port against the JAX
package's, on mirrored two-shard memstores: the unaggregated histogram
range functions and the bare selector on irregular and regular grids
(``offset``, ``@``, delta histograms, NaN bucket counts), the instant
histogram functions (``histogram_quantile`` per series and after a tree
``sum by``, ``histogram_max_quantile[_even]``, ``histogram_fraction`` at
infinite bounds, below the first bound and on a bound,
``histogram_bucket``, ``hist_to_prom_vectors``), the hist component of
the map and merge phases with ``fused_aggregate`` off against the JAX
engine and the port's own fused answer, two bucket schemes across the
shards, the pass-through of sort, topk, limitk, quantile, count_values,
operators and joins, and the JAX package's errors word for word. Then the
plain versions of the store mode (K1, ``hist_series_plain``) and of the
instant kernel (K2, ``histogram_quantile_plain`` with ``even`` and
``histogram_fraction_plain``) against ``hist_range_kernel``,
``_hist_range_shared``, ``histogram_quantile`` and ``histogram_fraction``.

Rows are matched by labels; NaN masks must be equal, values within rtol
2e-4 / atol 1e-4 (tests/test_pallas.py's tolerance), bucket bounds equal;
an error must have the JAX error's type name and text."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from filodb_tpu.coordinator.planner import PlannerParams as JaxParams
from filodb_tpu.coordinator.planner import QueryEngine as JaxEngine
from filodb_tpu.core import records as JR
from filodb_tpu.core import schemas as JS
from filodb_tpu.memstore.memstore import TimeSeriesMemStore as JaxMemStore
from filodb_tpu.ops import hist_kernels as JHK
from filodb_tpu_torch.coordinator.planner import PlannerParams, QueryEngine
from filodb_tpu_torch.core import records as R
from filodb_tpu_torch.core import schemas as S
from filodb_tpu_torch.core.histograms import custom_buckets
from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore
from filodb_tpu_torch.ops import aggregations as AGG
from filodb_tpu_torch.ops import hist_kernels as HK
from filodb_tpu_torch.ops.kernels import pad_steps
from test_torch_hist import PARAMS, blocks, cpu, np_windows

BASE = 1_600_000_000_000
N_SHARDS, N_SAMPLES = 2, 160
START_S = (BASE + 400_000) / 1000
END_S = (BASE + 1_300_000) / 1000
STEP_S = 60
AT_S = 1_600_000_900
RTOL, ATOL = 2e-4, 1e-4
SCHEME_A = custom_buckets([0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10])  # 12
SCHEME_B = custom_buckets([0.01, 0.1, 0.25, 0.5, 2.5])  # 6
SCHEME_D = custom_buckets([0.5, 1, 2, 4, 8, 16, 32])  # 8


def series_data(grid: str, seed: int = 3):
    """(shard, schema name, tags, ts, values) of every series: ``lat``
    (prom histograms, scheme A, 8 series over both shards), ``nlat`` (the
    same with NaN bucket counts in one series), ``mix`` (scheme A on shard
    0, scheme B on shard 1), ``dlat`` (delta histograms, 8 buckets) and the
    ``req`` counters, on 10 s samples from BASE (``regular``) or 5-15 s
    apart (``irregular``). A NaN bucket count stays inside its windows in
    the port's window sums and spreads to later windows in the JAX
    package's (ROADMAP C): ``nlat`` meets no window sum here."""
    rng = np.random.default_rng(seed)
    out = []

    def ts_of():
        if grid == "regular":
            return BASE + 5_000 + np.arange(N_SAMPLES, dtype=np.int64) * 10_000
        return BASE + np.cumsum(rng.integers(5_000, 15_001, N_SAMPLES)).astype(np.int64)

    def hist_of(scheme, delta=False):
        incr = rng.poisson(2.0, size=(N_SAMPLES, scheme.num_buckets)).astype(np.float64)
        incr[:, -1] = incr.sum(1)
        h = np.cumsum(incr, axis=1)
        return h if delta else np.cumsum(h, axis=0)

    for metric, n, schema in (("lat", 8, "prom-histogram"), ("nlat", 3, "prom-histogram"),
                              ("mix", 6, "prom-histogram"), ("dlat", 4, "delta-histogram")):
        for i in range(n):
            shard = i % N_SHARDS
            scheme = (SCHEME_D if metric == "dlat" else
                      SCHEME_B if metric == "mix" and shard == 1 else SCHEME_A)
            h = hist_of(scheme, delta=metric == "dlat")
            if metric == "nlat" and i == 1:
                h[40:44, 2] = np.nan
            tags = {S.METRIC_TAG: metric, "_ws_": "demo", "_ns_": "App-2",
                    "instance": f"host-{i}", "zone": f"z{i % 3}"}
            vals = {"sum": np.cumsum(rng.uniform(0, 5, N_SAMPLES)), "count": h[:, -1], "h": h}
            out.append((shard, schema, tags, ts_of(), vals, scheme.bounds()))
    for i in range(4):  # ``omix``: two histogram schemas (and schemes) in each shard
        schema, scheme = (("prom-histogram", SCHEME_A) if i < 2
                          else ("otel-cumulative-histogram", SCHEME_B))
        h = hist_of(scheme)
        tags = {S.METRIC_TAG: "omix", "_ws_": "demo", "_ns_": "App-2", "instance": f"host-{i}",
                "zone": f"z{i % 3}"}
        vals = {"sum": np.cumsum(rng.uniform(0, 5, N_SAMPLES)), "count": h[:, -1], "h": h}
        if schema != "prom-histogram":
            vals.update(min=np.zeros(N_SAMPLES), max=np.full(N_SAMPLES, 9.0))
        out.append((i % N_SHARDS, schema, tags, ts_of(), vals, scheme.bounds()))
    for i in range(4):
        tags = {S.METRIC_TAG: "req", "_ws_": "demo", "_ns_": "App-2", "instance": f"host-{i}",
                "zone": f"z{i % 3}"}
        out.append((i % N_SHARDS, "prom-counter", tags, ts_of(),
                    {"count": np.cumsum(rng.uniform(0, 10, N_SAMPLES))}, None))
    return out


def build(data):
    jms, pms = JaxMemStore(), TimeSeriesMemStore()
    jms.setup(JS.Dataset("prometheus"), range(N_SHARDS))
    pms.setup(S.Dataset("prometheus"), range(N_SHARDS))
    for shard, schema, tags, ts, vals, les in data:
        jms.shard("prometheus", shard).ingest_series(JR.SeriesBatch(
            JS.SCHEMAS[schema], tags, ts, vals, bucket_les=les))
        pms.shard("prometheus", shard).ingest_series(R.SeriesBatch(
            S.SCHEMAS[schema], tags, ts, vals, bucket_les=les))
    return jms, pms


@pytest.fixture(scope="module")
def stores():
    return {grid: build(series_data(grid)) for grid in ("irregular", "regular")}


def answer(run):
    """("ok", rows by labels, (buckets, bounds) by labels) of a query, or
    ("error", type name, text)."""
    try:
        res = run()
    except Exception as e:  # the JAX package's errors are part of its answer
        return ("error", type(e).__name__, str(e))
    rows, hists = {}, {}
    for g in res.grids:
        h = g.hist_np()
        for i, (lbls, v) in enumerate(zip(g.labels, g.values_np())):
            key = tuple(sorted(lbls.items()))
            rows[key] = np.asarray(v, np.float64)
            if h is not None:
                hists[key] = (np.asarray(h[i], np.float64), np.asarray(g.les, np.float64))
    return ("ok", rows, hists)


def close(got, want, what):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=f"{what}: NaN masks")
    m = ~np.isnan(want)
    np.testing.assert_allclose(got[m], want[m], rtol=RTOL, atol=ATOL, err_msg=what)


def assert_same(got, want, what):
    assert got[0] == want[0], (what, got, want)
    if got[0] == "error":
        assert got[1:] == want[1:], what
        return
    assert sorted(got[1]) == sorted(want[1]), (what, sorted(got[1]), sorted(want[1]))
    for k, w in want[1].items():
        close(got[1][k], w, f"{what} {k}")
    assert sorted(got[2]) == sorted(want[2]), what
    for k, (w, w_les) in want[2].items():
        np.testing.assert_array_equal(got[2][k][1], w_les, err_msg=f"{what} {k} bounds")
        close(got[2][k][0], w, f"{what} {k} buckets")


def both(stores, grid, q, fused=True, instant=False):
    """The query through both engines: (port answer, JAX answer)."""
    jms, pms = stores[grid]
    jax_eng = JaxEngine(jms, "prometheus", params=JaxParams(fused_aggregate=fused))
    port = QueryEngine(pms, "prometheus", params=PlannerParams(fused_aggregate=fused),
                       device="cpu")
    if instant:
        return (answer(lambda: port.query_instant(q, AT_S)),
                answer(lambda: jax_eng.query_instant(q, AT_S)))
    return (answer(lambda: port.query_range(q, START_S, END_S, STEP_S)),
            answer(lambda: jax_eng.query_range(q, START_S, END_S, STEP_S)))


# -- unaggregated range functions and selectors ------------------------------------------

RANGE_QUERIES = [
    "rate(lat[5m])", "increase(lat[5m])", "delta(lat[5m])", "sum_over_time(lat[3m])",
    "last_over_time(lat[3m])", "lat", "rate(lat[5m] offset 2m)", f"rate(lat[5m] @ {AT_S})",
    "rate(dlat[5m])", "increase(dlat[5m])", "rate(mix[5m])", "irate(lat[5m])",
    "rate(nlat[5m])", "nlat", "delta(nlat[5m])", "rate(omix[5m])",
    "lat_bucket", 'rate(lat_bucket{le="0.5"}[5m])',
]


@pytest.mark.parametrize("grid", ["irregular", "regular"])
@pytest.mark.parametrize("q", RANGE_QUERIES)
def test_range_functions_match_jax(stores, grid, q):
    got, want = both(stores, grid, q)
    assert_same(got, want, f"{grid} {q}")
    if want[0] == "ok" and "@" not in q and "le=" not in q and q != "lat_bucket":
        assert want[2] and len(got[2]) == len(got[1])  # every row carries its buckets


# -- the instant histogram functions ---------------------------------------------------

FRACTION_BOUNDS = ["0, 0.25", "-Inf, +Inf", "-Inf, 0.1", "0.001, 0.002", "0.25, 0.5",
                   "1, +Inf", "0.5, 0.25"]
FUNC_QUERIES = [
    "histogram_quantile(0.9, rate(lat[5m]))",
    "histogram_quantile(0.5, sum_over_time(lat[3m]))",
    "histogram_quantile(0.5, increase(dlat[5m]))",
    "histogram_quantile(0.9, rate(nlat[5m]))",
    "histogram_fraction(0.1, 1, rate(nlat[5m]))",
    "histogram_max_quantile(0.9, rate(lat[5m]))",
    "histogram_max_quantile_even(0.75, rate(lat[5m]))",
    "histogram_max_quantile_even(1.5, lat)",
    *[f"histogram_fraction({b}, rate(lat[5m]))" for b in FRACTION_BOUNDS],
    "histogram_fraction(0.5, 4, delta(dlat[5m]))",
    "histogram_bucket(0.5, rate(lat[5m]))",
    "histogram_bucket(+Inf, rate(lat[5m]))",
    "histogram_bucket(0.123, rate(lat[5m]))",
    "hist_to_prom_vectors(rate(lat[5m]))",
    "hist_to_prom_vectors(lat)",
    "histogram_fraction(0, 0.25, rate(req[5m]))",
    "histogram_bucket(0.5, rate(req[5m]))",
    "histogram_max_quantile(0.9, rate(req[5m]))",
    "hist_to_prom_vectors(rate(req[5m]))",
    f"histogram_quantile(0.5, rate(lat[5m] @ {AT_S}))",
]


@pytest.mark.parametrize("grid", ["irregular", "regular"])
@pytest.mark.parametrize("q", FUNC_QUERIES)
def test_instant_histogram_functions_match_jax(stores, grid, q):
    got, want = both(stores, grid, q)
    assert_same(got, want, f"{grid} {q}")


# -- the map and merge phases: fused_aggregate off, and the fused answer -------------------

AGG_QUERIES = [
    "sum(rate(lat[5m]))",
    "sum by (zone) (increase(lat[5m]))",
    "sum by (instance) (lat)",
    "sum(rate(mix[5m]))",
    "sum by (zone) (rate(mix[5m]))",
    "sum(rate(dlat[5m]))",
    "sum(rate(nlat[5m]))",
    "sum by (zone) (rate(omix[5m]))",
    "histogram_quantile(0.5, sum(rate(omix[5m])))",
    "histogram_quantile(0.9, sum by (zone) (rate(lat[5m])))",
    "histogram_quantile(0.5, sum(rate(mix[5m])))",
    "histogram_fraction(0, 0.5, sum by (zone) (rate(mix[5m])))",
    "histogram_max_quantile_even(0.9, sum(rate(lat[5m])))",
    "histogram_bucket(2.5, sum(rate(mix[5m])))",
    "hist_to_prom_vectors(sum by (zone) (rate(lat[5m])))",
    "sum(sum by (zone) (rate(lat[5m])))",
    "sum(rate(lat[5m])) + sum(rate(lat[5m]))",
    "count(rate(lat[5m]))",
    "max by (zone) (rate(lat[5m]))",
    "stddev(rate(lat[5m]))",
    "sum(avg_over_time(lat[3m]))",
    "histogram_quantile(0.9, max(rate(lat[5m])))",
    'sum(rate({__name__=~"lat|req"}[5m]))',
]


@pytest.mark.parametrize("fused", [False, True], ids=["tree", "fused"])
@pytest.mark.parametrize("q", AGG_QUERIES)
def test_aggregates_match_jax(stores, q, fused):
    got, want = both(stores, "irregular", q, fused=fused)
    assert_same(got, want, f"{q} fused={fused}")


@pytest.mark.parametrize("grid", ["irregular", "regular"])
@pytest.mark.parametrize("q", [q for q in AGG_QUERIES[:12]])
def test_tree_matches_the_fused_answer(stores, grid, q):
    """The port's tree (map phase on each shard, host merge) against its
    own fused path on the same store."""
    _, pms = stores[grid]
    tree = answer(lambda: QueryEngine(pms, "prometheus", params=PlannerParams(
        fused_aggregate=False), device="cpu").query_range(q, START_S, END_S, STEP_S))
    fused = answer(lambda: QueryEngine(pms, "prometheus", device="cpu").query_range(
        q, START_S, END_S, STEP_S))
    assert_same(tree, fused, f"{grid} {q}")


# -- pass-throughs: sort, topk, limitk, quantile, count_values, operators -------------------

PASS_QUERIES = [
    "sort(rate(lat[5m]))",
    "sort_desc(histogram_quantile(0.5, rate(lat[5m])))",
    "topk(2, rate(lat[5m]))",
    "topk by (zone) (1, rate(lat[5m]))",
    "bottomk(1, rate(lat[5m]))",
    "limitk(2, rate(lat[5m]))",
    "quantile(0.5, rate(lat[5m]))",
    'count_values("c", rate(lat[5m]))',
    "rate(lat[5m]) * 2",
    "rate(lat[5m]) > bool 0",
    "rate(lat[5m]) + on (instance) rate(lat[5m])",
    "rate(lat[5m]) and rate(lat[5m])",
    "abs(rate(lat[5m]))",
    "absent(rate(lat[5m]))",
    "timestamp(rate(lat[5m]))",
    "sort_desc(lat)",
    # an m_bucket{le=...} slice beside the native selection in one query
    'histogram_bucket(0.5, rate(lat[5m])) - rate(lat_bucket{le="0.5"}[5m])',
    'lat_bucket{le="+Inf"} / on (instance) group_left sum by (instance) (lat)',
]


@pytest.mark.parametrize("q", PASS_QUERIES)
def test_pass_throughs_match_jax(stores, q):
    got, want = both(stores, "regular", q)
    assert_same(got, want, q)


@pytest.mark.parametrize("q", ["rate(lat[5m])", "histogram_quantile(0.9, rate(lat[5m]))",
                               "histogram_fraction(0, 0.1, sum by (zone) (rate(mix[5m])))",
                               "histogram_bucket(+Inf, lat)"])
def test_instant_queries_match_jax(stores, q):
    got, want = both(stores, "irregular", q, instant=True)
    assert_same(got, want, q)


def test_leaf_grid_is_the_store_view():
    """A tree leaf's buckets are the permuted view of the store mode's
    step-major [J, B, S] grid (the map phase's segment aggregate reads it
    in place), its values the NaN placeholder."""
    jms, pms = build(series_data("regular"))
    res = QueryEngine(pms, "prometheus", device="cpu").query_range(
        "rate(lat[5m])", START_S, END_S, STEP_S)
    for g in res.grids:
        S_pad = g.hist.shape[0]
        assert g.hist.shape[1:] == (g.num_steps, 12)
        assert g.hist.stride() == (1, 12 * S_pad, S_pad)
        assert np.isnan(g.values_np()).all()


# -- the plain versions of K1 and K2 against the JAX functions -----------------------------


@pytest.mark.parametrize("is_delta", [False, True], ids=["cumulative", "delta"])
@pytest.mark.parametrize("func", sorted(HK.FUSED_HIST_FUNCS))
@pytest.mark.parametrize("grid", ["regular", "irregular"])
def test_store_plain_matches_jax(grid, func, is_delta):
    """``hist_series_plain`` (the store mode's plain version: [J, B, S],
    padded rows NaN) against ``hist_range_kernel`` per series and, on the
    regular grid, ``_hist_range_shared`` over its shared bounds."""
    port, jax_b = blocks(grid)
    port = cpu(port)
    S, n, J = port.vals.shape[0], port.n_series, PARAMS.num_steps
    j_pad = pad_steps(J)
    gids = torch.ones(S, dtype=torch.int64)
    gids[:n] = 0
    got = HK.hist_series_plain(func, port, gids, PARAMS, None, is_delta)
    assert got.shape == (J, port.vals.shape[2], S) and torch.isnan(got[:, :, n:]).all()
    want = JHK.run_hist_range_function(func, jax_b, PARAMS, is_delta=is_delta)
    ok_rows = np.asarray(want)[:n, :J]
    close(got.permute(2, 0, 1)[:n].numpy().astype(np.float64), ok_rows.astype(np.float64),
          f"{grid} {func} per-series")
    if grid == "regular":
        windows = AGG._hist_shared_windows(port, PARAMS, j_pad)
        got = HK.hist_series_plain(func, port, gids, PARAMS, windows, is_delta)
        lo, hi, tf, tl, out_t = np_windows(np.asarray(jax_b.ts)[0], int(jax_b.lens[0]), PARAMS,
                                           j_pad)
        want = JHK._hist_range_shared(func, jax_b.vals, jnp.asarray(lo), jnp.asarray(hi),
                                      jnp.asarray(tf), jnp.asarray(tl), jnp.asarray(out_t),
                                      np.int32(PARAMS.window_ms), is_delta)
        close(got.permute(2, 0, 1)[:n].numpy().astype(np.float64),
              np.asarray(want)[:n, :J].astype(np.float64), f"{grid} {func} shared")


def edge_buckets(first_le: float):
    """[rows, J, B] cumulative counts with the edge rows: an all-NaN row, a
    zero total, a NaN inside, counts only in the +Inf bucket, ties across
    buckets; bounds ``les`` with ``first_le`` first."""
    rng = np.random.default_rng(9)
    les = np.array([first_le, 0.1, 0.25, 0.5, 1.0, 2.5, np.inf])
    incr = rng.poisson(1.5, size=(7, 5, len(les))).astype(np.float64)
    h = np.cumsum(incr, axis=-1)
    h[0] = np.nan
    h[1] = 0.0
    h[2, :, 3] = np.nan
    h[3, :, :-1] = 0.0
    h[4, :, 1:4] = h[4, :, 1:2]
    return h.astype(np.float32), les.astype(np.float32)


@pytest.mark.parametrize("even", [False, True])
@pytest.mark.parametrize("q", [-0.1, 0.0, 0.25, 0.5, 0.99, 1.0, 1.1])
@pytest.mark.parametrize("first_le", [0.005, 0.0, -1.0])
def test_instant_quantile_plain_matches_jax(first_le, q, even):
    h, les = edge_buckets(first_le)
    (got,) = HK.hist_instant("quantile_even" if even else "quantile", [torch.from_numpy(h)],
                             [torch.from_numpy(les)], q=q)
    want = JHK.histogram_quantile(np.float32(q), jnp.asarray(h), jnp.asarray(les), even=even)
    want = np.asarray(want, np.float64)
    np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(want))
    close(got.numpy().astype(np.float64), want, f"q={q} even={even}")


@pytest.mark.parametrize("bounds", [(0.0, 0.25), (-np.inf, np.inf), (-np.inf, 0.1), (0.001, 0.002),
                                    (0.25, 0.5), (1.0, np.inf), (0.5, 0.25), (-2.0, -1.0),
                                    (0.1 + 1e-9, 3.0)])
@pytest.mark.parametrize("first_le", [0.005, 0.0, -1.0])
def test_instant_fraction_plain_matches_jax(first_le, bounds):
    h, les = edge_buckets(first_le)
    lo, hi = bounds
    (got,) = HK.hist_instant("fraction", [torch.from_numpy(h)], [torch.from_numpy(les)],
                             lower=lo, upper=hi)
    want = JHK.histogram_fraction(np.float32(lo), np.float32(hi), jnp.asarray(h),
                                  jnp.asarray(les))
    close(got.numpy().astype(np.float64), np.asarray(want, np.float64), f"{bounds}")


def test_instant_wrapper_reads_any_strides():
    """The wrapper takes a node's [S_g, J, B_g] grids of any strides, each
    with its own bounds: the store's permuted view, the row-major grid and
    a grid of other bounds answer as each alone."""
    h, les = edge_buckets(0.005)
    t, l1 = torch.from_numpy(h), torch.from_numpy(les)
    view = t.permute(1, 2, 0).contiguous().permute(2, 0, 1)
    h2, les2 = edge_buckets(-1.0)
    t2, l2 = torch.from_numpy(h2[:3, :, :5]).contiguous(), torch.from_numpy(les2[:5].copy())
    for op in HK.INSTANT_OPS:
        kw = {"q": 0.5, "lower": 0.1, "upper": 1.0}
        a, b, c = HK.hist_instant(op, [t, view, t2], [l1, l1, l2], **kw)
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        np.testing.assert_array_equal(c.numpy(), HK.hist_instant(op, [t2], [l2], **kw)[0].numpy())
    with pytest.raises(ValueError, match="unknown instant histogram op"):
        HK.hist_instant("median", [t], [l1])
    with pytest.raises(ValueError, match="les"):
        HK.hist_instant("quantile", [t], [l1[:3]])
    with pytest.raises(ValueError, match="hists must be"):
        HK.hist_instant("quantile", [t, t[:, :2]], [l1, l1])
