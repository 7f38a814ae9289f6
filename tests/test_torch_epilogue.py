"""The fused epilogues (B9) of the port against the JAX package on the CPU:
global ``topk``/``bottomk`` and ``quantile [by (...)]`` over every scalar
rung.

- Kernel level: ``order_stats.topk_steps_plain`` and
  ``segment_quantile_plain`` on the store mode's grid of the same values
  (``group_acc.series_grid``) against the JAX ``_apply_epilogue`` topk arm
  / ``topk_mask`` and ``segment_quantile`` on identical seeded ``[S, J]``
  grids: exact, NaN masks and the signs of zeros equal (ties, all-NaN
  steps, +-inf, -0 against +0, k past the finite count and past S, q
  outside [0, 1], empty groups and groups of one).
- Store mode: ``aggregations.fused_range_series`` on each rung (on a CPU
  block its plain per-series values) against ``range_kernel_plain`` and
  against the rung's own sum aggregate.
- Engine level: ``QueryEngine(..., device="cpu")`` against the JAX
  ``QueryEngine`` on irregular, jittered and regular stores, every rung
  reached, rtol 2e-4 / atol 1e-4, NaN masks equal. The moments
  (stddev_over_time) run on gauges on the regular and jittered grids only
  (ROADMAP C: off those grids the JAX package's mean differs from the
  port's by more than the tolerance).

The near-tie rule of the topk comparisons: the two packages compute the
range function in another f32 order, so where two series' values at the
k boundary lie within the tolerance of each other either may win. The
tests then compare each step's winning values, sorted, within the
tolerance, and the values of the series both packages chose. Integer
valued functions (changes, count_over_time) have exact ties, which both
break to the lower series index: their winner sets must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from filodb_tpu.coordinator.planner import QueryEngine as JaxEngine
from filodb_tpu.core import schemas as JS
from filodb_tpu.core.records import SeriesBatch as JaxSeriesBatch
from filodb_tpu.memstore.memstore import TimeSeriesMemStore as JaxMemStore
from filodb_tpu.ops import aggregations as JAGG
from filodb_tpu_torch.coordinator.planner import QueryEngine
from filodb_tpu_torch.core import schemas as S
from filodb_tpu_torch.core.records import SeriesBatch
from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore
from filodb_tpu_torch.ops import aggregations as AGG
from filodb_tpu_torch.ops import group_acc as GA
from filodb_tpu_torch.ops import order_stats as OS
from filodb_tpu_torch.ops.kernels import RangeParams, pad_steps, range_kernel_plain
from filodb_tpu_torch.ops.staging import stage_series
from filodb_tpu_torch.ops.window_stats import PALLAS_FUNCS
from filodb_tpu_torch.query.promql import query_range_to_logical_plan, query_to_logical_plan

BASE = 1_600_000_000_000
RTOL, ATOL = 2e-4, 1e-4


# -- kernel level: the plain order statistics against the JAX epilogues -------------

N_REAL, S_PAD, J = 37, 48, 9


def epilogue_grid(kind: str, seed: int = 0) -> np.ndarray:
    """A seeded [S_PAD, J] f32 grid (padded rows past N_REAL hold values,
    which the n_real mask must hide): normal values; small integers (exact
    ties, as changes or count_over_time give); NaN-heavy with all-NaN
    steps; or with +-inf and signed zeros mixed in."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        v = rng.integers(0, 4, (S_PAD, J)).astype(np.float32)
    else:
        v = (50 + 20 * rng.standard_normal((S_PAD, J))).astype(np.float32)
    if kind in ("nan", "ties"):
        v[rng.random((S_PAD, J)) < 0.3] = np.nan
        v[:, 2] = np.nan  # an all-NaN step
    if kind == "nan":
        v[: N_REAL - 3, 5] = np.nan  # three finite values left
    if kind == "inf":
        v[rng.random((S_PAD, J)) < 0.15] = np.inf
        v[rng.random((S_PAD, J)) < 0.15] = -np.inf
        v[rng.random((S_PAD, J)) < 0.1] = 0.0
        v[rng.random((S_PAD, J)) < 0.1] = -0.0
        v[rng.random((S_PAD, J)) < 0.1] = np.nan
    return v


def masked(v: np.ndarray) -> np.ndarray:
    """The grid as both epilogues see it: rows past N_REAL NaN."""
    out = v.copy()
    out[N_REAL:] = np.nan
    return out


def gids_of(G: int, grouping: str) -> np.ndarray:
    """[S_PAD] group ids, padded rows in the trash group G."""
    g = np.full(S_PAD, G, np.int32)
    if grouping == "one":
        g[:N_REAL] = 0
    elif grouping == "singletons":
        g[:N_REAL] = np.arange(N_REAL)
    elif grouping == "zones":
        g[:N_REAL] = np.arange(N_REAL) % G
    else:  # "with_empty": groups 1 and G-1 have no member, group 2 one
        g[:N_REAL] = np.where(np.arange(N_REAL) % 3 == 0, 0, 3)
        g[5] = 2
    return g


GROUPINGS = {"one": 1, "zones": 4, "singletons": N_REAL, "with_empty": 6}


def store_grid(v: np.ndarray, gids: np.ndarray, G: int) -> torch.Tensor:
    """The [J, S_PAD] grid the store mode writes for the [S_PAD, J]
    values ``v``: rows outside [0, G) (the padded ones) NaN."""
    return GA.series_grid(torch.from_numpy(v), torch.from_numpy(gids.astype(np.int64)), G, J)


def port_topk(v: np.ndarray, k: int, bottom: bool):
    gids = np.ones(S_PAD, np.int64)
    gids[:N_REAL] = 0
    vals, idx = OS.topk_steps_plain(store_grid(v, gids, 1), min(k, S_PAD), bottom)
    return vals.numpy(), idx.numpy()


def jax_topk(v: np.ndarray, k: int, bottom: bool):
    vals, idx = JAGG._apply_epilogue(jnp.asarray(v), ("topk", k, bottom),
                                     jnp.zeros(S_PAD, jnp.int32), N_REAL, jnp.float32(0.0), 1)
    return np.asarray(vals), np.asarray(idx)


def winners(vals: np.ndarray, idx: np.ndarray) -> list[dict]:
    """Per step: series index -> value (NaN for a non-finite winner)."""
    return [{int(i): float(x) for i, x in zip(idx[:, j], vals[:, j])} for j in range(J)]


@pytest.mark.parametrize("bottom", [False, True], ids=["topk", "bottomk"])
@pytest.mark.parametrize("k", [1, 3, "past_finite", "S", "past_S"])
@pytest.mark.parametrize("kind", ["normal", "ties", "nan", "inf"])
def test_topk_plain_matches_jax(kind, k, bottom):
    """The same winners (indices, ties to the lower index in the total
    order: -0 below +0) and values as ``lax.top_k``, k capped at S; the
    [S, J] rows they present equal ``topk_mask``'s."""
    v = epilogue_grid(kind, seed=len(kind))
    k = {"past_finite": 34, "S": S_PAD, "past_S": S_PAD + 5}.get(k, k)
    got_vals, got_idx = port_topk(v, k, bottom)
    want_vals, want_idx = jax_topk(v, k, bottom)
    assert got_vals.shape == got_idx.shape == (min(k, S_PAD), J)
    assert got_idx.dtype == np.int32
    got, want = winners(got_vals, got_idx), winners(want_vals, want_idx)
    for j in range(J):
        assert got[j].keys() == want[j].keys(), j
        np.testing.assert_array_equal([got[j][i] for i in sorted(got[j])],
                                      [want[j][i] for i in sorted(want[j])])
    presented = np.full((S_PAD, J), np.nan, np.float32)
    for j in range(J):
        for i, x in got[j].items():
            if np.isfinite(x):
                presented[i, j] = x
    want_mask = np.asarray(JAGG.topk_mask(jnp.asarray(masked(v)), min(k, S_PAD), bottom))
    np.testing.assert_array_equal(presented, want_mask)


@pytest.mark.parametrize("q", [-0.5, 0.0, 0.25, 0.5, 0.99, 1.0, 1.5])
@pytest.mark.parametrize("grouping", sorted(GROUPINGS))
def test_quantile_plain_matches_jax(grouping, q):
    """``segment_quantile``: NaN where a group has no value (an empty
    group, an all-NaN step); q outside [0, 1] clipped, as the JAX package
    does; +inf sorts with the absent values. A selected order statistic
    (a whole rank) is equal; an interpolated one within 2 ulp: XLA may fuse
    the interpolation's multiply and add on the CPU, where the plain
    version, like the kernel (built with -fmad=false), rounds them
    separately."""
    G = GROUPINGS[grouping]
    v = epilogue_grid("inf" if grouping == "zones" else "nan", seed=G)
    got = assert_quantile_matches_jax(v, gids_of(G, grouping), G, q)
    if grouping == "with_empty":
        assert np.isnan(got[[1, G - 1]]).all()


@pytest.mark.parametrize("q", [0.0, 0.3, 0.5, 1.0])
@pytest.mark.parametrize("grouping", ["one", "zones"])
def test_quantile_of_signed_zeros_matches_jax(grouping, q):
    """The port sorts -0 below +0 where ``jnp.argsort`` ties them; the
    answers agree to the sign all the same, since ``v_lo + (v_hi - v_lo) *
    frac`` of two zeros is +0 whatever their signs."""
    G = GROUPINGS[grouping]
    rng = np.random.default_rng(7)
    v = np.where(rng.random((S_PAD, J)) < 0.5, np.float32(-0.0), np.float32(0.0))
    v[:, 5:][rng.random((S_PAD, J - 5)) < 0.2] = 1.0  # steps 0-4 hold zeros only
    v[rng.random((S_PAD, J)) < 0.1] = np.nan
    got = assert_quantile_matches_jax(v.astype(np.float32), gids_of(G, grouping), G, q)
    zero = got == 0
    assert zero.any() and not np.signbit(got[zero]).any()


def port_quantile(v: np.ndarray, g: np.ndarray, G: int, q: float) -> np.ndarray:
    gids = torch.from_numpy(g.astype(np.int64))
    return OS.segment_quantile_plain(store_grid(v, g, G), OS.segment_members(gids, G), q).numpy()


def assert_quantile_matches_jax(v: np.ndarray, g: np.ndarray, G: int, q: float) -> np.ndarray:
    """The port's plain quantile against the JAX ``segment_quantile`` (see
    ``test_quantile_plain_matches_jax``); returns the port's."""
    got = port_quantile(v, g, G, q)
    want = np.asarray(JAGG._apply_epilogue(jnp.asarray(v), ("quantile",), jnp.asarray(g), N_REAL,
                                           jnp.float32(q), G))
    assert got.shape == want.shape == (G, J)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    present = ~np.isnan(want)
    np.testing.assert_array_equal(np.signbit(got[present]), np.signbit(want[present]))
    count = np.zeros((G + 1, J), np.float32)
    np.add.at(count, g, ~np.isnan(masked(v)))
    rank = np.float32(np.clip(q, 0, 1)) * np.maximum(count[:G] - np.float32(1), np.float32(0))
    whole = rank == np.floor(rank)
    np.testing.assert_array_equal(got[whole], want[whole])
    finite = ~whole & np.isfinite(want)
    np.testing.assert_array_max_ulp(got[finite], want[finite], maxulp=2)
    np.testing.assert_array_equal(got[~whole & ~finite], want[~whole & ~finite])
    return got


def test_segment_members_order_and_split():
    """Members: the real rows stably ordered by group, [G+1] starts, and
    the groups split at ``SMALL_SEGMENT`` members."""
    G = 5
    g = np.full(40, G, np.int64)
    g[:34] = np.r_[np.zeros(20), np.full(3, 2), np.full(11, 4)].astype(np.int64)[
        np.random.default_rng(3).permutation(34)]
    m = OS.segment_members(torch.from_numpy(g), G)
    perm, starts = m.perm.numpy(), m.starts.numpy()
    assert perm.dtype == starts.dtype == np.int32
    np.testing.assert_array_equal(starts, [0, 20, 20, 23, 23, 34])
    np.testing.assert_array_equal(perm, np.argsort(g[:34], kind="stable"))
    np.testing.assert_array_equal(m.large.numpy(), [0])
    np.testing.assert_array_equal(m.small.numpy(), [1, 2, 3, 4])
    assert m.small_max == 11


def test_topk_wrapper_refuses_k_below_one():
    with pytest.raises(ValueError, match="at least 1"):
        OS.topk_steps(torch.zeros((4, 8)), 0)


# -- the store mode: the per-series grid of each rung ------------------------------

STORE_CASES = [  # (rung, function, grid, staging flags, is_counter)
    ("mxu", "rate", "regular", {"counter_corrected": True}, True),
    ("mxu", "irate", "regular", {"counter_corrected": True}, True),
    ("mxu", "sum_over_time", "regular", {}, False),
    ("mxu", "last", "regular", {}, False),
    ("window_stats", "rate", "irregular", {"counter_corrected": True}, True),
    ("window_stats", "increase", "irregular", {"counter_corrected": True}, True),
    ("window_stats", "max_over_time", "irregular", {}, False),
    ("window_stats", "count_over_time", "irregular", {}, False),
    ("general", "irate", "irregular", {"counter_corrected": True}, True),
    ("general", "changes", "irregular", {"diff_encode": True}, True),
    ("general", "resets", "regular", {"diff_encode": True}, True),
    ("general", "stddev_over_time", "irregular", {}, False),
]


def store_block(grid: str, flags: dict, counter: bool, seed: int = 0):
    rng = np.random.default_rng(seed)
    series = []
    for i in range(21):
        if grid == "regular":
            ts = BASE + 5_000 + np.arange(150, dtype=np.int64) * 10_000
        else:
            ts = BASE + np.cumsum(rng.integers(5_000, 15_001, 150 - i)).astype(np.int64)
        if counter:
            vals = np.cumsum(rng.uniform(0, 10, len(ts))) + 1e3
            vals[len(ts) // 2:] -= vals[len(ts) // 2] - 1.0
        else:
            vals = 50 + 20 * rng.standard_normal(len(ts))
        series.append((ts, vals))
    return stage_series(series, BASE, **flags).to_device("cpu")


@pytest.mark.parametrize("rung, func, grid, flags, counter", STORE_CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in STORE_CASES])
def test_store_mode_matches_plain_per_series(rung, func, grid, flags, counter):
    """``fused_range_series``: the [J_pad, S_pad] grid of the rung the
    ladder picks, padded rows and steps NaN, its real rows equal to
    ``range_kernel_plain`` and summing to the rung's ``sum`` aggregate."""
    b = store_block(grid, flags, counter)
    params = RangeParams(BASE + 400_000, 60_000, 20, 300_000)
    obs = {}
    got = AGG.fused_range_series(func, b, params, is_counter=counter, obs=obs)
    assert obs == {"variant": rung}
    s_pad, n = b.ts.shape[0], b.n_series
    assert got.shape == (pad_steps(20), s_pad) and got.is_contiguous()
    assert torch.isnan(got[:, n:]).all() and torch.isnan(got[20:]).all()
    raw = b.raw if b.raw is not None else b.vals
    want = range_kernel_plain(func, b.ts, b.vals, b.lens, b.baseline, raw,
                              params.start_ms - BASE, params.step_ms, params.window_ms,
                              pad_steps(20), is_counter=counter)
    g, w = got.T[:n, :20].numpy(), want[:n, :20].numpy()
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    assert (~np.isnan(w)).any()
    np.testing.assert_allclose(g[~np.isnan(w)], w[~np.isnan(w)], rtol=RTOL, atol=ATOL)
    gids = AGG.zero_gids(b)
    total = AGG.fused_range_aggregate(func, "sum", b, gids, 1, params, is_counter=counter)
    has = ~torch.isnan(got[:20]).all(dim=1)
    np.testing.assert_allclose(torch.nansum(got[:20], dim=1)[has].numpy(),
                               total[0, :20][has].numpy(), rtol=RTOL, atol=ATOL)


def test_zero_gids_is_the_global_grouping():
    b = store_block("irregular", {}, False)
    gids = AGG.zero_gids(b)
    assert gids.dtype == torch.int64 and AGG.zero_gids(b) is gids
    assert (gids[: b.n_series] == 0).all() and (gids[b.n_series:] == 1).all()


# -- engine level: the port's QueryEngine against the JAX engine -------------------

E_SERIES, E_SAMPLES, E_SHARDS, SPREAD = 14, 200, 4, 1
START_S = (BASE + 400_000) / 1000
END_S = (BASE + 1_500_000) / 1000
STEP_S = 60
ENGINE_GRIDS = ("irregular", "jitter", "regular")


def engine_data(grid: str, seed: int = 0):
    """Counters (a reset in every third) and gauges (repeated readings) on
    10 s samples from BASE, exact, +-5 % (jitter) or irregular 5-15 s
    apart."""
    rng = np.random.default_rng(seed)
    nominal = BASE + 5_000 + np.arange(E_SAMPLES, dtype=np.int64) * 10_000
    out = []
    for metric, schema in (("http_requests_total", "prom-counter"), ("node_temp", "gauge")):
        for i in range(E_SERIES):
            if grid == "irregular":
                ts = BASE + np.cumsum(rng.integers(5_000, 15_001, E_SAMPLES)).astype(np.int64)
            elif grid == "jitter":
                ts = nominal + np.rint(rng.uniform(-0.05, 0.05, E_SAMPLES) * 10_000).astype(
                    np.int64)
            else:
                ts = nominal
            if schema == "prom-counter":
                vals = np.cumsum(rng.uniform(0, 10, E_SAMPLES)) + 1e6
                if i % 3 == 0:
                    vals[E_SAMPLES // 2:] -= vals[E_SAMPLES // 2] - 3.0
            else:
                vals = np.round(50 + 20 * rng.standard_normal(E_SAMPLES))
                vals[4::9] = vals[3::9][: len(vals[4::9])]
            tags = {S.METRIC_TAG: metric, "_ws_": "demo", "_ns_": "App-2",
                    "instance": f"host-{i}", "zone": f"z{i % 4}"}
            out.append((tags, schema, ts, vals))
    return out


@pytest.fixture(scope="module")
def stores():
    out = {}
    for grid in ENGINE_GRIDS:
        jms, pms = JaxMemStore(), TimeSeriesMemStore()
        jms.setup(JS.Dataset("prometheus"), range(E_SHARDS))
        pms.setup(S.Dataset("prometheus"), range(E_SHARDS))
        for tags, schema, ts, vals in engine_data(grid):
            col = "count" if schema == "prom-counter" else "value"
            shard = S.shard_for(tags, SPREAD, E_SHARDS)
            jms.shard("prometheus", shard).ingest_series(JaxSeriesBatch(
                schema=JS.SCHEMAS[schema], tags=tags, timestamps=ts, values={col: vals}))
            pms.shard("prometheus", shard).ingest_series(SeriesBatch(
                schema=S.SCHEMAS[schema], tags=tags, timestamps=ts, values={col: vals}))
        out[grid] = (jms, pms)
    return out


def run_both(stores, grid: str, query: str, instant: bool = False):
    """(JAX result, port result, the port's rung) of one query, each
    result as (labels, [rows, steps] values)."""
    jms, pms = stores[grid]
    jeng = JaxEngine(jms, "prometheus")
    eng = QueryEngine(pms, "prometheus", device="cpu")
    lookback = eng.planner.params.lookback_ms
    if instant:
        want = jeng.query_instant(query, END_S)
        plan = query_to_logical_plan(query, END_S, lookback)
    else:
        want = jeng.query_range(query, START_S, END_S, STEP_S)
        plan = query_range_to_logical_plan(query, START_S, END_S, STEP_S, lookback)
    ctx = eng.context()
    got = eng.planner.materialize(plan).execute(ctx)
    (wg,), (gg,) = want.grids, got.grids
    return (wg.labels, wg.values_np()), (gg.labels, gg.values_np()), ctx.obs.get("variant")


def assert_rows_close(got, want, what):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=what)
    m = ~np.isnan(want)
    assert m.any(), what
    np.testing.assert_allclose(got[m], want[m], rtol=RTOL, atol=ATOL, err_msg=what)


def assert_groups_match(got, want, what):
    assert got[0] == want[0], what
    assert_rows_close(got[1], want[1], what)


def assert_topk_matches(got, want, k: int, bottom: bool, what: str):
    """The presented topk rows under the near-tie rule (module
    docstring): the values of every series both packages present agree;
    per step, the winning values, sorted, agree; and a series only one
    package chose at a step lies within the tolerance of the other's
    boundary value (the worst of its winners)."""
    def rows(res):
        return {tuple(sorted(l.items())): r for l, r in zip(*res)}

    g_rows, w_rows = rows(got), rows(want)
    assert len(g_rows) == len(got[0]) and g_rows, what
    for key in g_rows.keys() & w_rows.keys():
        both = ~np.isnan(g_rows[key]) & ~np.isnan(w_rows[key])
        np.testing.assert_allclose(g_rows[key][both], w_rows[key][both], rtol=RTOL, atol=ATOL,
                                   err_msg=what)
    steps = want[1].shape[1]
    assert got[1].shape[1] == steps, what
    for j in range(steps):
        g_win = {key: r[j] for key, r in g_rows.items() if not np.isnan(r[j])}
        w_win = {key: r[j] for key, r in w_rows.items() if not np.isnan(r[j])}
        gv, wv = np.sort(list(g_win.values())), np.sort(list(w_win.values()))
        assert len(gv) == len(wv) <= k, (what, j)
        np.testing.assert_allclose(gv, wv, rtol=RTOL, atol=ATOL, err_msg=f"{what} step {j}")
        for key in g_win.keys() ^ w_win.keys():
            value, other = (g_win[key], wv) if key in g_win else (w_win[key], gv)
            boundary = other[-1] if bottom else other[0]
            assert np.isclose(value, boundary, rtol=RTOL, atol=ATOL), (what, j, key)


def expected_rung(grid: str, func: str) -> str:
    """The JAX ladder's rung (its ``general`` as the port's general rung or
    window stats)."""
    if grid == "regular" and func in JAGG.FUSED_MXU_FUNCS:
        return "mxu"
    if grid == "jitter" and func in JAGG.FUSED_JITTER_FUNCS:
        return "jitter"
    return "window_stats" if func in PALLAS_FUNCS else "general"


TOPK_QUERIES = [  # (query, k, the range function)
    ("topk(3, rate(http_requests_total[5m]))", 3, "rate"),
    ("bottomk(2, irate(http_requests_total[5m]))", 2, "irate"),
    ("topk(4, changes(node_temp[5m]))", 4, "changes"),
    ("bottomk(3, count_over_time(node_temp[5m]))", 3, "count_over_time"),
    ("topk(2, node_temp)", 2, "last"),
    ("bottomk(5, increase(http_requests_total[5m]))", 5, "increase"),
]
QUANTILE_QUERIES = [
    ("quantile(0.9, rate(http_requests_total[5m]))", "rate"),
    ("quantile by (zone) (0.5, max_over_time(node_temp[5m]))", "max_over_time"),
    ("quantile without (instance) (0.25, idelta(http_requests_total[5m]))", "idelta"),
    ("quantile by (zone) (0.75, resets(http_requests_total[5m]))", "resets"),
]


@pytest.mark.parametrize("grid", ENGINE_GRIDS)
@pytest.mark.parametrize("query, k, func", TOPK_QUERIES, ids=[q[0] for q in TOPK_QUERIES])
def test_topk_queries_match_jax(stores, grid, query, k, func):
    want, got, variant = run_both(stores, grid, query)
    assert variant == expected_rung(grid, func)
    assert want[1].shape[1] == 19
    # the metric name is stripped unless the selector is bare
    assert all((S.METRIC_TAG in l) == (func == "last") for l in got[0])
    if func in ("changes", "count_over_time"):  # exact ties: the same winners, by index
        assert_groups_match(got, want, query)
    else:
        assert_topk_matches(got, want, k, query.startswith("bottomk"), query)


@pytest.mark.parametrize("grid", ENGINE_GRIDS)
@pytest.mark.parametrize("query, func", QUANTILE_QUERIES, ids=[q[0] for q in QUANTILE_QUERIES])
def test_quantile_queries_match_jax(stores, grid, query, func):
    want, got, variant = run_both(stores, grid, query)
    assert variant == expected_rung(grid, func)
    assert_groups_match(got, want, query)


@pytest.mark.parametrize("grid", ["jitter", "regular"])
@pytest.mark.parametrize("query, func", [
    ("quantile by (zone) (0.5, stddev_over_time(node_temp[5m]))", "stddev_over_time"),
    ("topk(3, stdvar_over_time(node_temp[5m]))", "stdvar_over_time"),
])
def test_moments_on_gauges_match_jax(stores, grid, query, func):
    want, got, variant = run_both(stores, grid, query)
    assert variant == expected_rung(grid, func)
    if query.startswith("topk"):
        assert_topk_matches(got, want, 3, False, query)
    else:
        assert_groups_match(got, want, query)


@pytest.mark.parametrize("query, k", [
    ("topk(0, rate(http_requests_total[5m]))", 1),  # k < 1 -> 1, as the JAX exec node
    ("topk(1000, rate(http_requests_total[5m]))", 1000),  # k past S
    ("bottomk(2, rate(http_requests_total[5m] offset 1m))", 2),
    ("quantile(1.5, rate(http_requests_total[5m]))", None),
    ("quantile(-0.5, rate(http_requests_total[5m]))", None),
])
def test_epilogue_edges_match_jax(stores, query, k):
    want, got, _ = run_both(stores, "irregular", query)
    if k is None:
        assert_groups_match(got, want, query)
        return
    assert_topk_matches(got, want, k, query.startswith("bottomk"), query)
    if k == 1000:
        assert len(got[0]) == E_SERIES  # every counter wins every step
        assert not np.isnan(got[1]).any()


@pytest.mark.parametrize("query", ["topk(2, rate(http_requests_total[5m]))",
                                   "quantile by (zone) (0.5, rate(http_requests_total[5m]))"])
def test_instant_epilogues_match_jax(stores, query):
    want, got, _ = run_both(stores, "irregular", query, instant=True)
    assert got[1].shape[1] == 1
    if query.startswith("topk"):
        assert_topk_matches(got, want, 2, False, query)
    else:
        assert_groups_match(got, want, query)


@pytest.mark.parametrize("query", [
    "topk by (zone) (3, rate(http_requests_total[5m]))",
    "bottomk without (instance) (2, rate(http_requests_total[5m]))",
    "quantile(0.5, rate(http_requests_total[5m] @ 1600000600))",
    "topk(3, predict_linear(http_requests_total[5m], 60))",
])
def test_shapes_the_jax_fused_planner_refuses_raise(stores, query):
    """Grouped topk/bottomk, ``@`` and function arguments: the JAX fused
    planner refuses them and answers them on its reference tree; the
    port's planner refuses them the same way, and its tree gives the JAX
    engine's rows (by labels, NaN masks equal, within the tolerance; topk
    and bottomk per group under the near-tie rule)."""
    eng = QueryEngine(stores["irregular"][1], "prometheus", device="cpu")
    plan = query_range_to_logical_plan(query, START_S, END_S, STEP_S)
    assert eng.planner._try_fused_aggregate(plan) is None
    want, got, _ = run_both(stores, "irregular", query)
    if query.startswith(("topk", "bottomk")):
        # per group of the grouping, the near-tie rule (predict_linear sums
        # in f64 in the port, ROADMAP C)
        k, bottom = int(query.split("(")[-2].split(",")[0]), query.startswith("bottomk")

        def group(l):
            if "by (zone)" in query:
                return l.get("zone")
            if "without (instance)" in query:
                return tuple(sorted((a, b) for a, b in l.items() if a != "instance"))
            return None

        for key in {group(l) for l in want[0]}:
            pick = [[i for i, l in enumerate(res[0]) if group(l) == key] for res in (got, want)]
            assert_topk_matches(([got[0][i] for i in pick[0]], got[1][pick[0]]),
                                ([want[0][i] for i in pick[1]], want[1][pick[1]]), k, bottom,
                                f"{query} {key}")
        return
    rows_w = {tuple(sorted(l.items())): r for l, r in zip(*want)}
    rows_g = {tuple(sorted(l.items())): r for l, r in zip(*got)}
    assert sorted(rows_g) == sorted(rows_w) and rows_w, query
    for key, w in rows_w.items():
        assert_rows_close(rows_g[key], w, f"{query} {key}")


@pytest.mark.parametrize("op, params", [
    ("topk", ()), ("topk", (3, 4)), ("bottomk", ("3",)), ("quantile", ()),
    ("quantile", (0.5, 0.9)), ("quantile", ("0.5",)),
])
def test_epilogue_parameters_other_than_one_number_raise(stores, op, params):
    """As the JAX fused planner: exactly one numeric parameter, else the
    reference tree (its ``AggregatePresentExec``), in both planners."""
    import dataclasses

    from filodb_tpu.coordinator.planner import SingleClusterPlanner as JaxPlanner
    from filodb_tpu.query.promql import query_range_to_logical_plan as jax_plan
    from filodb_tpu_torch.query.exec.plans import AggregatePresentExec

    eng = QueryEngine(stores["irregular"][1], "prometheus", device="cpu")
    q = f"{op}(3, rate(http_requests_total[5m]))"
    plan = dataclasses.replace(query_range_to_logical_plan(q, START_S, END_S, STEP_S),
                               params=params)
    assert eng.planner._try_fused_aggregate(plan) is None
    assert isinstance(eng.planner.materialize(plan), AggregatePresentExec)
    jplan = dataclasses.replace(jax_plan(q, START_S, END_S, STEP_S), params=params)
    assert JaxPlanner(stores["irregular"][0], "prometheus")._try_fused_aggregate(jplan) is None


def test_a_topk_query_reports_its_rung(stores):
    """The query's path annotations name the rung whose store mode ran."""
    eng = QueryEngine(stores["regular"][1], "prometheus", device="cpu")
    plan = query_range_to_logical_plan("topk(3, rate(http_requests_total[5m]))", START_S,
                                       END_S, STEP_S)
    ctx = eng.context()
    eng.planner.materialize(plan).execute(ctx)
    assert ctx.obs == {"path": "fused", "variant": "mxu"}


def test_topk_wrapper_checks_the_real_row_count():
    grid = torch.zeros((4, 8))
    for n_real in (-1, 9):
        with pytest.raises(ValueError, match="n_real"):
            OS.topk_steps(grid, 2, n_real=n_real)


# -- a live-edge extension keeps the epilogues' memos --------------------------------

X_SERIES, X_SAMPLES, X_SHARDS = 12, 60, 2
X_END_S = (BASE + (X_SAMPLES + 40) * 10_000) / 1000  # past the head: the live edge


def live_store(samples: int):
    """A port memstore of counters ``m`` on an exact 10 s grid, ``samples``
    each (the same values for any count: a store can be extended to
    another's)."""
    from filodb_tpu_torch.core.records import RecordBatch

    ms = TimeSeriesMemStore()
    ms.setup(S.Dataset("ds"), range(X_SHARDS))
    tags = [{S.METRIC_TAG: "m", "instance": f"host-{i}", "zone": f"z{i % 3}"}
            for i in range(X_SERIES)]
    rng = np.random.default_rng(5)
    vals = np.cumsum(rng.uniform(0, 10, (X_SERIES, X_SAMPLES + 1)), axis=1) + 1e3

    def append(slot):
        ts = np.full(X_SERIES, BASE + 3_000 + slot * 10_000, np.int64)
        ms.ingest_routed("ds", RecordBatch(S.PROM_COUNTER, ts, {"count": vals[:, slot]}, tags),
                         spread=0)

    for slot in range(samples):
        append(slot)
    return ms, append


@pytest.mark.parametrize("query", [
    "topk(3, rate(m[5m]))",
    "quantile by (zone) (0.5, rate(m[5m]))",
    "quantile(0.9, irate(m[5m]))",
])
def test_epilogue_on_an_extended_superblock(query):
    """After a live-edge append extends the cached superblock, the query
    reuses the grouping's member lists and zero gids (no regroup: the
    memos are carried) and answers as a fresh build of the same store."""
    ms, append = live_store(X_SAMPLES)
    eng = QueryEngine(ms, "ds", device="cpu")
    plan = query_range_to_logical_plan(query, START_S, X_END_S, STEP_S)
    first = eng.query_range(query, START_S, X_END_S, STEP_S)
    assert first.stats.cache_misses and not first.stats.cache_hits
    old = eng.planner.materialize(plan).superblock(eng.context()).block
    memos = {m: dict(old.__dict__.get(m, {})) for m in ("group_members_memo", "zero_gids_memo")}
    assert any(memos.values())
    append(X_SAMPLES)
    got = eng.query_range(query, START_S, X_END_S, STEP_S)
    assert got.stats.cache_extends == 1
    new = eng.planner.materialize(plan).superblock(eng.context()).block
    assert new is not old
    for name, memo in memos.items():
        for key, value in memo.items():
            assert new.__dict__[name][key] is value, name
    fresh_ms, _ = live_store(X_SAMPLES + 1)
    want = QueryEngine(fresh_ms, "ds", device="cpu").query_range(query, START_S, X_END_S,
                                                                  STEP_S)
    (gg,), (wg,) = got.grids, want.grids
    assert gg.labels == wg.labels
    assert_rows_close(gg.values_np(), wg.values_np(), query)
