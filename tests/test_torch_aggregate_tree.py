"""The reference tree's aggregate part in the port against the JAX package's
on mirrored memstores: the segment aggregate's plain version (the kernel
``csrc/segment_agg.cu`` is held against it on the card) vs the JAX
``_segment_aggregate_jit``, the grouped top-k's plain version vs the JAX
``topk_mask`` of each group, every mergeable op of ``_PARTIAL_COMPONENTS``
with ``by``/``without`` through both engines on their trees
(``fused_aggregate=False``) and over shapes the fused path does not take,
the port's tree against its own fused path, the non-mergeable ops of
``AggregatePresentExec`` (topk, bottomk, limitk, quantile, count_values),
the per-shard ``TopkCandidateFilter`` on and off, and a selection of two
scalar schemas, which the fused exec hands to the tree.

Inputs are made from a seed with numpy. Rows are matched by labels; NaN
masks must be equal and values within rtol 2e-4 / atol 1e-4. The tree's
stddev/stdvar is E[v^2] - E[v]^2 in f32 in both packages, whose sums may
run in another order: where the JAX value disagrees with a float64 oracle
of the same formula over the inputs by more than the tolerance, the
port's may equal either (the JAX-or-oracle rule).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from filodb_tpu.coordinator.planner import PlannerParams as JaxParams
from filodb_tpu.coordinator.planner import QueryEngine as JaxEngine
from filodb_tpu.core import schemas as JS
from filodb_tpu.core.records import SeriesBatch as JaxSeriesBatch
from filodb_tpu.memstore.memstore import TimeSeriesMemStore as JaxMemStore
from filodb_tpu.ops import aggregations as JAGG
from filodb_tpu_torch.coordinator.planner import PlannerParams, QueryEngine
from filodb_tpu_torch.core import schemas as S
from filodb_tpu_torch.core.records import SeriesBatch
from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore
from filodb_tpu_torch.ops import order_stats as OS
from filodb_tpu_torch.ops import segment_agg as SA
from filodb_tpu_torch.query.exec import plans as P
from filodb_tpu_torch.query.exec import transformers as TR
from filodb_tpu_torch.query.promql import query_range_to_logical_plan as port_logical

BASE = 1_600_000_000_000
N_SERIES, N_SAMPLES, N_SHARDS, SPREAD = 24, 120, 4, 1
START_S = (BASE + 400_000) / 1000
END_S = (BASE + 1_100_000) / 1000
STEP_S = 60
RTOL, ATOL = 2e-4, 1e-4
C, G = "http_requests_total", "node_temp"


def make_data(grid: str, seed: int = 0):
    """(tags, schema, ts, values): counters (a reset in every third) and
    gauges with repeated readings, on 10 s samples or irregular 5-15 s."""
    rng = np.random.default_rng(seed)
    out = []
    for metric, schema in ((C, "prom-counter"), (G, "gauge")):
        for i in range(N_SERIES // 2):
            if grid == "irregular":
                ts = BASE + np.cumsum(rng.integers(5_000, 15_001, N_SAMPLES)).astype(np.int64)
            else:
                ts = BASE + 5_000 + np.arange(N_SAMPLES, dtype=np.int64) * 10_000
            if schema == "prom-counter":
                vals = np.cumsum(rng.uniform(0, 10, N_SAMPLES)) + 1e6
                if i % 3 == 0:
                    vals[N_SAMPLES // 2:] -= vals[N_SAMPLES // 2] - 3.0
            else:
                vals = np.round(50 + 20 * rng.standard_normal(N_SAMPLES), 1)
                vals[4::9] = vals[3::9][: len(vals[4::9])]
            tags = {S.METRIC_TAG: metric, "_ws_": "demo", "_ns_": "App-2",
                    "instance": f"host-{i}", "zone": f"z{i % 4}", "dc": f"d{i % 3}"}
            out.append((tags, schema, ts, vals))
    return out


def build_stores(data):
    jms, pms = JaxMemStore(), TimeSeriesMemStore()
    jms.setup(JS.Dataset("prometheus"), range(N_SHARDS))
    pms.setup(S.Dataset("prometheus"), range(N_SHARDS))
    for tags, schema, ts, vals in data:
        col = "count" if schema == "prom-counter" else "value"
        shard = S.shard_for(tags, SPREAD, N_SHARDS)
        jms.shard("prometheus", shard).ingest_series(JaxSeriesBatch(
            schema=JS.SCHEMAS[schema], tags=tags, timestamps=ts, values={col: vals}))
        pms.shard("prometheus", shard).ingest_series(SeriesBatch(
            schema=S.SCHEMAS[schema], tags=tags, timestamps=ts, values={col: vals}))
    return jms, pms


@pytest.fixture(scope="module")
def stores():
    return {grid: build_stores(make_data(grid)) for grid in ("irregular", "regular")}


def by_labels(res) -> dict:
    return {tuple(sorted(l.items())): np.asarray(v, np.float64)
            for g in res.grids for l, v in zip(g.labels, g.values_np())}


def assert_rows_match(got: dict, want: dict, what: str, oracle: dict | None = None) -> None:
    assert sorted(got) == sorted(want), what
    assert want, what
    for k, w in want.items():
        g = got[k]
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=f"{what} {k}")
        m = ~np.isnan(w)
        if oracle is not None:
            # held to JAX; where the JAX value itself is off the float64
            # oracle (f32 cancellation in E[v^2] - E[v]^2), to JAX or the oracle
            o = oracle[k]
            jax_ok = ~m | np.isclose(w, o, rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(g[m & jax_ok], w[m & jax_ok], rtol=RTOL, atol=ATOL,
                                       err_msg=what)
            off = ~jax_ok
            near = (np.isclose(g[off], w[off], rtol=RTOL, atol=ATOL)
                    | np.isclose(g[off], o[off], rtol=RTOL, atol=ATOL))
            assert near.all(), (what, g[off][~near], w[off][~near], o[off][~near])
            continue
        np.testing.assert_allclose(g[m], w[m], rtol=RTOL, atol=ATOL, err_msg=f"{what} {k}")


def engines(stores, grid: str, fused: bool):
    jms, pms = stores[grid]
    return (JaxEngine(jms, "prometheus", params=JaxParams(fused_aggregate=fused)),
            QueryEngine(pms, "prometheus", device="cpu",
                        params=PlannerParams(fused_aggregate=fused)))


def run_both(stores, grid: str, query: str, fused: bool = False):
    jax_engine, port_engine = engines(stores, grid, fused)
    return (by_labels(jax_engine.query_range(query, START_S, END_S, STEP_S)),
            by_labels(port_engine.query_range(query, START_S, END_S, STEP_S)))


# -- K1: the segment aggregate's plain version -----------------------------------------


def seeded_grid(S_: int, J: int, seed: int) -> np.ndarray:
    """[S, J] f32 with 2 % NaN, repeated values (ties), +-inf and signed zeros."""
    rng = np.random.default_rng(seed)
    v = np.round(rng.standard_normal((S_, J)) * 4, 1).astype(np.float32)
    v[rng.random((S_, J)) < 0.02] = np.nan
    v[rng.random((S_, J)) < 0.01] = np.inf
    v[rng.random((S_, J)) < 0.01] = -np.inf
    z = rng.random((S_, J)) < 0.05
    v[z] = np.where(rng.random(int(z.sum())) < 0.5, -0.0, 0.0)
    v[S_ // 2] = np.nan  # a series with no value
    return v


JAX_OPS = ("count", "sum", "min", "max", "group")


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("groups", ["one", "eight", "each", "sparse"])
@pytest.mark.parametrize("op", JAX_OPS + ("sumsq",))
def test_segment_components_plain_matches_jax(op, groups, seed):
    S_, J = 97, 13
    v = seeded_grid(S_, J, seed)
    if op == "sumsq":  # finite squares: the sum of +-inf^2 is inf on both sides anyway
        v[np.isinf(v)] = 7.5
    rng = np.random.default_rng(seed + 10)
    n_groups = {"one": 1, "eight": 8, "each": S_, "sparse": 40}[groups]
    gids = {"one": np.zeros(S_, np.int64), "eight": np.arange(S_) % 8,
            "each": np.arange(S_), "sparse": rng.integers(0, 40, S_)}[groups]
    got = SA.segment_components(torch.from_numpy(v), torch.from_numpy(gids), n_groups,
                                (op,))[op].numpy()
    jop, jv = ("sum", jnp.asarray(v) ** 2) if op == "sumsq" else (op, jnp.asarray(v))
    want = np.asarray(JAGG._segment_aggregate_jit(jop, jv, jnp.asarray(gids, jnp.int32),
                                                  n_groups))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    m = ~np.isnan(want)
    if op in ("count", "group", "min", "max"):
        np.testing.assert_array_equal(got[m], want[m])
    else:
        np.testing.assert_allclose(got[m], want[m], rtol=RTOL, atol=ATOL)


def test_segment_components_min_max_order_signed_zeros():
    v = torch.tensor([[0.0, -0.0], [-0.0, 0.0], [np.nan, np.nan]], dtype=torch.float32)
    out = SA.segment_components(v, torch.tensor([0, 0, 1]), 2, ("min", "max", "group"))
    assert torch.equal(torch.signbit(out["min"][0]), torch.tensor([True, True]))
    assert torch.equal(torch.signbit(out["max"][0]), torch.tensor([False, False]))
    assert torch.isnan(out["group"][1]).all() and (out["group"][0] == 1).all()


def test_step_major_reads_a_store_grid_in_place():
    store = torch.arange(24, dtype=torch.float32).reshape(4, 6)  # [J_pad, S_pad]
    before = SA.TRANSPOSES
    view = SA.step_major(store.T[:5, :3])
    assert view.data_ptr() == store.data_ptr() and SA.TRANSPOSES == before
    rows = torch.arange(12, dtype=torch.float32).reshape(3, 4)  # row-major [S, J]
    assert torch.equal(SA.step_major(rows), rows.T) and SA.TRANSPOSES == before + 1


# -- K2: the grouped top-k's plain version ---------------------------------------------


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("bottom", [False, True])
@pytest.mark.parametrize("k", [1, 3, 40])
@pytest.mark.parametrize("groups", ["one", "eight", "each", "sparse"])
def test_segment_topk_plain_matches_jax(groups, k, bottom, seed):
    S_, J = 61, 9
    v = np.round(seeded_grid(S_, J, seed), 0)  # many ties
    rng = np.random.default_rng(seed + 20)
    n_groups = {"one": 1, "eight": 8, "each": S_, "sparse": 25}[groups]
    gids = {"one": np.zeros(S_, np.int64), "eight": np.arange(S_) % 8,
            "each": np.arange(S_), "sparse": rng.integers(0, 25, S_)}[groups]
    members = OS.segment_members(torch.from_numpy(gids), n_groups)
    out, thr = OS.segment_topk(torch.from_numpy(np.ascontiguousarray(v.T)), members, k, bottom)
    got = out.numpy().T
    want = np.full((S_, J), np.nan, np.float32)
    fill = np.inf if bottom else -np.inf
    for g in range(n_groups):
        rows = np.nonzero(gids == g)[0]
        if not len(rows):
            continue
        kk = min(k, len(rows))
        want[rows] = np.asarray(JAGG.topk_mask(jnp.asarray(v[rows]), kk, bottom=bottom))
        vv = np.where(np.isnan(v[rows]), fill, v[rows])
        t = np.partition(vv, kk - 1, axis=0)[kk - 1] if bottom else np.partition(vv, -kk,
                                                                                 axis=0)[-kk]
        np.testing.assert_array_equal(thr.numpy()[g], t)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    m = ~np.isnan(want)
    np.testing.assert_array_equal(got[m], want[m])
    np.testing.assert_array_equal(np.signbit(got[m]), np.signbit(want[m]))


def test_segment_topk_needs_every_column_a_member():
    members = OS.segment_members(torch.tensor([0, 0, 1]), 2)
    with pytest.raises(ValueError):
        OS.segment_topk(torch.zeros((3, 4)), members, 1)


# -- the mergeable ops through both trees ------------------------------------------------

OPS = tuple(P._PARTIAL_COMPONENTS)
GROUPINGS = ("", " by (zone)", " without (instance)", " by (zone, dc)")
# inner shapes, each of which the fused path would also take (rate, the
# selector) or never takes (an argument, @, an instant function, a join)
INNERS = (f"rate({C}[5m])", G, f"quantile_over_time(0.5, {G}[5m])",
          f"rate({C}[5m] @ 1600000900)", f"abs({G} - 50)",
          f"rate({C}[5m]) / on (instance, zone, dc) irate({C}[5m])")


@pytest.mark.parametrize("grid", ["irregular", "regular"])
@pytest.mark.parametrize("grouping", GROUPINGS)
@pytest.mark.parametrize("op", OPS)
def test_tree_aggregate_matches_jax(stores, op, grouping, grid):
    for inner in INNERS[:2] if grid == "regular" else INNERS:
        query = f"{op}{grouping} ({inner})"
        want, got = run_both(stores, grid, query)
        oracle = None
        if op in ("stddev", "stdvar"):
            oracle = tree_moments_oracle(stores, grid, inner, op, grouping)
        assert_rows_match(got, want, query, oracle=oracle)


def tree_moments_oracle(stores, grid: str, inner: str, op: str, grouping: str) -> dict:
    """stddev/stdvar by the tree's formula in float64 over the port's own
    inner rows (E[v^2] - E[v]^2 clamped at 0)."""
    _, port = engines(stores, grid, fused=False)
    rows = by_labels(port.query_range(inner, START_S, END_S, STEP_S))
    by = without = None
    if "by (" in grouping:
        by = [x.strip() for x in grouping.split("(")[1].rstrip(")").split(",")]
    elif "without" in grouping:
        without = [x.strip() for x in grouping.split("(")[1].rstrip(")").split(",")]
    labels = [dict(k) for k in rows]
    gids, group_labels = JAGG.group_ids_for(labels, by, without)
    vals = np.stack(list(rows.values()))
    out = {}
    for g, gl in enumerate(group_labels):
        v = vals[gids == g]
        n = (~np.isnan(v)).sum(axis=0)
        with np.errstate(invalid="ignore", divide="ignore"):
            mean = np.nansum(v, axis=0) / n
            var = np.maximum(np.nansum(v * v, axis=0) / n - mean**2, 0.0)
        res = var if op == "stdvar" else np.sqrt(var)
        out[tuple(sorted(gl.items()))] = np.where(n > 0, res, np.nan)
    return out


@pytest.mark.parametrize("grid", ["irregular", "regular"])
@pytest.mark.parametrize("query", [f"sum by (zone) (rate({C}[5m]))", f"avg(irate({C}[5m]))",
                                   f"max without (instance) ({G})",
                                   f"min by (dc) (delta({G}[5m]))",
                                   f"count by (zone) (changes({G}[5m]))"])
def test_port_tree_matches_port_fused(stores, query, grid):
    _, fused = engines(stores, grid, fused=True)
    _, tree = engines(stores, grid, fused=False)
    ctx_plan = fused.planner.materialize(port_logical(query, START_S, END_S, STEP_S))
    assert isinstance(ctx_plan, P.FusedAggregateExec)
    assert isinstance(tree.planner.materialize(port_logical(query, START_S, END_S, STEP_S)),
                      P.ReduceAggregateExec)
    assert_rows_match(by_labels(tree.query_range(query, START_S, END_S, STEP_S)),
                      by_labels(fused.query_range(query, START_S, END_S, STEP_S)), query)


# the eight shapes the fused path hands to the tree (they raised before the
# tree's aggregate part was ported), through the default planner
FALLBACK_SHAPES = [
    f"stddev(rate({C}[5m]))", f"stdvar by (zone) (rate({C}[5m]))", f"group by (zone) ({C})",
    f"sum(quantile_over_time(0.5, {C}[5m]))", f"sum(predict_linear({C}[5m], 60))",
    f"sum(rate({C}[5m] @ 1600000600))", f"sum(rate({C}[5m])) * 2",
    f"count_values(\"c\", changes({C}[5m]))",
]


@pytest.mark.parametrize("grid", ["irregular", "regular"])
@pytest.mark.parametrize("query", FALLBACK_SHAPES)
def test_unfused_shapes_take_the_tree_and_match_jax(stores, query, grid):
    want, got = run_both(stores, grid, query, fused=True)
    oracle = None
    if query.startswith(("stddev", "stdvar")):
        op, grouping = ("stddev", "") if query.startswith("stddev") else ("stdvar", " by (zone)")
        oracle = tree_moments_oracle(stores, grid, f"rate({C}[5m])", op, grouping)
    assert_rows_match(got, want, query, oracle=oracle)


# -- the non-mergeable ops ---------------------------------------------------------------

PRESENT_QUERIES = [
    f"topk by (zone) (2, rate({C}[5m]))", f"bottomk by (dc) (3, {G})",
    f"topk without (instance) (1, deriv({G}[5m]))", f"topk by (zone) (100, rate({C}[5m]))",
    f"limitk by (zone) (2, rate({C}[5m]))", f"limitk(5, {G})",
    f"quantile by (zone) (0.5, rate({C}[5m]))", f"quantile(0.9, abs({G} - 50))",
    f"quantile without (instance) (0.25, {G})",
    f"count_values by (zone) (\"v\", round({G} / 10))", f"count_values(\"v\", changes({G}[5m]))",
    f"topk(3, rate({C}[5m]) * 2)", f"bottomk by (zone) (1, {G} > 50)",
]


def present_order(res) -> list:
    return [tuple(sorted(l.items())) for g in res.grids for l in g.labels]


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("grid", ["irregular", "regular"])
@pytest.mark.parametrize("query", PRESENT_QUERIES)
def test_present_ops_match_jax(stores, query, grid, fused):
    jax_engine, port_engine = engines(stores, grid, fused)
    want_res = jax_engine.query_range(query, START_S, END_S, STEP_S)
    got_res = port_engine.query_range(query, START_S, END_S, STEP_S)
    assert_rows_match(by_labels(got_res), by_labels(want_res), query)
    if query.startswith(("topk by", "bottomk by", "limitk by")):
        # groups in order, series order within a group, as the JAX root gives them
        assert present_order(got_res) == present_order(want_res)


def strip_candidate_filters(plan) -> int:
    n = 0
    for child in plan.children():
        for c in child.children() or [child]:
            before = len(c.transformers)
            c.transformers = [t for t in c.transformers
                              if not isinstance(t, TR.TopkCandidateFilter)]
            n += before - len(c.transformers)
    return n


@pytest.mark.parametrize("grid", ["irregular", "regular"])
@pytest.mark.parametrize("query", [f"topk by (zone) (1, rate({C}[5m]))",
                                   f"bottomk by (dc) (2, {G})",
                                   f"topk without (instance) (2, max_over_time({G}[2m]))",
                                   f"bottomk by (zone) (3, changes({G}[5m]))"])
def test_candidate_filter_changes_no_answer(stores, query, grid):
    _, port = engines(stores, grid, fused=False)
    logical = port_logical(query, START_S, END_S, STEP_S)
    with_filter = port.planner.materialize(logical)
    without_filter = port.planner.materialize(logical)
    assert strip_candidate_filters(without_filter) == N_SHARDS
    a = with_filter.execute(port.context())
    b = without_filter.execute(port.context())
    assert present_order(a) == present_order(b)
    ra, rb = by_labels(a), by_labels(b)
    for k in ra:
        np.testing.assert_array_equal(ra[k], rb[k])


def test_candidate_filter_keeps_ties_and_small_groups():
    labels = [{"zone": "a", "i": str(i)} for i in range(4)] + [{"zone": "b", "i": "9"}]
    vals = np.array([[1, 5], [3, 3], [3, 1], [2, np.nan], [np.nan, np.nan]], np.float32)
    g = P.Grid(labels, 0, 1, 2, torch.from_numpy(vals))
    (out,) = TR.TopkCandidateFilter(1, False, ("zone",)).apply([g])
    # ties at the threshold (3 at step 0) are kept; zone b (one series, at
    # most k) keeps its all-NaN row, as the JAX filter does
    assert [l["i"] for l in out.labels] == ["0", "1", "2", "9"]


# -- a selection of two schemas falls back to the tree ---------------------------------


@pytest.mark.parametrize("grid", ["irregular", "regular"])
@pytest.mark.parametrize("op", ["sum", "max by (zone)", "count without (instance)"])
def test_mixed_schemas_fall_back_to_the_tree(stores, op, grid):
    query = f'{op} ({{__name__=~"{C}|{G}"}})'
    jax_engine, port_engine = engines(stores, grid, fused=True)
    plan = port_engine.planner.materialize(port_logical(query, START_S, END_S, STEP_S))
    assert isinstance(plan, P.FusedAggregateExec)
    ctx = port_engine.context()
    got = by_labels(plan.execute(ctx))
    assert ctx.obs["path"] == "fallback" and ctx.obs["fallback"] == "mixed_schemas"
    want = by_labels(jax_engine.query_range(query, START_S, END_S, STEP_S))
    assert_rows_match(got, want, query)
