"""The port's jitter rung (``ops/mxu_jitter.py``, B6) against the JAX
package's on the same numpy inputs: ``JitterWindowMatrices`` field by
field and its decline, the deviations the port takes from ``ts`` and
``nominal_ts`` against the JAX package's staged ``ts_dev`` at every window
edge, ``jitter_range_plain`` / ``jitter_minmax_plain`` through the tree's
entry (``_dispatch_range_function``) against the JAX package's, the fused aggregate against ``_fused_dispatch``
(``_fused_jitter_jit``), ``_slot_align`` and ``stage_from_shard``'s repair
of ragged edges, the fused ladder on every grid class against
``_grid_variant``, delta counters, and the engine end to end on a jittered
store (fused, epilogues, tree, subqueries) against the JAX engine.

Tolerance rtol 2e-4 / atol 1e-4 (as tests/test_pallas.py); NaN masks equal;
counts exact."""

import functools

import numpy as np
import pytest
import torch

from filodb_tpu.coordinator.planner import QueryEngine as JaxEngine
from filodb_tpu.core import schemas as JS
from filodb_tpu.core.records import SeriesBatch as JaxSeriesBatch
from filodb_tpu.memstore.memstore import TimeSeriesMemStore as JaxMemStore
from filodb_tpu.ops import aggregations as JAGG
from filodb_tpu.ops import kernels as JK
from filodb_tpu.ops import mxu_jitter as JMJ
from filodb_tpu.ops import staging as JST
from filodb_tpu_torch.coordinator.planner import QueryEngine
from filodb_tpu_torch.core import schemas as S
from filodb_tpu_torch.core.records import SeriesBatch
from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore
from filodb_tpu_torch.ops import aggregations as AGG
from filodb_tpu_torch.ops import kernels as K
from filodb_tpu_torch.ops import mxu_jitter as JR
from filodb_tpu_torch.ops import staging as ST
from filodb_tpu_torch.ops.kernels import RangeParams, pad_steps

BASE = 1_600_000_000_000
RTOL, ATOL = 2e-4, 1e-4
NUM_STEPS = 18
# (start offset, step, window): the main path's grid, steps outside the
# data, windows just past twice the deviation bound
QUERY_GRIDS = {"main": (400_000, 60_000, 300_000), "outside": (-600_000, 250_000, 120_000),
               "narrow": (400_000, 13_000, 1_100)}
STAGINGS = {"gauge": ({}, False, False), "corrected": ({"counter_corrected": True}, True, False),
            "shifted": ({"subtract_baseline": True}, True, False),
            "diff": ({"diff_encode": True}, True, False), "delta": ({}, True, True)}


def near_regular(n_series=9, n=140, seed=0, holes=False, counter=False):
    """Series on a 10 s grid from BASE + 5 s, each sample moved by a rounded
    uniform +-5 %; with ``holes``, two interior slots of each missed."""
    rng = np.random.default_rng(seed)
    nominal = BASE + 5_000 + np.arange(n, dtype=np.int64) * 10_000
    out = []
    for i in range(n_series):
        ts = nominal + np.rint(rng.uniform(-0.05, 0.05, n) * 10_000).astype(np.int64)
        vals = (np.cumsum(rng.uniform(0, 10, n)) + 1e3) if counter else 50 + 20 * rng.standard_normal(n)
        if counter and i % 3 == 0:
            vals[n // 2:] -= vals[n // 2] - 2.0  # a reset
        if holes:
            drop = [5 + i, 60 + 3 * i]
            ts, vals = np.delete(ts, drop), np.delete(vals, drop)
        out.append((ts, vals))
    return out


@functools.lru_cache(maxsize=None)
def staged(staging: str, seed: int = 0):
    """(JAX block, port CPU block, is_counter, is_delta) of jittered series."""
    flags, counter, delta = STAGINGS[staging]
    series = near_regular(seed=seed, counter=counter and not delta)
    jb = JST.stage_series(series, BASE, **flags)
    pb = ST.device_copy(ST.stage_series(series, BASE, **flags), "cpu")
    assert JST.grid_class(jb) == ST.grid_class(pb) == "jitter"
    return jb, pb, counter, delta


def assert_close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=what)
    m = ~np.isnan(want)
    np.testing.assert_allclose(got[m], want[m], rtol=RTOL, atol=ATOL, err_msg=what)


@pytest.mark.parametrize("grid", sorted(QUERY_GRIDS))
def test_window_matrices_match_jax(grid):
    jb, pb, _, _ = staged("gauge")
    start, step, window = QUERY_GRIDS[grid]
    J = pad_steps(NUM_STEPS)
    want = JMJ.jitter_window_matrices(jb, start, step, J, window)
    got = JR.jitter_window_matrices(pb, start, step, J, window)
    assert got.ok == want.ok is True
    for name in ("count0", "c0pos", "c0ge2", "has_klo", "has_khi", "F0_rel", "L0_rel",
                 "L2_rel", "Klo_rel", "Khi_rel", "blo_rel", "ehi_rel", "idx", "clo", "chi"):
        np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)),
                                      err_msg=name)
    # the kernel's step table, which the plain versions read back, holds the same
    d = JR.step_vectors(got)
    for name in ("count0", "c0pos", "c0ge2", "has_klo", "has_khi", "F0_rel", "L0_rel",
                 "L2_rel", "Klo_rel", "Khi_rel", "blo_rel", "ehi_rel", "idx", "clo", "chi"):
        np.testing.assert_array_equal(d[name].numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(d["nom"].numpy(), np.asarray(pb.nominal_ts)[got.idx])
    t = torch.arange(want.W0.shape[0])[:, None]
    certain = ((t >= d["clo"]) & (t < d["chi"])).float().numpy()
    np.testing.assert_array_equal(certain, want.W0)


def test_window_matrices_decline_as_jax():
    """A window not wider than twice the deviation bound: ``ok`` false in
    both packages, nothing built; the port's ladders take window stats."""
    jb, pb, _, _ = staged("gauge")
    md = pb.maxdev_ms
    assert md == jb.maxdev_ms and md > 0
    for window, ok in ((2 * md, False), (2 * md + 1, True)):
        want = JMJ.jitter_window_matrices(jb, 400_000, 60_000, 32, window)
        got = JR.jitter_window_matrices(pb, 400_000, 60_000, 32, window)
        assert got.ok == want.ok == ok == JR.window_ok(window, md)
    assert not hasattr(JR.jitter_window_matrices(pb, 0, 60_000, 32, 2 * md), "steps")
    assert AGG.grid_variant(pb, "rate", False, 2 * md) == "window_stats"
    assert AGG.grid_variant(pb, "irate", False, 2 * md) == "general"
    assert AGG.grid_variant(pb, "rate", False, 2 * md + 1) == "jitter"
    params = RangeParams(BASE + 400_000, 60_000, 10, 2 * md)
    assert K.tree_rung("rate", pb, params) == "window_stats"
    assert K._dispatch_range_function("rate", pb, params)[1] == "window_stats"
    with pytest.raises(ValueError, match="not wider"):
        JR.jitter_range_aggregate("rate", "sum", pb, AGG.zero_gids(pb), 1, params)


def test_deviations_equal_the_staged_ts_dev_at_every_edge():
    """The port takes each deviation as ts - nominal_ts: equal to the JAX
    package's f32 ts_dev on every real slot, so every edge compare (klo >
    blo_rel, khi <= ehi_rel) falls as JAX's."""
    for staging in ("gauge", "corrected"):
        jb, pb, _, _ = staged(staging)
        n, m = pb.n_series, int(pb.lens[0])
        dev = (pb.ts[:n, :m].long() - torch.from_numpy(pb.nominal_ts[:m]).long()).float()
        np.testing.assert_array_equal(dev.numpy(), np.asarray(jb.ts_dev)[:n, :m])
        for start, step, window in QUERY_GRIDS.values():
            wm = JMJ.jitter_window_matrices(jb, start, step, pad_steps(NUM_STEPS), window)
            pwm = JR.jitter_window_matrices(pb, start, step, pad_steps(NUM_STEPS), window)
            jdev = np.asarray(jb.ts_dev)[:n]
            for k, bound, op in ((JR.KLO, "blo_rel", np.greater), (JR.KHI, "ehi_rel",
                                                                   np.less_equal)):
                want = op(jdev[:, wm.idx[k]], getattr(wm, bound)[None, :])
                d = JR.step_vectors(pwm)
                pdev = (pb.ts[:n][:, d["idx"][k]].long() - d["nom"][k]).float().numpy()
                got = op(pdev, getattr(pwm, bound)[None, :])
                np.testing.assert_array_equal(got, want)


MOMENTS = ("stddev_over_time", "stdvar_over_time", "z_score")


def moments_oracle(func, pb, start, step, window):
    """The moments in float64 over each series' exact windows (b, e] of the
    staged f32 values, and the windows' sample counts."""
    n = pb.n_series
    ts, lens = np.asarray(pb.ts), np.asarray(pb.lens)
    vals = np.asarray(pb.vals).astype(np.float64)
    out_t = start + np.arange(NUM_STEPS, dtype=np.int64) * step
    out = np.full((n, NUM_STEPS), np.nan)
    count = np.zeros((n, NUM_STEPS), np.int64)
    for s in range(n):
        t = ts[s, : lens[s]].astype(np.int64)
        for j, e in enumerate(out_t):
            w = vals[s, : lens[s]][(t > e - window) & (t <= e)]
            count[s, j] = len(w)
            if not len(w):
                continue
            var = ((w - w.mean()) ** 2).mean()
            out[s, j] = {"stdvar_over_time": var, "stddev_over_time": np.sqrt(var),
                         "z_score": (w[-1] - w.mean()) / max(np.sqrt(var), 1e-30)}[func]
    return out, count


def tree_pair(func, jb, pb, start, step, window, counter, delta):
    """``func`` over both packages' blocks through their tree entries
    (``_dispatch_range_function``): the port's and the JAX package's
    [S, J] grids, after checking that both took the same rung (the JAX
    general or pallas rung is the port's ``general_rung``)."""
    want, jvar = JK._dispatch_range_function(
        func, jb, JK.RangeParams(BASE + start, step, NUM_STEPS, window), is_counter=counter,
        is_delta=delta)
    params = RangeParams(BASE + start, step, NUM_STEPS, window)
    got, pvar = K._dispatch_range_function(func, pb, params, is_counter=counter, is_delta=delta)
    if jvar in ("jitter", "masked"):
        assert pvar == jvar, (func, pvar, jvar)
    else:
        assert pvar == AGG.general_rung(func, pb), (func, pvar, jvar)
    return got.numpy(), np.asarray(want)


# the moments run on gauges: on counters both packages' f32 E[v^2] - E[v]^2
# cancels in their own orders (ROADMAP C, the regular rung's moments)
PLAIN_CASES = [(f, s) for f in sorted(JR.JITTER_FUNCS) for s in sorted(STAGINGS)
               if f not in MOMENTS or s == "gauge"]


@pytest.mark.parametrize("grid", sorted(QUERY_GRIDS))
@pytest.mark.parametrize("func,staging", PLAIN_CASES)
def test_jitter_plain_matches_jax(func, staging, grid):
    """The tree's entry on a ``jitter`` block (the store mode's plain
    version and ``jitter_minmax_plain``; irate/idelta of delta counters on
    the general rung) against the JAX package's; the moments by the
    JAX-or-oracle rule (both packages take E[v^2] - E[v]^2, the JAX
    package's matmul in another order, which on windows of a few samples
    leaves more than the tolerance)."""
    from tests.test_torch_general import assert_jax_or_oracle

    jb, pb, counter, delta = staged(staging)
    start, step, window = QUERY_GRIDS[grid]
    got, want = tree_pair(func, jb, pb, start, step, window, counter, delta)
    n = pb.n_series
    what = f"{func} {staging} {grid}"
    if func in MOMENTS:
        exact, count = moments_oracle(func, pb, start, step, window)
        assert_jax_or_oracle(got[:n, :NUM_STEPS], want[:n, :NUM_STEPS], exact, count, what)
    else:
        assert_close(got[:n, :NUM_STEPS], want[:n, :NUM_STEPS], what)
    if grid == "main":
        assert not np.isnan(want[:n, :NUM_STEPS]).all() or func == "absent_over_time"


@pytest.mark.parametrize("op", ["sum", "count", "avg", "min", "max"])
@pytest.mark.parametrize("func", sorted(AGG.FUSED_JITTER_FUNCS))
def test_jitter_aggregate_matches_fused_jitter(func, op):
    """``jitter_range_aggregate`` on the CPU against the JAX package's fused
    jitter dispatch (``_fused_jitter_jit``, ``_fused_jitter_minmax_jit``)."""
    staging = {"rate": "corrected", "increase": "corrected", "irate": "corrected",
               "idelta": "diff", "delta": "shifted"}.get(func, "gauge")
    jb, pb, counter, delta = staged(staging, seed=1)
    G = 3
    gids = np.full(pb.vals.shape[0], G, np.int64)
    gids[: pb.n_series] = np.arange(pb.n_series) % G
    want = JAGG.fused_range_aggregate(func, op, jb, gids.astype(np.int32), G,
                                      JK.RangeParams(BASE + 400_000, 60_000, NUM_STEPS, 300_000),
                                      is_counter=counter, is_delta=delta)
    got = JR.jitter_range_aggregate(func, op, pb, torch.from_numpy(gids), G,
                                    RangeParams(BASE + 400_000, 60_000, NUM_STEPS, 300_000),
                                    is_counter=counter, is_delta=delta)
    assert_close(got.numpy()[:, :NUM_STEPS], np.asarray(want)[:, :NUM_STEPS], f"{op}({func})")


@pytest.mark.parametrize("func", ["rate", "increase", "sum_over_time", "irate", "idelta",
                                  "last", "count_over_time"])
def test_delta_counters_on_the_jitter_rung(func):
    """Delta counters: rate/increase are window sums on the rung; irate and
    idelta leave it (the JAX ladder's exclusion) for the general one."""
    jb, pb, _, _ = staged("delta")
    params = RangeParams(BASE + 400_000, 60_000, NUM_STEPS, 300_000)
    jvar, _ = JAGG._grid_variant(jb, func, True)
    pvar = AGG.grid_variant(pb, func, True, params.window_ms)
    assert pvar == ("general" if func in ("irate", "idelta") else "jitter") == (
        "general" if jvar == "general" else "jitter")
    want, jtree = JK._dispatch_range_function(
        func, jb, JK.RangeParams(BASE + 400_000, 60_000, NUM_STEPS, 300_000), is_counter=True,
        is_delta=True)
    got, ptree = K._dispatch_range_function(func, pb, params, is_counter=True, is_delta=True)
    assert ptree == ("general" if jtree == "general" else jtree)
    n = pb.n_series
    assert_close(got.numpy()[:n, :NUM_STEPS], np.asarray(want)[:n, :NUM_STEPS], func)


# -- staging: ragged edges -------------------------------------------------------------


def test_slot_align_repairs_ragged_edges_as_jax():
    """A read range whose edges cut through jittered samples: per-series
    counts differ by one, so the packed staging is not jittered;
    ``_slot_align`` re-reads with a margin and trims to the common slots,
    and ``stage_from_shard`` stages that as ``jitter``, as in JAX."""
    jms, pms = mirrored_stores(near_regular_data(n=90, seed=4, phase_ms=0))
    start, end = BASE + 100_000, BASE + 700_000  # nominal slots land on both edges
    repaired = 0
    for js, ps in zip(jms.shards("prometheus"), pms.shards("prometheus")):
        ids = sorted(i for i, p in ps.partitions.items() if p.schema.name == "gauge")
        if len(ids) < 2:
            continue
        series = [ps.partition(i).samples_in_range(start, end, "value") for i in ids]
        want = JST._slot_align(js, ids, "value", series, start, end)
        got = ST._slot_align(ps, ids, "value", series, start, end)
        assert (got is None) == (want is None)
        if want is not None:
            repaired += 1
            for (gt, gv), (wt, wv) in zip(got, want):
                np.testing.assert_array_equal(gt, wt)
                np.testing.assert_array_equal(gv, wv)
        jblock = JST.stage_from_shard(js, ids, "value", start, end, mode="raw")
        pblock = ST.stage_from_shard(ps, ids, "value", start, end, "raw")
        # a shard's block leaves its masked sidecar to its device copy
        assert ST.grid_class(ST.device_copy(pblock, "cpu")) == JST.grid_class(jblock)
        np.testing.assert_array_equal(pblock.ts, np.asarray(jblock.ts))
    assert repaired >= 1


# -- the engine end to end ------------------------------------------------------------

N_SERIES, N_SHARDS, SPREAD = 24, 4, 1
START_S, END_S, STEP_S = (BASE + 400_000) / 1000, (BASE + 1_300_000) / 1000, 60


def near_regular_data(n=150, seed=0, holes=False, phase_ms=5_000, delta=False):
    """(tags, schema, ts, values): counters (delta counters with ``delta``)
    and gauges on a jittered 10 s grid."""
    rng = np.random.default_rng(seed)
    nominal = BASE + phase_ms + np.arange(n, dtype=np.int64) * 10_000
    out = []
    counter = "delta-counter" if delta else "prom-counter"
    for metric, schema in (("http_requests_total", counter), ("node_temp", "gauge")):
        for i in range(N_SERIES // 2):
            ts = nominal + np.rint(rng.uniform(-0.05, 0.05, n) * 10_000).astype(np.int64)
            if schema == "prom-counter":
                vals = np.cumsum(rng.uniform(0, 10, n)) + 1e6
                if i % 3 == 0:
                    vals[n // 2:] -= vals[n // 2] - 3.0
            elif schema == "delta-counter":
                vals = rng.uniform(0, 10, n)
            else:
                vals = 50 + 20 * rng.standard_normal(n)
            if holes:
                keep = np.ones(n, bool)
                keep[rng.choice(np.arange(1, n - 1), 2, replace=False)] = False
                ts, vals = ts[keep], vals[keep]
            tags = {S.METRIC_TAG: metric, "_ws_": "demo", "_ns_": "App-2",
                    "instance": f"host-{i}", "zone": f"z{i % 4}"}
            out.append((tags, schema, ts, vals))
    return out


def mirrored_stores(data):
    jms, pms = JaxMemStore(), TimeSeriesMemStore()
    jms.setup(JS.Dataset("prometheus"), range(N_SHARDS))
    pms.setup(S.Dataset("prometheus"), range(N_SHARDS))
    for tags, schema, ts, vals in data:
        col = "value" if schema == "gauge" else "count"
        shard = S.shard_for(tags, SPREAD, N_SHARDS)
        jms.shard("prometheus", shard).ingest_series(JaxSeriesBatch(
            schema=JS.SCHEMAS[schema], tags=tags, timestamps=ts, values={col: vals}))
        pms.shard("prometheus", shard).ingest_series(SeriesBatch(
            schema=S.SCHEMAS[schema], tags=tags, timestamps=ts, values={col: vals}))
    return jms, pms


@pytest.fixture(scope="module")
def engines():
    jms, pms = mirrored_stores(near_regular_data())
    return JaxEngine(jms, "prometheus"), QueryEngine(pms, "prometheus", device="cpu")


def by_labels(res) -> dict:
    return {tuple(sorted(l.items())): np.asarray(v, np.float64)
            for g in res.grids for l, v in zip(g.labels, g.values_np())}


def assert_rows(got: dict, want: dict, what: str, oracle_funcs=()) -> None:
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        g = got[k]
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=f"{what} {k}")
        m = ~np.isnan(w)
        if oracle_funcs:
            assert np.isclose(g[m], w[m], rtol=RTOL, atol=ATOL).mean() > 0.9, what
        else:
            np.testing.assert_allclose(g[m], w[m], rtol=RTOL, atol=ATOL, err_msg=f"{what} {k}")


ENGINE_QUERIES = [
    ("sum(rate(http_requests_total[5m]))", "jitter"),
    ("sum by (zone) (increase(http_requests_total[5m]))", "jitter"),
    ("max by (zone) (min_over_time(node_temp[5m]))", "jitter"),
    ("sum(max_over_time(node_temp[5m]))", "jitter"),
    ("avg by (zone) (irate(http_requests_total[5m]))", "jitter"),
    ("sum(stddev_over_time(node_temp[5m]))", "jitter"),
    ("sum by (zone) (changes(node_temp[5m]))", "general"),
    ("topk(3, rate(http_requests_total[5m]))", "jitter"),
    ("quantile by (zone) (0.5, last_over_time(node_temp[5m]))", "jitter"),
    ("rate(http_requests_total[5m])", "jitter"),
    ("min_over_time(node_temp[5m])", "jitter"),
    ("absent_over_time(node_temp[5m])", "jitter"),
    ("deriv(node_temp[5m])", "general"),
    ("predict_linear(node_temp[5m], 600)", "general"),
    ("max_over_time(rate(http_requests_total[5m])[10m:1m])", None),
    ("sum(rate(http_requests_total[900ms]))", "window_stats"),
]


@pytest.mark.parametrize("query,rung", ENGINE_QUERIES, ids=[q for q, _ in ENGINE_QUERIES])
def test_engine_matches_jax_on_a_jittered_store(engines, query, rung):
    """Fused aggregates, epilogues, tree leaves and a subquery over a
    jittered store; each answered on the JAX ladder's rung (a 900 ms
    window is not wider than twice the deviation bound: window stats)."""
    jax_engine, port_engine = engines
    want = jax_engine.query_range(query, START_S, END_S, STEP_S)
    got = port_engine.query_range(query, START_S, END_S, STEP_S)
    if rung is not None:
        assert set(got.stats.rungs) == {rung}, got.stats.rungs
    oracle = ("deriv", "predict_linear", "stddev")
    assert_rows(by_labels(got), by_labels(want), query,
                oracle_funcs=oracle if any(f in query for f in oracle) else ())


@pytest.mark.parametrize("query", ["sum(rate(http_requests_total[5m]))",
                                   "sum by (zone) (increase(http_requests_total[5m]))",
                                   "sum(sum_over_time(http_requests_total[5m]))",
                                   "rate(http_requests_total[5m])",
                                   "sum(irate(http_requests_total[5m]))",
                                   "sum(idelta(http_requests_total[5m]))"])
def test_delta_counter_store_matches_jax(query):
    """A jittered store of ``delta-counter`` series through both engines:
    rate/increase/sum_over_time on the jitter rung, irate/idelta on the
    general one."""
    jms, pms = mirrored_stores(near_regular_data(delta=True, seed=3))
    want = JaxEngine(jms, "prometheus").query_range(query, START_S, END_S, STEP_S)
    got = QueryEngine(pms, "prometheus", device="cpu").query_range(query, START_S, END_S, STEP_S)
    rung = "general" if ("irate" in query or "idelta" in query) else "jitter"
    assert set(got.stats.rungs) == {rung}, got.stats.rungs
    assert_rows(by_labels(got), by_labels(want), query)


def test_extended_jitter_superblock_keeps_its_deviations():
    """A live-edge extension of a jittered superblock: the new columns'
    ts - nominal equal the deviations a fresh build stages, and the
    extended block answers on the jitter rung as a fresh build does."""
    data = near_regular_data(n=120, seed=5)
    _, pms = mirrored_stores(data)
    engine = QueryEngine(pms, "prometheus", device="cpu")
    q = "sum(rate(http_requests_total[5m]))"
    end = (BASE + 1_500_000) / 1000
    engine.query_range(q, START_S, end, STEP_S)
    rng = np.random.default_rng(9)
    for k in range(2):
        for tags, schema, ts, vals in data:
            if schema != "prom-counter":
                continue
            t = BASE + 5_000 + (120 + k) * 10_000 + int(np.rint(rng.uniform(-0.04, 0.04) * 1e4))
            pms.shard("prometheus", S.shard_for(tags, SPREAD, N_SHARDS)).ingest_series(
                SeriesBatch(S.PROM_COUNTER, tags, np.array([t]),
                            {"count": np.array([vals[-1] + 10.0 * (k + 1)])}))
    got = engine.query_range(q, START_S, end, STEP_S)
    assert got.stats.cache_extends == 1 and got.stats.rungs == {"jitter": 1}
    fresh_pms = TimeSeriesMemStore()
    fresh_pms.setup(S.Dataset("prometheus"), range(N_SHARDS))
    for s in pms.shard_nums("prometheus"):
        for p in pms.shard("prometheus", s).partitions.values():
            ts, v = p.samples_in_range(0, 2**62, p.schema.value_column)
            fresh_pms.shard("prometheus", s).ingest_series(
                SeriesBatch(p.schema, p.tags, ts, {p.schema.value_column: v}))
    want = QueryEngine(fresh_pms, "prometheus", device="cpu").query_range(q, START_S, end, STEP_S)
    assert_rows(by_labels(got), by_labels(want), q)
