"""Cross-query batching in the port (query/scheduler.DispatchScheduler and
the rungs' lane modes, ops/aggregations.fused_batched_scalar /
fused_batched_hist) against itself and the JAX package, on mirrored
memstores of tests/test_scheduler.py's shape (48 counters, 48 gauges, 24
histograms, 8 shards):

- every family of tests/test_scheduler.py's FAMILY_QUERIES, run as one
  coalesced round: each port lane bit-equal to its port solo run (on the
  CPU both are the plain versions, composed the same way), and within
  rtol 2e-4 / atol 1e-4 of the JAX package's batched lanes (stddev by the
  JAX-or-oracle rule: both packages' f32 E[v^2] - E[v]^2 cancels);
- one lane-mode dispatch per coalesced group, compatible window groups
  merged, identical specs on one lane, the plans and launches of an engine
  without batching unchanged;
- the port's recorded differences: no fallback around a batched launch (a
  failing one reaches every lane's caller, outcome ``error``); groups a
  predicate declines run solo (``fallback``); the batch predicate equals
  the JAX package's on every cell.

The batch window is held by a test-controlled waiter, released once every
query has joined: no sleeps decide a result.
"""

import threading
import time

import numpy as np
import pytest

from filodb_tpu.coordinator.planner import PlannerParams as JaxParams
from filodb_tpu.coordinator.planner import QueryEngine as JaxEngine
from filodb_tpu.core import schemas as JS
from filodb_tpu.memstore.memstore import TimeSeriesMemStore as JaxMemStore
from filodb_tpu.ops import aggregations as JAGG
from filodb_tpu.query.scheduler import DispatchScheduler as JaxDispatch
from filodb_tpu.testkit import counter_batch, histogram_batch, machine_metrics
from filodb_tpu_torch.coordinator.planner import PlannerParams, QueryEngine
from filodb_tpu_torch.core import schemas as S
from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore
from filodb_tpu_torch.ops import aggregations as AGG
from filodb_tpu_torch.ops import hist_kernels as HK
from filodb_tpu_torch.ops import mxu_kernels as MK
from filodb_tpu_torch.query import scheduler as QS
from filodb_tpu_torch.query.exec import plans as P
from filodb_tpu_torch.query.scheduler import DispatchScheduler
from test_torch_hist_engine import port_batch

BASE = 1_600_000_000_000
N_SHARDS = 8
START = (BASE + 600_000) / 1000
END = START + 900
STEP = 60
RTOL, ATOL = 2e-4, 1e-4

# tests/test_scheduler.py's families: group-bys sharing one window (and one
# group-count bucket) coalesce; other windows and buckets ride along
FAMILY_QUERIES = {
    "agg_sum": [
        "sum(rate(http_requests_total[5m]))",
        "sum by (_ws_) (rate(http_requests_total[5m]))",
        "sum by (job) (rate(http_requests_total[5m]))",
        "sum(rate(http_requests_total[4m]))",
        "sum(rate(http_requests_total[5m] offset 1m))",
    ],
    "agg_grouped": [
        "sum by (instance) (rate(http_requests_total[5m]))",
        "sum by (instance,job) (rate(http_requests_total[5m]))",
    ],
    "agg_minmax": [
        "max by (instance) (avg_over_time(heap_usage0[5m]))",
        "max by (instance,job) (avg_over_time(heap_usage0[5m]))",
        "min(avg_over_time(heap_usage0[5m]))",
    ],
    "agg_stddev": [
        "stddev(rate(http_requests_total[5m]))",
        "stddev by (_ns_) (rate(http_requests_total[5m]))",
    ],
    "topk": [
        "topk(3, rate(http_requests_total[5m]))",
        "topk(3, rate(http_requests_total[4m]))",
        "bottomk(2, rate(http_requests_total[5m]))",
    ],
    "quantile": [
        "quantile(0.9, rate(http_requests_total[5m]))",
        "quantile(0.5, rate(http_requests_total[5m]))",
        "quantile(0.99, rate(http_requests_total[5m]))",
    ],
    "hist": [
        "sum by (le) (rate(http_request_latency_bucket[5m]))",
        "sum by (le,_ws_) (rate(http_request_latency_bucket[5m]))",
    ],
    "hist_quantile": [
        "histogram_quantile(0.99, sum by (le) (rate(http_request_latency_bucket[5m])))",
        "histogram_quantile(0.5, sum by (le) (rate(http_request_latency_bucket[5m])))",
        "histogram_quantile(0.9, sum by (le) (rate(http_request_latency_bucket[4m])))",
    ],
}


@pytest.fixture(scope="module")
def stores():
    jms, pms = JaxMemStore(), TimeSeriesMemStore()
    jms.setup(JS.Dataset("ds"), list(range(N_SHARDS)))
    pms.setup(S.Dataset("ds"), list(range(N_SHARDS)))
    for jb in (counter_batch(n_series=48, n_samples=240, start_ms=BASE),
               machine_metrics(n_series=48, n_samples=240, start_ms=BASE),
               histogram_batch(n_series=24, n_samples=240, start_ms=BASE,
                               metric="http_request_latency")):
        assert pms.ingest_routed("ds", port_batch(jb), 3) == jms.ingest_routed("ds", jb, 3)
    return jms, pms


@pytest.fixture(scope="module")
def port_engines(stores):
    """(batched, its scheduler, sequential twin): the twin shares the
    batched engine's aligned plans but a disabled scheduler."""
    _, pms = stores
    sched = DispatchScheduler(window_ms=100, max_batch=32)
    batched = QueryEngine(pms, "ds", PlannerParams(batch_window_ms=100, dispatch_scheduler=sched),
                          device="cpu")
    seq = QueryEngine(pms, "ds", PlannerParams(batch_window_ms=100,
                                               dispatch_scheduler=DispatchScheduler(0)),
                      device="cpu")
    return batched, sched, seq


def rows(res):
    return {tuple(sorted(l.items())): np.asarray(v, np.float64)
            for g in res.grids for l, v in zip(g.labels, g.values_np())}


def hist_rows(res):
    out = {}
    for g in res.grids:
        h = g.hist_np()
        if h is not None:
            for lbls, cube in zip(g.labels, h):
                out[tuple(sorted(lbls.items()))] = np.asarray(cube, np.float64)
    return out


def run_coalesced(engine, sched, queries, want_lanes=None):
    """Run ``queries`` concurrently with the batch window held until every
    query has joined (and ``want_lanes`` lanes queued), then release."""
    hold = threading.Event()
    sched._waiter = lambda ev, s: hold.wait(30)
    q0 = sched.stats["queries"]
    results, errors = {}, {}

    def worker(q):
        try:
            results[q] = engine.query_range(q, START, END, STEP)
        except Exception as e:  # noqa: BLE001 -- surfaced below
            errors[q] = e

    threads = [threading.Thread(target=worker, args=(q,)) for q in queries]
    for t in threads:
        t.start()
    fused = [q for q in queries if not q.startswith("stddev")]
    want = len(fused) if want_lanes is None else want_lanes
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        snap = sched.snapshot()
        if snap["queries"] - q0 >= len(fused) and snap["queued_lanes"] >= want:
            break
        time.sleep(0.002)
    hold.set()
    for t in threads:
        t.join(60)
    sched._waiter = None
    return results, errors


def assert_bit_equal(got, want, what):
    a, b = rows(got), rows(want)
    assert a.keys() == b.keys() and a, what
    for k in a:
        assert np.array_equal(a[k], b[k], equal_nan=True), (what, k)
    ha, hb = hist_rows(got), hist_rows(want)
    assert ha.keys() == hb.keys(), what
    for k in ha:
        assert np.array_equal(ha[k], hb[k], equal_nan=True), (what, k)


def moments_oracle(seq, query: str) -> dict:
    """stddev of the port's own rate rows in float64 (the JAX-or-oracle
    rule of tests/test_torch_aggregate_tree.py)."""
    inner = query[query.index("(rate(") + 1:-1]
    by = [query.split("by (")[1].split(")")[0]] if " by (" in query else None
    inner_rows = rows(seq.query_range(inner, START, END, STEP))
    gids, group_labels = AGG.group_ids_for([dict(k) for k in inner_rows], by, None)
    vals = np.stack(list(inner_rows.values()))
    out = {}
    for g, gl in enumerate(group_labels):
        v = vals[gids == g]
        n = (~np.isnan(v)).sum(axis=0)
        with np.errstate(invalid="ignore", divide="ignore"):
            mean = np.nansum(v, axis=0) / n
            sd = np.sqrt(np.maximum(np.nansum(v * v, axis=0) / n - mean ** 2, 0.0))
        out[tuple(sorted(gl.items()))] = np.where(n > 0, sd, np.nan)
    return out


def assert_close(got: dict, want: dict, what: str, oracle: dict | None = None):
    assert got.keys() == want.keys() and want, what
    for k, w in want.items():
        g = got[k]
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=f"{what} {k}")
        m = ~np.isnan(w)
        if oracle is not None:
            ok = np.isclose(g, w, rtol=RTOL, atol=ATOL) | np.isclose(g, oracle[k], rtol=RTOL,
                                                                      atol=ATOL)
            assert ok[m].all(), (what, k)
            continue
        np.testing.assert_allclose(g[m], w[m], rtol=RTOL, atol=ATOL, err_msg=f"{what} {k}")


@pytest.mark.parametrize("family", sorted(FAMILY_QUERIES))
def test_batched_lanes_bit_equal_to_solo_and_match_jax(stores, port_engines, family):
    jms, _ = stores
    batched, sched, seq = port_engines
    queries = FAMILY_QUERIES[family]
    want = {q: seq.query_range(q, START, END, STEP) for q in queries}
    got, errors = run_coalesced(batched, sched, queries)
    assert not errors, errors
    for q in queries:
        assert_bit_equal(got[q], want[q], q)
    jsched = JaxDispatch(window_ms=100, max_batch=32)
    jax = JaxEngine(jms, "ds", JaxParams(batch_window_ms=100, dispatch_scheduler=jsched))
    jgot, jerr = run_coalesced(jax, jsched, queries)
    assert not jerr, jerr
    for q in queries:
        oracle = moments_oracle(seq, q) if q.startswith("stddev") else None
        assert_close(rows(got[q]), rows(jgot[q]), q, oracle)
        ha, hb = hist_rows(got[q]), hist_rows(jgot[q])
        assert ha.keys() == hb.keys(), q
        for k in ha:
            assert_close({k: ha[k]}, {k: hb[k]}, f"{q} hist")


def test_coalesced_group_is_one_lane_mode_dispatch(port_engines, monkeypatch):
    """Four group-bys of one window: ONE dispatch of the regular rung's lane
    mode serving four lanes (the plain version stands in for the kernel on
    the CPU; the count is of its entry point)."""
    batched, sched, seq = port_engines
    calls = []
    real = MK.regular_range_lanes
    monkeypatch.setattr(MK, "regular_range_lanes",
                        lambda *a, **k: calls.append(len(a[3])) or real(*a, **k))
    queries = ["sum(rate(http_requests_total[5m]))",
               "sum by (_ws_) (rate(http_requests_total[5m]))",
               "sum by (job) (rate(http_requests_total[5m]))",
               "sum by (_ns_) (rate(http_requests_total[5m]))"]
    before = dict(sched.stats)
    got, errors = run_coalesced(batched, sched, queries)
    assert not errors and calls == [4]
    assert sched.stats["batched"] == before["batched"] + 1
    assert sched.stats["dispatches"] == before["dispatches"] + 1
    for q in queries:
        assert_bit_equal(got[q], seq.query_range(q, START, END, STEP), q)


def test_compatible_window_groups_merge_into_one_launch(port_engines, monkeypatch):
    batched, sched, seq = port_engines
    windows = []
    real = AGG._batched_stacks
    monkeypatch.setattr(AGG, "_batched_stacks",
                        lambda block, lanes, *a: windows.append(len({l[3].window_ms
                                                                     for l in lanes}))
                        or real(block, lanes, *a))
    queries = [f"sum by (_ws_) (rate(http_requests_total[{w}]))" for w in ("5m", "4m", "3m")]
    before = dict(sched.stats)
    got, errors = run_coalesced(batched, sched, queries)
    assert not errors and windows == [3]
    assert sched.stats["merged_windows"] == before["merged_windows"] + 2
    assert sched.stats["dispatches"] == before["dispatches"] + 1
    for q in queries:
        assert_bit_equal(got[q], seq.query_range(q, START, END, STEP), q)


def test_identical_specs_share_one_lane(stores):
    """With identical-query coalescing off, the same query twice reaches
    the scheduler twice and rides ONE lane (and its future)."""
    _, pms = stores
    sched = DispatchScheduler(window_ms=100)
    eng = QueryEngine(pms, "ds", PlannerParams(batch_window_ms=100, dispatch_scheduler=sched,
                                               coalesce_identical=False), device="cpu")
    q = "sum by (job) (rate(http_requests_total[5m]))"
    hold = threading.Event()
    sched._waiter = lambda ev, s: hold.wait(30)
    out = []
    ths = [threading.Thread(target=lambda: out.append(eng.query_range(q, START, END, STEP)))
           for _ in range(2)]
    for t in ths:
        t.start()
    deadline = time.monotonic() + 30
    while sched.snapshot()["queries"] < 2 and time.monotonic() < deadline:
        time.sleep(0.002)
    hold.set()
    for t in ths:
        t.join(60)
    snap = sched.snapshot()
    assert snap["coalesced"] == 1 and snap["solo"] == 1 and snap["dispatches"] == 1
    assert_bit_equal(out[0], out[1], q)


def test_batching_disabled_keeps_plans_and_launches(stores, monkeypatch):
    """batch_window_ms 0: the unaligned plans of a default engine, no
    scheduler on the context, and every launch through the solo entry
    points, once per query."""
    _, pms = stores
    from filodb_tpu_torch.query.promql import query_range_to_logical_plan

    q = "sum by (job) (rate(http_requests_total[4m]))"
    plain = QueryEngine(pms, "ds", device="cpu")
    off = QueryEngine(pms, "ds", PlannerParams(batch_window_ms=0), device="cpu")
    lp = query_range_to_logical_plan(q, START, END, STEP)
    a, b = plain.planner.materialize(lp), off.planner.materialize(lp)
    assert isinstance(a, P.FusedAggregateExec)
    assert (a.raw_start_ms, a.raw_end_ms) == (b.raw_start_ms, b.raw_end_ms) == (
        lp.inner.raw.start_ms, lp.inner.raw.end_ms)
    assert off.context().dispatch_scheduler is None
    on = QueryEngine(pms, "ds", PlannerParams(batch_window_ms=50), device="cpu")
    c = on.planner.materialize(lp)
    assert c.raw_start_ms % on.planner.FUSED_ALIGN_MS == 0 and c.raw_start_ms <= a.raw_start_ms
    calls = []
    monkeypatch.setattr(MK, "regular_range_lanes", lambda *a, **k: calls.append("lanes"))
    real = MK.regular_range_aggregate
    monkeypatch.setattr(MK, "regular_range_aggregate",
                        lambda *a, **k: calls.append("solo") or real(*a, **k))
    assert_bit_equal(off.query_range(q, START, END, STEP), plain.query_range(q, START, END, STEP),
                     q)
    assert calls == ["solo", "solo"]


# -- the port's recorded differences -------------------------------------------


def test_failed_batched_launch_reaches_every_lane(port_engines, monkeypatch):
    """No fallback around a batched launch: its failure reaches each lane's
    caller, counted as outcome ``error`` (the JAX package reruns the lanes
    unbatched and counts ``fallback``)."""
    batched, sched, _ = port_engines

    def broken(*a, **k):
        raise RuntimeError("lane-mode launch failed: cudaError 700")

    monkeypatch.setattr(MK, "regular_range_lanes", broken)
    queries = ["sum by (job) (rate(http_requests_total[3m]))",
               "sum by (_ws_) (rate(http_requests_total[3m]))"]
    before = dict(sched.stats)
    _, errors = run_coalesced(batched, sched, queries)
    assert sorted(errors) == sorted(queries)
    assert all("cudaError 700" in str(e) for e in errors.values())
    assert sched.stats["error"] == before["error"] + 1
    assert sched.stats["fallback"] == before["fallback"]


def test_declined_group_runs_each_lane_solo(stores):
    """A group whose lanes would take different rungs (one merged window
    inside the jitter bound of a near-regular grid, here forced by a
    predicate that declines) runs every lane solo, outcome ``fallback``,
    before any launch."""
    _, pms = stores
    sched = DispatchScheduler(window_ms=100)
    eng = QueryEngine(pms, "ds", PlannerParams(batch_window_ms=100, dispatch_scheduler=sched),
                      device="cpu")
    seq = QueryEngine(pms, "ds", PlannerParams(batch_window_ms=100,
                                               dispatch_scheduler=DispatchScheduler(0)),
                      device="cpu")
    queries = ["sum by (job) (rate(http_requests_total[2m]))",
               "sum by (_ws_) (rate(http_requests_total[2m]))"]
    real = AGG.lanes_variant
    AGG.lanes_variant = lambda *a: None
    try:
        got, errors = run_coalesced(eng, sched, queries)
    finally:
        AGG.lanes_variant = real
    assert not errors
    assert sched.stats["fallback"] == 1 and sched.stats["batched"] == 0
    for q in queries:
        assert_bit_equal(got[q], seq.query_range(q, START, END, STEP), q)


def test_block_identity_checked_at_execute(stores):
    """Lanes batch only over the same block object (``is``), whatever
    their ids say."""
    from filodb_tpu_torch.ops.kernels import RangeParams
    from filodb_tpu_torch.query.promql import query_range_to_logical_plan

    _, pms = stores
    eng = QueryEngine(pms, "ds", device="cpu")

    lp = query_range_to_logical_plan("sum(rate(http_requests_total[5m]))", START, END, STEP)
    ex = eng.planner.materialize(lp)
    got = ex.superblock(eng.context())
    other = type(got.block).__new__(type(got.block))
    other.__dict__.update(got.block.__dict__)  # an equal block, another object
    params = RangeParams(int(START * 1000), 60_000, 16, 300_000)
    gids = AGG.zero_gids(got.block)

    def req(block):
        return QS.FusedRequest(block=block, func="rate", kind="agg", epilogue=("agg", "sum"),
                               gids_dev=gids, G=1, qv=0.0, params=params, j_pad=16,
                               is_counter=True, is_delta=False)

    assert QS.batch_lanes_ok([req(got.block), req(got.block)])
    assert not QS.batch_lanes_ok([req(got.block), req(other)])


def test_groups_over_the_lane_cap_run_solo(stores):
    """Port difference (ROADMAP C, "Lane cap"): one lane-mode launch takes
    at most ``group_acc.MAX_LANES`` lanes (the kernels' lanes::MAX_LANES).
    A group over it is declined before any launch (outcome ``fallback``),
    and the ops layer refuses to launch one."""
    from filodb_tpu_torch.ops import group_acc as GA
    from filodb_tpu_torch.ops.kernels import RangeParams
    from filodb_tpu_torch.query.promql import query_range_to_logical_plan

    _, pms = stores
    eng = QueryEngine(pms, "ds", device="cpu")
    lp = query_range_to_logical_plan("sum(rate(http_requests_total[5m]))", START, END, STEP)
    block = eng.planner.materialize(lp).superblock(eng.context()).block
    gids = AGG.zero_gids(block)
    reqs = [QS.FusedRequest(block=block, func="rate", kind="agg", epilogue=("agg", "sum"),
                            gids_dev=gids, G=1, qv=0.0,
                            params=RangeParams(int(START * 1000), 60_000, 16,
                                               60_000 * (1 + i % 4)),
                            j_pad=16, is_counter=True, is_delta=False)
            for i in range(GA.MAX_LANES + 1)]
    assert QS.batch_lanes_ok(reqs[:GA.MAX_LANES])
    assert not QS.batch_lanes_ok(reqs)
    lanes = [r.lane() for r in reqs]
    with pytest.raises(ValueError, match="lane mode"):
        AGG.fused_batched_scalar("rate", ("agg", "sum"), block, lanes, True, False)
    assert len(AGG.fused_batched_scalar("rate", ("agg", "sum"), block, lanes[:GA.MAX_LANES],
                                        True, False)) == GA.MAX_LANES


GRID_CLASSES = ("regular", "jitter", "holes", "irregular")
PREDICATE_FUNCS = sorted(MK.FUSED_MXU_FUNCS | {"min_over_time", "max_over_time", "changes",
                                               "resets", "deriv", "stddev_over_time",
                                               "absent_over_time", "first_over_time",
                                               "present_over_time"})


@pytest.fixture(scope="module")
def grid_blocks():
    """One staged block of each grid class (port and JAX staging of the
    same series)."""
    from filodb_tpu.ops import staging as JST
    from filodb_tpu_torch.ops import staging as ST

    rng = np.random.default_rng(3)
    nominal = BASE + np.arange(120, dtype=np.int64) * 10_000
    out = {}
    for kind in GRID_CLASSES:
        series = []
        for i in range(6):
            if kind == "irregular":
                ts = BASE + np.cumsum(rng.integers(5_000, 15_001, 120)).astype(np.int64)
            elif kind == "regular":
                ts = nominal
            else:
                ts = nominal + np.rint(rng.uniform(-0.05, 0.05, 120) * 10_000).astype(np.int64)
            vals = np.cumsum(rng.uniform(0, 10, len(ts)))
            if kind == "holes":
                ts, vals = np.delete(ts, [5 + i, 60]), np.delete(vals, [5 + i, 60])
            series.append((ts, vals))
        pb, jb = ST.stage_series(series, BASE), JST.stage_series(series, BASE)
        assert ST.grid_class(pb) == kind
        out[kind] = (pb.to_device("cpu"), jb)
    return out


@pytest.mark.parametrize("kind", GRID_CLASSES)
def test_batch_predicate_matches_jax(grid_blocks, kind, monkeypatch):
    """The port's batch predicate equals the JAX package's on every grid
    class and function (the JAX Pallas promotion off, as on the CPU: the
    port serves those dispatches on window stats, which has a lane mode),
    and ``lanes_variant`` takes the solo rung of every batched cell."""
    from filodb_tpu_torch.ops.kernels import RangeParams

    monkeypatch.setenv("FILODB_PALLAS", "0")
    pb, jb = grid_blocks[kind]
    for func in PREDICATE_FUNCS:
        port = AGG.batch_variant_supported(pb, func, "agg", False)
        assert port == JAGG.batch_variant_supported(jb, func, "agg", False, None), (kind, func)
        params = [RangeParams(BASE + 400_000, 60_000, 10, 300_000)]
        want = AGG.grid_variant(pb, func, False, 300_000) if port else None
        assert AGG.lanes_variant(pb, func, "agg", False, params) == want, (kind, func)
    assert AGG.batch_variant_supported(pb, "rate", "hist", False) == \
        JAGG.batch_variant_supported(jb, "rate", "hist", False, None)


def test_lane_plan_counts_lanes_and_falls_back_to_global():
    """group_acc.tile_plan counts the lanes of one window: 4 lanes at G = 8,
    J = 111 keep shared partials (about 28 KB); 16 lanes at G = 64 go to
    global atomics."""
    from filodb_tpu_torch.ops import group_acc as GA

    p = GA.tile_plan(8, 111, 0, 0, lanes=4)
    assert p.shared and p.smem_bytes == 2 * 4 * 8 * 111 * 4
    q = GA.tile_plan(64, 111, 0, 0, lanes=16)
    assert not q.shared and q.smem_bytes == 0
    assert HK.LANE_LAUNCHES == 0 and MK.LANE_LAUNCHES == 0  # the CPU never launches
