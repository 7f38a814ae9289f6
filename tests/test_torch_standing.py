"""Standing queries in the port (filodb_tpu_torch/standing/) against itself
and the JAX package (tests/test_standing.py's shapes: 24 counters on 4
shards, 10 s scrapes, 15 s steps over 20 minutes; on the CPU).

- delta refreshes bit-equal to a forced full refresh of the port across
  regular, jittered and holey grids and three live-edge append rounds; the
  retained matrices within rtol 2e-4 / atol 1e-4 of the JAX package's,
  with equal NaN masks and labels;
- a delta refresh is one suffix dispatch, disjoint ingest none; new series
  reset; nondecomposable epilogues re-dispatch in full, counted;
- the recurrence ring (C1): the same queries through both engines give
  equal ring keys and descriptors (less ``end_lag_ms``); promotion and its
  hysteresis; no promotion of historical scans;
- ``ingest_effects_interval_since`` equal to the JAX shard's on the same
  effect logs; append listeners outside the shard lock;
- the hub, SSE fan-out of one render, the HTTP API and ``/debug/standing``,
  ``serve_range``, recording rules, the append wake, ledger and tenant
  attribution, superblock pins, refreshes under batching.
"""

import json
import threading
import time

import numpy as np
import pytest

from filodb_tpu.coordinator.planner import QueryEngine as JaxEngine
from filodb_tpu.core.records import SeriesBatch as JaxSeriesBatch
from filodb_tpu.core.schemas import PROM_COUNTER as JAX_PROM_COUNTER
from filodb_tpu.core.schemas import Dataset as JaxDataset
from filodb_tpu.memstore.memstore import TimeSeriesMemStore as JaxMemStore
from filodb_tpu.standing import StandingEngine as JaxStanding
from filodb_tpu_torch.coordinator.planner import PlannerParams, QueryEngine
from filodb_tpu_torch.core.records import SeriesBatch
from filodb_tpu_torch.core.schemas import METRIC_TAG, PROM_COUNTER, Dataset, shard_for
from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore
from filodb_tpu_torch.metrics import REGISTRY
from filodb_tpu_torch.ops import aggregations as AGG
from filodb_tpu_torch.query.exec import plans as P
from filodb_tpu_torch.query.scheduler import DispatchScheduler
from filodb_tpu_torch.standing import StandingEngine, SubscriptionHub, SubscriptionLimit

BASE = 1_600_000_000_000
INTERVAL = 10_000
N_SHARDS = 4
STEP_MS = 15_000
SPAN_MS = 1_200_000
RTOL, ATOL = 2e-4, 1e-4

GRIDS = {
    "regular": dict(jitter=0.0, hole_frac=0.0),
    "jitter": dict(jitter=0.05, hole_frac=0.0),
    "holes": dict(jitter=0.05, hole_frac=0.01),
}

QUERIES = [
    "sum by (instance) (rate(rq[5m]))",
    "avg by (job) (increase(rq[5m]))",
    "count(sum_over_time(rq[2m]))",
]


def series_data(metric, n_series, total, jitter=0.0, hole_frac=0.0, seed=7):
    """Per-series (tags, ts, vals) counters (tests/test_standing.py's): a
    prefix ingests first, later slices append as live scrapes."""
    rng = np.random.default_rng(seed)
    nominal = BASE + INTERVAL // 2 + (1 + np.arange(total, dtype=np.int64)) * INTERVAL
    out = []
    for i in range(n_series):
        tags = {METRIC_TAG: metric, "_ws_": "w", "_ns_": "n", "instance": f"h{i}",
                "job": f"j{i % 4}"}
        dev = (np.rint(rng.uniform(-jitter, jitter, total) * INTERVAL).astype(np.int64)
               if jitter > 0 else 0)
        ts = nominal + dev
        vals = np.cumsum(rng.uniform(0, 10, total)) + 1e9
        keep = np.ones(total, bool)
        if hole_frac > 0:
            drop = rng.choice(np.arange(1, total - 1), max(1, int(hole_frac * total)),
                              replace=False)
            keep[drop] = False
        out.append((tags, ts[keep], vals[keep]))
    return out


def ingest_window(ms, data, lo_ms, hi_ms, jax=False):
    """Ingest every sample with lo_ms <= ts < hi_ms, one series batch each."""
    sb, schema = (JaxSeriesBatch, JAX_PROM_COUNTER) if jax else (SeriesBatch, PROM_COUNTER)
    n = 0
    for tags, ts, vals in data:
        m = (ts >= lo_ms) & (ts < hi_ms)
        if m.any():
            shard = shard_for(tags, spread=3, num_shards=N_SHARDS)
            n += ms.shard("ds", shard).ingest_series(sb(schema, tags, ts[m],
                                                        {"count": vals[m]}))
    return n


def fresh(n_series=24, total=260, jitter=0.0, hole_frac=0.0, seed=7, prefix=200,
          params=None):
    """(memstore, engine on the CPU, data, edge_ms): the prefix ingested."""
    ms = TimeSeriesMemStore()
    ms.setup(Dataset("ds"), list(range(N_SHARDS)))
    data = series_data("rq", n_series, total, jitter, hole_frac, seed)
    edge = BASE + prefix * INTERVAL
    ingest_window(ms, data, 0, edge)
    return ms, QueryEngine(ms, "ds", params, device="cpu"), data, edge


def fresh_jax(data, edge):
    ms = JaxMemStore()
    ms.setup(JaxDataset("ds"), list(range(N_SHARDS)))
    ingest_window(ms, data, 0, edge, jax=True)
    return ms, JaxEngine(ms, "ds")


def standing(engine, edge_ms, cls=StandingEngine, **cfg):
    return cls(engine, {"default_span_ms": SPAN_MS, **cfg},
               clock=lambda: (edge_ms + 5_000) / 1e3)


@pytest.fixture
def dispatches(monkeypatch):
    """Counts fused dispatches (``FusedAggregateExec._dispatch_fused``
    calls): on the card each is one kernel launch."""
    n = [0]
    orig = P.FusedAggregateExec._dispatch_fused

    def counted(self, ctx, request):
        n[0] += 1
        return orig(self, ctx, request)

    monkeypatch.setattr(P.FusedAggregateExec, "_dispatch_fused", counted)
    return n


# -- registration and modes ---------------------------------------------------


def test_register_modes_and_unregister():
    _ms, eng, _data, edge = fresh()
    se = standing(eng, edge)
    sq = se.register("sum by (job) (rate(rq[5m]))", STEP_MS)
    assert sq.mode == "delta" and sq.mode_reason is None
    top = se.register("topk(3, rate(rq[5m]))", STEP_MS)
    assert top.mode == "full" and top.mode_reason == "standing_nondecomposable"
    assert se.register("quantile(0.9, rate(rq[5m]))", STEP_MS).mode == "full"
    assert se.register("rate(rq[5m])", STEP_MS).mode_reason == "not_fused"
    assert se.registry.get(sq.qid) is sq and len(se.registry.list()) == 4
    se.unregister(sq.qid)
    assert se.registry.get(sq.qid) is None
    with pytest.raises(Exception):
        se.register("not a promql ((", STEP_MS)


def test_registry_bounded():
    _ms, eng, _data, edge = fresh()
    se = standing(eng, edge, max_standing=2)
    se.register("sum(rate(rq[5m]))", STEP_MS)
    se.register("avg(rate(rq[5m]))", STEP_MS)
    with pytest.raises(ValueError, match="max_standing"):
        se.register("count(rate(rq[5m]))", STEP_MS)


def test_standing_helpers_equal_jax():
    from filodb_tpu.ops import aggregations as JAGG

    rng = np.random.default_rng(5)
    ret = rng.uniform(0, 1, (6, 20)).astype(np.float32)
    fresh_ = rng.uniform(0, 1, (6, 13)).astype(np.float32)
    for shift, J in ((0, 20), (3, 20), (19, 22), (25, 20)):
        np.testing.assert_array_equal(AGG.shift_partials(ret, shift, J),
                                      JAGG.shift_partials(ret, shift, J))
    np.testing.assert_array_equal(AGG.splice_partials(ret.copy(), fresh_, 7),
                                  JAGG.splice_partials(ret.copy(), fresh_, 7))
    with pytest.raises(ValueError, match="group mismatch"):
        AGG.splice_partials(ret.copy(), fresh_[:5], 7)
    for op in ("sum", "avg", "count", "min", "max", "topk", "quantile", "stddev"):
        for params, hq in (((), None), ((3,), None), ((), 0.9)):
            assert AGG.standing_delta_eligible(op, params, hq) == \
                JAGG.standing_delta_eligible(op, params, hq)
    assert AGG.STANDING_DELTA_OPS == JAGG.STANDING_DELTA_OPS


# -- delta maintenance: bit-equality and parity -------------------------------


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("q", QUERIES)
def test_delta_biteq_vs_full_reevaluation(grid, q, dispatches):
    """Across live-edge append rounds, the port's spliced partials equal a
    forced full refresh of the same grid (the same aligned superblock) bit
    for bit, on every grid class, and each delta refresh is one dispatch."""
    ms, eng, data, edge = fresh(seed=11, **GRIDS[grid])
    se = standing(eng, edge)
    sq = se.register(q, STEP_MS)
    twin = se.register(q, STEP_MS)
    se.refresh(sq)
    for rnd in range(3):
        lo, hi = edge + rnd * 50_000, edge + (rnd + 1) * 50_000
        assert ingest_window(ms, data, lo, hi) > 0
        se.clock = lambda e=hi: (e + 5_000) / 1e3
        n0, d0 = dispatches[0], sq.stats["delta"]
        se.refresh(sq)
        if sq.stats["delta"] > d0:
            assert dispatches[0] - n0 == 1
        se.refresh(twin, force_full=True)
        assert sq.grid_start_ms == twin.grid_start_ms
        assert sq.labels == twin.labels
        assert sq.retained.tobytes() == twin.retained.tobytes(), (grid, q, rnd)
    assert sq.stats["delta"] >= 1 and sq.stats["steps_retained"] > 0


@pytest.mark.parametrize("grid", list(GRIDS))
def test_delta_biteq_vs_full_with_aligned_staging(grid, dispatches):
    """The engine of a server with pre-warm on stages its fused ranges
    aligned (``align_staging``) before the maintainer aligns them again:
    delta refreshes still happen and equal a forced full refresh bit for
    bit."""
    ms, eng, data, edge = fresh(seed=11, params=PlannerParams(align_staging=True),
                                **GRIDS[grid])
    se = standing(eng, edge)
    sq, twin = se.register(QUERIES[0], STEP_MS), se.register(QUERIES[0], STEP_MS)
    se.refresh(sq)
    for rnd in range(3):
        lo, hi = edge + rnd * 50_000, edge + (rnd + 1) * 50_000
        assert ingest_window(ms, data, lo, hi) > 0
        se.clock = lambda e=hi: (e + 5_000) / 1e3
        n0, d0 = dispatches[0], sq.stats["delta"]
        se.refresh(sq)
        if sq.stats["delta"] > d0:
            assert dispatches[0] - n0 == 1
        se.refresh(twin, force_full=True)
        assert sq.retained.tobytes() == twin.retained.tobytes(), (grid, rnd)
    assert sq.stats["delta"] >= 1


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("q", QUERIES)
def test_retained_matrices_match_jax(grid, q):
    """The port's and the JAX package's standing engines over the same
    seeded stores and appends: equal grids and labels, equal NaN masks,
    values within rtol 2e-4 / atol 1e-4, the same delta/reset outcomes."""
    ms, eng, data, edge = fresh(seed=13, **GRIDS[grid])
    jms, jeng = fresh_jax(data, edge)
    se, je = standing(eng, edge), standing(jeng, edge, cls=JaxStanding)
    sq, jq = se.register(q, STEP_MS), je.register(q, STEP_MS)
    assert (sq.mode, sq.window_ms, sq.offset_ms) == (jq.mode, jq.window_ms, jq.offset_ms)
    for rnd in range(4):
        if rnd:
            lo, hi = edge + (rnd - 1) * 40_000, edge + rnd * 40_000
            assert ingest_window(ms, data, lo, hi) == ingest_window(jms, data, lo, hi, jax=True)
            se.clock = je.clock = lambda e=hi: (e + 5_000) / 1e3
        se.refresh(sq)
        je.refresh(jq)
        assert (sq.grid_start_ms, sq.grid_end_ms) == (jq.grid_start_ms, jq.grid_end_ms)
        assert sq.labels == jq.labels
        a, b = sq.retained, jq.retained
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        m = ~np.isnan(b)
        np.testing.assert_allclose(a[m], b[m], rtol=RTOL, atol=ATOL, err_msg=f"{grid} {rnd}")
    assert {k: sq.stats[k] for k in ("delta", "reset", "retained")} == \
        {k: jq.stats[k] for k in ("delta", "reset", "retained")}


def test_delta_refresh_is_suffix_only_single_dispatch(dispatches):
    ms, eng, data, edge = fresh()
    se = standing(eng, edge)
    sq = se.register("sum by (instance) (rate(rq[5m]))", STEP_MS)
    se.refresh(sq)
    # priming round: pay a roll of the aligned staging range here
    ingest_window(ms, data, edge, edge + 30_000)
    se.clock = lambda: (edge + 35_000) / 1e3
    se.refresh(sq)
    J = sq.num_steps()
    computed0 = sq.stats["steps_computed"]
    ingest_window(ms, data, edge + 30_000, edge + 60_000)
    se.clock = lambda: (edge + 65_000) / 1e3
    n0 = dispatches[0]
    se.refresh(sq)
    assert dispatches[0] - n0 == 1
    delta_steps = sq.stats["steps_computed"] - computed0
    assert 0 < delta_steps < J / 2, (delta_steps, J)
    assert sq.stats["delta"] >= 1


def test_disjoint_ingest_serves_retained_zero_dispatch(dispatches):
    ms, eng, data, edge = fresh()
    # series of another metric, far in the past of every window: their
    # later appends are effects the log proves disjoint
    other = [(t, ts - 10 * SPAN_MS, v) for t, ts, v in series_data("other", 4, 20, seed=3)]
    ingest_window(ms, other, 0, BASE - 10 * SPAN_MS + 100_000)
    se = standing(eng, edge)
    sq = se.register("sum by (instance) (rate(rq[5m]))", STEP_MS)
    first = se.refresh(sq)
    assert first is not None
    versions = sq.versions
    assert ingest_window(ms, other, BASE - 10 * SPAN_MS + 100_000, 2**62) > 0
    assert tuple(ms.shard("ds", s).version for s in sq.shard_nums) != versions
    n0, renders0 = dispatches[0], sq.stats["renders"]
    assert se.refresh(sq) is None  # no new content: nothing rendered or pushed
    assert sq.last_payload == first
    assert dispatches[0] - n0 == 0
    assert sq.stats["renders"] == renders0 and sq.stats["retained"] == 1


def test_new_series_resets_cleanly():
    ms, eng, data, edge = fresh(n_series=12)
    se = standing(eng, edge)
    sq = se.register("sum by (instance) (rate(rq[5m]))", STEP_MS)
    se.refresh(sq)
    g0 = len(sq.labels)
    extra = series_data("rq", 16, 260, seed=99)[12:]  # 4 unseen series
    ingest_window(ms, extra, 0, edge + 40_000)
    se.clock = lambda: (edge + 45_000) / 1e3
    se.refresh(sq)
    assert sq.stats["reset"] >= 2 and len(sq.labels) > g0
    twin = se.register("sum by (instance) (rate(rq[5m]))", STEP_MS)
    se.refresh(twin, force_full=True)
    assert sq.retained.tobytes() == twin.retained.tobytes()


def test_concurrent_extension_soak():
    ms, eng, data, edge = fresh(total=300, prefix=200)
    se = standing(eng, edge)
    q = "sum by (job) (rate(rq[5m]))"
    sq, twin = se.register(q, STEP_MS), se.register(q, STEP_MS)
    se.refresh(sq)
    stop = threading.Event()
    state = {"hi": edge}

    def ingester():
        hi = edge
        while not stop.is_set() and hi < edge + 90_000:
            ingest_window(ms, data, hi, hi + 10_000)
            hi += 10_000
            state["hi"] = hi
            time.sleep(0.005)

    t = threading.Thread(target=ingester)
    t.start()
    try:
        for _ in range(12):
            se.clock = lambda e=state["hi"]: (e + 5_000) / 1e3
            se.refresh(sq)
            assert sq.last_error is None, sq.last_error
            assert sq.retained.shape[1] == sq.num_steps()
            time.sleep(0.003)
    finally:
        stop.set()
        t.join()
    se.clock = lambda e=state["hi"]: (e + 5_000) / 1e3
    se.refresh(sq)
    se.refresh(twin, force_full=True)
    assert sq.labels == twin.labels
    assert sq.retained.tobytes() == twin.retained.tobytes()
    assert sq.stats["errors"] == 0


def fallback_count(reason):
    return REGISTRY.counter("filodb_fused_fallback", reason=reason).value


def test_nondecomposable_full_refresh_counted():
    _ms, eng, _data, edge = fresh()
    se = standing(eng, edge)
    sq = se.register("topk(3, rate(rq[5m]))", STEP_MS)
    before = fallback_count("standing_nondecomposable")
    payload = se.refresh(sq)
    assert payload is not None
    assert fallback_count("standing_nondecomposable") == before + 1
    body = json.loads(payload)
    assert body["resultType"] == "matrix" and body["result"]
    assert sq.stats["full"] == 1 and sq.stats["delta"] == 0


def test_refresh_under_batching_stays_out_of_the_ring():
    """With batching on a refresh goes through the dispatch scheduler (its
    group runs, here alone) and records no recurrence; the engine's own
    queries still do."""
    sched = DispatchScheduler(window_ms=2, max_batch=8)
    ms, eng, data, edge = fresh(params=PlannerParams(batch_window_ms=2,
                                                     dispatch_scheduler=sched))
    se = standing(eng, edge)
    assert se.scheduler is sched
    q = "sum by (job) (rate(rq[5m]))"
    sq, twin = se.register(q, STEP_MS), se.register(q, STEP_MS)
    q0 = sched.stats["queries"]
    se.refresh(sq)
    ingest_window(ms, data, edge, edge + 30_000)
    se.clock = lambda: (edge + 35_000) / 1e3
    se.refresh(sq)
    se.refresh(twin, force_full=True)
    assert sched.stats["queries"] - q0 == 3
    assert len(sched.key_ring) == 0
    assert sq.retained.tobytes() == twin.retained.tobytes()
    eng.query_range(q, (edge - SPAN_MS) / 1e3, edge / 1e3, STEP_MS / 1e3)
    assert len(sched.key_ring) == 1


# -- the recurrence ring (C1) and promotion -----------------------------------


RING_QUERIES = ["sum by (instance) (rate(rq[5m]))", "avg by (job) (increase(rq[5m]))",
                "topk(2, rate(rq[5m]))", "count(sum_over_time(rq[2m]))"]


def test_key_ring_matches_jax():
    """C1: the same queries through both engines (each with a ring, batching
    off) record equal keys and descriptors, less ``end_lag_ms``."""
    _ms, eng, data, edge = fresh()
    _jms, jeng = fresh_jax(data, edge)
    se, je = standing(eng, edge), standing(jeng, edge, cls=JaxStanding)
    for i, q in enumerate(RING_QUERIES * 3):
        end = edge - (i % 2) * 60_000
        for e in (eng, jeng):
            e.query_range(q, (end - SPAN_MS) / 1e3, end / 1e3, STEP_MS / 1e3)
    mine, theirs = se.scheduler.key_ring.entries(), je.scheduler.key_ring.entries()
    assert [k for k, _ in mine] == [k for k, _ in theirs] and len(mine) == len(RING_QUERIES)

    def desc(e):
        return {k: v for k, v in e["desc"].items() if k != "end_lag_ms"}

    for (_k, a), (_k2, b) in zip(mine, theirs):
        assert desc(a) == desc(b)
        assert a["count"] == b["count"] == 3
    snap = [{k: v for k, v in e.items() if k not in ("last_s", "first_s", "age_s", "rate")}
            for e in se.scheduler.key_ring.snapshot()]
    jsnap = [{k: v for k, v in e.items() if k not in ("last_s", "first_s", "age_s", "rate")}
             for e in je.scheduler.key_ring.snapshot()]
    assert [e.get("key") for e in snap] == [e.get("key") for e in jsnap]
    assert se.scheduler.snapshot()["standing_keys"] == len(RING_QUERIES)


def test_observe_key_without_trace_root():
    """Direct exec.execute (no root span, no PromQL): the structural key is
    recorded, and a key without PromQL never promotes."""
    from filodb_tpu_torch.query.promql import query_range_to_logical_plan

    _ms, eng, _data, edge = fresh()
    se = standing(eng, edge)
    plan = query_range_to_logical_plan("sum by (job) (rate(rq[5m]))", (edge - SPAN_MS) / 1e3,
                                       edge / 1e3, 15)
    res = eng.planner.materialize(plan).execute(eng.context())
    assert res.grids and len(se.scheduler.key_ring) == 1
    key, e = se.scheduler.key_ring.entries()[0]
    assert key[1] == "sum" and e["desc"]["promql"] is None
    assert se.promote_tick() == 0


def test_remote_leg_is_not_observed():
    _ms, eng, _data, edge = fresh()
    se = standing(eng, edge)
    eng.query_range("sum(rate(rq[5m]))", (edge - SPAN_MS) / 1e3, edge / 1e3, 15,
                    trace_id="t1", parent_span_id="p1")
    assert len(se.scheduler.key_ring) == 0


def test_promotion_hysteresis():
    from filodb_tpu.testkit import counter_batch
    from test_torch_hist_engine import port_batch

    ms = TimeSeriesMemStore()
    ms.setup(Dataset("ds"), list(range(N_SHARDS)))
    now_ms = int(time.time() * 1000)
    ms.ingest_routed("ds", port_batch(counter_batch(n_series=12, n_samples=120,
                                                    start_ms=now_ms - 1_200_000)), spread=3)
    eng = QueryEngine(ms, "ds", device="cpu")
    se = StandingEngine(eng, {"promote_min_count": 3, "promote_window_s": 300.0,
                              "demote_idle_s": 600.0, "default_span_ms": 600_000})
    q = "sum by (instance) (rate(http_requests_total[5m]))"
    for _ in range(3):
        eng.query_range(q, (now_ms - 600_000) / 1e3, now_ms / 1e3, 15)
    assert se.promote_tick() == 1
    sqs = se.registry.list()
    assert len(sqs) == 1 and sqs[0].source == "promoted"
    assert sqs[0].promql == q and sqs[0].mode == "delta"
    assert se.promote_tick() == 0
    qt = "topk(2, rate(http_requests_total[5m]))"
    for _ in range(3):
        eng.query_range(qt, (now_ms - 600_000) / 1e3, now_ms / 1e3, 15)
    assert se.promote_tick() == 0
    reasons = {d["reason"] for d in se.registry.snapshot()["demoted"]}
    assert "standing_nondecomposable" in reasons
    assert se.demote_tick(time.time() + 60) == 0
    sub = se.hub.subscribe(sqs[0].qid)
    assert se.demote_tick(time.time() + 10_000) == 0
    se.hub.unsubscribe(sub)
    assert se.demote_tick(time.time() + 10_000) == 1
    assert not se.registry.list()
    assert se.registry.demoted_reason(sqs[0].key) == "idle"
    assert se.promote_tick() == 0


def test_historical_scan_never_promotes():
    _ms, eng, _data, edge = fresh()
    se = standing(eng, edge, promote_min_count=2)
    for _ in range(3):
        eng.query_range("sum(rate(rq[5m]))", (edge - SPAN_MS) / 1e3, edge / 1e3, 15)
    assert se.promote_tick() == 0  # the grid end lags the wall clock by years


# -- shard effect intervals ---------------------------------------------------


def test_ingest_effects_interval_since_equals_jax():
    """The same ingests into a port and a JAX shard: equal answers of
    ``ingest_effects_interval_since`` for every version pair and probe."""
    from filodb_tpu.memstore.shard import TimeSeriesShard as JaxShard
    from filodb_tpu_torch.memstore.shard import TimeSeriesShard

    sh, jsh = TimeSeriesShard("ds", 0), JaxShard("ds", 0)
    data = series_data("m", 2, 40)
    versions = [sh.version]
    steps = [(t, ts[:20], v[:20]) for t, ts, v in data]
    tags, ts, vals = data[0]
    steps += [(tags, ts[20:25], vals[20:25]), (data[1][0], data[1][1][20:22], data[1][2][20:22]),
              ({METRIC_TAG: "m", "instance": "new"}, ts[:5] + 1, vals[:5])]
    probes = [(0, 2**62), (0, int(ts[19]) - 600_000), (int(ts[21]), int(ts[23])),
              (int(ts[30]), 2**62)]
    answers = []
    for t, s, v in steps:
        sh.ingest_series(SeriesBatch(PROM_COUNTER, t, s, {"count": v}))
        jsh.ingest_series(JaxSeriesBatch(JAX_PROM_COUNTER, t, s, {"count": v}))
        assert sh.version == jsh.version
        versions.append(sh.version)
        for v0 in versions:
            for lo, hi in probes:
                got = sh.ingest_effects_interval_since(v0, lo, hi)
                assert got == jsh.ingest_effects_interval_since(v0, lo, hi), (v0, lo, hi)
                assert got[0] == sh.ingest_effects_since(v0, lo, hi)
                answers.append(got[0])
        if len(versions) == 5:  # the two appends, before the new series
            reason, lo, hi = sh.ingest_effects_interval_since(versions[2], 0, 2**62)
            assert reason == "overlap" and lo <= int(ts[20]) and hi == int(ts[24])
    assert sh.ingest_effects_interval_since(versions[3], 0, 2**62)[0] == "full_clear"
    assert {None, "overlap", "full_clear"} <= set(answers)


def test_append_listener_fires_outside_lock():
    from filodb_tpu_torch.memstore.shard import TimeSeriesShard

    sh = TimeSeriesShard("ds", 0)
    seen = []

    def cb(dataset, shard, lo, hi, full):
        # re-entering from another thread would deadlock under the lock
        t = threading.Thread(target=lambda: sh.ingest_effects_interval_since(0, 0, 1))
        t.start()
        t.join(5)
        assert not t.is_alive()
        seen.append((dataset, shard, lo, hi, full))

    sh.add_append_listener(cb)
    tags, ts, vals = series_data("m", 1, 10)[0]
    sh.ingest_series(SeriesBatch(PROM_COUNTER, tags, ts, {"count": vals}))
    assert len(seen) == 1 and seen[0][0] == "ds" and seen[0][4] is True
    sh.remove_append_listener(cb)
    sh.ingest_series(SeriesBatch(PROM_COUNTER, tags, ts + 200_000, {"count": vals + 1}))
    assert len(seen) == 1


# -- the hub and SSE ----------------------------------------------------------


def test_hub_limit_and_newest_wins():
    hub = SubscriptionHub(max_subscribers=2, queue_depth=2)
    a = hub.subscribe("q1")
    _b = hub.subscribe("q1")
    with pytest.raises(SubscriptionLimit):
        hub.subscribe("q1")
    payloads = [b"payload-%d" % i for i in range(4)]
    for p in payloads:
        assert hub.publish("q1", p) == 2
    got = [a.get(timeout=1), a.get(timeout=1)]
    assert got == payloads[2:] and got[1] is payloads[3]  # the same bytes object
    hub.close("q1")
    assert hub.total() == 0


def sse_events(resp, n, timeout_s=15.0):
    out, buf = [], b""
    deadline = time.time() + timeout_s
    while len(out) < n and time.time() < deadline:
        line = resp.fp.readline()
        if not line:
            break
        line = line.rstrip(b"\r\n")
        if line.startswith(b"data: "):
            buf += line[6:]
        elif not line and buf:
            out.append(json.loads(buf))
            buf = b""
    return out


def test_sse_fanout_one_materialization():
    """8 SSE subscribers get the same frame of one render; the 9th sheds
    with 429 and Retry-After."""
    import http.client

    from filodb_tpu_torch.api.http import serve_background

    ms, eng, data, edge = fresh()
    se = standing(eng, edge, max_subscribers=8)
    sq = se.register("sum by (job) (rate(rq[5m]))", STEP_MS)
    se.refresh(sq)
    srv, port = serve_background(eng, standing=se)
    conns = []
    try:
        for _ in range(8):
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
            c.request("GET", f"/api/v1/standing/subscribe?id={sq.qid}")
            r = c.getresponse()
            assert r.status == 200 and r.getheader("Content-Type") == "text/event-stream"
            conns.append((c, r))
        c9 = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        c9.request("GET", f"/api/v1/standing/subscribe?id={sq.qid}")
        r9 = c9.getresponse()
        assert r9.status == 429 and r9.getheader("Retry-After")
        c9.close()
        deadline = time.time() + 10
        while se.hub.count(sq.qid) < 8 and time.time() < deadline:
            time.sleep(0.01)
        renders0 = sq.stats["renders"]
        ingest_window(ms, data, edge, edge + 20_000)
        se.clock = lambda: (edge + 25_000) / 1e3
        se.refresh(sq)
        assert sq.stats["renders"] == renders0 + 1
        frames = []
        for _c, r in conns:
            evs = sse_events(r, 2)  # the first frame, then the refresh
            assert len(evs) == 2
            frames.append(evs[1])
        assert all(f == frames[0] for f in frames)
        assert frames[0]["seq"] == sq.seq and frames[0]["result"]
    finally:
        for c, _r in conns:
            c.close()
        srv.shutdown()
        srv.server_close()


def http_json(url, data=None):
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(data).encode() if data else None,
                                 headers={"Content-Type": "application/json"},
                                 method="POST" if data else "GET")
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def test_standing_http_api_and_debug():
    from filodb_tpu_torch.api.http import serve_background

    _ms, eng, _data, edge = fresh()
    se = standing(eng, edge)
    srv, port = serve_background(eng, standing=se)
    url = f"http://127.0.0.1:{port}"
    try:
        out = http_json(f"{url}/api/v1/standing/register",
                        {"query": "sum(rate(rq[5m]))", "step": "15s", "range": "20m"})
        assert out["status"] == "success" and out["data"]["mode"] == "delta"
        qid = out["data"]["id"]
        assert http_json(f"{url}/api/v1/standing")["data"]["count"] == 1
        dbg = http_json(f"{url}/debug/standing")["data"]
        assert dbg["count"] == 1 and "key_ring" in dbg and "subscribers" in dbg
        assert http_json(f"{url}/api/v1/standing/unregister", {"id": qid})["status"] == "success"
        assert http_json(f"{url}/api/v1/standing")["data"]["count"] == 0
    finally:
        srv.shutdown()
        srv.server_close()


def test_standing_routes_without_an_engine_answer_404():
    import urllib.error

    from filodb_tpu_torch.api.http import serve_background

    _ms, eng, _data, _edge = fresh(n_series=2)
    srv, port = serve_background(eng)
    try:
        for path in ("/api/v1/standing", "/debug/standing", "/api/v1/standing/subscribe?id=x"):
            with pytest.raises(urllib.error.HTTPError) as e:
                http_json(f"http://127.0.0.1:{port}{path}")
            assert e.value.code == 404
    finally:
        srv.shutdown()
        srv.server_close()


def test_query_range_is_served_from_standing(dispatches):
    """A query_range of a registered panel is answered from its retained
    matrix (``servedFrom: standing``), equal to the engine's answer, with no
    dispatch; a trace request runs the engine."""
    from filodb_tpu_torch.api.http import serve_background

    ms, eng, data, edge = fresh()
    se = standing(eng, edge)
    q = "sum by (job) (rate(rq[5m]))"
    sq = se.register(q, STEP_MS)
    se.refresh(sq)
    srv, port = serve_background(eng, standing=se)
    try:
        start, end = sq.grid_start_ms + 10 * STEP_MS, sq.grid_end_ms
        path = (f"http://127.0.0.1:{port}/api/v1/query_range?query={q.replace(' ', '%20')}"
                f"&start={start / 1e3}&end={end / 1e3}&step=15")
        n0 = dispatches[0]
        body = http_json(path)
        assert body["data"]["stats"]["servedFrom"] == "standing" and dispatches[0] == n0
        want = eng.query_range(q, start / 1e3, end / 1e3, 15)
        rows = {tuple(sorted(r["metric"].items())): [float(v) for _t, v in r["values"]]
                for r in body["data"]["result"]}
        for lbl, v in zip(want.grids[0].labels, want.grids[0].values_np()):
            got = rows[tuple(sorted({k: x for k, x in lbl.items()}.items()))]
            np.testing.assert_allclose(got, v[~np.isnan(v)], rtol=1e-6)
        traced = http_json(path + "&trace=true")
        assert "servedFrom" not in traced["data"]["stats"]
    finally:
        srv.shutdown()
        srv.server_close()
    assert se.serve_range(q, (sq.grid_start_ms + 7) / 1e3, sq.grid_end_ms / 1e3, 15) is None
    assert se.serve_range("sum(rate(rq[5m]))", sq.grid_start_ms / 1e3,
                          sq.grid_end_ms / 1e3, 15) is None


# -- recording rules, the wake, attribution, pins -----------------------------


def test_recording_rule_writes_back_series():
    ms, eng, data, edge = fresh()
    se = standing(eng, edge)
    sq = se.register("sum by (job) (rate(rq[5m]))", STEP_MS, span_ms=4 * STEP_MS,
                     source="rule", rule_name="job_rq_rate5m", eval_interval_s=15.0)
    se.refresh(sq)
    end1 = sq.grid_end_ms
    res = eng.query_range("job_rq_rate5m", end1 / 1e3, end1 / 1e3, 15)
    rows = {tuple(sorted(lbl.items())): v for g in res.grids
            for lbl, v in zip(g.labels, g.values_np())}
    assert rows, "the rule wrote no series"
    mine = {tuple(sorted({**dict(lbl), METRIC_TAG: "job_rq_rate5m"}.items())): sq.retained[i, -1]
            for i, lbl in enumerate(sq.labels)}
    for k, v in rows.items():
        assert np.float32(v[-1]) == np.float32(mine[k])
    ingest_window(ms, data, edge, edge + 30_000)
    se.clock = lambda: (edge + 35_000) / 1e3
    se.refresh(sq)
    assert sq.last_rule_write_ms == sq.grid_end_ms > end1
    rule = se.rules_payload()["groups"][0]["rules"][0]
    assert rule["name"] == "job_rq_rate5m" and rule["type"] == "recording"


def test_rules_record_over_http():
    from filodb_tpu_torch.api.http import serve_background

    _ms, eng, _data, edge = fresh()
    se = standing(eng, edge)
    srv, port = serve_background(eng, standing=se)
    try:
        out = http_json(f"http://127.0.0.1:{port}/api/v1/rules/record",
                        {"name": "job:rq:rate5m", "expr": "sum by (job) (rate(rq[5m]))",
                         "interval": "15s"})
        assert out["data"]["rule_name"] == "job:rq:rate5m" and out["data"]["mode"] == "delta"
        import urllib.error

        with pytest.raises(urllib.error.HTTPError) as e:
            http_json(f"http://127.0.0.1:{port}/api/v1/rules/record",
                      {"name": "bad name", "expr": "sum(rq)"})
        assert e.value.code == 400
    finally:
        srv.shutdown()
        srv.server_close()


def test_alert_sink_gets_the_newest_column_outside_the_lock():
    ms, eng, data, edge = fresh()
    se = standing(eng, edge)
    got = []

    def sink(sq, end_ms, vec):
        assert not sq.lock.locked()
        # a sink that ingests (as the alerting plane writes ALERTS back)
        ingest_window(ms, series_data("alerts", 1, 5, seed=2), 0, 2**62)
        got.append((end_ms, vec))

    sq = se.register("sum by (job) (rate(rq[5m]))", STEP_MS, source="alert", alert_sink=sink)
    se.refresh(sq)
    se.refresh(sq)
    assert len(got) == 2 and got[0][0] == sq.grid_end_ms
    assert {tuple(sorted(lbl.items())) for lbl, _ in got[0][1]} == \
        {tuple(sorted(lbl.items())) for lbl in sq.labels}


def test_append_wake_refreshes_via_loop():
    ms, eng, data, edge = fresh()
    se = standing(eng, edge, refresh_debounce_ms=0, tick_s=0.05)
    sq = se.register("sum(rate(rq[5m]))", STEP_MS)
    se.refresh(sq)
    seq0 = sq.seq
    se.start()
    try:
        ingest_window(ms, data, edge, edge + 20_000)
        deadline = time.time() + 10
        while sq.seq == seq0 and time.time() < deadline:
            time.sleep(0.02)
        assert sq.seq > seq0, "the append never woke the loop"
    finally:
        se.stop()
    assert not se._listening


def test_ledger_and_tenant_attribution():
    from filodb_tpu_torch.ledger import LEDGER

    _ms, eng, _data, edge = fresh()
    se = standing(eng, edge)
    c = REGISTRY.counter("filodb_tenant_queries", ws="w", ns="n")
    before = c.value
    sq = se.register('sum by (instance) (rate(rq{_ws_="w",_ns_="n"}[5m]))', STEP_MS)
    se.refresh(sq)
    assert sq.ws == "w" and sq.ns == "n" and c.value == before + 1
    kind = LEDGER.verify()["kinds"].get("standing_state")
    assert kind is not None and kind["drift"] == 0
    assert se.registry.ledger.bytes == sq.state_nbytes() > 0
    se.unregister(sq.qid)
    assert se.registry.ledger.bytes == 0
    assert LEDGER.verify()["kinds"]["standing_state"]["drift"] == 0
    # a refresh racing the unregister returns without growing the state
    assert se.refresh(sq) is None and sq.retained is None


def test_superblock_pins_survive_eviction_and_release():
    ms, eng, data, edge = fresh()
    se = standing(eng, edge)
    sq = se.register("sum by (job) (rate(rq[5m]))", STEP_MS)
    se.refresh(sq)
    cache = ms._superblock_cache
    (pinned,) = se._sb_pins[sq.qid]
    assert pinned[0] is cache and cache.peek(pinned[1]) is not None
    assert cache.pinned_bytes() == cache.peek(pinned[1])[2] > 0
    # ad-hoc queries past the cache's entry bound evict the others, never it
    for w in range(1, cache.max_entries + 3):
        eng.query_range(f"sum(rate(rq[{w + 1}m]))", (edge - SPAN_MS - w * 60_000) / 1e3,
                        edge / 1e3, 60)
    assert cache.peek(pinned[1]) is not None
    se.unregister(sq.qid)
    assert cache.pinned_bytes() == 0 and not cache._pins
