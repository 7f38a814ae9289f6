"""Pre-warm in the port (``query/scheduler.DispatchScheduler.prewarm_tick``,
``coordinator/planner.QueryEngine._prewarm_key``; the JAX package's
``tests/test_costmodel.py::TestPrewarm`` shapes) on the CPU:

- ring keys past the recurrence bar run once through the registered
  executor; a storm annotation lowers the bar to one observation;
- a failed pre-warm is counted (``filodb_prewarm_total{outcome="error"}``),
  kept for ``/debug/scheduler`` and never retried;
- the engine's executor runs solo, out of the ring, and leaves the query
  warm: its first real dispatch finds the superblock cached and the group
  ids built (on the card also the kernel module loaded);
- the server's pre-warm loop ticks when ``query.prewarm.enabled``.
"""

import time

import numpy as np
import pytest

from filodb_tpu.query.scheduler import DispatchScheduler as JaxDispatch
from filodb_tpu.testkit import counter_batch
from filodb_tpu_torch.coordinator.planner import PlannerParams, QueryEngine
from filodb_tpu_torch.core import schemas as S
from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore
from filodb_tpu_torch.metrics import REGISTRY
from filodb_tpu_torch.ops import aggregations as AGG
from filodb_tpu_torch.query.scheduler import DispatchScheduler
from test_torch_hist_engine import port_batch

BASE = 1_600_000_000_000
DESC = {"promql": "sum(rate(m[5m]))", "step_ms": 60_000, "span_ms": 900_000, "end_lag_ms": 0}


@pytest.mark.parametrize("cls", [DispatchScheduler, JaxDispatch], ids=["port", "jax"])
def test_ring_keys_warm_once_past_the_bar(cls):
    s = cls(window_ms=0, prewarm_min_count=3)
    warmed = []
    s.register_prewarmer(lambda desc: warmed.append(desc["promql"]))
    s.register_prewarmer(lambda desc: None)  # the first registration wins
    s.key_ring.observe("k1", DESC)
    assert s.prewarm_tick(storms={}) == []
    s.key_ring.observe("k1", DESC)
    s.key_ring.observe("k1", DESC)
    assert s.prewarm_tick(storms={}) == ["k1"]
    assert warmed == ["sum(rate(m[5m]))"]
    assert s.prewarm_tick(storms={}) == []
    assert s.stats["prewarmed"] == 1


def test_storm_lowers_the_bar_and_limit_bounds_a_tick():
    s = DispatchScheduler(window_ms=0, prewarm_min_count=3)
    s.register_prewarmer(lambda desc: None)
    for k in ("a", "b", "c"):
        s.key_ring.observe(k, DESC)
    assert s.prewarm_tick(storms={}) == []
    assert s.prewarm_tick(limit=2, storms={"fused_agg": {"n": 6}}) == ["a", "b"]
    assert s.prewarm_tick(storms={"fused_agg": {"n": 6}}) == ["c"]
    s.key_ring.observe("d", {"promql": None})  # no PromQL: nothing to run
    assert s.prewarm_tick(storms={"x": 1}) == []


def test_without_an_executor_a_tick_does_nothing():
    s = DispatchScheduler(window_ms=0, prewarm_min_count=1)
    s.key_ring.observe("k", DESC)
    assert s.prewarm_tick() == []


def test_prewarm_errors_are_counted_and_kept():
    def boom(desc):
        raise RuntimeError("stage failed")

    s = DispatchScheduler(window_ms=0, prewarm_min_count=1)
    s.register_prewarmer(boom)
    s.key_ring.observe("k3", DESC)
    c = REGISTRY.counter("filodb_prewarm", outcome="error")
    before = c.value
    assert s.prewarm_tick(storms={}) == []
    assert c.value == before + 1
    snap = s.snapshot()
    assert snap["prewarm_errors"] == 1 and snap["prewarmed"] == 0
    assert snap["prewarm_last_error"] == "RuntimeError: stage failed"
    assert s.prewarm_tick(storms={}) == []  # memoed: no retry storm
    assert c.value == before + 1


@pytest.fixture(scope="module")
def store():
    ms = TimeSeriesMemStore()
    ms.setup(S.Dataset("ds"), list(range(4)))
    ms.ingest_routed("ds", port_batch(counter_batch(n_series=16, n_samples=240,
                                                    start_ms=BASE)), 3)
    return ms


def test_prewarmed_key_first_real_dispatch_stages_nothing(store, monkeypatch):
    """Seed the ring with a query never run, tick, then issue it for real:
    the tick staged the superblock and built the group ids off the serving
    path, solo and out of the ring; the real query is a cache hit that
    builds no grouping."""
    sched = DispatchScheduler(window_ms=5, prewarm_min_count=3)
    engine = QueryEngine(store, "ds", PlannerParams(batch_window_ms=5, dispatch_scheduler=sched),
                         device="cpu")
    assert sched._prewarm_exec == engine._prewarm_key
    end_s = (BASE + 1_800_000) / 1e3
    q = "sum by (job) (rate(http_requests_total[6m]))"
    desc = {"promql": q, "step_ms": 60_000, "span_ms": 840_000,
            "end_lag_ms": (time.time() - end_s) * 1000}
    key = ("prewarm-proof", q)
    for _ in range(3):
        sched.key_ring.observe(key, desc)
    built = []
    orig = AGG.group_ids_for
    monkeypatch.setattr(AGG, "group_ids_for", lambda *a, **k: built.append(1) or orig(*a, **k))
    q0, ring0 = sched.stats["queries"], len(sched.key_ring)
    assert sched.prewarm_tick(storms={}) == [key]
    assert sched.stats["queries"] == q0  # solo: no batch window
    assert len(sched.key_ring) == ring0  # and out of the ring
    assert built, "the tick must build the grouping"
    n_built = len(built)
    res = engine.query_range(q, end_s - 840, end_s, 60)
    assert res.stats.cache_hits == 1 and res.stats.cache_misses == 0
    assert len(built) == n_built
    assert np.isfinite(res.grids[0].values_np()).any()


def test_prewarm_with_batching_off_warms_a_later_poll(store, monkeypatch):
    """Batching off (window 0, the scheduler kept for its recurrence ring),
    the next poll's end one step after the pre-warm's: with
    ``align_staging`` (the server sets it with pre-warm on) both stage the
    same aligned range, so the poll finds the pre-warmed superblock and
    builds no grouping."""
    sched = DispatchScheduler(0, prewarm_min_count=1)
    engine = QueryEngine(store, "ds", PlannerParams(dispatch_scheduler=sched, align_staging=True),
                         device="cpu")
    assert not sched.enabled and sched._prewarm_exec == engine._prewarm_key
    # 100 s into a 300 s alignment bucket: the poll's end, 60 s later, and
    # both starts stay in their buckets
    end_s = (BASE + 1_500_000) / 1e3
    assert end_s % 300 == 100
    q = "sum by (job) (rate(http_requests_total[6m]))"
    desc = {"promql": q, "step_ms": 60_000, "span_ms": 840_000,
            "end_lag_ms": (time.time() - end_s) * 1000}
    sched.key_ring.observe("prewarm-later-poll", desc)
    built = []
    orig = AGG.group_ids_for
    monkeypatch.setattr(AGG, "group_ids_for", lambda *a, **k: built.append(1) or orig(*a, **k))
    assert sched.prewarm_tick(storms={}) == ["prewarm-later-poll"]
    n_built = len(built)
    assert n_built
    res = engine.query_range(q, end_s + 60 - 840, end_s + 60, 60)
    assert (res.stats.cache_hits, res.stats.cache_misses) == (1, 0)
    assert len(built) == n_built
    assert np.isfinite(res.grids[0].values_np()).any()


def test_server_aligns_staging_with_prewarm_on():
    from filodb_tpu_torch.server import FiloServer

    for prewarm in (True, False):
        srv = FiloServer({"shards": 2, "query": {"prewarm": {"enabled": prewarm}}}, device="cpu")
        assert srv.engine.planner.params.align_staging is prewarm
        srv.stop()


def test_prewarm_key_skips_an_unusable_descriptor(store):
    engine = QueryEngine(store, "ds", device="cpu")
    for desc in ({}, {"promql": "sum(m)", "step_ms": 0, "span_ms": 60_000},
                 {"promql": "sum(m)", "step_ms": 60_000}):
        assert engine._prewarm_key(desc) is None


def test_server_prewarm_loop_ticks(monkeypatch):
    from filodb_tpu_torch.server import FiloServer

    srv = FiloServer({"shards": 2, "query": {"prewarm": {"enabled": True, "interval_s": 0.05,
                                                        "min_count": 1}}}, device="cpu")
    ticks = []
    sched = srv.dispatch_scheduler
    orig = sched.prewarm_tick
    monkeypatch.setattr(sched, "prewarm_tick", lambda **kw: ticks.append(kw) or orig(**kw))
    srv.start(port=0)
    try:
        deadline = time.time() + 10
        while not ticks and time.time() < deadline:
            time.sleep(0.02)
        assert ticks and ticks[0]["limit"] == 2
        assert srv.standing is None and srv.engine.planner.params.dispatch_scheduler is sched
    finally:
        srv.stop()
