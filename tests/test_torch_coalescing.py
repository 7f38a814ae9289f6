"""The engine's query pool and identical-query coalescing
(coordinator/scheduler.py) and the dispatch scheduler's mechanics
(query/scheduler.DispatchScheduler, KeyStatsRing) in the port, each
scenario run on the port's class and on the JAX package's: concurrent
callers share one execution, an exception reaches the followers, a
saturated pool rejects, a caller's deadline frees the slot of a query that
never started; the leader's window closes at max_batch and when joins go
quiet; the adaptive window and the recurrence ring under a fake clock.
Events, not sleeps, decide every outcome.
"""

import threading
import time

import pytest

from filodb_tpu.coordinator import scheduler as JCS
from filodb_tpu.query import scheduler as JQS
from filodb_tpu_torch import metrics as M
from filodb_tpu_torch.coordinator import scheduler as CS
from filodb_tpu_torch.coordinator.planner import PlannerParams, QueryEngine
from filodb_tpu_torch.query import scheduler as QS

PACKAGES = {"port": (CS, QS), "jax": (JCS, JQS)}


def wait_for(pred, timeout=20.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, "condition not reached"
        time.sleep(0.001)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_single_flight_shares_one_execution(pkg):
    cs, _ = PACKAGES[pkg]
    sf = cs.SingleFlight()
    release, entered = threading.Event(), threading.Event()
    calls, out = [], []

    def fn():
        calls.append(1)
        entered.set()
        release.wait(20)
        return object()

    lead = threading.Thread(target=lambda: out.append(sf.run("k", fn, 20)))
    lead.start()
    entered.wait(20)
    followers = [threading.Thread(target=lambda: out.append(sf.run("k", fn, 20)))
                 for _ in range(5)]
    for t in followers:
        t.start()
    wait_for(lambda: len(sf._flights) == 1 and sum(t.is_alive() for t in followers) == 5)
    time.sleep(0.02)  # the followers reach their wait on the leader's future
    release.set()
    for t in [lead] + followers:
        t.join(20)
    assert len(calls) == 1 and len(out) == 6 and all(o is out[0] for o in out)
    release.set()
    assert sf.run("k", fn, 5) is not out[0] and len(calls) == 2  # never a cache


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_single_flight_exception_reaches_followers(pkg):
    cs, _ = PACKAGES[pkg]
    sf = cs.SingleFlight()
    release, entered = threading.Event(), threading.Event()
    errors = []

    def fn():
        entered.set()
        release.wait(20)
        raise ValueError("boom")

    def call():
        try:
            sf.run("k", fn, 20)
        except ValueError as e:
            errors.append(str(e))

    ths = [threading.Thread(target=call)]
    ths[0].start()
    entered.wait(20)
    ths += [threading.Thread(target=call) for _ in range(3)]
    for t in ths[1:]:
        t.start()
    time.sleep(0.02)
    release.set()
    for t in ths:
        t.join(20)
    assert errors == ["boom"] * 4
    assert not sf._flights


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_query_scheduler_rejects_when_saturated(pkg):
    cs, _ = PACKAGES[pkg]
    sched = cs.QueryScheduler(parallelism=1, max_queued=0)
    release, entered = threading.Event(), threading.Event()
    t = threading.Thread(target=lambda: sched.run(lambda: (entered.set(), release.wait(20)), 20))
    t.start()
    entered.wait(20)
    with pytest.raises(cs.QueryRejected):
        sched.run(lambda: 1, 5)
    release.set()
    t.join(20)
    assert sched.run(lambda: 7, 5) == 7 and sched.peak_in_flight == 1
    sched.shutdown()


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_deadline_frees_the_slot_of_a_query_that_never_started(pkg):
    cs, _ = PACKAGES[pkg]
    sched = cs.QueryScheduler(parallelism=1, max_queued=1)
    release, entered = threading.Event(), threading.Event()
    t = threading.Thread(target=lambda: sched.run(lambda: (entered.set(), release.wait(20)), 20))
    t.start()
    entered.wait(20)
    ran, result = [], []
    with pytest.raises(Exception, match="exceeded deadline"):
        sched.run(lambda: ran.append(1), 0.05)  # queued behind the first, never starts
    # accepted only because the cancelled query gave its slot back
    c = threading.Thread(target=lambda: result.append(sched.run(lambda: 3, 20)))
    c.start()
    release.set()
    t.join(20)
    c.join(20)
    assert result == [3] and not ran
    sched.shutdown()


def test_identical_concurrent_queries_share_one_execution():
    """Through the port's engine: N concurrent identical range queries, one
    execution (one span tree, ``filodb_queries_coalesced`` counted)."""
    from test_torch_engine import build_stores, make_data

    _, pms = build_stores(make_data("regular"))
    eng = QueryEngine(pms, "prometheus", device="cpu")
    release, entered = threading.Event(), threading.Event()
    real = eng._run

    def gated(*a, **k):
        entered.set()
        release.wait(20)
        return real(*a, **k)

    eng._run = gated
    q = "sum(rate(http_requests_total[5m]))"
    before = M.REGISTRY.counter("filodb_queries_coalesced").value
    out = []
    ths = [threading.Thread(target=lambda: out.append(
        eng.query_range(q, 1_600_000_400, 1_600_002_000, 60))) for _ in range(4)]
    ths[0].start()
    entered.wait(20)
    for t in ths[1:]:
        t.start()
    wait_for(lambda: M.REGISTRY.counter("filodb_queries_coalesced").value - before == 3)
    release.set()
    for t in ths:
        t.join(30)
    assert len(out) == 4 and all(r is out[0] for r in out)
    eng2 = QueryEngine(pms, "prometheus", PlannerParams(coalesce_identical=False), device="cpu")
    assert eng2.query_range(q, 1_600_000_400, 1_600_002_000, 60) is not out[0]


class Req:
    """A stand-in fused request: the scheduler reads only these."""

    def __init__(self, key, lane, out, cost=0.0):
        self._key, self._lane, self.out = key, lane, out
        self.predicted_cost_s = cost
        self.timeout_s = 20.0
        self.exec_seconds = None
        self.block = key

    def family(self):
        return "agg"

    def group_key(self):
        return (self._key,)

    def merge_key(self):
        return ("m",)

    def lane_key(self):
        return (self._lane,)

    def run_single(self):
        return self.out


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_max_batch_closes_the_window(pkg, monkeypatch):
    """A 60 s window closes as soon as the group holds max_batch lanes."""
    _, qs = PACKAGES[pkg]
    sched = qs.DispatchScheduler(window_ms=60_000, max_batch=2)
    monkeypatch.setattr(qs, "_run_batch", lambda reqs: [r.out for r in reqs])
    if pkg == "port":
        monkeypatch.setattr(qs, "batch_lanes_ok", lambda reqs: True)
    out = {}
    ths = [threading.Thread(target=lambda i=i: out.__setitem__(i, sched.dispatch(Req("b", i, i))))
           for i in range(2)]
    t0 = time.monotonic()
    for t in ths:
        t.start()
    for t in ths:
        t.join(30)
    assert out == {0: 0, 1: 1} and time.monotonic() - t0 < 30
    assert sched.stats["batched"] == 1 and sched.stats["dispatches"] == 1


def test_groups_stay_within_the_lane_cap(monkeypatch):
    """Port difference (ROADMAP C, "Lane cap"): ``max_batch`` is capped at
    the lane modes' ``MAX_LANES``, and a join that finds its group closed
    (max_batch reached, its leader not yet sealed) opens a new group, so no
    group outgrows max_batch. Five joins at max_batch 2 while every leader
    is held: two batched pairs and one solo lane, each caller its own
    answer."""
    from filodb_tpu_torch.ops import group_acc as GA

    assert QS.DispatchScheduler(5, max_batch=1000).max_batch == GA.MAX_LANES
    hold = threading.Event()
    sched = QS.DispatchScheduler(window_ms=60_000, max_batch=2,
                                 waiter=lambda ev, s: hold.wait(20))
    sizes = []
    monkeypatch.setattr(QS, "_run_batch",
                        lambda reqs: sizes.append(len(reqs)) or [r.out for r in reqs])
    monkeypatch.setattr(QS, "batch_lanes_ok", lambda reqs: True)
    out = {}
    ths = [threading.Thread(target=lambda i=i: out.__setitem__(i, sched.dispatch(Req("b", i, i))))
           for i in range(5)]
    for t in ths:
        t.start()
    wait_for(lambda: sched.stats["queries"] == 5)
    hold.set()
    for t in ths:
        t.join(30)
    assert out == {i: i for i in range(5)}
    assert sorted(sizes) == [2, 2] and sched.stats["solo"] == 1
    assert sched.stats["dispatches"] == 3 and sched.snapshot()["queued_lanes"] == 0


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_quiet_joins_close_the_window(pkg):
    """The leader's collection ends once no lane joined for a quarter of
    the window: a group whose last join lies that far back returns at once
    even with a minute of window left."""
    _, qs = PACKAGES[pkg]
    sched = qs.DispatchScheduler(window_ms=60_000)
    group = qs._Group()
    group.last_join = time.monotonic() - 20.0  # quiet for more than 15 s
    t0 = time.monotonic()
    sched._collect(group)
    closed = qs._Group()
    closed.closed.set()  # max_batch reached, or absorbed by another leader
    sched._collect(closed)
    assert time.monotonic() - t0 < 5.0 and sched.window_s == 60.0


def test_adaptive_window_matches_jax():
    class Clock:
        t = 100.0

        def __call__(self):
            return self.t

    pc, jc = Clock(), Clock()
    port = QS.DispatchScheduler(5, window_cap_ms=50, load_ref_cost_s=0.5, clock=pc)
    jax = JQS.DispatchScheduler(5, window_cap_ms=50, load_ref_cost_s=0.5, clock=jc)
    assert port.adaptive and jax.adaptive
    for cost, dt in [(0.1, 0.0), (0.2, 0.5), (0.0, 3.0), (0.4, 0.1), (0.05, 10.0)]:
        pc.t += dt
        jc.t += dt
        port._note_load(cost)
        jax._note_load(cost)
        assert port.window_s == jax.window_s and port._load() == jax._load()


def test_key_ring_matches_jax():
    class Clock:
        t = 50.0

        def __call__(self):
            return self.t

    pc, jc = Clock(), Clock()
    port, jax = QS.KeyStatsRing(3, clock=pc), JQS.KeyStatsRing(3, clock=jc)
    for i, key in enumerate(["a", "b", "a", "c", "d", "a", "b"]):
        pc.t = jc.t = 50.0 + i
        port.observe(key, {"promql": key} if i % 2 else None)
        jax.observe(key, {"promql": key} if i % 2 else None)
    assert port.entries() == jax.entries() and len(port) == len(jax) == 3
    assert port.snapshot() == jax.snapshot() and port.get("a") == jax.get("a")


def test_snapshot_and_disabled_dispatch():
    sched = QS.DispatchScheduler(0)
    assert not sched.enabled and sched.dispatch(Req("x", 0, 42)) == 42
    snap = sched.snapshot()
    assert snap["queries"] == 0 and snap["dispatches"] == 0
    for key in ("window_ms", "open_groups", "queued_lanes", "batched", "solo", "fallback",
                "error", "coalesced", "merged_windows", "standing_keys"):
        assert key in snap


def test_dispatch_scheduler_stress(monkeypatch):
    """24 threads x 25 dispatches over three window groups of one merge key,
    a 1 ms window and a short switch interval: every caller gets its own
    lane's output (never another's), no lane is left queued, and every
    dispatch is counted under one outcome."""
    import sys

    sched = QS.DispatchScheduler(window_ms=1.0, max_batch=8)
    monkeypatch.setattr(QS, "_run_batch", lambda reqs: [r.out for r in reqs])
    monkeypatch.setattr(QS, "batch_lanes_ok", lambda reqs: True)
    bad, done = [], []

    def worker(t):
        for i in range(25):
            want = (t, i)
            got = sched.dispatch(Req(("w", (t + i) % 3), want, want))
            if got != want:
                bad.append((want, got))
        done.append(t)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ths = [threading.Thread(target=worker, args=(t,)) for t in range(24)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ths) and len(done) == 24 and not bad
    snap = sched.snapshot()
    assert snap["queries"] == 600 and snap["queued_lanes"] == 0 and snap["open_groups"] == 0
    assert snap["batched"] + snap["solo"] + snap["fallback"] + snap["error"] == snap["dispatches"]
