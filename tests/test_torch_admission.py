"""Admission control and the cost model of the port (query/scheduler.py,
query/costmodel.py, metering.py) against the JAX package's classes on the
same op sequences under a fake clock -- admit/shed decisions, Retry-After
values, warnings and snapshots, bounded tenant labels, predictions and
their evidence tiers -- and the server edge: the scheduling settings it now
accepts, an admission shed answered 429 with ``Retry-After`` and the
structured warning, ``/debug/scheduler``, and the client's mapping of 429
to ``AdmissionRejected``.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from filodb_tpu import metering as JMET
from filodb_tpu.query import costmodel as JCM
from filodb_tpu.query import promql as JP
from filodb_tpu.query import scheduler as JQS
from filodb_tpu_torch import metering as MET
from filodb_tpu_torch.client import fetch_raw
from filodb_tpu_torch.query import costmodel as CM
from filodb_tpu_torch.query import promql as PP
from filodb_tpu_torch.query import scheduler as QS
from filodb_tpu_torch.server import FiloServer

BASE = 1_600_000_000_000


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def outcome(ctl, ws, ns, cost, held):
    try:
        held.append(ctl.admit(ws, ns, cost_s=cost))
        return ("ok",)
    except (QS.AdmissionRejected, JQS.AdmissionRejected) as e:
        return ("shed", e.outcome, e.retry_after_s, e.warning())


@pytest.mark.parametrize("seed", range(4))
def test_token_bucket_matches_jax(seed):
    rng = np.random.default_rng(seed)
    rate, burst = float(rng.uniform(0.5, 4)), float(rng.uniform(0.5, 6))
    pc, jc = Clock(), Clock()
    port, jax = QS.TokenBucket(rate, burst, pc), JQS.TokenBucket(rate, burst, jc)
    for _ in range(200):
        dt, cost = float(rng.exponential(0.3)), float(rng.uniform(0, 3))
        pc.t += dt
        jc.t += dt
        assert port.try_take(cost) == jax.try_take(cost)
        assert port.balance() == jax.balance()


QUOTAS = [
    {"*": {"rate": 2, "burst": 3}},
    {"App/a": {"rate_device_s": 0.2, "burst_device_s": 0.5}, "*": {"max_concurrent": 2}},
    {"App/b": {"rate": 1, "max_concurrent": 1}},
]


@pytest.mark.parametrize("quotas", QUOTAS, ids=["legacy", "device_s", "concurrency"])
@pytest.mark.parametrize("max_queued", [0, 3])
def test_admission_sequences_match_jax(quotas, max_queued):
    rng = np.random.default_rng(len(json.dumps(quotas)) + max_queued)
    pc, jc = Clock(), Clock()
    port = QS.AdmissionController(quotas, max_queued=max_queued, clock=pc)
    jax = JQS.AdmissionController(quotas, max_queued=max_queued, clock=jc)
    held_p, held_j = [], []
    tenants = [("App", "a"), ("App", "b"), ("Other", "c")]
    for _ in range(150):
        dt = float(rng.exponential(0.2))
        pc.t += dt
        jc.t += dt
        if held_p and rng.random() < 0.4:
            i = int(rng.integers(len(held_p)))
            held_p.pop(i).__exit__(None, None, None)
            held_j.pop(i).__exit__(None, None, None)
            continue
        ws, ns = tenants[int(rng.integers(3))]
        cost = None if rng.random() < 0.3 else float(rng.uniform(0.01, 0.4))
        assert outcome(port, ws, ns, cost, held_p) == outcome(jax, ws, ns, cost, held_j)
        assert port.snapshot() == jax.snapshot()


def test_retry_after_is_an_achievable_drain_time():
    clock = Clock()
    ctl = QS.AdmissionController({"*": {"rate_device_s": 0.1, "burst_device_s": 0.2}},
                                 clock=clock)
    with ctl.admit("t", "x", cost_s=0.2):
        pass
    with pytest.raises(QS.AdmissionRejected) as exc:
        ctl.admit("t", "x", cost_s=0.2)
    clock.t += exc.value.retry_after_s
    with ctl.admit("t", "x", cost_s=0.2):
        pass


def test_tenant_labels_are_bounded_like_jax(monkeypatch):
    for mod in (MET, JMET):
        monkeypatch.setattr(mod, "MAX_TENANT_PAIRS", 3)
        monkeypatch.setattr(mod, "_tenant_pairs", set())
    pairs = [(f"w{i}", f"n{i % 2}") for i in range(6)] + [("w0", "n0")]
    assert [MET.bounded_tenant_pair(*p) for p in pairs] == [
        JMET.bounded_tenant_pair(*p) for p in pairs]
    port = QS.AdmissionController({"*": {"max_concurrent": 1}})
    jax = JQS.AdmissionController({"*": {"max_concurrent": 1}})
    for p in pairs:
        assert outcome(port, *p, None, []) == outcome(jax, *p, None, [])
    assert sorted(port.snapshot()["tenants"]) == sorted(jax.snapshot()["tenants"])
    assert "overflow/overflow" in port.snapshot()["tenants"]


@pytest.mark.parametrize("query", [
    'sum(rate(m{_ws_="App",_ns_="a"}[5m]))',
    'm{_ws_="App"} + on() n{_ns_="b"}',
    'sum(rate(m{_ws_="App",_ns_="a"}[5m])) / sum(rate(m{_ws_="Other",_ns_="a"}[5m]))',
    "up", 'count(m{_ns_=~"a.*"})',
])
def test_tenant_of_plan_matches_jax(query):
    port = MET.tenant_of_plan(PP.query_range_to_logical_plan(query, 1000, 2000, 60))
    jax = JMET.tenant_of_plan(JP.query_range_to_logical_plan(query, 1000, 2000, 60))
    assert port == jax


@pytest.mark.parametrize("seed", range(3))
def test_cost_model_sequences_match_jax(seed):
    rng = np.random.default_rng(seed)
    port, jax = CM.CostModel(alpha=0.4), JCM.CostModel(alpha=0.4)
    queries = ["rate(m[5m])", "sum(rate(m[5m]))", "max_over_time(g[1h])", "up",
               "sum by (a) (irate(m[1m]))"]
    assert [CM.family_of(q) for q in queries] == [JCM.family_of(q) for q in queries]
    for i in range(120):
        q = queries[int(rng.integers(len(queries)))]
        step, span = int(rng.choice([15_000, 60_000])), int(rng.choice([0, 3_600_000]))
        fp = CM.promql_fingerprint("ds", q, step, span)
        assert fp == jax_fingerprint("ds", q, step, span)
        steps, series = int(rng.integers(1, 300)), int(rng.integers(0, 5000))
        assert port.predict(fp, steps, series, CM.family_of(q)) == jax.predict(
            fp, steps, series, JCM.family_of(q))
        realized = None if rng.random() < 0.2 else float(rng.exponential(0.02))
        record = {"fingerprint": fp, "promql": q, "status": "shed" if i % 17 == 0 else "ok",
                  "realized_cost_s": realized, "predicted_cost_s": float(rng.uniform(0, 0.1)),
                  "grid": {"steps": steps}, "stats": {"series_scanned": series}}
        port.observe(record)
        jax.observe(record)
        assert port.error_ratio(fp) == jax.error_ratio(fp)
    assert port.snapshot() == jax.snapshot()
    port.configure(prior_cost_s=0.2, max_entries=16)
    jax.configure(prior_cost_s=0.2, max_entries=16)
    assert port.snapshot() == jax.snapshot()
    port.clear()
    assert port.snapshot()["observed"] == 0


def jax_fingerprint(dataset, q, step, span):
    from filodb_tpu.obs.querylog import promql_fingerprint

    return promql_fingerprint(dataset, q, step, span)


# -- the server edge ------------------------------------------------------------------


@pytest.mark.parametrize("query_cfg", [
    {"parallelism": 2, "max_queued": 4},
    {"batch_window_ms": 2.0, "batch_max": 8, "batch_window_cap_ms": 10.0},
    {"tenant_quotas": {"*": {"rate": 1}}},
    {"admission_max_queued": 5},
], ids=["parallelism", "batch_window_ms", "tenant_quotas", "admission_max_queued"])
def test_server_accepts_scheduling_settings(query_cfg):
    srv = FiloServer({"shards": 2, "query": query_cfg}, device="cpu")
    params = srv.engine.planner.params
    assert params.scheduler.parallelism == query_cfg.get("parallelism", 8)  # the JAX default
    assert (params.dispatch_scheduler is not None) == ("batch_window_ms" in query_cfg)
    assert (params.admission is not None) == any(
        k in query_cfg for k in ("tenant_quotas", "admission_max_queued"))
    if "batch_window_ms" in query_cfg:
        assert params.dispatch_scheduler.adaptive and params.batch_window_ms == 2.0
    srv.stop()


@pytest.mark.parametrize("config", [{"query": {"prewarm": {"enabled": True}}},
                                    {"standing": {"enabled": True}}], ids=["prewarm", "standing"])
def test_prewarm_and_standing_still_raise_naming_a5b(config):
    """Since A5b landed, neither setting raises: either builds the dispatch
    scheduler (window 0, for its recurrence ring) with the engine's
    prewarmer registered, and standing a StandingEngine on the engine."""
    srv = FiloServer(config, device="cpu")
    sched = srv.engine.planner.params.dispatch_scheduler
    assert sched is not None and not sched.enabled
    assert sched._prewarm_exec == srv.engine._prewarm_key
    assert (srv.standing is not None) == ("standing" in config)
    if srv.standing is not None:
        assert srv.standing.scheduler is sched and srv.standing.engine is srv.engine
    s = QS.DispatchScheduler(5)
    s.register_prewarmer(lambda d: None)
    assert s._prewarm_exec is not None and s.prewarm_tick() == []
    srv.stop()


@pytest.fixture(scope="module")
def quota_server():
    """A CPU server whose tenant App-2 has a quota of one prior-priced
    query with no refill to speak of, and App-1 none."""
    srv = FiloServer({"shards": 2, "retention_hours": 10**6, "query": {
        "parallelism": 2, "batch_window_ms": 1.0,
        "tenant_quotas": {"demo/App-2": {"rate": 0.001, "burst": 1}}}}, device="cpu")
    port = srv.start(port=0)
    base = f"http://127.0.0.1:{port}"
    body = "\n".join(json.dumps({"tags": {"__name__": "cpu", "_ws_": "demo", "_ns_": ns,
                                          "host": f"h{i}"},
                                 "ts_ms": BASE + k * 15_000, "value": float(i + k)})
                     for ns in ("App-1", "App-2") for i in range(3) for k in range(40)).encode()
    req = urllib.request.Request(base + "/ingest", data=body, method="POST")
    urllib.request.urlopen(req, timeout=30).read()
    yield srv, base
    srv.stop()


def query_url(base, ns):
    from urllib.parse import quote

    q = quote(f'sum(cpu{{_ws_="demo",_ns_="{ns}"}})')
    return f"{base}/api/v1/query_range?query={q}&start={(BASE + 300_000) / 1e3}" \
           f"&end={(BASE + 500_000) / 1e3}&step=60"


def test_admission_shed_answers_429_with_retry_after(quota_server):
    srv, base = quota_server
    for _ in range(3):
        with urllib.request.urlopen(query_url(base, "App-1"), timeout=30) as r:
            assert json.loads(r.read())["status"] == "success"
    codes = []
    for _ in range(2):
        try:
            with urllib.request.urlopen(query_url(base, "App-2"), timeout=30) as r:
                codes.append(r.status)
        except urllib.error.HTTPError as e:
            codes.append(e.code)
            payload = json.loads(e.read())
            assert int(e.headers["Retry-After"]) >= 1
            warning = payload["warnings"][0]
            assert warning["reason"] == "admission_rejected" and warning["ns"] == "App-2"
            assert warning["outcome"] == "shed_rate" and payload["errorType"] == "throttled"
    assert codes == [200, 429]
    with urllib.request.urlopen(base + "/debug/scheduler", timeout=30) as r:
        snap = json.loads(r.read())["data"]
    assert snap["admission"]["tenants"]["demo/App-2"]["shed"] == 1
    assert snap["admission"]["shed_total"] == 1 and snap["batch"]["window_ms"] == 1.0
    with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
        text = r.read().decode()
    assert 'filodb_admission_total{ns="App-2",outcome="shed_rate",ws="demo"} 1' in text


def test_client_maps_429_to_admission_rejected(quota_server):
    _, base = quota_server
    with pytest.raises(QS.AdmissionRejected) as exc:
        fetch_raw(query_url(base, "App-2"), timeout=30)
    assert exc.value.outcome == "shed_remote" and exc.value.retry_after_s >= 1
