"""Binary-join pushdown in the port (``SingleClusterPlanner._try_join_pushdown``)
against the JAX package on ``tests/test_join_pushdown.py``'s cases: a
dataset sharded by (_ws_, _ns_) at spread 0, where the series of one
workspace and namespace share a shard and joins run per shard. Both
packages plan the same shape (a per-shard join under a concatenation, or
the root join where pairs may cross shards) and answer equally."""

import numpy as np
import pytest

from filodb_tpu.coordinator.planner import PlannerParams as JaxParams
from filodb_tpu.coordinator.planner import QueryEngine as JaxEngine
from filodb_tpu.coordinator.planner import SingleClusterPlanner as JaxPlanner
from filodb_tpu.core import schemas as JS
from filodb_tpu.memstore.memstore import TimeSeriesMemStore as JaxMemStore
from filodb_tpu.query.promql import query_range_to_logical_plan as jax_plan
from filodb_tpu.testkit import machine_metrics
from filodb_tpu_torch.coordinator.planner import PlannerParams, QueryEngine, SingleClusterPlanner
from filodb_tpu_torch.core import schemas as S
from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore
from filodb_tpu_torch.query.exec.joins import BinaryJoinExec, SetOperatorExec
from filodb_tpu_torch.query.exec.plans import DistConcatExec
from filodb_tpu_torch.query.promql import query_range_to_logical_plan
from test_torch_hist_engine import port_batch

BASE = 1_600_000_000_000
START, END = (BASE + 400_000) / 1000, (BASE + 1_100_000) / 1000

# (query, spread, the root the plans must have)
CASES = [
    ("err_total / req_total", 0, "DistConcatExec"),
    ("err_total and req_total", 0, "DistConcatExec"),
    ("err_total or on(_ws_, _ns_, instance) req_total", 0, "DistConcatExec"),
    ("err_total / on(instance, _ws_) req_total", 0, "BinaryJoinExec"),
    ("err_total and on() req_total", 0, "SetOperatorExec"),
    ("err_total / ignoring(_ns_) req_total", 0, "BinaryJoinExec"),
    ("sum(err_total) / sum(req_total)", 0, "BinaryJoinExec"),
    ("err_total / req_total", 3, "BinaryJoinExec"),
]


@pytest.fixture(scope="module")
def stores():
    opts = (JS.DatasetOptions(shard_key_columns=("_ws_", "_ns_")),
            S.DatasetOptions(shard_key_columns=("_ws_", "_ns_")))
    jms, pms = JaxMemStore(), TimeSeriesMemStore()
    jms.setup(JS.Dataset("prometheus", options=opts[0]), range(4))
    pms.setup(S.Dataset("prometheus", options=opts[1]), range(4))
    for ns in ("ns-a", "ns-b", "ns-c"):
        for metric, seed in (("req_total", 0), ("err_total", 9)):
            jb = machine_metrics(n_series=4, n_samples=120, start_ms=BASE, metric=metric, ns=ns,
                                 seed=seed)
            assert pms.ingest_routed("prometheus", port_batch(jb), 0) == \
                jms.ingest_routed("prometheus", jb, 0)
    return jms, pms


def rows(res):
    return {tuple(sorted(lbl.items())): np.asarray(v, np.float64)
            for g in res.grids for lbl, v in zip(g.labels, g.values_np())}


@pytest.mark.parametrize("q,spread,root", CASES, ids=[f"{c[0]}|{c[1]}" for c in CASES])
def test_pushdown_plans_and_answers_as_jax(stores, q, spread, root):
    jms, pms = stores
    pplan = SingleClusterPlanner(pms, "prometheus", params=PlannerParams(spread=spread)
                                 ).materialize(query_range_to_logical_plan(q, START, END, 60))
    jplan = JaxPlanner(jms, "prometheus", params=JaxParams(spread=spread)
                       ).materialize(jax_plan(q, START, END, 60))
    assert type(pplan).__name__ == type(jplan).__name__ == root
    if root == "DistConcatExec":
        kinds = {type(c) for c in pplan.child_plans}
        assert kinds <= {BinaryJoinExec, SetOperatorExec} and len(pplan.child_plans) >= 2
        assert len(pplan.child_plans) == len(jplan.children())
    port = QueryEngine(pms, "prometheus", PlannerParams(spread=spread), device="cpu")
    jax = JaxEngine(jms, "prometheus", JaxParams(spread=spread))
    try:
        want = jax.query_range(q, START, END, 60)
    except Exception as e:  # noqa: BLE001 -- the port must refuse it alike
        with pytest.raises(Exception, match="many-to-many"):
            port.query_range(q, START, END, 60)
        assert "many-to-many" in str(e)
        return
    a, b = rows(port.query_range(q, START, END, 60)), rows(want)
    assert a.keys() == b.keys() and a
    for k in a:
        np.testing.assert_array_equal(np.isnan(a[k]), np.isnan(b[k]), err_msg=str(k))
        m = ~np.isnan(b[k])
        np.testing.assert_allclose(a[k][m], b[k][m], rtol=2e-4, atol=1e-4, err_msg=str(k))


def test_pushdown_equals_the_root_join(stores):
    _, pms = stores
    q = "err_total / req_total"
    a = rows(QueryEngine(pms, "prometheus", PlannerParams(spread=0), device="cpu")
             .query_range(q, START, END, 60))
    b = rows(QueryEngine(pms, "prometheus", PlannerParams(spread=3), device="cpu")
             .query_range(q, START, END, 60))
    assert a.keys() == b.keys() and len(a) == 12
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_no_pushdown_when_metric_is_shard_key():
    ms = TimeSeriesMemStore()
    ms.setup(S.Dataset("prometheus"), range(4))
    ms.ingest_routed("prometheus", port_batch(machine_metrics(n_series=4, n_samples=60,
                                                              start_ms=BASE)), 0)
    pl = SingleClusterPlanner(ms, "prometheus", params=PlannerParams(spread=0))
    ep = pl.materialize(query_range_to_logical_plan("a / b", START, (BASE + 500_000) / 1000, 60))
    assert isinstance(ep, BinaryJoinExec)
