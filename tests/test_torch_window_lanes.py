"""The lane mode of the fused window-stats kernel (ops/window_stats.py
``window_range_lanes``; csrc/window_stats.cu ``filodb_window_range_lanes``)
on the CPU, where it runs its plain version:

- ``window_range_lanes_plain`` against the JAX package's batched general
  program (``aggregations._batched_general_jit`` through
  ``fused_batched_scalar``, the Pallas promotion off as on the CPU) on
  regular blocks (min/max/absent_over_time, which the port serves on
  window stats) and irregular ones (``PALLAS_FUNCS``), within rtol 2e-4 /
  atol 1e-4 with equal NaN masks;
- every lane bit-equal to its solo plain run, in the aggregate and the
  store mode;
- a coalesced round of window-stats queries through both engines'
  schedulers: one lane-mode dispatch a group, each lane bit-equal to its
  solo answer and within tolerance of the JAX package's batched lanes.

The kernel itself runs on the card (``tests/test_torch_cuda.py``).
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from filodb_tpu.coordinator.planner import PlannerParams as JaxParams
from filodb_tpu.coordinator.planner import QueryEngine as JaxEngine
from filodb_tpu.core.records import SeriesBatch as JaxSeriesBatch
from filodb_tpu.core.schemas import PROM_COUNTER as JAX_PROM_COUNTER
from filodb_tpu.core.schemas import Dataset as JaxDataset
from filodb_tpu.memstore.memstore import TimeSeriesMemStore as JaxMemStore
from filodb_tpu.ops import aggregations as JAGG
from filodb_tpu.ops import staging as JST
from filodb_tpu.ops.kernels import RangeParams as JaxRangeParams
from filodb_tpu.query.scheduler import DispatchScheduler as JaxDispatch
from filodb_tpu_torch.coordinator.planner import PlannerParams, QueryEngine
from filodb_tpu_torch.core.records import SeriesBatch
from filodb_tpu_torch.core.schemas import METRIC_TAG, PROM_COUNTER, Dataset, shard_for
from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore
from filodb_tpu_torch.ops import aggregations as AGG
from filodb_tpu_torch.ops import staging as ST
from filodb_tpu_torch.ops import window_stats as WS
from filodb_tpu_torch.ops.kernels import RangeParams, pad_steps
from filodb_tpu_torch.query.scheduler import DispatchScheduler

BASE = 1_600_000_000_000
RTOL, ATOL = 2e-4, 1e-4
WINDOWS = (300_000, 240_000, 180_000)
# the functions the port serves on window stats where the JAX ladder takes
# its general program: on a regular grid those outside FUSED_MXU_FUNCS, on
# an irregular one every PALLAS_FUNCS member outside the general kernel's
CASES = [("regular", f) for f in ("min_over_time", "max_over_time", "absent_over_time")] + [
    ("irregular", f) for f in ("rate", "increase", "delta", "sum_over_time", "count_over_time",
                               "avg_over_time", "last", "first_over_time", "min_over_time")]
COUNTER_FUNCS = ("rate", "increase")


def series(grid: str, n_series=9, n=160, seed=4):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_series):
        if grid == "regular":
            ts = BASE + 3_000 + np.arange(n, dtype=np.int64) * 10_000
        else:
            gaps = rng.integers(5_000, 15_001, n - 3 * i)
            ts = BASE + np.cumsum(gaps).astype(np.int64)
        vals = np.cumsum(rng.uniform(0, 10, len(ts))) + 100.0
        if i == 4:
            vals[len(ts) // 2:] -= vals[len(ts) // 2] - 1.0  # a counter reset
        out.append((ts, vals))
    return out


def blocks(grid: str):
    s = series(grid)
    pb = ST.stage_series(s, BASE).to_device("cpu")
    jb = JST.stage_series(s, BASE).to_device()
    assert ST.grid_class(pb) == grid
    return pb, jb


def port_lanes(pb, num_steps=(40, 40, 33, 40, 40)):
    """Lanes of 1, 3 and 5 interleaved groups over the three windows
    (int64 ids, padded rows in each lane's trash group)."""
    S = pb.ts.shape[0]
    lanes = []
    for i, J in enumerate(num_steps):
        G = (1, 3, 5)[i % 3]
        gids = np.full(S, G, np.int64)
        gids[: pb.n_series] = np.arange(pb.n_series) % G
        lanes.append((torch.as_tensor(gids), G, 0.0,
                      RangeParams(BASE + 400_000, 60_000, J, WINDOWS[i % 3])))
    return lanes


@pytest.mark.parametrize("grid,func", CASES, ids=[f"{g}-{f}" for g, f in CASES])
@pytest.mark.parametrize("op", ["sum", "max", "count"])
def test_window_lanes_plain_matches_jax_batched_general(grid, func, op, monkeypatch):
    monkeypatch.setenv("FILODB_PALLAS", "0")
    pb, jb = blocks(grid)
    counter = func in COUNTER_FUNCS
    lanes = port_lanes(pb, num_steps=(40,) * 5)
    assert AGG.lanes_variant(pb, func, "agg", False, [l[3] for l in lanes]) == "window_stats"
    batch = AGG._batched_stacks(pb, lanes, "window_stats", "agg", pad_steps(40))
    got = WS.window_range_lanes_plain(func, op, pb, lanes, batch, counter, False)
    G_max = max(l[1] for l in lanes)
    jlanes = [(jnp.asarray(g.numpy().astype(np.int32)), 0.0,
               JaxRangeParams(p.start_ms, p.step_ms, p.num_steps, p.window_ms))
              for g, _G, _q, p in lanes]
    jout = np.asarray(JAGG.fused_batched_scalar(func, ("agg", op), jb, jlanes, G_max,
                                                pad_steps(40), counter, False))
    for i, ((_g, G, _q, p), g) in enumerate(zip(lanes, got)):
        a = g.numpy()[:, : p.num_steps].astype(np.float64)
        b = jout[i, :G, : p.num_steps].astype(np.float64)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=f"lane {i}")
        m = ~np.isnan(b)
        assert m.any() or func == "absent_over_time"
        np.testing.assert_allclose(a[m], b[m], rtol=RTOL, atol=ATOL, err_msg=f"lane {i}")


@pytest.mark.parametrize("grid,func", CASES, ids=[f"{g}-{f}" for g, f in CASES])
def test_window_lanes_bit_equal_to_solo(grid, func):
    """Each lane (lanes of 40 and 33 steps over three windows) bit-equal to
    its solo plain run, for sum and max; the store mode's grids bit-equal
    to each window's solo store."""
    pb, _ = blocks(grid)
    counter = func in COUNTER_FUNCS
    lanes = port_lanes(pb)
    batch = AGG._batched_stacks(pb, lanes, "window_stats", "agg", pad_steps(40))
    for op in ("sum", "max"):
        got = WS.window_range_lanes(func, op, pb, lanes, batch, is_counter=counter)
        outs = AGG.fused_batched_scalar(func, ("agg", op), pb, lanes, counter, False)
        for (gids, G, _q, p), g, o in zip(lanes, got, outs):
            w = AGG.fused_range_aggregate(func, op, pb, gids, G, p, is_counter=counter)
            assert np.array_equal(g.numpy()[:, : p.num_steps], w.numpy()[:, : p.num_steps],
                                  equal_nan=True)
            assert np.array_equal(o.numpy(), g.numpy(), equal_nan=True)
    zero = AGG.zero_gids(pb)
    tl = [(zero, 1, 0.0, RangeParams(BASE + 400_000, 60_000, 40, w)) for w in WINDOWS]
    tb = AGG._batched_stacks(pb, tl, "window_stats", "topk", pad_steps(40))
    grids = WS.window_range_lanes_series(func, pb, tb, is_counter=counter)
    assert grids.shape == (3, pad_steps(40), pb.ts.shape[0])
    for u, (_z, _G, _q, p) in enumerate(tl):
        solo = AGG.fused_range_series(func, pb, p, is_counter=counter)
        assert np.array_equal(grids[u].numpy(), solo.numpy(), equal_nan=True)
    outs = AGG.fused_batched_scalar(func, ("topk", 2, False), pb, tl, counter, False)
    for (_z, _G, _q, p), (v, idx) in zip(tl, outs):
        sv, si = AGG.fused_topk(func, pb, 2, False, p, is_counter=counter)
        assert np.array_equal(v.numpy(), sv.numpy(), equal_nan=True)


def test_window_lanes_refuse_other_functions_and_ops():
    pb, _ = blocks("irregular")
    lanes = port_lanes(pb)
    batch = AGG._batched_stacks(pb, lanes, "window_stats", "agg", pad_steps(40))
    with pytest.raises(NotImplementedError, match="window-stats rung"):
        WS.window_range_lanes("irate", "sum", pb, lanes, batch)
    with pytest.raises(NotImplementedError, match="not ported"):
        WS.window_range_lanes("rate", "stddev", pb, lanes, batch)
    with pytest.raises(NotImplementedError, match="window-stats rung"):
        WS.window_range_lanes_series("irate", pb, batch)
    assert WS.LANE_LAUNCHES == 0  # the CPU never launches


# -- a coalesced round through both engines -----------------------------------

N_SHARDS = 4
START = (BASE + 900_000) / 1000
END = START + 600
STEP = 60
# two groups of one group-count bucket each (tests/test_torch_batching.py's
# agg_sum family shape): rate sums over three windows, last_over_time maxima
ROUND = ["sum(rate(rq[5m]))", "sum by (_ws_) (rate(rq[5m]))", "sum(rate(rq[4m]))",
         "sum(rate(rq[5m] offset 1m))", "max(last_over_time(rq[5m]))",
         "max by (_ns_) (last_over_time(rq[3m]))"]


def mirrored_irregular():
    jms, pms = JaxMemStore(), TimeSeriesMemStore()
    jms.setup(JaxDataset("ds"), list(range(N_SHARDS)))
    pms.setup(Dataset("ds"), list(range(N_SHARDS)))
    for i, (ts, vals) in enumerate(series("irregular", n_series=24, n=200, seed=9)):
        tags = {METRIC_TAG: "rq", "_ws_": "w", "_ns_": "n", "instance": f"h{i}",
                "job": f"j{i % 3}"}
        shard = shard_for(tags, spread=3, num_shards=N_SHARDS)
        assert pms.shard("ds", shard).ingest_series(
            SeriesBatch(PROM_COUNTER, tags, ts, {"count": vals})) == \
            jms.shard("ds", shard).ingest_series(
                JaxSeriesBatch(JAX_PROM_COUNTER, tags, ts, {"count": vals}))
    return jms, pms


def run_coalesced(engine, sched, queries):
    hold = threading.Event()
    sched._waiter = lambda ev, s: hold.wait(30)
    q0 = sched.stats["queries"]
    out, errors = {}, {}

    def run(q):
        try:
            out[q] = engine.query_range(q, START, END, STEP)
        except Exception as e:  # noqa: BLE001 -- surfaced below
            errors[q] = e

    threads = [threading.Thread(target=run, args=(q,)) for q in queries]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 30
    while sched.stats["queries"] - q0 < len(queries) and time.monotonic() < deadline:
        time.sleep(0.002)
    hold.set()
    for t in threads:
        t.join(60)
    sched._waiter = None
    assert not errors, errors
    return out


def rows(res):
    return {tuple(sorted(lbl.items())): np.asarray(v, np.float64)
            for g in res.grids for lbl, v in zip(g.labels, g.values_np())}


def test_coalesced_window_stats_round_matches_solo_and_jax(monkeypatch):
    monkeypatch.setenv("FILODB_PALLAS", "0")
    jms, pms = mirrored_irregular()
    sched = DispatchScheduler(window_ms=100, max_batch=32)
    eng = QueryEngine(pms, "ds", PlannerParams(batch_window_ms=100, dispatch_scheduler=sched),
                      device="cpu")
    seq = QueryEngine(pms, "ds", PlannerParams(batch_window_ms=100,
                                               dispatch_scheduler=DispatchScheduler(0)),
                      device="cpu")
    want = {q: seq.query_range(q, START, END, STEP) for q in ROUND}
    calls = []
    orig = AGG.fused_batched_scalar
    monkeypatch.setattr(AGG, "fused_batched_scalar",
                        lambda func, epi, block, lanes, *a: calls.append(
                            (func, epi, AGG.lanes_variant(block, func, "agg", False,
                                                          [l[3] for l in lanes]), len(lanes)))
                        or orig(func, epi, block, lanes, *a))
    got = run_coalesced(eng, sched, ROUND)
    assert sched.stats["fallback"] == 0 and sched.stats["error"] == 0
    assert sched.stats["batched"] == 2 and sched.stats["solo"] == 0
    assert {c[2] for c in calls} == {"window_stats"}
    assert sorted(c[3] for c in calls) == [2, 4]
    for q in ROUND:
        a, b = rows(got[q]), rows(want[q])
        assert a.keys() == b.keys() and a
        for k in a:
            assert np.array_equal(a[k], b[k], equal_nan=True), (q, k)
    jsched = JaxDispatch(window_ms=100, max_batch=32)
    jeng = JaxEngine(jms, "ds", JaxParams(batch_window_ms=100, dispatch_scheduler=jsched))
    jgot = run_coalesced(jeng, jsched, ROUND)
    assert jsched.stats["batched"] >= 1
    for q in ROUND:
        a, b = rows(got[q]), rows(jgot[q])
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.isnan(a[k]), np.isnan(b[k]), err_msg=f"{q} {k}")
            m = ~np.isnan(b[k])
            np.testing.assert_allclose(a[k][m], b[k][m], rtol=RTOL, atol=ATOL, err_msg=q)
