"""The port's QueryEngine on native histograms against the JAX package's, on
mirrored memstores: every histogram query of tests/test_fused_hist.py
(quantile forms, the _bucket/_sum/_count suffixes, le= and +Inf bucket
selections, a missing bucket), heterogeneous bucket schemes across shards,
a superblock-cache hit, and the cache's maintenance outcomes under live
ingest (extend, restage) step by step. (The JAX package keys a histogram
selection's first superblock by the function's staging mode and builds it
again on the second query; the port keys it by the resolved mode, so its
second query hits. The sequence primes the JAX engine with that extra
query.) Group labels and NaN masks must be
equal, values within rtol 2e-4 / atol 1e-4 (tests/test_pallas.py's
tolerance). Plus the schemas, records and partitions the slice adds, and
the shapes the fused kernels do not model, which fall back to the tree
(on a build and on a cache hit) and answer as the JAX engine does, or
raise its error."""

import numpy as np
import pytest

from filodb_tpu import metrics as JM
from filodb_tpu.coordinator.planner import QueryEngine as JaxEngine
from filodb_tpu.core import records as JR
from filodb_tpu.core import schemas as JS
from filodb_tpu.core.histograms import custom_buckets
from filodb_tpu.memstore.memstore import TimeSeriesMemStore as JaxMemStore
from filodb_tpu.testkit import counter_batch, histogram_batch
from filodb_tpu_torch import metrics as M
from filodb_tpu_torch.coordinator.planner import QueryEngine
from filodb_tpu_torch.core import records as R
from filodb_tpu_torch.core import schemas as S
from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore
from filodb_tpu_torch.ops import hist_kernels as HK
from filodb_tpu_torch.ops import staging as ST

BASE = 1_600_000_000_000
N_SHARDS = 4
START = (BASE + 600_000) / 1000
END = START + 900
STEP = 60
RTOL, ATOL = 2e-4, 1e-4
HQ_QUERY = "histogram_quantile(0.99, sum by (le) (rate(http_request_latency_bucket[5m])))"
HIST_SCHEMAS = ("prom-histogram", "delta-histogram", "otel-cumulative-histogram",
                "otel-delta-histogram", "otel-exp-delta-histogram")


def port_batch(jb):
    """The JAX RecordBatch ``jb`` as the port's (same arrays and tags)."""
    return R.RecordBatch(S.SCHEMAS[jb.schema.name], jb.timestamps, dict(jb.values), jb.tags,
                         bucket_les=jb.bucket_les)


def mirrored(*batches, shards=N_SHARDS, spread=2):
    jms, pms = JaxMemStore(), TimeSeriesMemStore()
    jms.setup(JS.Dataset("ds"), list(range(shards)))
    pms.setup(S.Dataset("ds"), list(range(shards)))
    for jb in batches:
        assert pms.ingest_routed("ds", port_batch(jb), spread) == jms.ingest_routed(
            "ds", jb, spread)
    return jms, pms


@pytest.fixture(scope="module")
def stores():
    return mirrored(
        histogram_batch(n_series=24, n_samples=240, start_ms=BASE, metric="http_request_latency"),
        counter_batch(n_series=24, n_samples=240, start_ms=BASE))


def rows(res):
    out = {}
    for g in res.grids:
        for lbls, vals in zip(g.labels, g.values_np()):
            out[tuple(sorted(lbls.items()))] = np.asarray(vals)
    return out


def hist_rows(res):
    out = {}
    for g in res.grids:
        h = g.hist_np()
        if h is not None:
            for lbls, cube in zip(g.labels, h):
                out[tuple(sorted(lbls.items()))] = (np.asarray(cube), np.asarray(g.les, np.float64))
    return out


def close(got, want, what):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=f"{what}: NaN masks")
    m = ~np.isnan(want)
    np.testing.assert_allclose(got[m], want[m], rtol=RTOL, atol=ATOL, err_msg=what)


def assert_parity(jms, pms, q, start=START, end=END, step=STEP):
    want = JaxEngine(jms, "ds").query_range(q, start, end, step)
    got = QueryEngine(pms, "ds", device="cpu").query_range(q, start, end, step)
    a, b = rows(got), rows(want)
    assert a.keys() == b.keys(), (q, sorted(a), sorted(b))
    for k in a:
        close(a[k], b[k], f"{q} {k}")
    ha, hb = hist_rows(got), hist_rows(want)
    assert ha.keys() == hb.keys(), q
    for k in ha:
        np.testing.assert_array_equal(ha[k][1], hb[k][1])
        close(ha[k][0], hb[k][0], f"{q} {k} hist")
    return got, want


# -- parity on the fused histogram path -----------------------------------------


@pytest.mark.parametrize("q", [
    HQ_QUERY,
    "histogram_quantile(0.9, sum(rate(http_request_latency[5m])))",
    "histogram_quantile(0.5, sum(increase(http_request_latency[5m])))",
    "histogram_quantile(0.99, sum(sum_over_time(http_request_latency[3m])))",
    "histogram_quantile(0.9, sum(last_over_time(http_request_latency[3m])))",
    "histogram_quantile(0.9, sum by (instance) (rate(http_request_latency[5m])))",
    "histogram_quantile(0.5, sum(delta(http_request_latency[5m])))",
    "histogram_quantile(0.9, sum(http_request_latency))",
    "histogram_quantile(1.5, sum(rate(http_request_latency[5m])))",
    "histogram_quantile(-1, sum(rate(http_request_latency[5m])))",
])
def test_hist_quantile_matches_jax(stores, q):
    got, _ = assert_parity(*stores, q)
    assert got.grids and got.grids[0].hist is None


@pytest.mark.parametrize("q", [
    "sum(rate(http_request_latency[5m]))",
    "sum(rate(http_request_latency_bucket[5m]))",
    "sum(rate(http_request_latency_sum[5m]))",
    "sum(rate(http_request_latency_count[5m]))",
    'sum(rate(http_request_latency_bucket{le="0.5"}[5m]))',
    'sum(rate(http_request_latency_bucket{le="+Inf"}[5m]))',
    "sum by (instance) (increase(http_request_latency[5m]))",
    "sum(sum_over_time(http_request_latency[3m]))",
])
def test_hist_suffixes_and_sums_match_jax(stores, q):
    assert_parity(*stores, q)


def test_missing_bucket_is_empty_on_both(stores):
    jms, pms = stores
    q = 'sum(rate(http_request_latency_bucket{le="0.123"}[5m]))'
    assert not rows(JaxEngine(jms, "ds").query_range(q, START, END, STEP))
    assert not rows(QueryEngine(pms, "ds", device="cpu").query_range(q, START, END, STEP))


def test_native_hist_grid_carries_buckets(stores):
    got, want = assert_parity(*stores, "sum(rate(http_request_latency[5m]))")
    g = got.grids[0]
    assert g.hist_np().shape == (1, g.num_steps, 12) and np.isnan(g.values_np()).all()
    np.testing.assert_array_equal(g.les, want.grids[0].les)


def test_plan_fuses_the_quantile(stores):
    from filodb_tpu_torch.query.exec.plans import FusedAggregateExec
    from filodb_tpu_torch.query.promql import query_range_to_logical_plan

    eng = QueryEngine(stores[1], "ds", device="cpu")
    ex = eng.planner.materialize(query_range_to_logical_plan(HQ_QUERY, START, END, STEP))
    assert isinstance(ex, FusedAggregateExec) and ex.hist_quantile == pytest.approx(0.99)
    ctx = eng.context()
    ex.execute(ctx)
    assert ctx.obs == {"path": "fused", "variant": "hist_shared"}


# -- heterogeneous bucket schemes -------------------------------------------------


def hetero_stores():
    """Scheme A on shards 0-1, scheme B (A plus two bounds) on shards 2-3
    (tests/test_fused_hist.py:254)."""
    rng = np.random.default_rng(5)
    jms, pms = JaxMemStore(), TimeSeriesMemStore()
    jms.setup(JS.Dataset("ds"), list(range(4)))
    pms.setup(S.Dataset("ds"), list(range(4)))
    scheme_a = custom_buckets([0.1, 0.5, 1, 5])
    scheme_b = custom_buckets([0.1, 0.25, 0.5, 1, 2.5, 5])
    m = 200
    ts = BASE + np.arange(m, dtype=np.int64) * 10_000
    for i in range(16):
        shard = i % 4
        scheme = scheme_a if shard < 2 else scheme_b
        incr = rng.poisson(2.0, size=(m, scheme.num_buckets)).astype(np.float64)
        incr[:, -1] = incr.sum(1)
        hist = np.cumsum(np.cumsum(incr, axis=1), axis=0)
        tags = {S.METRIC_TAG: "lat_hetero", "_ws_": "w", "_ns_": "n", "instance": f"h{i}"}
        vals = {"sum": np.cumsum(rng.uniform(0, 5, size=m)), "count": hist[:, -1], "h": hist}
        jms.shard("ds", shard).ingest_series(JR.SeriesBatch(
            JS.PROM_HISTOGRAM, tags, ts, vals, bucket_les=scheme.bounds()))
        pms.shard("ds", shard).ingest_series(R.SeriesBatch(
            S.PROM_HISTOGRAM, tags, ts, vals, bucket_les=scheme.bounds()))
    return jms, pms


@pytest.mark.parametrize("q", [
    "histogram_quantile(0.9, sum by (le) (rate(lat_hetero_bucket[5m])))",
    "sum(rate(lat_hetero[5m]))",
    'sum(rate(lat_hetero_bucket{le="0.25"}[5m]))',
])
def test_heterogeneous_schemes_match_jax(q):
    jms, pms = hetero_stores()
    start = (BASE + 400_000) / 1000
    got, want = assert_parity(jms, pms, q, start, start + 600, 60)
    assert got.stats.series_scanned == want.stats.series_scanned == 16
    assert got.stats.samples_scanned == want.stats.samples_scanned
    if q == "sum(rate(lat_hetero[5m]))":
        np.testing.assert_allclose(got.grids[0].les[:-1], [0.1, 0.25, 0.5, 1, 2.5, 5])


def test_intra_shard_scheme_mismatch_raises():
    """Partitions of one shard on different bucket schemes: the fused exec
    falls back to the tree (the JAX package's ``hist_scheme``) before it
    stages anything, and the tree answers as the JAX engine's does -- with
    the shard's first partition's bounds for all of them
    (``parts[0].bucket_les``)."""
    rng = np.random.default_rng(7)
    jms, pms = JaxMemStore(), TimeSeriesMemStore()
    jms.setup(JS.Dataset("ds"), [0])
    pms.setup(S.Dataset("ds"), [0])
    ts = BASE + np.arange(120, dtype=np.int64) * 10_000
    for i, bounds in enumerate(([0.1, 1, 5], [0.2, 1, 5])):
        scheme = custom_buckets(bounds)
        incr = rng.poisson(2.0, size=(120, scheme.num_buckets)).astype(np.float64)
        hist = np.cumsum(np.cumsum(incr, axis=1), axis=0)
        tags = {S.METRIC_TAG: "lat_mixed", "_ws_": "w", "_ns_": "n", "instance": f"h{i}"}
        vals = {"sum": hist[:, -1], "count": hist[:, -1], "h": hist}
        jms.shard("ds", 0).ingest_series(JR.SeriesBatch(JS.PROM_HISTOGRAM, tags, ts, vals,
                                                        bucket_les=scheme.bounds()))
        pms.shard("ds", 0).ingest_series(R.SeriesBatch(S.PROM_HISTOGRAM, tags, ts, vals,
                                                       bucket_les=scheme.bounds()))
    start = (BASE + 400_000) / 1000
    for q in ("sum(rate(lat_mixed[5m]))",
              "histogram_quantile(0.5, sum(rate(lat_mixed[5m])))",
              "rate(lat_mixed[5m])"):
        got, _ = assert_parity(jms, pms, q, start, start + 300, 60)
        assert got.grids and np.isfinite(got.grids[0].values_np()).any() or got.grids[0].hist_np(
        ) is not None
    eng = QueryEngine(pms, "ds", device="cpu")
    ctx = eng.context()
    from filodb_tpu_torch.query.promql import query_range_to_logical_plan

    plan = eng.planner.materialize(query_range_to_logical_plan(
        "sum(rate(lat_mixed[5m]))", start, start + 300, 60))
    plan.execute(ctx)
    assert ctx.obs["fallback"] == "hist_scheme"


# -- shapes the fused kernels do not model: the tree answers them ---------------------


def answer(engine, q):
    """("ok", the result) of a query, or ("error", type name, text)."""
    try:
        return "ok", engine.query_range(q, START, END, STEP)
    except Exception as e:  # the JAX package's errors are part of its answer
        return "error", type(e).__name__, str(e)


# (query, the refusal the port gave before the tree took these shapes: the
# case's id)
@pytest.mark.parametrize("q, match", [
    ("count(rate(http_request_latency[5m]))", "native histograms"),
    ("max by (instance) (rate(http_request_latency[5m]))", "native histograms"),
    ("topk(3, rate(http_request_latency[5m]))", "native histograms"),
    ("quantile(0.5, rate(http_request_latency[5m]))", "native histograms"),
    ("sum(avg_over_time(http_request_latency[3m]))", "histogram range function"),
    ("sum(irate(http_request_latency[5m]))", "histogram range function"),
    ("histogram_quantile(0.9, max(rate(http_request_latency[5m])))", "not ported"),
    ("histogram_fraction(0, 0.5, sum(rate(http_request_latency[5m])))", "not ported"),
])
def test_unsupported_hist_shapes_raise(stores, q, match):
    """Each shape answers as the JAX engine does: its rows and buckets, or
    its error's type and text."""
    jms, pms = stores
    want = answer(JaxEngine(jms, "ds"), q)
    got = answer(QueryEngine(pms, "ds", device="cpu"), q)
    assert got[0] == want[0], (q, got, want)
    if want[0] == "error":
        assert got[1:] == want[1:], q
    else:
        assert_parity(jms, pms, q)


@pytest.mark.parametrize("q", [
    "histogram_quantile(0.9, sum by (le) (rate(http_requests_total[5m])))",
    "histogram_quantile(0.9, sum(rate(http_requests_total[5m])))",
])
def test_classic_quantile_without_le_raises_as_jax(stores, q):
    """histogram_quantile over scalar series that carry no ``le``: both
    packages raise the same error type with the same message -- the
    QueryError of the classic fold where the grouping drops ``le``, and,
    grouped by an ``le`` the series lack, the ValueError of parsing its
    empty value as a bound."""
    jms, pms = stores
    with pytest.raises(ValueError) as want:
        JaxEngine(jms, "ds").query_range(q, START, END, STEP)
    with pytest.raises(ValueError) as got:
        QueryEngine(pms, "ds", device="cpu").query_range(q, START, END, STEP)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


def test_unsupported_shape_on_a_cached_superblock_raises(stores):
    """A hit decides the shape before it serves: on the cached histogram
    superblock of sum(rate), count(rate) falls back to the tree as the
    build does (``hist_op``), before any stats bump, and raises the JAX
    engine's error."""
    from filodb_tpu_torch.query.promql import query_range_to_logical_plan

    jms, pms = stores
    eng = QueryEngine(pms, "ds", device="cpu")
    eng.query_range("sum(rate(http_request_latency[5m]))", START, END, STEP)
    q = "count(rate(http_request_latency[5m]))"
    want = answer(JaxEngine(jms, "ds"), q)
    assert want[0] == "error" and answer(eng, q) == want
    plan = eng.planner.materialize(query_range_to_logical_plan(q, START, END, STEP))
    ctx = eng.context()
    with pytest.raises(ValueError):
        plan.execute(ctx)
    assert ctx.obs == {"path": "fallback", "fallback": "hist_op"}
    # the superblock hit counts (as the JAX package counts it) but scans
    # nothing: the series scanned are the first tree leaf's, which raised
    shard = plan.fallback.child_plans[0].shard_num
    leaf_series = sum(p.schema.name == "prom-histogram"
                      for p in pms.shard("ds", shard).partitions.values())
    assert ctx.stats.cache_hits == 2 and ctx.stats.series_scanned == leaf_series < 24


# -- the superblock cache and the live-edge extension ----------------------------

N_SERIES, N_SAMPLES, SPREAD = 12, 200, 1
LIVE_END = (BASE + (N_SAMPLES + 30) * 10_000) / 1000  # past the head: the live edge
LIVE_START = (BASE + 400_000) / 1000
LES = custom_buckets([0.1, 0.5, 1, 5]).bounds()


def hist_rows_batch(grid: str, series, slots, rng, metric="lat"):
    """One sample per (series, slot) of a cumulative histogram whose counts
    grow by slot: the same rows for both packages. ``irregular`` moves each
    sample by its own offset."""
    tags, ts, hs = [], [], []
    for i in series:
        t = {S.METRIC_TAG: metric, "_ws_": "w", "_ns_": "n", "instance": f"h{i}"}
        for k in slots:
            off = int(rng.integers(-3_000, 3_001)) if grid == "irregular" else 0
            tags.append(t)
            ts.append(BASE + k * 10_000 + off)
            hs.append(np.cumsum(np.full(len(LES), 1.0 + i)) * (k + 1))
    h = np.asarray(hs)
    jb = JR.RecordBatch(JS.PROM_HISTOGRAM, np.asarray(ts, np.int64),
                        {"sum": h[:, -1] * 0.1, "count": h[:, -1], "h": h}, tags, LES)
    return jb


def _jax_events() -> dict:
    return {o: JM.REGISTRY.counter("filodb_superblock_maintenance", outcome=o).value
            for o in M.SUPERBLOCK_OUTCOMES}


def cache_steps(grid, jms, pms, rng):
    m = [N_SAMPLES]

    def ingest(jb):
        assert pms.ingest_routed("ds", port_batch(jb), SPREAD) == jms.ingest_routed(
            "ds", jb, SPREAD)

    def append_all():
        ingest(hist_rows_batch(grid, range(N_SERIES), [m[0]], rng))
        m[0] += 1

    def disjoint():  # existing series of another metric, far past the range
        ingest(hist_rows_batch(grid, range(3), [N_SAMPLES + 700], rng, metric="other"))

    def half():
        ingest(hist_rows_batch(grid, range(N_SERIES // 2), [m[0]], rng))

    def new_series():
        ingest(hist_rows_batch(grid, [N_SERIES], range(m[0]), rng))

    append = {"extend": 1} if grid == "regular" else {"restage": 1}
    return [
        ("cold", None, {}),
        ("warm_hit", None, {}),
        ("disjoint_ingest", disjoint, {"revalidate": 1}),
        ("live_edge_append", append_all, append),
        ("second_append", append_all, append),
        ("non_uniform_append", half, {"restage": 1}),
        ("new_series", new_series, {"restage": 1}),
        ("warm_hit_after", None, {}),
    ]


@pytest.mark.parametrize("q", [
    "histogram_quantile(0.9, sum by (le) (rate(lat_bucket[5m])))",
    "sum(rate(lat[5m]))",
    'sum(rate(lat_bucket{le="0.5"}[5m]))',
])
@pytest.mark.parametrize("grid", ["regular", "irregular"])
def test_hist_cache_sequence_matches_jax(grid, q):
    rng = np.random.default_rng(3)
    jms, pms = mirrored(hist_rows_batch(grid, range(N_SERIES), range(N_SAMPLES), rng),
                        hist_rows_batch(grid, range(3), [N_SAMPLES + 600], rng, metric="other"),
                        spread=SPREAD)
    jeng, peng = JaxEngine(jms, "ds"), QueryEngine(pms, "ds", device="cpu")
    jeng.query_range(q, LIVE_START, LIVE_END, STEP)  # keyed by the function's mode
    sliced = "le=" in q
    for step, action, expect in cache_steps(grid, jms, pms, rng):
        if action is not None:
            action()
        j0, p0 = _jax_events(), M.superblock_events()
        want = jeng.query_range(q, LIVE_START, LIVE_END, STEP)
        got = peng.query_range(q, LIVE_START, LIVE_END, STEP)
        j1, p1 = _jax_events(), M.superblock_events()
        jev = {o: int(j1[o] - j0[o]) for o in j0 if j1[o] != j0[o]}
        pev = {o: p1[o] - p0[o] for o in p0 if p1[o] != p0[o]}
        assert pev == jev, step
        if not sliced:  # a le= slice never extends: it restages on overlap
            assert pev == expect, step
        elif "extend" in expect:
            assert pev == {"restage": 1}, step
        # both cold steps build (the primed JAX build reads its shards'
        # staged blocks back from their caches)
        fields = ("cache_hits", "cache_misses", "cache_extends") if step != "cold" else ()
        for f in fields + ("series_scanned", "samples_scanned"):
            assert getattr(got.stats, f) == getattr(want.stats, f), (step, f)
        if step.startswith("warm_hit") or step == "disjoint_ingest":
            assert got.stats.cache_hits == 1 and got.stats.cache_misses == 0, step
        a, b = rows(got), rows(want)
        assert a.keys() == b.keys(), step
        for k in a:
            close(a[k], b[k], f"{step} {k}")
        ha, hb = hist_rows(got), hist_rows(want)
        assert ha.keys() == hb.keys(), step
        for k in ha:
            close(ha[k][0], hb[k][0], f"{step} {k} hist")


def test_hist_extension_matches_a_fresh_build():
    """The extended histogram superblock equals one built afresh from the
    final store: ts, lens and vals bit for bit; the old block is unchanged."""
    from filodb_tpu_torch.query.promql import query_range_to_logical_plan

    rng = np.random.default_rng(4)
    jms, pms = mirrored(hist_rows_batch("regular", range(N_SERIES), range(N_SAMPLES), rng),
                        spread=SPREAD)
    eng = QueryEngine(pms, "ds", device="cpu")
    q = "sum(rate(lat[5m]))"
    plan = query_range_to_logical_plan(q, LIVE_START, LIVE_END, STEP)
    eng.query_range(q, LIVE_START, LIVE_END, STEP)
    held = eng.planner.materialize(plan).superblock(eng.context())
    held_vals, held_len = held.block.vals.clone(), int(held.block.lens[0])
    pms.ingest_routed("ds", port_batch(hist_rows_batch("regular", range(N_SERIES),
                                                       [N_SAMPLES], rng)), SPREAD)
    res = eng.query_range(q, LIVE_START, LIVE_END, STEP)
    assert res.stats.cache_extends == 1
    assert held.block.vals.equal(held_vals) and int(held.block.lens[0]) == held_len
    ext = eng.planner.materialize(plan).superblock(eng.context()).block
    assert int(ext.lens[0]) == held_len + 1
    pms._superblock_cache = ST.SuperblockCache()
    for s in pms.shard_nums("ds"):
        pms.shard("ds", s)._clear_stage_cache()
    fresh = eng.planner.materialize(plan).superblock(eng.context()).block
    for name in ("ts", "lens", "vals"):
        assert getattr(ext, name).equal(getattr(fresh, name)), name
    np.testing.assert_array_equal(ext.regular_ts, fresh.regular_ts)


def test_hist_superblock_evicts_scalar_entries():
    """A histogram superblock's bytes count its B axis: under a budget that
    holds it but not it and a scalar entry, it evicts the scalar entry
    (tests/test_fused_hist.py:449)."""
    _, pms = mirrored(
        histogram_batch(n_series=8, n_samples=200, start_ms=BASE, metric="http_request_latency"),
        counter_batch(n_series=8, n_samples=200, start_ms=BASE), shards=2, spread=1)
    eng = QueryEngine(pms, "ds", device="cpu")
    scalar_q, hist_q = "sum(rate(http_requests_total[5m]))", "sum(rate(http_request_latency[5m]))"
    eng.query_range(scalar_q, START, END, STEP)
    eng.query_range(hist_q, START, END, STEP)
    cache = pms._superblock_cache
    sizes = {e[1].is_hist: e[2] for e in cache._d.values()}
    blocks = {e[1].is_hist: e[1].block for e in cache._d.values()}
    assert sizes[True] > sizes[False]
    assert sizes[True] == ST.staged_nbytes(blocks[True])
    pms._superblock_cache = ST.SuperblockCache(max_entries=8,
                                               max_bytes=sizes[True] + sizes[False] // 2)
    eng.query_range(scalar_q, START, END, STEP)
    assert len(pms._superblock_cache) == 1
    eng.query_range(hist_q, START, END, STEP)
    entries = list(pms._superblock_cache._d.values())
    assert len(entries) == 1 and entries[0][1].is_hist


def test_warm_hist_query_is_a_hit_with_no_staging(stores):
    eng = QueryEngine(stores[1], "ds", device="cpu")
    first = eng.query_range(HQ_QUERY, START, END, STEP)
    before = (HK.RANGE_LAUNCHES, HK.FOLDED_QUANTILES)
    warm = eng.query_range(HQ_QUERY, START, END, STEP)
    assert warm.stats.cache_hits == 1 and warm.stats.cache_misses == 0
    assert warm.stats.bytes_staged == 0
    assert (HK.RANGE_LAUNCHES, HK.FOLDED_QUANTILES) == before  # CPU: the plain versions
    np.testing.assert_array_equal(warm.grids[0].values_np(), first.grids[0].values_np())


# -- schemas, records, partitions ------------------------------------------------


@pytest.mark.parametrize("name", HIST_SCHEMAS)
def test_hist_schemas_equal_jax(name):
    got, want = S.SCHEMAS[name], JS.SCHEMAS[name]
    assert got.value_column == want.value_column == "h"
    assert got.has_histogram and want.has_histogram
    assert [(c.name, c.ctype.value, c.is_counter, c.is_delta) for c in got.columns] == [
        (c.name, c.ctype.value, c.is_counter, c.is_delta) for c in want.columns]
    assert not S.PROM_COUNTER.has_histogram


def test_records_carry_bucket_les():
    jb = histogram_batch(n_series=6, n_samples=5, start_ms=BASE)
    pb = port_batch(jb)
    for got, want in zip(pb.group_by_series(), jb.group_by_series()):
        assert got.partkey == want.partkey
        np.testing.assert_array_equal(got.values["h"], want.values["h"])
        assert got.bucket_les is jb.bucket_les and want.bucket_les is jb.bucket_les
    split, jsplit = pb.shard_split(2, 4), jb.shard_split(2, 4)
    assert split.keys() == jsplit.keys()
    for s in split:
        assert split[s].bucket_les is jb.bucket_les
        np.testing.assert_array_equal(split[s].values["h"], jsplit[s].values["h"])


@pytest.mark.parametrize("window", [(0, 10**13), (BASE + 35_000, BASE + 75_000),
                                    (BASE + 10**9, BASE + 2 * 10**9)])
def test_hist_partition_reads_match_jax(stores, window):
    jms, pms = stores
    t0, t1 = window
    for s in range(N_SHARDS):
        jsh, psh = jms.shard("ds", s), pms.shard("ds", s)
        for pid, part in psh.partitions.items():
            jp = jsh.partitions[pid]
            if part.schema.name != "prom-histogram":
                continue
            for read in ("samples_in_range", "tail_samples"):
                gt, gv = getattr(part, read)(t0, t1, "h")
                wt, wv = getattr(jp, read)(t0, t1, "h")
                np.testing.assert_array_equal(gt, wt)
                np.testing.assert_array_equal(gv, wv)
                assert gv.shape == wv.shape and gv.ndim == 2
