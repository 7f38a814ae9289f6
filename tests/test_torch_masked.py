"""The port's missed-scrape grid against the JAX package's on the same numpy
inputs: the ``holes`` class, ``MaskedGrid`` field by field (per-shard
staging, the superblock's concatenation, re-staged subquery rows),
``_snap_slots``, ``masked_fills`` and ``harmonize_masked``; the sidecar's
planes on a device copy and in the caches' byte count, the sidecar a
shard's host block leaves to its device copy; the masked rung's plain
versions (``masked_range_plain``, ``masked_minmax_plain``) through the
tree's entry against the JAX package's, its fused aggregate against
``_fused_dispatch`` (``_fused_masked_jit``), its decline; the engine end to
end on a holey store (fused, epilogues, tree, subqueries) against the JAX
engine, and a holey superblock restaged, not extended, under live ingest.

Tolerance rtol 2e-4 / atol 1e-4; NaN masks equal."""

import functools

import numpy as np
import pytest
import torch

from filodb_tpu.coordinator.planner import QueryEngine as JaxEngine
from filodb_tpu.ops import aggregations as JAGG
from filodb_tpu.ops import kernels as JK
from filodb_tpu.ops import mxu_jitter as JMJ
from filodb_tpu.ops import staging as JST
from filodb_tpu_torch.coordinator.planner import QueryEngine
from filodb_tpu_torch.core import schemas as S
from filodb_tpu_torch.core.records import SeriesBatch
from filodb_tpu_torch.ops import aggregations as AGG
from filodb_tpu_torch.ops import kernels as K
from filodb_tpu_torch.ops import mxu_jitter as JR
from filodb_tpu_torch.ops import staging as ST
from filodb_tpu_torch.ops.kernels import RangeParams, pad_steps
from tests.test_torch_jitter import (BASE, MOMENTS, N_SHARDS, QUERY_GRIDS, SPREAD, STAGINGS,
                                     assert_close, assert_rows, by_labels, mirrored_stores,
                                     moments_oracle, near_regular, near_regular_data,
                                     tree_pair)

NUM_STEPS = 18
START_S, END_S, STEP_S = (BASE + 400_000) / 1000, (BASE + 1_300_000) / 1000, 60
FIELDS = ("valid", "vals", "dev", "raw", "ffv", "ffd", "bfv", "bfd", "ff2v", "ff2d", "bfraw",
          "cc")


@functools.lru_cache(maxsize=None)
def staged(staging: str, seed: int = 0):
    """(JAX block, port host block, is_counter, is_delta) of holey series."""
    flags, counter, delta = STAGINGS[staging]
    series = near_regular(seed=seed, holes=True, counter=counter and not delta)
    jb = JST.stage_series(series, BASE, **flags)
    pb = ST.stage_series(series, BASE, **flags)
    assert JST.grid_class(jb) == ST.grid_class(pb) == "holes"
    return jb, pb, counter, delta


def assert_same_grid(got, want):
    for name in ("nominal_ts", "n_valid", "interval_ms", "maxdev_ms"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    for name in FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if w is not None:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("staging", sorted(STAGINGS))
def test_masked_grid_matches_jax(staging):
    jb, pb, _, _ = staged(staging)
    assert_same_grid(pb.mgrid, jb.mgrid)


def test_snap_slots_and_fills_match_jax():
    series = near_regular(seed=2, holes=True)
    want, got = JST._snap_slots(series), ST._snap_slots(series)
    assert got[:2] == want[:2]
    for g, w in zip(got[2], want[2]):
        np.testing.assert_array_equal(g, w)
    g = JST.stage_series(series, BASE).mgrid
    R = np.asarray(g.nominal_ts, np.int64)
    for a, b in zip(ST.masked_fills(g.valid, g.vals, g.dev, g.raw, R),
                    JST.masked_fills(g.valid, g.vals, g.dev, g.raw, R)):
        assert (a is None) == (b is None)
        if b is not None:
            np.testing.assert_array_equal(a, b)


def test_not_near_regular_is_not_holes():
    """Irregular scrapes and too many holes: no masked grid, as in JAX."""
    rng = np.random.default_rng(1)
    irregular = [(BASE + np.cumsum(rng.integers(5_000, 15_001, 80)), rng.standard_normal(80))
                 for _ in range(5)]
    nominal = BASE + np.arange(80, dtype=np.int64) * 10_000
    sparse = [(np.delete(nominal, np.arange(3 + i, 80, 7)), rng.standard_normal(80 - 11))
              for i in range(5)]
    for series in (irregular, sparse):
        assert JST.stage_series(series, BASE).mgrid is None
        assert ST.grid_class(ST.stage_series(series, BASE)) == "irregular"


def test_concat_and_restaged_rows_build_the_jax_grid():
    """The superblock's concatenation snaps all rows onto one slot grid, and
    a subquery's re-staged step rows with NaN steps build the grid that
    ``stage_series`` builds, as in the JAX package: each built once, by
    the block's device copy."""
    a, b = near_regular(seed=4, holes=True), near_regular(seed=5, holes=True)
    jblocks = [JST.stage_series(s, BASE) for s in (a, b)]
    pblocks = [ST.stage_series(s, BASE) for s in (a, b)]
    superblock = ST.concat_blocks(pblocks)
    assert superblock.mgrid is None and superblock.mgrid_deferred  # built by its device copy
    assert_same_grid(superblock.to_device("cpu").mgrid, JST.concat_blocks(jblocks).mgrid)
    rng = np.random.default_rng(6)
    times = BASE + 60_000 * np.arange(1, 41, dtype=np.int64)
    v = rng.uniform(0, 5, (7, 40)).astype(np.float32)
    for i in range(7):
        v[i, 3 + 4 * i] = np.nan
    got = ST.device_copy(ST.stage_step_rows(v, times, BASE), "cpu")
    want = JST.stage_series([(times[~np.isnan(r)], r[~np.isnan(r)].astype(np.float64))
                             for r in v], BASE)
    assert ST.grid_class(got) == JST.grid_class(want) == "holes"
    assert_same_grid(got.mgrid, want.mgrid)


def test_harmonize_masked_matches_jax():
    """Blocks staged apart rebuilt on one common grid, as the JAX package's
    ``harmonize_masked`` rebuilds them; a regular member snaps on too."""
    sets = [near_regular(seed=7, holes=True), near_regular(seed=8, holes=True)]
    jblocks = [JST.stage_series(s, BASE) for s in sets]
    pblocks = [ST.stage_series(s, BASE) for s in sets]
    assert JST.harmonize_masked(jblocks) == ST.harmonize_masked(pblocks) is True
    for p, j in zip(pblocks, jblocks):
        assert_same_grid(p.mgrid, j.mgrid)
    rng = np.random.default_rng(9)
    irregular = [(BASE + np.cumsum(rng.integers(5_000, 15_001, 30)), np.ones(30))
                 for _ in range(3)]
    assert ST.harmonize_masked([ST.stage_series(irregular, BASE)]) is False
    assert JST.harmonize_masked([JST.stage_series(irregular, BASE)]) is False


def test_device_copy_holds_the_kernel_planes_and_counts_them():
    """The sidecar holds ``MASKED_PLANES`` alone, as tensors where it was
    built; a device copy on that device shares them (no copy); the caches'
    byte count includes them."""
    _, pb, _, _ = staged("corrected")
    dev = ST.device_copy(pb, "cpu")
    assert ST.grid_class(dev) == "holes"
    for name in ST.MASKED_PLANES:
        assert isinstance(getattr(pb.mgrid, name), torch.Tensor), name
        assert getattr(dev.mgrid, name) is getattr(pb.mgrid, name), name
    planes = sum(getattr(pb.mgrid, f).nbytes for f in ST.MASKED_PLANES)
    bare = sum(np.asarray(a).nbytes for a in (pb.ts, pb.vals, pb.raw, pb.baseline, pb.lens))
    assert ST.staged_nbytes(pb) == bare + planes
    assert ST.staged_nbytes(dev) == bare + planes


@pytest.mark.parametrize("staging", sorted(STAGINGS))
def test_deferred_sidecar_is_built_by_the_device_copy(staging):
    """A host block staged with ``sidecar=False`` (a shard's, in the
    planner's cache) holds no sidecar and counts none; its device copy
    builds the one ``stage_series`` builds, and so does ``to_device``."""
    flags, counter, delta = STAGINGS[staging]
    series = near_regular(seed=0, holes=True, counter=counter and not delta)
    eager = ST.stage_series(series, BASE, **flags)
    lazy = ST.stage_series(series, BASE, sidecar=False, **flags)
    assert lazy.mgrid is None and lazy.mgrid_deferred and ST.grid_class(lazy) == "irregular"
    assert ST.staged_nbytes(lazy) + eager.mgrid.nbytes() == ST.staged_nbytes(eager)
    dev = ST.device_copy(lazy, "cpu")
    assert ST.grid_class(dev) == "holes" and lazy.mgrid is None
    assert_same_grid(dev.mgrid, eager.mgrid)
    assert_same_grid(lazy.to_device("cpu").mgrid, eager.mgrid)


@pytest.mark.parametrize("grid", sorted(QUERY_GRIDS))
def test_window_matrices_match_jax(grid):
    jb, pb, _, _ = staged("gauge")
    dev = ST.device_copy(pb, "cpu")
    start, step, window = QUERY_GRIDS[grid]
    if grid == "narrow":  # just past twice the masked grid's own bound
        window = 2 * pb.mgrid.maxdev_ms + 100
    want = JMJ.masked_window_matrices(jb, start, step, pad_steps(NUM_STEPS), window)
    got = JR.masked_window_matrices(dev, start, step, pad_steps(NUM_STEPS), window)
    assert got.ok == want.ok is True
    for name in ("count0", "c0pos", "has_klo", "has_khi", "F0_rel", "L0_rel", "Klo_rel",
                 "Khi_rel", "blo_rel", "ehi_rel", "idx", "clo", "chi"):
        np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)),
                                      err_msg=name)


PLAIN_CASES = [(f, s) for f in sorted(JR.JITTER_FUNCS) for s in sorted(STAGINGS)
               if f not in MOMENTS or s == "gauge"]


@pytest.mark.parametrize("grid", sorted(QUERY_GRIDS))
@pytest.mark.parametrize("func,staging", PLAIN_CASES)
def test_masked_plain_matches_jax(func, staging, grid):
    """The tree's entry on a ``holes`` block (the masked store mode's plain
    version, ``masked_minmax_plain``; irate/idelta of delta counters on the
    general rung) against the JAX package's (its lean gather plan on the
    CPU); the moments on gauges (ROADMAP C), by the JAX-or-oracle rule."""
    jb, pb, counter, delta = staged(staging)
    dev = ST.device_copy(pb, "cpu")
    start, step, window = QUERY_GRIDS[grid]
    if grid == "narrow":  # just past twice the masked grid's own bound
        window = 2 * pb.mgrid.maxdev_ms + 100
    got, want = tree_pair(func, jb, dev, start, step, window, counter, delta)
    n = pb.n_series
    what = f"{func} {staging} {grid}"
    if func in MOMENTS:  # by the JAX-or-oracle rule, as on the jitter rung
        from tests.test_torch_general import assert_jax_or_oracle

        exact, count = moments_oracle(func, pb, start, step, window)
        assert_jax_or_oracle(got[:n, :NUM_STEPS], want[:n, :NUM_STEPS], exact, count, what)
    else:
        assert_close(got[:n, :NUM_STEPS], want[:n, :NUM_STEPS], what)


@pytest.mark.parametrize("op", ["sum", "count", "avg", "min", "max"])
@pytest.mark.parametrize("func", sorted(AGG.FUSED_JITTER_FUNCS))
def test_masked_aggregate_matches_fused_masked(func, op):
    """``masked_range_aggregate`` on the CPU against the JAX package's fused
    masked dispatch (``_fused_masked_jit``, ``_fused_masked_minmax_jit``)."""
    staging = {"rate": "corrected", "increase": "corrected", "irate": "corrected",
               "idelta": "diff", "delta": "shifted"}.get(func, "gauge")
    jb, pb, counter, delta = staged(staging, seed=1)
    dev = ST.device_copy(pb, "cpu")
    G = 3
    gids = np.full(pb.vals.shape[0], G, np.int64)
    gids[: pb.n_series] = np.arange(pb.n_series) % G
    params = (BASE + 400_000, 60_000, NUM_STEPS, 300_000)
    want = JAGG.fused_range_aggregate(func, op, jb, gids.astype(np.int32), G,
                                      JK.RangeParams(*params), is_counter=counter,
                                      is_delta=delta)
    got = JR.masked_range_aggregate(func, op, dev, torch.from_numpy(gids), G,
                                    RangeParams(*params), is_counter=counter, is_delta=delta)
    what = f"{op}({func})"
    if func in MOMENTS and staging != "gauge":
        return
    assert_close(got.numpy()[:, :NUM_STEPS], np.asarray(want)[:, :NUM_STEPS], what)


def test_masked_rung_declines_as_jax():
    jb, pb, _, _ = staged("gauge")
    dev = ST.device_copy(pb, "cpu")
    md = pb.mgrid.maxdev_ms
    assert md == jb.mgrid.maxdev_ms
    for window in (2 * md, 2 * md + 1):
        ok = JMJ.masked_window_matrices(jb, 400_000, 60_000, 32, window).ok
        assert JR.masked_window_matrices(dev, 400_000, 60_000, 32, window).ok == ok
        assert AGG.grid_variant(dev, "rate", False, window) == ("masked" if ok else
                                                                  "window_stats")
        params = RangeParams(BASE + 400_000, 60_000, 10, window)
        assert K.tree_rung("min_over_time", dev, params) == ("masked" if ok else "window_stats")


# -- the engine end to end ------------------------------------------------------------


@pytest.fixture(scope="module")
def engines():
    jms, pms = mirrored_stores(near_regular_data(holes=True, seed=11))
    return JaxEngine(jms, "prometheus"), QueryEngine(pms, "prometheus", device="cpu")


ENGINE_QUERIES = [
    ("sum(rate(http_requests_total[5m]))", "masked"),
    ("sum by (zone) (increase(http_requests_total[5m]))", "masked"),
    ("min by (zone) (max_over_time(node_temp[5m]))", "masked"),
    ("sum(min_over_time(node_temp[5m]))", "masked"),
    ("avg by (zone) (irate(http_requests_total[5m]))", "masked"),
    ("count(count_over_time(node_temp[5m]))", "masked"),
    ("sum by (zone) (resets(http_requests_total[5m]))", "general"),
    ("bottomk(3, rate(http_requests_total[5m]))", "masked"),
    ("quantile by (zone) (0.9, avg_over_time(node_temp[5m]))", "masked"),
    ("rate(http_requests_total[5m])", "masked"),
    ("last_over_time(node_temp[5m])", "masked"),
    ("first_over_time(node_temp[5m])", "masked"),
    ("deriv(node_temp[5m])", "general"),
    ("min_over_time(rate(http_requests_total[5m])[10m:1m])", None),
    ("sum(rate(http_requests_total[900ms]))", "window_stats"),
]


@pytest.mark.parametrize("query,rung", ENGINE_QUERIES, ids=[q for q, _ in ENGINE_QUERIES])
def test_engine_matches_jax_on_a_holey_store(engines, query, rung):
    """Fused aggregates, epilogues, tree leaves and a subquery over a store
    with missed scrapes, each on the JAX ladder's rung."""
    jax_engine, port_engine = engines
    want = jax_engine.query_range(query, START_S, END_S, STEP_S)
    got = port_engine.query_range(query, START_S, END_S, STEP_S)
    if rung is not None:
        assert set(got.stats.rungs) == {rung}, got.stats.rungs
    assert_rows(by_labels(got), by_labels(want), query,
                oracle_funcs=("deriv",) if "deriv" in query else ())


def test_holey_superblock_restages_under_live_ingest():
    """A live-edge append to a holey superblock is not an extension (the
    JAX package's ``_append_to_parts`` declines masked blocks): the next
    query restages, answers on the masked rung and equals the JAX
    engine's."""
    data = near_regular_data(n=120, holes=True, seed=12)
    jms, pms = mirrored_stores(data)
    jax_engine, engine = JaxEngine(jms, "prometheus"), QueryEngine(pms, "prometheus",
                                                                   device="cpu")
    q = "sum(rate(http_requests_total[5m]))"
    end = (BASE + 1_400_000) / 1000
    first = engine.query_range(q, START_S, end, STEP_S)
    assert first.stats.rungs == {"masked": 1}
    from filodb_tpu.core import schemas as JS
    from filodb_tpu.core.records import SeriesBatch as JaxSeriesBatch

    for tags, schema, ts, vals in data:
        if schema != "prom-counter":
            continue
        t, v = np.array([BASE + 5_000 + 120 * 10_000 + 37]), np.array([vals[-1] + 5.0])
        shard = S.shard_for(tags, SPREAD, N_SHARDS)
        pms.shard("prometheus", shard).ingest_series(
            SeriesBatch(S.PROM_COUNTER, tags, t, {"count": v}))
        jms.shard("prometheus", shard).ingest_series(
            JaxSeriesBatch(JS.PROM_COUNTER, tags, t, {"count": v}))
    got = engine.query_range(q, START_S, end, STEP_S)
    assert got.stats.cache_extends == 0 and got.stats.cache_misses >= 1
    assert got.stats.rungs == {"masked": 1}
    want = jax_engine.query_range(q, START_S, end, STEP_S)
    assert_rows(by_labels(got), by_labels(want), q)
