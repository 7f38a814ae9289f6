"""Live ingest in the port against the JAX package on mirrored stores:
record batches and their shard routing, the live-edge tail read, the
shards' effect logs and staging-cache dirt, the append core
(``append_to_block`` / ``extend_superblock``, whose host mirrors must be
bit-equal to the JAX package's), the old block's immutability, and the
query engine's superblock cache through a sequence of cold query, warm hit,
revalidate, extend, restage and drop. Results agree within rtol 2e-4 /
atol 1e-4 with equal NaN masks (f32 sums taken in another order)."""

import threading

import numpy as np
import pytest
import torch

from filodb_tpu import metrics as JM
from filodb_tpu.coordinator.planner import PlannerParams as JaxParams
from filodb_tpu.coordinator.planner import QueryEngine as JaxEngine
from filodb_tpu.core import records as JR
from filodb_tpu.core import schemas as JS
from filodb_tpu.memstore import shard as JSH
from filodb_tpu.memstore.memstore import TimeSeriesMemStore as JaxMemStore
from filodb_tpu.ops import staging as JST
from filodb_tpu.query.exec.plans import QueryError as JaxQueryError
from filodb_tpu_torch import metrics as M
from filodb_tpu_torch.coordinator.planner import PlannerParams, QueryEngine
from filodb_tpu_torch.core import records as R
from filodb_tpu_torch.core import schemas as S
from filodb_tpu_torch.memstore import shard as SH
from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore, member_locks
from filodb_tpu_torch.ops import staging as ST
from filodb_tpu_torch.query.exec.plans import QueryError

BASE = 1_600_000_000_000
INTERVAL = 10_000
FAR = BASE + 10**9  # the "other" metric lives far past every query range


def tags_of(i: int, metric: str = "m") -> dict:
    return {S.METRIC_TAG: metric, "_ws_": "demo", "_ns_": "App-2", "instance": f"host-{i}",
            "zone": f"z{i % 4}"}


def batches(rows, tag_objs=None):
    """``rows`` of (series, ts, value) as a JAX and a port RecordBatch with
    the same tags objects (one per series, repeated per row)."""
    tag_objs = tag_objs if tag_objs is not None else {}
    tags = [tag_objs.setdefault(i, tags_of(i)) for i, _, _ in rows]
    ts = np.array([t for _, t, _ in rows], np.int64)
    vals = {"count": np.array([v for _, _, v in rows], np.float64)}
    return (JR.RecordBatch(JS.PROM_COUNTER, ts, vals, tags),
            R.RecordBatch(S.PROM_COUNTER, ts, vals, tags))


# -- records -------------------------------------------------------------------

RECORD_CASES = {
    "contiguous_runs": [(i, BASE + j * INTERVAL, float(j)) for i in range(5) for j in range(4)],
    "interleaved": [(i, BASE + j * INTERVAL, float(j)) for j in range(4) for i in range(5)],
    "mixed_runs": [(0, BASE, 1.0), (0, BASE + 1, 2.0), (1, BASE, 3.0), (0, BASE + 2, 4.0),
                   (2, BASE, 5.0), (1, BASE + 1, 6.0), (1, BASE + 2, 7.0)],
    "one_row": [(3, BASE, 1.0)],
}


@pytest.mark.parametrize("case", sorted(RECORD_CASES))
def test_record_batch_grouping_and_split_match_jax(case):
    jb, pb = batches(RECORD_CASES[case])
    want, got = jb.group_by_series(), pb.group_by_series()
    assert [dict(g.tags) for g in got] == [dict(w.tags) for w in want]
    for g, w in zip(got, want):
        assert g.partkey == w.partkey
        np.testing.assert_array_equal(g.timestamps, w.timestamps)
        np.testing.assert_array_equal(g.values["count"], w.values["count"])
    for spread, num_shards in ((0, 4), (1, 4), (3, 8)):
        want_split = jb.shard_split(spread, num_shards)
        got_split = pb.shard_split(spread, num_shards)
        assert sorted(got_split) == sorted(want_split)
        for s in want_split:
            np.testing.assert_array_equal(got_split[s].timestamps, want_split[s].timestamps)
            assert [dict(t) for t in got_split[s].tags] == [dict(t) for t in want_split[s].tags]


def test_ingest_routed_matches_jax():
    jms, pms = JaxMemStore(), TimeSeriesMemStore()
    jms.setup(JS.Dataset("ds"), range(4))
    pms.setup(S.Dataset("ds"), range(4))
    jb, pb = batches(RECORD_CASES["interleaved"])
    assert pms.ingest_routed("ds", pb, spread=1) == jms.ingest_routed("ds", jb, spread=1)
    for s in range(4):
        jsh, psh = jms.shard("ds", s), pms.shard("ds", s)
        assert psh.version == jsh.version
        assert sorted(p.partkey for p in psh.partitions.values()) == sorted(
            p.partkey for p in jsh.partitions.values())


# -- tail reads ----------------------------------------------------------------

TAIL_WINDOWS = {
    "in_buffer": (BASE + 12 * INTERVAL, BASE + 10**8),
    "buffer_middle": (BASE + 13 * INTERVAL + 1, BASE + 15 * INTERVAL),
    "reaches_a_chunk": (BASE + 5 * INTERVAL, BASE + 10**8),
    "past_the_end": (BASE + 100 * INTERVAL, BASE + 10**8),
    "before_the_buffer": (BASE, BASE + 3 * INTERVAL),
}


@pytest.mark.parametrize("window", sorted(TAIL_WINDOWS))
def test_tail_samples_match_jax(window):
    jsh = JSH.TimeSeriesShard("ds", 0, JSH.StoreConfig(max_chunk_size=10))
    psh = SH.TimeSeriesShard("ds", 0, SH.StoreConfig(max_chunk_size=10))
    ts = BASE + np.arange(17, dtype=np.int64) * INTERVAL
    vals = np.arange(17, dtype=np.float64)
    jsh.ingest_series(JR.SeriesBatch(JS.PROM_COUNTER, tags_of(0), ts, {"count": vals}))
    psh.ingest_series(R.SeriesBatch(S.PROM_COUNTER, tags_of(0), ts, {"count": vals}))
    t0, t1 = TAIL_WINDOWS[window]
    want = jsh.partition(0).tail_samples(t0, t1, "count")
    got = psh.partition(0).tail_samples(t0, t1, "count")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], psh.partition(0).samples_in_range(t0, t1, "count")[0])


# -- effect log and staging-cache dirt -----------------------------------------

def _series_op(i, ts, vals):
    return ("series", i, np.asarray(ts, np.int64), np.asarray(vals, np.float64))


EDGE = BASE + 50 * INTERVAL
EFFECT_SEQUENCES = {
    "disjoint_appends": [
        _series_op(0, [BASE, BASE + INTERVAL], [1, 2]), _series_op(1, [FAR], [1]),
        _series_op(1, [FAR + INTERVAL], [2]), ("batch", [(1, FAR + 2 * INTERVAL, 3.0)]),
    ],
    "overlapping_appends": [
        _series_op(0, [BASE, EDGE], [1, 2]), _series_op(1, [BASE, EDGE], [1, 2]),
        ("batch", [(0, EDGE + INTERVAL, 3.0), (1, EDGE + INTERVAL, 3.0)]),
        ("batch", [(0, EDGE + 2 * INTERVAL, 4.0)]),
    ],
    "new_series": [
        _series_op(0, [BASE, EDGE], [1, 2]), ("batch", [(0, EDGE + INTERVAL, 3.0)]),
        ("batch", [(0, EDGE + 2 * INTERVAL, 4.0), (7, EDGE + 2 * INTERVAL, 1.0)]),
        ("batch", [(0, EDGE + 3 * INTERVAL, 5.0)]),
    ],
    "more_bumps_than_the_log": [_series_op(0, [BASE], [0])] + [
        _series_op(0, [BASE + (j + 1) * INTERVAL], [j]) for j in range(SH.EFFECT_LOG_MAX + 40)],
    "out_of_order_rows_dropped": [
        _series_op(0, [BASE, EDGE], [1, 2]),
        ("batch", [(0, BASE + INTERVAL, 9.0)]),
        ("batch", [(0, BASE + 2 * INTERVAL, 9.0), (0, EDGE + INTERVAL, 3.0)]),
    ],
    "empty_series_ingest": [
        _series_op(0, [BASE, EDGE], [1, 2]), _series_op(0, [], []),
        _series_op(0, [EDGE + INTERVAL], [3]),
    ],
    "gap_series_pulled_into_range": [
        _series_op(0, [BASE - 10 * INTERVAL], [1]), _series_op(1, [EDGE], [1]),
        _series_op(0, [FAR], [2]),
    ],
    "unsorted_run": [
        _series_op(0, [BASE], [1]), _series_op(0, [EDGE, BASE + INTERVAL, BASE + 5 * INTERVAL],
                                               [4, 2, 3]),
    ],
}
RANGES = [(BASE, EDGE), (BASE, BASE + 5 * INTERVAL), (EDGE + INTERVAL, EDGE + 3 * INTERVAL),
          (FAR - 1, FAR + 10 * INTERVAL), (BASE - 20 * INTERVAL, BASE - 1)]


def _apply(jsh, psh, op, tag_objs):
    if op[0] == "series":
        _, i, ts, vals = op
        jn = jsh.ingest_series(JR.SeriesBatch(JS.PROM_COUNTER, tags_of(i), ts, {"count": vals}))
        pn = psh.ingest_series(R.SeriesBatch(S.PROM_COUNTER, tags_of(i), ts, {"count": vals}))
    else:
        jb, pb = batches(op[1], tag_objs)
        jn, pn = jsh.ingest(jb), psh.ingest(pb)
    assert pn == jn


@pytest.mark.parametrize("name", sorted(EFFECT_SEQUENCES))
def test_effect_log_and_stage_cache_dirt_match_jax(name):
    jsh, psh = JSH.TimeSeriesShard("ds", 0), SH.TimeSeriesShard("ds", 0)
    tag_objs: dict = {}
    ops = EFFECT_SEQUENCES[name]
    _apply(jsh, psh, ops[0], tag_objs)
    # cache entries over each range, inserted after the first ingest
    for lo, hi in RANGES:
        key = ((), lo, hi, "count", "prom-counter", "raw")
        jsh.stage_cache[key] = JSH.StageEntry(object(), 1)
        jsh.ledger.alloc(1)
        psh.stage_cache[key] = SH.StageEntry(object(), 1)
    for op in ops[1:]:
        _apply(jsh, psh, op, tag_objs)
    assert psh.version == jsh.version
    assert list(psh._effects) == list(jsh._effects)
    dirt = [(k, e.dirty, e.dirty_lo, e.dirty_hi) for k, e in jsh.stage_cache.items()]
    assert [(k, e.dirty, e.dirty_lo, e.dirty_hi) for k, e in psh.stage_cache.items()] == dirt
    versions = sorted(set(range(0, jsh.version + 1, 37)) | set(range(max(0, jsh.version - 6),
                                                                     jsh.version + 1)))
    for since in versions:
        for lo, hi in RANGES:
            assert psh.ingest_effects_since(since, lo, hi) == jsh.ingest_effects_since(
                since, lo, hi), (since, lo, hi)


# -- the append core -----------------------------------------------------------

N_SERIES, N_SAMPLES, N_SHARDS, SPREAD = 16, 60, 4, 1
STAGE_LO, STAGE_HI = BASE, BASE + 2_000_000  # the range reaches past the head
GRIDS = {"regular": 3_000, "jitter": 5_000}  # phase of the 10 s grid
MODES = ("raw", "shifted", "corrected")


def grid_ts(grid: str, slots, rng) -> np.ndarray:
    """Timestamps of ``slots`` on the grid: exact, or +-4 % of the interval
    around the nominal slot (every slot clear of the staging boundary)."""
    ts = BASE + GRIDS[grid] + np.asarray(slots, np.int64) * INTERVAL
    if grid == "jitter":
        ts = ts + np.rint(rng.uniform(-0.04, 0.04, ts.shape) * INTERVAL).astype(np.int64)
    return ts


def mirrored_stores(grid: str, n_series=N_SERIES, n_samples=N_SAMPLES, seed=0, other=True):
    """A JAX and a port memstore with the same counters of metric ``m``
    (a reset in every third series) and, with ``other``, a far-future
    metric ``other`` on every series' shard."""
    rng = np.random.default_rng(seed)
    jms, pms = JaxMemStore(), TimeSeriesMemStore()
    jms.setup(JS.Dataset("ds"), range(N_SHARDS))
    pms.setup(S.Dataset("ds"), range(N_SHARDS))
    rows = []
    for i in range(n_series):
        ts = grid_ts(grid, np.arange(n_samples), rng)
        vals = np.cumsum(rng.uniform(0, 10, n_samples)) + 1e9
        if i % 3 == 0:
            vals[n_samples // 2:] -= vals[n_samples // 2] - 5.0
        rows.append((tags_of(i), ts, vals))
        if other:
            rows.append((tags_of(i, "other"), np.array([FAR + i], np.int64), np.array([1.0])))
    for tags, ts, vals in rows:
        s = S.shard_for(tags, SPREAD, N_SHARDS)
        jms.shard("ds", s).ingest_series(JR.SeriesBatch(JS.PROM_COUNTER, tags, ts, {"count": vals}))
        pms.shard("ds", s).ingest_series(R.SeriesBatch(S.PROM_COUNTER, tags, ts, {"count": vals}))
    return jms, pms


def append_rows(jms, pms, rows):
    """Ingest (series, ts, value) rows into both stores, routed."""
    if not rows:
        return
    jb, pb = batches(rows)
    assert pms.ingest_routed("ds", pb, spread=SPREAD) == jms.ingest_routed("ds", jb, spread=SPREAD)


def live_rows(grid, series, slot, rng, value=None):
    """One sample per series at ``slot``; values past every staged one, or
    a reset (``value``)."""
    ts = grid_ts(grid, np.full(len(series), slot), rng)
    return [(i, int(t), value if value is not None else 2e9 + slot + i)
            for i, t in zip(series, ts)]


def selection(ms, shard_num):
    from filodb_tpu_torch.core.filters import ColumnFilter

    f = (ColumnFilter(S.METRIC_TAG, "=", "m"),)
    return ms.shard("ds", shard_num).lookup_partitions(f, STAGE_LO, STAGE_HI)


def staged_pair(jms, pms, shard_num, mode):
    """The shard's selection staged by both packages, mirrors kept."""
    pids = selection(pms, shard_num)
    jb = JST.stage_from_shard(jms.shard("ds", shard_num), pids, "count", STAGE_LO, STAGE_HI,
                              mode=mode).to_device(keep_host=True)
    pb = ST.stage_from_shard(pms.shard("ds", shard_num), pids, "count", STAGE_LO, STAGE_HI,
                             mode).to_device("cpu", keep_host=True)
    return pids, jb, pb


def superblock_pair(jms, pms, mode):
    jblocks, pblocks = [], []
    for s in range(N_SHARDS):
        pids = selection(pms, s)
        if len(pids):
            jblocks.append(JST.stage_from_shard(jms.shard("ds", s), pids, "count", STAGE_LO,
                                                STAGE_HI, mode=mode))
            pblocks.append(ST.stage_from_shard(pms.shard("ds", s), pids, "count", STAGE_LO,
                                               STAGE_HI, mode))
    return (JST.concat_blocks(jblocks).to_device(keep_host=True),
            ST.concat_blocks(pblocks).to_device("cpu", keep_host=True))


def assert_mirrors_equal(got, want):
    for name in ("h_ts", "h_vals", "h_lens", "h_raw", "h_dev"):
        w = getattr(want, name, None)
        if w is None:
            assert getattr(got, name) is None, name
        else:
            np.testing.assert_array_equal(getattr(got, name), w, err_msg=name)
    for name in ("regular_ts", "nominal_ts", "base64"):
        w = getattr(want, name, None)
        if w is None:
            assert getattr(got, name) is None, name
        else:
            np.testing.assert_array_equal(getattr(got, name), np.asarray(w), err_msg=name)
    want_cont = getattr(want, "cont", None)
    assert (got.cont is None) == (want_cont is None)
    if want_cont is not None:
        for g, w in zip(got.cont, want_cont):
            np.testing.assert_array_equal(g, w)
    assert got.maxdev_ms == want.maxdev_ms
    assert ST.grid_class(got) == JST.grid_class(want)
    for name in ("ts", "vals", "lens", "raw"):  # the new block's arrays = its mirrors
        w = getattr(want, name)
        if w is not None:
            np.testing.assert_array_equal(np.asarray(getattr(got, name)), np.asarray(w),
                                          err_msg=name)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_append_to_block_mirrors_bit_equal_to_jax(grid, mode):
    jms, pms = mirrored_stores(grid)
    rng = np.random.default_rng(5)
    shard_num = next(s for s in range(N_SHARDS) if len(selection(pms, s)) > 1)
    pids, jb, pb = staged_pair(jms, pms, shard_num, mode)
    series = list(range(N_SERIES))
    # two rounds: a plain append, then one with a counter reset in it
    for slot, value in ((N_SAMPLES, None), (N_SAMPLES + 1, 7.0)):
        append_rows(jms, pms, live_rows(grid, series, slot, rng, value))
        jb = JST.append_to_block(jms.shard("ds", shard_num), jb, pids, "count", STAGE_HI, mode)
        pb = ST.append_to_block(pms.shard("ds", shard_num), pb, pids, "count", STAGE_HI, mode)
        assert jb is not None and pb is not None
        assert int(pb.h_lens[0]) == slot + 1
        assert_mirrors_equal(pb, jb)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_extend_superblock_mirrors_bit_equal_to_jax(grid, mode):
    jms, pms = mirrored_stores(grid)
    rng = np.random.default_rng(6)
    jb, pb = superblock_pair(jms, pms, mode)
    series = list(range(N_SERIES))
    append_rows(jms, pms, live_rows(grid, series, N_SAMPLES, rng)
                + live_rows(grid, series, N_SAMPLES + 1, rng))
    jb = JST.extend_superblock(jms, "ds", jb, "count", STAGE_HI, mode)
    pb = ST.extend_superblock(pms, "ds", pb, "count", STAGE_HI, mode)
    assert jb is not None and pb is not None and int(pb.h_lens[0]) == N_SAMPLES + 2
    assert_mirrors_equal(pb, jb)


def _nonuniform(grid, rng):
    return live_rows(grid, range(N_SERIES // 2), N_SAMPLES, rng)


def _width(grid, rng):
    return [r for slot in range(N_SAMPLES, N_SAMPLES + 330)
            for r in live_rows(grid, range(N_SERIES), slot, rng)]


def _regular_torn(grid, rng):
    rows = live_rows(grid, range(N_SERIES), N_SAMPLES, rng)
    return [(i, t + (7 if i == 3 else 0), v) for i, t, v in rows]


def _nothing(grid, rng):
    return []


DECLINES = {
    "non_uniform_counts": (_nonuniform, "corrected"),
    "padded_width_exhausted": (_width, "corrected"),
    "regular_grid_torn": (_regular_torn, "raw"),
    "diff_mode": (lambda g, rng: live_rows(g, range(N_SERIES), N_SAMPLES, rng), "diff"),
    "nothing_new": (_nothing, "shifted"),
}


@pytest.mark.parametrize("case", sorted(DECLINES))
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_extension_declines_as_jax_does(grid, case):
    make_rows, mode = DECLINES[case]
    jms, pms = mirrored_stores(grid)
    jb, pb = superblock_pair(jms, pms, mode)
    append_rows(jms, pms, make_rows(grid, np.random.default_rng(7)))
    jnb = JST.extend_superblock(jms, "ds", jb, "count", STAGE_HI, mode)
    pnb = ST.extend_superblock(pms, "ds", pb, "count", STAGE_HI, mode)
    if jnb is None:
        assert pnb is None
    else:
        assert (pnb is pb) == (jnb is jb)
        assert_mirrors_equal(pnb, jnb)
    assert_mirrors_equal(pb, jb)


def test_irregular_block_is_not_extended():
    jms, pms = mirrored_stores("regular")
    rng = np.random.default_rng(8)
    append_rows(jms, pms, live_rows("regular", range(N_SERIES // 2), N_SAMPLES, rng))
    jb, pb = superblock_pair(jms, pms, "raw")
    # half the series one sample longer: the missed-scrape grid in both
    # packages, which neither extends
    assert ST.grid_class(pb) == JST.grid_class(jb) == "holes"
    append_rows(jms, pms, live_rows("regular", range(N_SERIES), N_SAMPLES + 1, rng))
    assert JST.extend_superblock(jms, "ds", jb, "count", STAGE_HI, "raw") is None
    assert ST.extend_superblock(pms, "ds", pb, "count", STAGE_HI, "raw") is None


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_extension_never_writes_the_old_block(grid, mode):
    """The old block's tensors stay as they were (on the CPU the mirrors
    must not alias them), and the new block's equal a fresh upload of its
    mirrors."""
    _, pms = mirrored_stores(grid)
    rng = np.random.default_rng(9)
    blocks = []
    for s in range(N_SHARDS):
        pids = selection(pms, s)
        if len(pids):
            blocks.append(ST.stage_from_shard(pms.shard("ds", s), pids, "count", STAGE_LO,
                                              STAGE_HI, mode))
    old = ST.concat_blocks(blocks).to_device("cpu", keep_host=True)
    arrays = ("ts", "vals", "lens", "raw", "baseline")
    before = {k: getattr(old, k).clone() for k in arrays if getattr(old, k) is not None}
    rows = live_rows(grid, range(N_SERIES), N_SAMPLES, rng)
    jb, pb = batches(rows)
    pms.ingest_routed("ds", pb, spread=SPREAD)
    new = ST.extend_superblock(pms, "ds", old, "count", STAGE_HI, mode)
    assert new is not None and new is not old
    for k, v in before.items():
        assert torch.equal(getattr(old, k), v), k
    assert int(old.lens[0]) == N_SAMPLES and int(new.lens[0]) == N_SAMPLES + 1
    fresh = {"ts": new.h_ts, "vals": new.h_vals, "lens": new.h_lens, "raw": new.h_raw}
    for k, mirror in fresh.items():
        if mirror is not None:
            assert torch.equal(getattr(new, k), torch.from_numpy(mirror)), k
    for name in ("h_ts", "h_vals", "h_raw"):
        mirror = getattr(new, name)
        if mirror is not None:
            assert not np.shares_memory(mirror, getattr(old, name[2:]).numpy()), name


# -- the engine sequence -------------------------------------------------------

START_S = (BASE + 400_000) / 1000
END_S = (BASE + (N_SAMPLES + 400) * INTERVAL) / 1000  # past the head: the live edge
STEP_S = 60
ENGINE_QUERIES = [
    "sum(rate(m[5m]))",
    "max by (zone) (delta(m[5m]))",
    "avg by (zone) (max_over_time(m[5m]))",
    "sum(sum_over_time(m[2m]))",
]


def _jax_events() -> dict:
    return {o: JM.REGISTRY.counter("filodb_superblock_maintenance", outcome=o).value
            for o in M.SUPERBLOCK_OUTCOMES}


CACHE_FIELDS = ("cache_hits", "cache_misses", "cache_extends")


def engine_steps(grid, jms, pms, rng):
    """(step name, ingest action) of the sequence; each action ingests the
    same records into both stores."""
    m = [N_SAMPLES]  # the head slot of every series

    def append_all():
        append_rows(jms, pms, live_rows(grid, range(N_SERIES), m[0], rng))
        m[0] += 1

    def disjoint():
        jb, pb = batches([(i, FAR + 100 + i, 2.0) for i in range(N_SERIES)],
                         {i: tags_of(i, "other") for i in range(N_SERIES)})
        assert pms.ingest_routed("ds", pb, SPREAD) == jms.ingest_routed("ds", jb, SPREAD)

    def half():
        append_rows(jms, pms, live_rows(grid, range(N_SERIES // 2), m[0], rng))

    def other_half():
        append_rows(jms, pms, live_rows(grid, range(N_SERIES // 2, N_SERIES), m[0], rng))
        m[0] += 1

    def new_series():
        ts = grid_ts(grid, np.arange(m[0]), rng)
        vals = np.cumsum(rng.uniform(0, 10, m[0])) + 1e9
        tags = tags_of(N_SERIES)
        s = S.shard_for(tags, SPREAD, N_SHARDS)
        jms.shard("ds", s).ingest_series(JR.SeriesBatch(JS.PROM_COUNTER, tags, ts, {"count": vals}))
        pms.shard("ds", s).ingest_series(R.SeriesBatch(S.PROM_COUNTER, tags, ts, {"count": vals}))

    def width():
        # past the staged width: the staged samples and 256 columns of
        # headroom pad to 384
        rows = [r for slot in range(m[0], m[0] + 400)
                for r in live_rows(grid, range(N_SERIES + 1), slot, rng)]
        append_rows(jms, pms, rows)
        m[0] += 400

    def truncate():
        tags = tags_of(0, "other")
        s = S.shard_for(tags, SPREAD, N_SHARDS)
        for j in range(SH.EFFECT_LOG_MAX + 8):
            ts, v = np.array([FAR + 10**6 + j], np.int64), {"count": np.array([3.0])}
            jms.shard("ds", s).ingest_series(JR.SeriesBatch(JS.PROM_COUNTER, tags, ts, v))
            pms.shard("ds", s).ingest_series(R.SeriesBatch(S.PROM_COUNTER, tags, ts, v))

    return [
        ("cold", None, {"cache_misses": 1}),
        ("warm_hit", None, {}),
        ("disjoint_ingest", disjoint, {"revalidate": 1}),
        ("live_edge_append", append_all, {"extend": 1}),
        ("non_uniform_append", half, {"restage": 1}),
        ("catch_up_on_irregular_block", other_half, {"restage": 1}),
        ("new_series", new_series, {"restage": 1}),
        ("width_exhausted", width, {"restage": 1}),
        ("log_truncated", truncate, {"restage": 1}),
        ("warm_hit_after", None, {}),
    ]


def rows_of(res):
    assert len(res.grids) == 1
    g = res.grids[0]
    return g.labels, g.values_np()


@pytest.mark.parametrize("query", ENGINE_QUERIES)
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_engine_cache_sequence_matches_jax(grid, query):
    jms, pms = mirrored_stores(grid)
    jeng, peng = JaxEngine(jms, "ds"), QueryEngine(pms, "ds", device="cpu")
    rng = np.random.default_rng(11)
    for step, action, expect in engine_steps(grid, jms, pms, rng):
        if action is not None:
            action()
        j0, p0 = _jax_events(), M.superblock_events()
        want = jeng.query_range(query, START_S, END_S, STEP_S)
        got = peng.query_range(query, START_S, END_S, STEP_S)
        j1, p1 = _jax_events(), M.superblock_events()
        jev = {o: int(j1[o] - j0[o]) for o in j0 if j1[o] != j0[o]}
        pev = {o: p1[o] - p0[o] for o in p0 if p1[o] != p0[o]}
        assert pev == jev, step
        assert pev == {k: v for k, v in expect.items() if k in M.SUPERBLOCK_OUTCOMES}, step
        assert [getattr(got.stats, f) for f in CACHE_FIELDS] == [
            getattr(want.stats, f) for f in CACHE_FIELDS], step
        if step in ("warm_hit", "warm_hit_after", "disjoint_ingest"):
            assert got.stats.cache_hits == 1 and got.stats.cache_misses == 0, step
        if step == "live_edge_append":
            assert got.stats.cache_extends == 1, step
        assert got.stats.series_scanned == want.stats.series_scanned, step
        assert got.stats.samples_scanned == want.stats.samples_scanned, step
        want_labels, w = rows_of(want)
        got_labels, g = rows_of(got)
        assert got_labels == want_labels, step
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=step)
        mask = ~np.isnan(w)
        assert mask.any(), step
        np.testing.assert_allclose(g[mask], w[mask], rtol=2e-4, atol=1e-4, err_msg=step)


def test_cached_superblock_respects_limits():
    """Per-request limits hold on a superblock-cache hit, as on a build."""
    jms, pms = mirrored_stores("regular", other=False)
    q = "sum(rate(m[5m]))"
    QueryEngine(pms, "ds", device="cpu").query_range(q, START_S, END_S, STEP_S)
    JaxEngine(jms, "ds").query_range(q, START_S, END_S, STEP_S)
    limited = QueryEngine(pms, "ds", PlannerParams(max_series=1), device="cpu")
    with pytest.raises(QueryError, match="limit"):
        limited.query_range(q, START_S, END_S, STEP_S)
    with pytest.raises(JaxQueryError, match="limit"):
        JaxEngine(jms, "ds", JaxParams(max_series=1)).query_range(q, START_S, END_S, STEP_S)


def test_routed_batch_is_read_whole_under_member_locks():
    """A reader holding the member shards' locks never sees part of a
    routed batch: every series has the same number of samples."""
    _, pms = mirrored_stores("regular", other=False)
    shards = [pms.shard("ds", s) for s in range(N_SHARDS)]
    stop, seen = threading.Event(), set()

    def reader():
        while not stop.is_set():
            with member_locks(shards):
                seen.add(frozenset(p._buf_len + sum(c.n for c in p.chunks)
                                   for sh in shards for p in sh.partitions.values()))

    th = threading.Thread(target=reader)
    th.start()
    try:
        rng = np.random.default_rng(12)
        for slot in range(N_SAMPLES, N_SAMPLES + 20):
            _, pb = batches(live_rows("regular", range(N_SERIES), slot, rng))
            pms.ingest_routed("ds", pb, spread=SPREAD)
    finally:
        stop.set()
        th.join(timeout=60)
    assert not th.is_alive()
    assert seen and all(len(s) == 1 for s in seen), seen
