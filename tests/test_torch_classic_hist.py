"""Classic-bucket ``histogram_quantile`` (A1) in the port against the JAX
package: ``histogram_quantile(q, sum by (le[, ...]) (rate(m_bucket[5m])))``
over ``le``-labelled counter series with two bucket schemes, on irregular
and regular scrapes, through both QueryEngines (the JAX package's fused
aggregate plus its classic fold; the port's fused aggregate plus one
standalone-quantile launch per scheme); the pivot itself
(``classic_histogram_quantile``) against the JAX function on the same rows,
``le`` spellings and schemes; one gather per scheme; the pivot memoized
on the superblock.

Group labels must be equal (the groups in the order they first appear),
NaN masks equal, values within rtol 2e-4 / atol 1e-4 (tests/test_pallas.py's
tolerance; the interpolation's multiply-add may be fused by XLA on the
CPU)."""

import numpy as np
import pytest
import torch

from filodb_tpu.coordinator.planner import QueryEngine as JaxEngine
from filodb_tpu.core import schemas as JS
from filodb_tpu.core.records import SeriesBatch as JaxSeriesBatch
from filodb_tpu.memstore.memstore import TimeSeriesMemStore as JaxMemStore
from filodb_tpu.query.exec.transformers import QueryError as JaxQueryError
from filodb_tpu.query.exec.transformers import classic_histogram_quantile as jax_classic
from filodb_tpu_torch.coordinator.planner import QueryEngine
from filodb_tpu_torch.core import schemas as S
from filodb_tpu_torch.core.records import SeriesBatch
from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore
from filodb_tpu_torch.ops import hist_kernels as HK
from filodb_tpu_torch.query.exec import transformers as T

BASE = 1_600_000_000_000
N_SAMPLES, N_SHARDS, SPREAD = 120, 4, 1
START_S = (BASE + 400_000) / 1000
END_S = (BASE + 1_100_000) / 1000
STEP_S = 60
RTOL, ATOL = 2e-4, 1e-4
SCHEMES = {"api": ["0.1", "0.5", "1", "+Inf"], "db": ["0.05", "0.25", "1", "5", "Inf"]}


def classic_data(grid: str, seed: int = 0):
    """(tags, ts, values) of cumulative bucket counters: per job its scheme,
    four instances in two zones; counts grow by Poisson increments per
    bucket, cumulative over the buckets and in time."""
    rng = np.random.default_rng(seed)
    out = []
    for job, les in SCHEMES.items():
        for i in range(4):
            if grid == "irregular":
                ts = BASE + np.cumsum(rng.integers(5_000, 15_001, N_SAMPLES)).astype(np.int64)
            else:
                ts = BASE + 5_000 + np.arange(N_SAMPLES, dtype=np.int64) * 10_000
            incr = rng.poisson(2.0, (N_SAMPLES, len(les))).astype(np.float64)
            counts = np.cumsum(np.cumsum(incr, axis=1), axis=0)
            for b, le in enumerate(les):
                tags = {S.METRIC_TAG: "rpc_latency_bucket", "_ws_": "demo", "_ns_": "App-2",
                        "job": job, "instance": f"{job}-{i}", "zone": f"z{i % 2}", "le": le}
                out.append((tags, ts, counts[:, b]))
    return out


def build_stores(data):
    jms, pms = JaxMemStore(), TimeSeriesMemStore()
    jms.setup(JS.Dataset("prometheus"), range(N_SHARDS))
    pms.setup(S.Dataset("prometheus"), range(N_SHARDS))
    for tags, ts, vals in data:
        shard = S.shard_for(tags, SPREAD, N_SHARDS)
        jms.shard("prometheus", shard).ingest_series(JaxSeriesBatch(
            schema=JS.SCHEMAS["prom-counter"], tags=tags, timestamps=ts, values={"count": vals}))
        pms.shard("prometheus", shard).ingest_series(SeriesBatch(
            schema=S.SCHEMAS["prom-counter"], tags=tags, timestamps=ts, values={"count": vals}))
    return jms, pms


@pytest.fixture(scope="module")
def stores():
    return {grid: build_stores(classic_data(grid)) for grid in ("irregular", "regular")}


def rows(res):
    assert len(res.grids) == 1
    g = res.grids[0]
    return g.labels, g.values_np()


QUERIES = [
    "histogram_quantile(0.9, sum by (le) (rate(rpc_latency_bucket[5m])))",
    "histogram_quantile(0.5, sum by (le, job) (rate(rpc_latency_bucket[5m])))",
    "histogram_quantile(0.99, sum by (le, job, zone) (rate(rpc_latency_bucket[5m])))",
    "histogram_quantile(0.25, sum by (job, le) (increase(rpc_latency_bucket[5m])))",
    "histogram_quantile(0, sum by (le, job) (rate(rpc_latency_bucket[5m])))",
    "histogram_quantile(1, sum by (le, zone) (rate(rpc_latency_bucket[5m])))",
    "histogram_quantile(-0.1, sum by (le) (rate(rpc_latency_bucket[5m])))",
    "histogram_quantile(1.1, sum by (le) (rate(rpc_latency_bucket[5m])))",
    "histogram_quantile(0.75, sum by (le, job) (rate(rpc_latency_bucket[5m] offset 2m)))",
    "histogram_quantile(0.9, sum by (le) (rate(rpc_latency_bucket{job=\"db\"}[2m])))",
]


@pytest.mark.parametrize("grid", ["irregular", "regular"])
@pytest.mark.parametrize("query", QUERIES)
def test_classic_quantile_matches_jax(stores, query, grid):
    jms, pms = stores[grid]
    want_labels, want = rows(JaxEngine(jms, "prometheus").query_range(query, START_S, END_S,
                                                                       STEP_S))
    got_labels, got = rows(QueryEngine(pms, "prometheus", device="cpu").query_range(
        query, START_S, END_S, STEP_S))
    assert got_labels == want_labels
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    m = ~np.isnan(want)
    assert m.any()
    np.testing.assert_allclose(got[m], want[m], rtol=RTOL, atol=ATOL)


def test_classic_quantile_gathers_once_per_scheme(monkeypatch):
    """The by-(le, job) aggregate is one launch of the rung; its fold one
    gather per bucket scheme (two here), one for by (le) (one scheme: the
    union of both jobs' le values, "+Inf" and "Inf" two rows of one bound,
    as in the JAX pivot); the pivot is memoized on the superblock and
    reused by the next query."""
    _, pms = build_stores(classic_data("regular", seed=1))
    calls = []
    real = HK.histogram_quantile_gather

    def counted(*a, **k):
        calls.append(tuple(a[2].shape))
        return real(*a, **k)

    monkeypatch.setattr(HK, "histogram_quantile_gather", counted)
    eng = QueryEngine(pms, "prometheus", device="cpu")
    q = "histogram_quantile(0.9, sum by (le, job) (rate(rpc_latency_bucket[5m])))"
    eng.query_range(q, START_S, END_S, STEP_S)
    assert sorted(calls) == [(1, 4), (1, 5)]
    calls.clear()
    eng.query_range(q.replace("le, job", "le"), START_S, END_S, STEP_S)
    assert calls == [(1, 8)]
    (entry,) = [v[1] for v in pms._superblock_cache._d.values()]
    memo = entry.block.__dict__["classic_pivot_memo"]
    assert len(memo) == 2  # by (le, job) and by (le)
    pivots = dict(memo)
    again = eng.query_range(q.replace("le, job", "le"), START_S, END_S, STEP_S)
    assert again.stats.cache_hits == 1 and calls == [(1, 8), (1, 8)]
    assert all(memo[k] is v for k, v in pivots.items())


LABEL_SETS = {
    "one-scheme": [{"le": le, "a": "x"} for le in ("1", "0.5", "+Inf", "0.1")],
    "spellings": [{"le": le, "a": "x"} for le in ("0.1", "Inf")]
    + [{"le": le, "a": "y"} for le in ("inf", "0.1")]
    + [{"le": le, "a": "z"} for le in ("+Inf", "0.1")],
    "two-schemes": [{"le": le, "a": a, "b": "q"} for a, les in
                    (("x", ("0.1", "1", "+Inf")), ("y", ("-1", "0", "2", "+Inf")),
                     ("w", ("1", "+Inf", "0.1"))) for le in les],
}


@pytest.mark.parametrize("q", [-0.5, 0.0, 0.3, 0.5, 0.95, 1.0, 1.5])
@pytest.mark.parametrize("labels", sorted(LABEL_SETS))
def test_classic_pivot_matches_jax(labels, q):
    rng = np.random.default_rng(3)
    lab = LABEL_SETS[labels]
    # cumulative counts per group in each group's le order, in row order here
    vals = rng.poisson(4.0, (len(lab), 9)).astype(np.float32)
    vals[:, 2] = np.nan
    vals[:, 5] = 0.0
    want_labels, want = jax_classic(q, lab, vals)
    got_labels, got = T.classic_histogram_quantile(q, lab, torch.from_numpy(vals), 9)
    assert got_labels == want_labels
    got = got.numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    m = ~np.isnan(want)
    np.testing.assert_allclose(got[m], want[m], rtol=RTOL, atol=ATOL)


def test_classic_pivot_without_le_raises_as_jax():
    lab = [{"le": "1"}, {"a": "x"}]
    vals = np.ones((2, 3), np.float32)
    with pytest.raises(JaxQueryError) as want:
        jax_classic(0.5, lab, vals)
    with pytest.raises(T.QueryError) as got:
        T.classic_histogram_quantile(0.5, lab, torch.from_numpy(vals), 3)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("q", [-0.1, 0.0, 0.5, 0.99, 1.0, 1.2])
def test_gather_plain_matches_jax_histogram_quantile(q):
    """The standalone quantile's plain version over gathered rows against
    ``hist_kernels.histogram_quantile`` on the same [G, J, B] grid (a first
    bound <= 0, empty groups, NaN counts)."""
    import jax.numpy as jnp

    from filodb_tpu.ops.hist_kernels import histogram_quantile as jax_hq

    rng = np.random.default_rng(5)
    G, J, B = 6, 10, 5
    les = np.array([-1.0, 0.5, 1, 5, np.inf], np.float32)
    grid = np.cumsum(rng.poisson(2.0, (G, J, B)), axis=2).astype(np.float32)
    grid[1] = 0.0
    grid[2, 3, :] = np.nan
    part = grid.transpose(0, 2, 1).reshape(G * B, J)  # each group's B rows, le-ascending
    table = np.arange(G * B, dtype=np.int32).reshape(G, B)
    want = np.asarray(jax_hq(np.float32(q), jnp.asarray(grid), jnp.asarray(les)))
    got = HK.histogram_quantile_gather_plain(q, torch.from_numpy(part), torch.from_numpy(table),
                                             torch.from_numpy(les), J).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    m = ~np.isnan(want)
    np.testing.assert_allclose(got[m], want[m], rtol=RTOL, atol=ATOL)


def _load_script(name: str):
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        name, Path(__file__).resolve().parents[1] / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("G, B", [(g, b) for g in (1, 8, 40) for b in (1, 2, 12, 33, 64)])
def test_gather_phase2d_cases_match_jax(G, B):
    """chip_smoke.py phase 2d's gather inputs (groups with no member, table
    entries < 0, a first bound <= 0 in every other scheme) through the
    wrapper on CPU tensors against the JAX ``histogram_quantile`` over the
    same gathered [G, J, B] counts, at phase 2d's q: NaN masks equal, values
    within the module's tolerance, and no out row written but the groups'
    (a sentinel elsewhere, and past the steps, survives)."""
    import jax.numpy as jnp

    from filodb_tpu.ops.hist_kernels import histogram_quantile as jax_hq

    cs = _load_script("chip_smoke")
    part, table, rows, les, n_out = cs.gather_inputs(G, B, 111, G + B, "cpu")
    HK.check_gather_table(table, rows, les)
    idx = table.numpy().astype(np.int64)
    grid = np.where((idx >= 0)[:, :, None], part.numpy()[np.maximum(idx, 0), :111], np.nan)
    for q in cs.GATHER_QS:
        out = torch.full((n_out, 128), 7.5)
        HK.histogram_quantile_gather(q, part, table, rows, les, 111, out)
        want = np.asarray(jax_hq(np.float32(q), jnp.asarray(grid.transpose(0, 2, 1)),
                                 jnp.asarray(les.numpy())))
        got = out.numpy()[rows.numpy()][:, :111]
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=f"q={q}")
        m = ~np.isnan(want)
        np.testing.assert_allclose(got[m], want[m], rtol=RTOL, atol=ATOL, err_msg=f"q={q}")
        untouched = np.ones(n_out, bool)
        untouched[rows.numpy()] = False
        assert (out.numpy()[untouched] == 7.5).all() and (out.numpy()[:, 111:] == 7.5).all()


@pytest.mark.parametrize("case", ["table_dtype", "table_1d", "table_no_buckets", "rows_length",
                                  "rows_dtype", "les_length", "les_strided"])
def test_gather_table_checks_raise(case):
    """``check_gather_table``, made once where a pivot is built (the
    wrapper then checks only ``part`` and ``out``), refuses a table, rows
    or bounds the kernel would misread; a well-formed scheme passes."""
    table = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    rows = torch.arange(3, dtype=torch.int32)
    les = torch.tensor([0.1, 0.5, 1.0, float("inf")])
    HK.check_gather_table(table, rows, les)
    bad = {"table_dtype": (table.long(), rows, les),
           "table_1d": (table.reshape(-1), rows, les),
           "table_no_buckets": (table[:, :0], rows, les[:0]),
           "rows_length": (table, rows[:2], les),
           "rows_dtype": (table, rows.long(), les),
           "les_length": (table, rows, les[:3]),
           "les_strided": (table, rows, torch.tensor([0.1, 0, 0.5, 0, 1.0, 0, 9, 0])[::2])}[case]
    with pytest.raises((TypeError, ValueError)):
        HK.check_gather_table(*bad)


@pytest.mark.parametrize("patch", [p for ps in _load_script("tile_sweep").GATHER_PATCHES.values()
                                   for p in ps])
def test_gather_patch_targets_are_in_the_source(patch):
    """tile_sweep.py --classic-gather builds the gather's tiled design by
    patching these lines of csrc/: each must appear exactly once, or the
    build cannot be made on the card."""
    from filodb_tpu_torch.ops import cuda_build

    fname, old, new = patch
    text = (cuda_build.CSRC / fname).read_text()
    assert text.count(old) == 1, f"{fname}: {old.strip()}"
    assert new != old
