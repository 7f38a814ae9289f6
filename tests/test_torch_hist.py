"""The port's native-histogram pieces against the JAX package on the same
seeded inputs: bucket-scheme unification, histogram staging, the plain
versions of the two histogram kernels (the per-bucket range function with
shared or per-series window bounds, fused with the per-bucket group sum;
the histogram_quantile epilogue) against ``hist_range_kernel``,
``_hist_range_shared``, ``_fused_hist_jit``, ``_fused_hist_shared_jit`` and
``histogram_quantile``. NaN masks must be identical and values within rtol
2e-4 / atol 1e-4 (tests/test_pallas.py's tolerance: the port sums windows
in index order where the JAX package differences f32 prefix sums).

One difference is deliberate: a NaN bucket count stays in the windows that
hold it in the port's window sums, where the JAX package's prefix-sum
difference carries it into every later window of the series
(``test_window_sums_confine_nan_to_their_windows``); the parity cases of
window sums use data without NaN."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from filodb_tpu.core import histograms as JH
from filodb_tpu.ops import hist_kernels as JHK
from filodb_tpu.ops import staging as JST
from filodb_tpu_torch.core import histograms as H
from filodb_tpu_torch.ops import aggregations as AGG
from filodb_tpu_torch.ops import group_acc as GA
from filodb_tpu_torch.ops import hist_kernels as HK
from filodb_tpu_torch.ops import staging as ST
from filodb_tpu_torch.ops.kernels import RangeParams, pad_steps

BASE = 1_600_000_000_000
RTOL, ATOL = 2e-4, 1e-4
FUNCS = sorted(HK.FUSED_HIST_FUNCS)
N_REAL, T_SAMPLES, B = 40, 150, 6
LES = np.array([0.1, 0.25, 0.5, 1.0, 5.0, np.inf])
# the query grid: from before the first sample (empty windows) to past the last
PARAMS = RangeParams(BASE - 120_000, 60_000, 30, 300_000)


def window_sum(func: str, is_delta: bool) -> bool:
    return func == "sum_over_time" or (is_delta and func in ("rate", "increase"))


def assert_close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=f"{what}: NaN masks")
    m = ~np.isnan(want)
    np.testing.assert_allclose(got[m], want[m], rtol=RTOL, atol=ATOL, err_msg=what)


def hist_series(grid: str, n=N_REAL, m=T_SAMPLES, seed=0, nan_row=False):
    """Seeded cumulative histograms: ``regular`` (every series on one 10 s
    grid), ``irregular`` (5-15 s apart, ragged lengths, one empty series).
    ``nan_row``: one series carries NaN bucket counts in a few samples."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = m if grid == "regular" else int(rng.integers(m // 2, m + 1))
        if grid == "irregular" and i == n // 2:
            k = 0
        if grid == "regular":
            ts = BASE + 3_000 + np.arange(k, dtype=np.int64) * 10_000
        else:
            ts = BASE + np.cumsum(rng.integers(5_000, 15_001, k)).astype(np.int64)
        incr = rng.poisson(2.0, size=(k, B)).astype(np.float64)
        incr[:, -1] = incr.sum(1)
        h = np.cumsum(np.cumsum(incr, axis=1), axis=0)
        if nan_row and i == 3 and k > 20:
            h[10:14, 2] = np.nan
        out.append((ts, h))
    return out


def blocks(grid: str, **kw):
    """The same series staged by both packages (host numpy)."""
    series = hist_series(grid, **kw)
    refs = [(0, i) for i in range(len(series))]
    return (ST.stage_histogram_series(series, BASE, B, refs),
            JST.stage_histogram_series(series, BASE, B, refs))


def cpu(block):
    return block.to_device("cpu")


def gids_for(G: int, S: int, n_real: int = N_REAL):
    gids = np.full(S, G, np.int64)
    gids[:n_real] = np.arange(n_real) % G
    return gids


def np_windows(ts_row, m, params, j_pad):
    """The shared [J] window bounds as the JAX package builds them."""
    tsv = ts_row[:m].astype(np.int64)
    out_t = params.start_ms - BASE + np.arange(j_pad, dtype=np.int64) * params.step_ms
    hi = np.searchsorted(tsv, out_t, side="right")
    lo = np.searchsorted(tsv, out_t - params.window_ms, side="right")
    return (lo.astype(np.int32), hi.astype(np.int32), tsv[np.minimum(lo, m - 1)].astype(np.int32),
            tsv[np.minimum(hi - 1, m - 1)].astype(np.int32), out_t.astype(np.int32))


# -- bucket schemes --------------------------------------------------------------

SCHEME_CASES = {
    "nested": ([0.5, 1.0, np.inf], [0.25, 0.5, 1.0, 2.5, np.inf]),
    "disjoint": ([0.1, 1.0, np.inf], [0.2, 2.0, np.inf]),
    "same": (list(LES), list(LES)),
    "near_equal": ([0.1, 1.0, np.inf], [0.1 + 1e-12, 1.0, np.inf]),
    "zero_first": ([0.0, 1.0, 2.0, np.inf], [0.5, 2.0, np.inf]),
}


@pytest.mark.parametrize("case", sorted(SCHEME_CASES))
def test_scheme_unification_matches_jax(case):
    a, b = (np.asarray(x) for x in SCHEME_CASES[case])
    assert H.same_scheme(a, b) == JH.same_scheme(a, b)
    np.testing.assert_array_equal(H.union_les([a, b]), JH.union_les([a, b]))
    union = H.union_les([a, b])
    np.testing.assert_array_equal(H.bucket_mapping(a, union), JH.bucket_mapping(a, union))
    arr = np.cumsum(np.random.default_rng(1).uniform(0, 3, (4, 7, len(a))), axis=-1)
    np.testing.assert_array_equal(H.remap_buckets(arr, a, union), JH.remap_buckets(arr, a, union))
    got, got_union, got_changed = H.unify_schemes([arr, arr[..., :1].repeat(len(b), -1)], [a, b])
    want, want_union, want_changed = JH.unify_schemes([arr, arr[..., :1].repeat(len(b), -1)],
                                                      [a, b])
    assert got_changed == want_changed
    np.testing.assert_array_equal(got_union, want_union)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_schemes_of_the_port_equal_jax():
    np.testing.assert_array_equal(H.PROM_DEFAULT.bounds(), JH.PROM_DEFAULT.bounds())
    for got, want in ((H.geometric_buckets(0.1, 2.0, 8), JH.geometric_buckets(0.1, 2.0, 8)),
                      (H.base2_exp_buckets(2, -3, 10), JH.base2_exp_buckets(2, -3, 10)),
                      (H.custom_buckets([1, 2, 3]), JH.custom_buckets([1, 2, 3]))):
        np.testing.assert_array_equal(got.bounds(), want.bounds())
        assert got.num_buckets == want.num_buckets


# -- staging ---------------------------------------------------------------------


@pytest.mark.parametrize("grid", ["regular", "irregular"])
def test_stage_histogram_series_matches_jax(grid):
    got, want = blocks(grid, nan_row=True)
    for name in ("ts", "vals", "lens", "baseline"):
        np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert ST.grid_class(got) == JST.grid_class(want) == grid
    if grid == "regular":
        np.testing.assert_array_equal(got.regular_ts, np.asarray(want.regular_ts))


def test_concat_of_histogram_blocks_matches_jax():
    parts = [blocks("regular", n=n, seed=s) for n, s in ((5, 0), (9, 1), (3, 2))]
    got = ST.concat_blocks([p for p, _ in parts])
    want = JST.concat_blocks([j for _, j in parts])
    for name in ("ts", "vals", "lens", "baseline"):
        np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert got.raw is None and got.vals.shape == (32, 256, B)
    np.testing.assert_array_equal(got.regular_ts, np.asarray(want.regular_ts))
    assert ST.staged_nbytes(got) == JST.staged_nbytes(want)


def test_concat_refuses_mixed_bucket_widths():
    a = blocks("regular", n=3)[0]
    b = ST.stage_histogram_series(hist_series("regular", n=2), BASE, B, [])
    b.vals = b.vals[..., :3].copy()
    with pytest.raises(ValueError, match="bucket scheme"):
        ST.concat_blocks([a, b])


# -- the range kernel's plain version --------------------------------------------


@pytest.mark.parametrize("is_delta", [False, True], ids=["cumulative", "delta"])
@pytest.mark.parametrize("func", FUNCS)
def test_hist_range_plain_matches_jax_per_series_bounds(func, is_delta):
    port, jblk = blocks("irregular", nan_row=not window_sum(func, is_delta))
    j_pad = pad_steps(PARAMS.num_steps)
    got = HK.hist_range_plain(func, cpu(port), PARAMS, None, is_delta)
    want = JHK.hist_range_kernel(
        func, jnp.asarray(jblk.ts), jnp.asarray(jblk.vals), jnp.asarray(jblk.lens),
        np.int32(PARAMS.start_ms - BASE), np.int32(PARAMS.step_ms),
        np.int32(PARAMS.window_ms), j_pad, is_delta=is_delta)
    assert_close(got.numpy(), np.asarray(want), f"{func} delta={is_delta}")


@pytest.mark.parametrize("is_delta", [False, True], ids=["cumulative", "delta"])
@pytest.mark.parametrize("func", FUNCS)
def test_hist_range_plain_matches_jax_shared_bounds(func, is_delta):
    port, jblk = blocks("regular", nan_row=not window_sum(func, is_delta))
    j_pad = pad_steps(PARAMS.num_steps)
    lo, hi, tf, tl, out_t = np_windows(port.regular_ts, int(port.lens[0]), PARAMS, j_pad)
    windows = AGG._hist_shared_windows(cpu(port), PARAMS, j_pad)
    for w, want in zip(windows, (lo, hi, tf, tl)):
        np.testing.assert_array_equal(w.numpy(), want)
    got = HK.hist_range_plain(func, port, PARAMS, windows, is_delta)
    want = JHK._hist_range_shared(
        func, jnp.asarray(jblk.vals), jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(tf),
        jnp.asarray(tl), jnp.asarray(out_t), np.int32(PARAMS.window_ms), is_delta)
    # padded rows carry garbage in the shared form (the trash group drops them)
    assert_close(got.numpy()[:N_REAL], np.asarray(want)[:N_REAL], f"{func} delta={is_delta}")


@pytest.mark.parametrize("grid", ["regular", "irregular"])
def test_window_sums_confine_nan_to_their_windows(grid):
    """A NaN bucket count makes NaN only the windows that hold it; the JAX
    package's prefix-sum difference is NaN in every later window of that
    series and bucket too. Elsewhere the two agree."""
    port, jblk = blocks(grid, nan_row=True)
    j_pad = pad_steps(PARAMS.num_steps)
    got = HK.hist_range_plain("sum_over_time", cpu(port), PARAMS, None).numpy()
    want = np.asarray(JHK.hist_range_kernel(
        "sum_over_time", jnp.asarray(jblk.ts), jnp.asarray(jblk.vals), jnp.asarray(jblk.lens),
        np.int32(PARAMS.start_ms - BASE), np.int32(PARAMS.step_ms), np.int32(PARAMS.window_ms),
        j_pad))
    has = ~np.isnan(got[3, :, 0])  # the steps whose window holds samples
    nan_steps = np.nonzero(np.isnan(got[3, :, 2]) & has)[0]
    assert 0 < len(nan_steps) <= 6  # the 5 m windows that hold samples 10-13
    later = np.arange(j_pad) > nan_steps[-1]
    assert (has & later).any() and np.isnan(want[3, has & later, 2]).all()
    assert not (np.isnan(got) & ~np.isnan(want)).any()
    both = ~np.isnan(got) & ~np.isnan(want)
    np.testing.assert_allclose(got[both], want[both], rtol=RTOL, atol=ATOL)


# -- the fused rung (range kernel + group sum, and the quantile epilogue) ----------


def jax_fused(variant, func, jblk, gids, G, les, q, is_delta):
    """The JAX package's fused hist program on the same block."""
    j_pad = pad_steps(PARAMS.num_steps)
    qv = np.float32(q if q is not None else 0.0)
    les_j = jnp.asarray(np.asarray(les, np.float32))
    if variant == "hist_shared":
        lo, hi, tf, tl, out_t = np_windows(np.asarray(jblk.regular_ts), int(jblk.lens[0]),
                                           PARAMS, j_pad)
        return np.asarray(JHK._fused_hist_shared_jit(
            func, jnp.asarray(jblk.vals), jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(tf),
            jnp.asarray(tl), jnp.asarray(out_t), np.int32(PARAMS.window_ms),
            jnp.asarray(gids.astype(np.int32)), les_j, qv, G, is_delta, q is not None))
    return np.asarray(JHK._fused_hist_jit(
        func, jnp.asarray(jblk.ts), jnp.asarray(jblk.vals), jnp.asarray(jblk.lens),
        jnp.asarray(gids.astype(np.int32)), les_j, qv, np.int32(PARAMS.start_ms - BASE),
        np.int32(PARAMS.step_ms), np.int32(PARAMS.window_ms), j_pad, G, is_delta,
        q is not None))


VARIANTS = {"hist_shared": "regular", "hist_general": "irregular"}


@pytest.mark.parametrize("is_delta", [False, True], ids=["cumulative", "delta"])
@pytest.mark.parametrize("func", FUNCS)
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_fused_hist_sum_matches_jax(variant, func, is_delta):
    port, jblk = blocks(VARIANTS[variant], nan_row=not window_sum(func, is_delta))
    G = 3
    gids = gids_for(G, port.vals.shape[0])
    obs = {}
    before = HK.RANGE_LAUNCHES
    got = AGG.fused_hist_range_aggregate(
        func, cpu(port), torch.from_numpy(gids), G, PARAMS, torch.tensor(LES, dtype=torch.float32),
        is_delta=is_delta, obs=obs)
    assert HK.RANGE_LAUNCHES == before  # the CPU wrapper runs the plain version
    assert obs == {"variant": variant}
    assert got.shape == (G, pad_steps(PARAMS.num_steps), B)
    assert torch.isnan(got[:, PARAMS.num_steps:]).all()
    want = jax_fused(variant, func, jblk, gids, G, LES, None, is_delta)
    J = PARAMS.num_steps
    assert_close(got.numpy()[:, :J], want[:, :J], f"{variant} {func}")


QS = [-0.1, 0.0, 0.5, 0.99, 1.0, 1.1]


@pytest.mark.parametrize("q", QS)
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_fused_hist_quantile_matches_jax(variant, q):
    port, jblk = blocks(VARIANTS[variant])
    G = 2
    gids = gids_for(G, port.vals.shape[0])
    before = (HK.RANGE_LAUNCHES, HK.FOLDED_QUANTILES)
    got = AGG.fused_hist_range_aggregate(
        "rate", cpu(port), torch.from_numpy(gids), G, PARAMS,
        torch.tensor(LES, dtype=torch.float32), q=q)
    assert (HK.RANGE_LAUNCHES, HK.FOLDED_QUANTILES) == before
    assert got.shape == (G, pad_steps(PARAMS.num_steps))
    want = jax_fused(variant, "rate", jblk, gids, G, LES, q, False)
    J = PARAMS.num_steps
    assert_close(got.numpy()[:, :J], want[:, :J], f"{variant} q={q}")
    assert torch.isnan(got[:, J:]).all()


def test_fused_hist_padded_rows_and_empty_groups():
    """Padded rows (the trash group) add nothing; a group with no member is
    NaN at every step, in the sums and the quantiles."""
    port, jblk = blocks("regular")
    G = 4
    gids = gids_for(3, port.vals.shape[0])  # group 3 has no member
    gids[N_REAL:] = G
    les = torch.tensor(LES, dtype=torch.float32)
    got = AGG.fused_hist_range_aggregate("increase", cpu(port), torch.from_numpy(gids), G,
                                         PARAMS, les)
    assert torch.isnan(got[3]).all()
    want = jax_fused("hist_shared", "increase", jblk, gids, G, LES, None, False)
    J = PARAMS.num_steps
    assert_close(got.numpy()[:, :J], want[:, :J])
    qv = AGG.fused_hist_range_aggregate("increase", cpu(port), torch.from_numpy(gids), G,
                                        PARAMS, les, q=0.5)
    assert torch.isnan(qv[3]).all() and torch.isfinite(qv[:3, 10:J]).all()


# -- histogram_quantile edge cases ------------------------------------------------


def quantile_case(name: str):
    """(buckets [G, J, B], les) of one edge case."""
    rng = np.random.default_rng(3)
    base = np.cumsum(rng.uniform(0, 4, (3, 5, 6)), axis=-1).astype(np.float32)
    les = LES.copy()
    if name == "zero_total":
        base[1] = 0.0
    elif name == "first_bound_not_positive":
        les = np.array([0.0, 0.5, 1.0, 2.0, 4.0, np.inf])
    elif name == "negative_first_bound":
        les = np.array([-1.0, 0.5, 1.0, 2.0, 4.0, np.inf])
    elif name == "all_in_top_bucket":
        base[..., :-1] = 0.0
    elif name == "nan_bucket":
        base[0, 2, 3] = np.nan
        base[2, 1, :] = np.nan
    elif name == "one_bucket":
        base = base[..., -1:]
        les = np.array([np.inf])
    return base, les


QCASES = ["plain", "zero_total", "first_bound_not_positive", "negative_first_bound",
          "all_in_top_bucket", "nan_bucket", "one_bucket"]


@pytest.mark.parametrize("q", QS)
@pytest.mark.parametrize("case", QCASES)
def test_histogram_quantile_plain_matches_jax(case, q):
    buckets, les = quantile_case(case)
    got = HK.histogram_quantile_plain(q, torch.from_numpy(buckets),
                                      torch.tensor(les, dtype=torch.float32))
    want = JHK.histogram_quantile(np.float32(q), jnp.asarray(buckets),
                                  jnp.asarray(les.astype(np.float32)))
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    m = np.isfinite(want)
    np.testing.assert_allclose(got[m], want[m], rtol=RTOL, atol=ATOL)


def test_quantile_wrapper_finishes_partials():
    """hist_quantile on accumulators: a bucket whose cnt is 0 is NaN (no
    member) before the interpolation, and padded steps are NaN."""
    buckets, les = quantile_case("nan_bucket")
    G, J, Bq = buckets.shape
    acc = torch.zeros((G + 1, 8 * Bq))
    cnt = torch.zeros((G + 1, 8 * Bq))
    flat = torch.from_numpy(buckets).reshape(G, J * Bq)
    acc[:G, : J * Bq] = torch.nan_to_num(flat, nan=0.0)
    cnt[:G, : J * Bq] = (~torch.isnan(flat)).float()
    got = HK.hist_quantile(0.7, acc, cnt, G, torch.tensor(les, dtype=torch.float32), J)
    want = HK.histogram_quantile_plain(0.7, torch.from_numpy(buckets),
                                       torch.tensor(les, dtype=torch.float32))
    assert got.shape == (G, 8)
    np.testing.assert_array_equal(got[:, :J].numpy(), want.numpy())
    assert torch.isnan(got[:, J:]).all()


# -- the wrappers ----------------------------------------------------------------


def test_wrappers_check_their_inputs():
    port = cpu(blocks("regular")[0])
    S = port.vals.shape[0]
    gids = torch.zeros(S, dtype=torch.int64)
    with pytest.raises(TypeError, match="gids"):
        HK.hist_range_partials("rate", port, gids.int(), 1, PARAMS)
    with pytest.raises(NotImplementedError, match="avg_over_time"):
        HK.hist_range_partials("avg_over_time", port, gids, 1, PARAMS)
    windows = AGG._hist_shared_windows(port, PARAMS, pad_steps(PARAMS.num_steps))
    with pytest.raises(ValueError, match="lo"):
        HK.hist_range_partials("rate", port, gids, 1, PARAMS, windows=(windows[0][:5],)
                               + windows[1:])
    acc, cnt = HK.hist_range_partials("rate", port, gids, 1, PARAMS, windows=windows)
    with pytest.raises(ValueError, match="les"):
        HK.hist_quantile(0.5, acc, cnt, 1, torch.ones(B + 1), PARAMS.num_steps)


def test_partials_layout_and_plan():
    port = cpu(blocks("regular")[0])
    S = port.vals.shape[0]
    G = 5
    gids = torch.from_numpy(gids_for(G, S))
    acc, cnt = HK.hist_range_partials("last", port, gids, G, PARAMS)
    j_pad = pad_steps(PARAMS.num_steps)
    assert acc.shape == cnt.shape == (G + 1, j_pad * B)
    # column j * B + b holds bucket b of step j; nothing past num_steps
    assert not cnt[:, PARAMS.num_steps * B:].any() and not cnt[G].any()
    sums = GA.finish_groups("sum", acc, cnt, G).reshape(G, j_pad, B)
    assert (cnt.reshape(G + 1, j_pad, B)[:G, 20] == torch.tensor(
        [8.0, 8.0, 8.0, 8.0, 8.0])[:, None]).all()
    assert torch.equal(torch.isnan(sums[:, :20]), cnt.reshape(G + 1, j_pad, B)[:G, :20] == 0)
    plan = HK.hist_plan(768, 111, 12, 1, True)
    assert plan.shared and plan.slices == 1 and plan.steps == 111
    assert not HK.hist_plan(768, 111, 12, 1000, False).shared
