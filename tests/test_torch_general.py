"""The port's general range rung (B4) against the JAX package on the CPU:
``range_kernel_plain`` against ``range_kernel``, the rung
(``general_range_aggregate``, on a CPU block its plain version) against
``_fused_general_jit``, the ladder ``grid_variant`` against
``_grid_variant``, and ``QueryEngine(device="cpu")`` against the JAX
engine for every function of the fused path on irregular, jittered and
regular stores, ``offset`` included. Inputs are made by numpy from a seed.

Tolerance rtol 2e-4 / atol 1e-4 (as tests/test_pallas.py: f32 sums are
taken in another order); NaN masks identical. Two deliberate differences
(ROADMAP C): the port takes stddev/stdvar_over_time's and z_score's mean
from the window's own sum, where ``range_kernel`` differences f32 prefix
sums of the whole row, and sums deriv's normal equations in float64, where
``range_kernel`` sums them in f32. The JAX package's rounding there is all
a window of one sample holds (z_score +-1 where the mean is the sample
itself, ``test_moment_mean_is_the_window_sum``) and more than the tolerance
on windows of a few samples far from the step. So the range-kernel cases
of those functions hold the port against the JAX package wherever the JAX
value agrees with a float64 oracle, and against the oracle elsewhere.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from filodb_tpu.coordinator.planner import QueryEngine as JaxEngine
from filodb_tpu.core import schemas as JS
from filodb_tpu.core.records import SeriesBatch as JaxSeriesBatch
from filodb_tpu.memstore.memstore import TimeSeriesMemStore as JaxMemStore
from filodb_tpu.ops import aggregations as JAGG
from filodb_tpu.ops import staging as JST
from filodb_tpu.ops.kernels import range_kernel as jax_range_kernel
from filodb_tpu.ops.staging import stage_series as jax_stage_series
from filodb_tpu.query.exec import plans as JPLANS
from filodb_tpu_torch import metrics as M
from filodb_tpu_torch.coordinator.planner import FUSED_FUNCS, QueryEngine
from filodb_tpu_torch.core import schemas as S
from filodb_tpu_torch.core.records import SeriesBatch
from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore
from filodb_tpu_torch.ops import aggregations as AGG
from filodb_tpu_torch.ops import general_range as GR
from filodb_tpu_torch.ops import window_stats as WS
from filodb_tpu_torch.ops.kernels import RangeParams, _bounds, pad_steps, range_kernel_plain
from filodb_tpu_torch.ops.staging import grid_class, stage_series
from filodb_tpu_torch.query.exec import plans as PLANS

BASE = 1_600_000_000_000
RTOL, ATOL = 2e-4, 1e-4
NEW_FUNCS = sorted(GR.GENERAL_FUNCS)
# held to JAX where JAX agrees with a float64 oracle (assert_jax_or_oracle)
ORACLE_FUNCS = ("stddev_over_time", "stdvar_over_time", "z_score", "deriv", "predict_linear")
OPS = ("sum", "count", "avg", "min", "max")


def assert_close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=what)
    m = ~np.isnan(want)
    np.testing.assert_allclose(got[m], want[m], rtol=RTOL, atol=ATOL, err_msg=what)


# -- the plain B4 against range_kernel ---------------------------------------------

N_REAL, N_SAMPLES, J = 12, 90, 20
QUERY_GRIDS = {
    "inside": (300_000, 30_000),  # (start offset, step): every window within the data
    "empty_at_both_ends": (-120_000, 75_000),  # from before the first sample past the last
}
WINDOW = 300_000


def sample_ts(grid: str, rng) -> list[np.ndarray]:
    """Per-series timestamps: irregular 5-15 s apart with tied pairs and
    ragged lengths, 10 s +-5 % (jitter), or one exact 10 s grid."""
    out = []
    for i in range(N_REAL):
        if grid == "irregular":
            n = N_SAMPLES - 3 * i
            gaps = rng.integers(5_000, 15_001, n)
            gaps[7::13] = 0  # a tie: a sample at its predecessor's timestamp
            out.append(BASE + np.cumsum(gaps).astype(np.int64))
            continue
        t = BASE + 5_000 + np.arange(N_SAMPLES, dtype=np.int64) * 10_000
        if grid == "jitter":
            t = t + np.rint(rng.uniform(-0.05, 0.05, N_SAMPLES) * 10_000).astype(np.int64)
        out.append(t)
    return out


def sample_vals(kind: str, n: int, rng) -> np.ndarray:
    """Gauges (with repeated neighbours), cumulative counters (one reset)
    or delta counters (non-negative increments, some zero)."""
    if kind == "gauge":
        v = 50 + 20 * rng.standard_normal(n)
        v[5::7] = v[4::7][: len(v[5::7])]
        return v
    if kind == "delta":
        v = rng.uniform(0, 10, n)
        v[3::5] = 0.0
        return v
    v = np.cumsum(rng.uniform(0, 10, n)) + 1e3
    v[n // 2:] -= v[n // 2] - rng.uniform(0, 5)
    return v


# staging mode -> (value kind, stage_series flags, is_counter, is_delta)
STAGINGS = {
    "gauge": ("gauge", {}, False, False),
    "corrected": ("counter", {"counter_corrected": True}, True, False),
    "shifted": ("counter", {"subtract_baseline": True}, True, False),
    "diff": ("counter", {"diff_encode": True}, True, False),
    "delta": ("delta", {}, True, True),
}


@functools.lru_cache(maxsize=None)
def staged(grid: str, staging: str):
    """A port-staged host block of the grid's series in the staging mode."""
    kind, flags, _, _ = STAGINGS[staging]
    rng = np.random.default_rng(sorted(STAGINGS).index(staging) * 7 + len(grid))
    series = [(t, sample_vals(kind, len(t), rng)) for t in sample_ts(grid, rng)]
    return stage_series(series, BASE, **flags)


def block_arrays(block):
    raw = block.raw if block.raw is not None else block.vals
    return tuple(np.asarray(a) for a in (block.ts, block.vals, block.lens, block.baseline, raw))


def jax_range(func, arrays, start_off, step, is_counter, is_delta, arg0=0.0):
    return np.asarray(jax_range_kernel(
        func, *arrays, np.int32(start_off), np.int32(step), np.int32(WINDOW), J,
        is_counter=is_counter, is_delta=is_delta, arg0=np.float32(arg0)))


def port_range(func, arrays, start_off, step, is_counter, is_delta, arg0=0.0):
    return range_kernel_plain(func, *(torch.from_numpy(a) for a in arrays), start_off, step,
                              WINDOW, J, is_counter=is_counter, is_delta=is_delta,
                              arg0=arg0).numpy()


def f64_oracle(func, arrays, start_off, step, arg0=0.0):
    """The moment functions and deriv/predict_linear in float64 over the
    same windows of the f32 inputs (deriv's tc rounded to f32 first, as
    both packages do), and the windows' sample counts."""
    ts, vals, lens = (torch.from_numpy(a) for a in arrays[:3])
    out_t = (start_off + np.arange(J) * step).astype(np.int32)
    lo, hi = (x.numpy() for x in _bounds(ts, lens, torch.from_numpy(out_t),
                                          torch.tensor(WINDOW, dtype=torch.int32)))
    v64 = arrays[1].astype(np.float64)
    out = np.full(lo.shape, np.nan)
    for s, j in zip(*np.nonzero(hi > lo)):
        w = v64[s, lo[s, j]:hi[s, j]]
        if func in ("deriv", "predict_linear"):
            dt = (arrays[0][s, lo[s, j]:hi[s, j]] - out_t[j]).astype(np.int32)
            tc = (dt.astype(np.float32) * np.float32(1e-3)).astype(np.float64)
            n = float(len(w))
            denom = n * (tc * tc).sum() - tc.sum() ** 2
            if n < 2 or abs(denom) < 1e-30:
                continue
            slope = (n * (tc * w).sum() - tc.sum() * w.sum()) / denom
            intercept = (w.sum() - slope * tc.sum()) / n
            out[s, j] = slope if func == "deriv" else intercept + slope * arg0
            continue
        var = ((w - w.mean()) ** 2).mean()
        out[s, j] = {"stdvar_over_time": var, "stddev_over_time": np.sqrt(var),
                     "z_score": (w[-1] - w.mean()) / max(np.sqrt(var), 1e-30)}[func]
    return out, hi - lo


def assert_jax_or_oracle(got, want, exact, count, what):
    """The port against the JAX package wherever the JAX value agrees with
    the float64 oracle, and against the oracle elsewhere: the JAX package's
    f32 prefix difference (the moments' mean) and f32 normal equations
    (deriv) lose more than the tolerance on windows of a few samples."""
    np.testing.assert_array_equal(np.isnan(exact), np.isnan(want), err_msg=what)
    jax_ok = np.isnan(want) | np.isclose(want, exact, rtol=RTOL, atol=ATOL)
    assert_close(got[jax_ok], want[jax_ok], what)
    assert_close(got[~jax_ok], exact[~jax_ok], what + " (oracle)")
    assert (count[~jax_ok] <= 5).all(), what


@pytest.mark.parametrize("query_grid", sorted(QUERY_GRIDS))
@pytest.mark.parametrize("grid", ["irregular", "jitter", "regular"])
@pytest.mark.parametrize("staging", sorted(STAGINGS))
@pytest.mark.parametrize("func", NEW_FUNCS)
def test_range_kernel_plain_matches_jax(func, staging, grid, query_grid):
    _, _, is_counter, is_delta = STAGINGS[staging]
    arrays = block_arrays(staged(grid, staging))
    start_off, step = QUERY_GRIDS[query_grid]
    want = jax_range(func, arrays, start_off, step, is_counter, is_delta)
    got = port_range(func, arrays, start_off, step, is_counter, is_delta)
    assert got.shape == want.shape == (arrays[0].shape[0], J)
    what = f"{func} {staging} {grid} {query_grid}"
    if func in ORACLE_FUNCS:
        exact, count = f64_oracle(func, arrays, start_off, step)
        assert_jax_or_oracle(got, want, exact, count, what)
    else:
        assert_close(got, want, what)
    assert not np.isnan(got).all(), what


# the rest of what range_kernel computes (not on the general rung)
OTHER_FUNCS = ["sum_over_time", "avg_over_time", "count_over_time", "last", "first_over_time",
               "timestamp", "present_over_time", "absent_over_time", "min_over_time",
               "max_over_time", "rate", "increase", "delta", "predict_linear"]


@pytest.mark.parametrize("staging", ["gauge", "corrected", "delta"])
@pytest.mark.parametrize("func", OTHER_FUNCS)
def test_range_kernel_plain_other_functions_match_jax(func, staging):
    """Against range_kernel evaluated op by op: on a window of two tied
    samples (sampled = 0) its compiled program rounds the extrapolation's
    0 / 1e-30 to +-1e25 where its own definition gives 0."""
    _, _, is_counter, is_delta = STAGINGS[staging]
    arrays = block_arrays(staged("irregular", staging))
    start_off, step = QUERY_GRIDS["empty_at_both_ends"]
    with jax.disable_jit():
        want = jax_range(func, arrays, start_off, step, is_counter, is_delta, arg0=120.0)
    got = port_range(func, arrays, start_off, step, is_counter, is_delta, arg0=120.0)
    if func in ORACLE_FUNCS:
        exact, count = f64_oracle(func, arrays, start_off, step, arg0=120.0)
        assert_jax_or_oracle(got, want, exact, count, f"{func} {staging}")
    else:
        assert_close(got, want, f"{func} {staging}")


def test_range_kernel_plain_refuses_holt_winters():
    """It refused double_exponential_smoothing until the general kernel
    took Holt-Winters: now it computes it, as range_kernel's _holt_winters
    scan does (rtol 2e-4 / atol 1e-4, NaN masks equal)."""
    arrays = block_arrays(staged("irregular", "gauge"))
    want = np.asarray(jax_range_kernel(
        "double_exponential_smoothing", *arrays, np.int32(0), np.int32(60_000),
        np.int32(WINDOW), J, arg0=np.float32(0.3), arg1=np.float32(0.1)))
    got = range_kernel_plain("double_exponential_smoothing",
                             *(torch.from_numpy(a) for a in arrays), 0, 60_000, WINDOW, J,
                             arg0=0.3, arg1=0.1).numpy()
    assert_close(got, want, "double_exponential_smoothing")
    assert not np.isnan(got).all()


def test_moment_mean_is_the_window_sum():
    """A window of one sample: its mean is the sample, so the port's
    stddev and z_score are exactly 0 there; the JAX package's mean, a
    difference of whole-row f32 prefix sums, misses the sample by their
    rounding, which is then all the window holds."""
    ts = np.full((8, 128), 2**31 - 1, np.int32)
    ts[0, :40] = np.arange(40) * 10_000
    vals = np.zeros((8, 128), np.float32)
    vals[0, :40] = (1000 + np.cumsum(np.linspace(1.37, 9.91, 40))).astype(np.float32)
    lens = np.zeros(8, np.int32)
    lens[0] = 40
    arrays = (ts, vals, lens, np.zeros(8, np.float32), vals)
    # step j's window (t_j - 10 s, t_j] holds exactly sample j
    args = (0, 10_000)
    jz = np.asarray(jax_range_kernel("z_score", *arrays, np.int32(0), np.int32(10_000),
                                     np.int32(10_000), 40))[0]
    jsd = np.asarray(jax_range_kernel("stddev_over_time", *arrays, np.int32(0),
                                      np.int32(10_000), np.int32(10_000), 40))[0]
    t = tuple(torch.from_numpy(a) for a in arrays)
    pz = range_kernel_plain("z_score", *t, *args, 10_000, 40).numpy()[0]
    psd = range_kernel_plain("stddev_over_time", *t, *args, 10_000, 40).numpy()[0]
    assert (pz == 0).all() and (psd == 0).all()
    assert set(np.unique(jz)) <= {-1.0, 0.0, 1.0} and (np.abs(jz) == 1).any()
    # at most the rounding of two prefix sums of the row's 40 samples
    assert (jsd > 0).any() and (jsd <= 40 * np.spacing(vals[0].sum())).all()


# -- the rung against _fused_general_jit --------------------------------------------

N_GROUPS = 3


@functools.lru_cache(maxsize=None)
def spanning_block(staging: str):
    """Irregular series that span every window of the query (no window of
    one or two samples, where the JAX mean is noise), staged on the CPU."""
    kind, flags, _, _ = STAGINGS[staging]
    rng = np.random.default_rng(41)
    series = []
    for _ in range(N_REAL):
        ts = BASE + np.cumsum(rng.integers(5_000, 15_001, 130)).astype(np.int64)
        series.append((ts, sample_vals(kind, 130, rng)))
    return stage_series(series, BASE, **flags).to_device("cpu")


def group_ids(s_pad: int) -> np.ndarray:
    g = np.full(s_pad, N_GROUPS, np.int64)
    g[:N_REAL] = np.random.default_rng(2).permutation(np.arange(N_REAL) % N_GROUPS)
    return g


def natural_staging(func: str, counter: bool) -> str:
    if not counter:
        return "gauge"
    return {"corrected": "corrected", "shifted": "shifted", "diff": "diff"}[
        PLANS._stage_mode_for_function(func)]


# every op over counters in the function's staging mode; the sum over gauges
RUNG_CASES = [(f, op, True) for f in NEW_FUNCS for op in OPS] + [
    (f, "sum", False) for f in NEW_FUNCS]


@pytest.mark.parametrize("func,op,counter", RUNG_CASES,
                         ids=[f"{f}-{op}-{'counter' if c else 'gauge'}" for f, op, c in RUNG_CASES])
def test_general_rung_matches_fused_general(func, op, counter, monkeypatch):
    staging = natural_staging(func, counter)
    block = spanning_block(staging)
    _, _, is_counter, is_delta = STAGINGS[staging]
    params = RangeParams(BASE + 330_000, 30_000, 10, WINDOW)
    gids = group_ids(block.ts.shape[0])
    ts, vals, lens, baseline, raw = block_arrays(block)
    want = np.asarray(JAGG._fused_general_jit(
        func, ("agg", op), ts, vals, lens, baseline, raw, gids.astype(np.int32),
        np.int32(N_REAL), np.float32(0.0), np.int32(330_000), np.int32(30_000),
        np.int32(WINDOW), pad_steps(10), N_GROUPS, is_counter, is_delta))
    monkeypatch.setattr(GR, "LAUNCHES", 0)
    got = GR.general_range_aggregate(func, op, block, torch.from_numpy(gids), N_GROUPS, params,
                                     is_counter=is_counter, is_delta=is_delta).numpy()
    assert GR.LAUNCHES == 0  # a CPU block runs the plain version
    assert got.shape == (N_GROUPS, pad_steps(10))
    assert np.isnan(got[:, 10:]).all()
    assert_close(got[:, :10], want[:, :10], f"{op}({func}) {staging}")
    assert not np.isnan(got[:, :10]).any()


def test_general_rung_refuses_what_it_does_not_compute():
    block = spanning_block("gauge")
    params = RangeParams(BASE + 330_000, 30_000, 10, WINDOW)
    gids = torch.from_numpy(group_ids(block.ts.shape[0]))
    with pytest.raises(NotImplementedError, match="general rung"):
        GR.general_range_aggregate("rate", "sum", block, gids, N_GROUPS, params)
    with pytest.raises(NotImplementedError, match="aggregation"):
        GR.general_range_aggregate("irate", "stddev", block, gids, N_GROUPS, params)
    with pytest.raises(TypeError):
        GR.general_range_aggregate("irate", "sum", block, gids.to(torch.int32), N_GROUPS, params)


def test_general_codes_are_the_kernels_own_enum():
    """The general kernel (csrc/general_range.cu) has an enum of its own:
    one code per function, 0..9 (the fused functions 0..7, the tree's
    predict_linear and double_exponential_smoothing 8 and 9), apart from
    the window-stats codes."""
    assert set(GR.GENERAL_FUNC_CODES) == GR.TREE_FUNCS == set(GR.KINDS)
    assert GR.TREE_FUNCS == GR.GENERAL_FUNCS | GR.ARG_FUNCS
    assert not GR.TREE_FUNCS & WS.PALLAS_FUNCS
    assert sorted(GR.GENERAL_FUNC_CODES[f] for f in GR.GENERAL_FUNCS) == list(range(8))
    assert sorted(GR.GENERAL_FUNC_CODES.values()) == list(range(10))


@pytest.mark.parametrize("func,counter,is_delta,distinct_raw,want", [
    ("irate", True, False, True, 2), ("idelta", True, False, False, 2),
    ("stddev_over_time", True, False, False, 2), ("deriv", False, False, False, 2),
    ("changes", True, False, True, 2), ("resets", False, False, False, 2),
    ("changes", False, False, True, 3), ("resets", True, True, True, 3),
])
def test_staged_arrays_of_the_general_kinds(func, counter, is_delta, distinct_raw, want):
    """ts and vals; raw only where changes/resets compare raw neighbours of
    a row of their own."""
    assert GR.staged_arrays(func, counter, is_delta, distinct_raw=distinct_raw) == want


# -- the ladder against _grid_variant ---------------------------------------------------


@functools.lru_cache(maxsize=None)
def ladder_blocks():
    """(JAX block, port block) per grid class, from the same series."""
    rng = np.random.default_rng(9)
    n = 60
    nominal = BASE + 5_000 + np.arange(n, dtype=np.int64) * 10_000
    grids = {
        "regular": [nominal] * 6,
        "jitter": [nominal + np.rint(rng.uniform(-0.05, 0.05, n) * 10_000).astype(np.int64)
                   for _ in range(6)],
        "holes": [np.delete(nominal, [7 + i, 30 + 2 * i]) for i in range(6)],
        "irregular": [BASE + np.cumsum(rng.integers(5_000, 15_001, n)).astype(np.int64)
                      for _ in range(6)],
    }
    out = {}
    for name, tss in grids.items():
        series = [(t, 50 + rng.standard_normal(len(t))) for t in tss]
        out[name] = jax_stage_series(series, BASE), stage_series(series, BASE)
    return out


def test_ladder_blocks_have_the_grid_classes():
    blocks = ladder_blocks()
    assert {k: grid_class(p) for k, (_, p) in blocks.items()} == {
        "regular": "regular", "jitter": "jitter", "holes": "holes",
        "irregular": "irregular"}
    assert {k: JST.grid_class(j) for k, (j, _) in blocks.items()} == {
        k: grid_class(p) for k, (_, p) in blocks.items()}


@pytest.mark.parametrize("func", sorted(JPLANS.FUSED_FUNCS))
def test_grid_variant_maps_the_jax_ladder(func):
    """Every (grid class, is_delta) of a fused function: the port's rung is
    the JAX package's ``_grid_variant`` exactly, its ``general`` being the
    port's ``general`` for ``GENERAL_FUNCS`` and ``window_stats`` for the
    rest (``general_rung``); and ``_fused_dispatch``'s decline -- the jitter
    and masked rungs' window structure not ``ok`` for a window of twice the
    grid's deviation bound -- maps the same way. Nothing in FUSED_FUNCS
    raises."""
    from filodb_tpu.ops import mxu_jitter as JMJ

    general = "general" if func in GR.GENERAL_FUNCS else "window_stats"
    for grid, (jb, pb) in ladder_blocks().items():
        for is_delta in (False, True):
            jvar, _ = JAGG._grid_variant(jb, func, is_delta)
            want = general if jvar == "general" else jvar
            assert AGG.grid_variant(pb, func, is_delta) == want, (grid, is_delta, jvar)
            if jvar not in ("jitter", "masked"):
                continue
            md = jb.maxdev_ms if jvar == "jitter" else jb.mgrid.maxdev_ms
            build = (JMJ.jitter_window_matrices if jvar == "jitter"
                     else JMJ.masked_window_matrices)
            for window in (2 * md, 2 * md + 1):
                ok = build(jb, 400_000, 60_000, 32, window).ok
                assert AGG.grid_variant(pb, func, is_delta, window) == (jvar if ok else general)


def test_fused_funcs_are_the_jax_packages():
    assert FUSED_FUNCS == JPLANS.FUSED_FUNCS
    assert FUSED_FUNCS <= WS.PALLAS_FUNCS | GR.GENERAL_FUNCS


@pytest.mark.parametrize("func", sorted(GR.GENERAL_FUNCS | {"rate", "increase", "delta"}))
def test_stage_modes_match_jax(func):
    assert PLANS._stage_mode_for_function(func) == JPLANS._stage_mode_for_function(func)


@pytest.mark.parametrize("func", ["timestamp", "quantile_over_time", "predict_linear"])
def test_grid_variant_raises_outside_the_fused_set(func):
    _, pb = ladder_blocks()["irregular"]
    with pytest.raises(NotImplementedError, match="not ported"):
        AGG.grid_variant(pb, func)


# -- the engine against the JAX engine ----------------------------------------------------

E_SERIES, E_SAMPLES, E_SHARDS, SPREAD = 16, 200, 4, 1
START_S = (BASE + 400_000) / 1000
END_S = (BASE + 1_500_000) / 1000
STEP_S = 60
ENGINE_GRIDS = ("irregular", "jitter", "regular")


def engine_data(grid: str, seed: int = 0):
    """(tags, schema, ts, values): counters (a reset in every third) and
    gauges on 10 s samples from BASE, exact, +-5 % (jitter) or irregular
    5-15 s apart; every series spans the queries' windows."""
    rng = np.random.default_rng(seed)
    nominal = BASE + 5_000 + np.arange(E_SAMPLES, dtype=np.int64) * 10_000
    out = []
    for metric, schema in (("http_requests_total", "prom-counter"), ("node_temp", "gauge")):
        for i in range(E_SERIES):
            if grid == "irregular":
                ts = BASE + np.cumsum(rng.integers(5_000, 15_001, E_SAMPLES)).astype(np.int64)
            elif grid == "jitter":
                ts = nominal + np.rint(rng.uniform(-0.05, 0.05, E_SAMPLES) * 10_000).astype(
                    np.int64)
            else:
                ts = nominal
            if schema == "prom-counter":
                vals = np.cumsum(rng.uniform(0, 10, E_SAMPLES)) + 1e6
                if i % 3 == 0:
                    vals[E_SAMPLES // 2:] -= vals[E_SAMPLES // 2] - 3.0
            else:
                vals = 50 + 20 * rng.standard_normal(E_SAMPLES)
                vals[4::9] = vals[3::9][: len(vals[4::9])]  # repeated readings
            tags = {S.METRIC_TAG: metric, "_ws_": "demo", "_ns_": "App-2",
                    "instance": f"host-{i}", "zone": f"z{i % 4}"}
            out.append((tags, schema, ts, vals))
    return out


def build_stores(data):
    jms, pms = JaxMemStore(), TimeSeriesMemStore()
    jms.setup(JS.Dataset("prometheus"), range(E_SHARDS))
    pms.setup(S.Dataset("prometheus"), range(E_SHARDS))
    for tags, schema, ts, vals in data:
        col = "count" if schema == "prom-counter" else "value"
        shard = S.shard_for(tags, SPREAD, E_SHARDS)
        jms.shard("prometheus", shard).ingest_series(JaxSeriesBatch(
            schema=JS.SCHEMAS[schema], tags=tags, timestamps=ts, values={col: vals}))
        pms.shard("prometheus", shard).ingest_series(SeriesBatch(
            schema=S.SCHEMAS[schema], tags=tags, timestamps=ts, values={col: vals}))
    return jms, pms


@pytest.fixture(scope="module")
def stores():
    return {grid: build_stores(engine_data(grid)) for grid in ENGINE_GRIDS}


def rows_of(res):
    assert len(res.grids) == 1
    g = res.grids[0]
    return g.labels, g.values_np()


def port_query(pms, query, instant=False):
    """The port's result and the rung its ladder took."""
    eng = QueryEngine(pms, "prometheus", device="cpu")
    if instant:
        from filodb_tpu_torch.query.promql import query_to_logical_plan as plan_of
        plan = plan_of(query, END_S, eng.planner.params.lookback_ms)
    else:
        from filodb_tpu_torch.query.promql import query_range_to_logical_plan as plan_of
        plan = plan_of(query, START_S, END_S, STEP_S, eng.planner.params.lookback_ms)
    ctx = eng.context()
    return eng.planner.materialize(plan).execute(ctx), ctx.obs.get("variant")


def assert_engine_matches(jms, pms, query, grid, instant=False):
    """The port's result equals the JAX engine's (labels, NaN mask, values
    within tolerance); deriv's is held to the JAX engine's where that
    agrees with ``deriv_oracle``, and to the oracle elsewhere. Returns the
    port's rung."""
    jeng = JaxEngine(jms, "prometheus")
    want = jeng.query_instant(query, END_S) if instant else jeng.query_range(
        query, START_S, END_S, STEP_S)
    got, variant = port_query(pms, query, instant)
    want_labels, w = rows_of(want)
    got_labels, g = rows_of(got)
    assert got_labels == want_labels, query
    assert g.shape == w.shape, query
    m = ~np.isnan(w)
    assert m.any(), query
    if "deriv(" in query:
        exact = deriv_oracle(grid, query, got_labels, instant)
        np.testing.assert_array_equal(np.isnan(exact), np.isnan(w), err_msg=query)
        jax_ok = ~m | np.isclose(w, exact, rtol=RTOL, atol=ATOL)
        assert_close(g[jax_ok], w[jax_ok], query)
        assert_close(g[~jax_ok], exact[~jax_ok], query + " (oracle)")
    else:
        assert_close(g, w, query)
    return variant


def deriv_oracle(grid: str, query: str, labels, instant: bool) -> np.ndarray:
    """``op [by (zone)] (deriv(m[5m] [offset d]))`` in float64 from the
    ingested samples, in the result's group order."""
    from filodb_tpu_torch.query.promql import query_range_to_logical_plan

    start = END_S if instant else START_S
    plan = query_range_to_logical_plan(query, start, END_S, STEP_S)
    inner = plan.inner
    steps = np.arange(inner.start_ms, inner.end_ms + 1, inner.step_ms) - inner.offset_ms
    metric = next(f.value for f in inner.raw.filters if f.column == S.METRIC_TAG)
    per_group: dict = {}
    for tags, _, ts, vals in engine_data(grid):
        if tags[S.METRIC_TAG] != metric:
            continue
        slopes = np.full(len(steps), np.nan)
        for j, t_j in enumerate(steps):
            m = (ts <= t_j) & (ts > t_j - inner.window_ms)
            tc, v, n = (ts[m] - t_j) * 1e-3, vals[m], int(m.sum())
            denom = n * (tc * tc).sum() - tc.sum() ** 2
            if n >= 2 and abs(denom) >= 1e-30:
                slopes[j] = (n * (tc * v).sum() - tc.sum() * v.sum()) / denom
        key = tuple(sorted((k, tags[k]) for k in plan.by or ()))
        per_group.setdefault(key, []).append(slopes)
    out = []
    for lbls in labels:
        stack = np.stack(per_group[tuple(sorted(lbls.items()))])
        has = ~np.isnan(stack)
        with np.errstate(all="ignore"):
            r = {"sum": lambda a: np.nansum(a, 0), "avg": lambda a: np.nanmean(a, 0),
                 "min": lambda a: np.nanmin(a, 0), "max": lambda a: np.nanmax(a, 0),
                 "count": lambda a: has.sum(0).astype(np.float64)}[plan.op](stack)
        out.append(np.where(has.any(axis=0), r, np.nan))
    return np.stack(out)


# counter functions query http_requests_total, the rest node_temp; the ops rotate
COUNTER_FUNCS = {"rate", "increase", "delta", "irate", "idelta", "changes", "resets", "deriv"}


def fused_query(func: str) -> str:
    metric = "http_requests_total" if func in COUNTER_FUNCS else "node_temp"
    op = OPS[sorted(FUSED_FUNCS).index(func) % len(OPS)]
    inner = metric if func == "last" else f"{func}({metric}[5m])"  # last: the bare selector
    return f"{op} by (zone) ({inner})"


@pytest.mark.parametrize("grid", ENGINE_GRIDS)
@pytest.mark.parametrize("func", sorted(FUSED_FUNCS))
def test_every_fused_function_matches_jax(stores, func, grid):
    jms, pms = stores[grid]
    query = fused_query(func)
    assert assert_engine_matches(jms, pms, query, grid) == expected_rung(query, grid)


# chip_smoke.py's phase-8 queries (on its irregular store; sum(changes) also
# on its regular one), offsets both ways, and gauge flags
PHASE8_QUERIES = [
    "sum(irate(http_requests_total[5m]))",
    "sum by (zone) (changes(http_requests_total[5m]))",
    "sum(resets(http_requests_total[5m]))",
    "sum(deriv(http_requests_total[5m]))",
    "sum by (zone) (stddev_over_time(http_requests_total[5m]))",
    "sum(rate(http_requests_total[5m] offset 1m))",
    "sum(rate(http_requests_total[5m] offset -1m))",
    "max by (zone) (changes(http_requests_total[5m] offset 2m))",
    "avg by (zone) (deriv(http_requests_total[5m] offset -2m))",
    "count by (zone) (resets(node_temp[5m]))",
    "sum(changes(node_temp[2m]))",
]


def expected_rung(query: str, grid: str) -> str:
    from filodb_tpu_torch.query.promql import query_range_to_logical_plan

    inner = query_range_to_logical_plan(query, START_S, END_S, STEP_S).inner
    func = getattr(inner, "function", None) or "last"
    if grid == "regular" and func in JAGG.FUSED_MXU_FUNCS:
        return "mxu"
    if grid == "jitter" and func in JAGG.FUSED_JITTER_FUNCS:
        return "jitter"
    return "window_stats" if func in WS.PALLAS_FUNCS else "general"


@pytest.mark.parametrize("query", PHASE8_QUERIES)
def test_phase8_queries_match_jax(stores, query):
    jms, pms = stores["irregular"]
    assert assert_engine_matches(jms, pms, query, "irregular") == expected_rung(
        query, "irregular")


def test_changes_on_the_regular_store_takes_general(stores):
    """The JAX package runs changes on a regular grid through its general
    kernel; so does the port."""
    jms, pms = stores["regular"]
    assert assert_engine_matches(jms, pms, "sum(changes(http_requests_total[5m]))",
                                 "regular") == "general"


@pytest.mark.parametrize("query", [
    "sum by (zone) (deriv(http_requests_total[5m]))",
    "sum(irate(http_requests_total[5m] offset 1m))",
    "avg(z_score(node_temp[5m]))",
])
def test_instant_queries_match_jax(stores, query):
    jms, pms = stores["irregular"]
    assert assert_engine_matches(jms, pms, query, "irregular", instant=True) == "general"


def test_offset_shifts_the_grid(stores):
    """``offset 1m`` on a 60 s step is the same windows one step earlier."""
    _, pms = stores["irregular"]
    eng = QueryEngine(pms, "prometheus", device="cpu")
    q = "sum by (zone) (changes(http_requests_total[5m]))"
    plain = rows_of(eng.query_range(q, START_S - 60, END_S, STEP_S))[1]
    shifted = rows_of(eng.query_range(q.replace("[5m]", "[5m] offset 1m"), START_S, END_S,
                                      STEP_S))[1]
    np.testing.assert_array_equal(shifted, plain[:, :-1])


# -- offset and general selections in the superblock cache ------------------------


def live_store():
    """A JAX and a port store of counters, 60 samples on one 10 s grid."""
    rng = np.random.default_rng(5)
    jms, pms = JaxMemStore(), TimeSeriesMemStore()
    jms.setup(JS.Dataset("ds"), range(E_SHARDS))
    pms.setup(S.Dataset("ds"), range(E_SHARDS))
    for i in range(E_SERIES):
        ts = BASE + 3_000 + np.arange(60, dtype=np.int64) * 10_000
        vals = np.cumsum(rng.uniform(0, 10, 60)) + 1e9
        tags = {S.METRIC_TAG: "m", "_ws_": "demo", "_ns_": "App-2", "instance": f"host-{i}",
                "zone": f"z{i % 4}"}
        s = S.shard_for(tags, SPREAD, E_SHARDS)
        jms.shard("ds", s).ingest_series(JaxSeriesBatch(JS.PROM_COUNTER, tags, ts, {"count": vals}))
        pms.shard("ds", s).ingest_series(SeriesBatch(S.PROM_COUNTER, tags, ts, {"count": vals}))
    return jms, pms


def append_head(jms, pms, slot: int):
    """One sample per series at ``slot`` of the grid, in both stores."""
    for ms, mod, batch in ((jms, JS, JaxSeriesBatch), (pms, S, SeriesBatch)):
        for i in range(E_SERIES):
            tags = {S.METRIC_TAG: "m", "_ws_": "demo", "_ns_": "App-2",
                    "instance": f"host-{i}", "zone": f"z{i % 4}"}
            t = BASE + 3_000 + slot * 10_000
            ms.shard("ds", S.shard_for(tags, SPREAD, E_SHARDS)).ingest_series(batch(
                mod.PROM_COUNTER, tags, np.array([t], np.int64),
                {"count": np.array([2e9 + slot + i])}))


@pytest.mark.parametrize("query,on_append", [
    ("sum(rate(m[5m] offset 1m))", "extend"),
    ("sum(irate(m[5m] offset -30s))", "extend"),
    ("sum by (zone) (stddev_over_time(m[5m]))", "extend"),
    ("sum(changes(m[5m] offset 1m))", "restage"),
])
def test_live_edge_cache_sequence_matches_jax(query, on_append):
    """Cold, warm (a hit), then one sample per series at the head: the
    cached superblock extends (raw, shifted and corrected modes) or
    restages (diff mode), as in the JAX package, and every answer agrees
    with the JAX engine's."""
    jms, pms = live_store()
    jeng, peng = JaxEngine(jms, "ds"), QueryEngine(pms, "ds", device="cpu")
    start, end = (BASE + 400_000) / 1000, (BASE + 800_000) / 1000  # past the head
    for step, expect in (("cold", {}), ("warm", {}), ("append", {on_append: 1})):
        if step == "append":
            append_head(jms, pms, 60)
        p0 = M.superblock_events()
        want = jeng.query_range(query, start, end, STEP_S)
        got = peng.query_range(query, start, end, STEP_S)
        p1 = M.superblock_events()
        assert {o: p1[o] - p0[o] for o in p0 if p1[o] != p0[o]} == expect, step
        if step == "warm":
            assert got.stats.cache_hits == 1 and got.stats.cache_misses == 0
        (wl, w), (gl, g) = rows_of(want), rows_of(got)
        assert gl == wl, step
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=step)
        m = ~np.isnan(w)
        assert m.any(), step
        np.testing.assert_allclose(g[m], w[m], rtol=RTOL, atol=ATOL, err_msg=step)


def test_offset_selection_keys_its_own_superblock(stores):
    """An offset query stages its own (shifted) range: a later query
    without offset does not hit its superblock, and the same offset does.
    The shards' blocks of the range without offset are staged first (a
    query against a throwaway superblock cache), so the one miss counted
    below is the superblock's, whatever ran before."""
    _, pms = stores["irregular"]
    eng = QueryEngine(pms, "prometheus", device="cpu")
    q = "sum(changes(http_requests_total[5m]))"
    pms._superblock_cache = None
    eng.query_range(q, START_S, END_S, STEP_S)
    pms._superblock_cache = None
    first = eng.query_range(q.replace("[5m]", "[5m] offset 2m"), START_S, END_S, STEP_S)
    assert len(pms._superblock_cache._d) == 1
    again = eng.query_range(q.replace("[5m]", "[5m] offset 2m"), START_S, END_S, STEP_S)
    assert again.stats.cache_hits == 1 and again.stats.cache_misses == 0
    np.testing.assert_array_equal(rows_of(again)[1], rows_of(first)[1])
    other = eng.query_range(q, START_S, END_S, STEP_S)
    assert other.stats.cache_misses == 1  # the superblock; its shards' blocks are cached
    keys = list(pms._superblock_cache._d)
    assert len(keys) == 2 and {k[6] for k in keys} == {"diff"}
    # (dataset, shards, filters, raw start, raw end, ...): two staged ranges, 2 min apart
    (a, b) = sorted((k[3], k[4]) for k in keys)
    assert b[0] - a[0] == b[1] - a[1] == 120_000
