"""The port's regular rung against the JAX package's MXU rung on the same
numpy inputs: ``WindowMatrices``, ``mxu_range_plain`` against
``mxu_range_kernel`` (under both of the JAX package's fetch strategies,
``FILODB_MXU_FETCH=gather`` and ``matmul``, as tests/test_fetch_parity.py
forces them), and ``regular_range_aggregate`` on the CPU against the JAX
package's fused MXU dispatch (``_fused_mxu_jit``); the B5 codes
(changes/resets, min/max, deriv/predict_linear, absent_over_time) against
``run_mxu_range_function``, deriv and predict_linear by the JAX-or-oracle
rule.

Tolerance rtol 2e-4 / atol 1e-4 (as tests/test_pallas.py): the window sums
are taken in another order. NaN masks must be identical."""

import numpy as np
import pytest
import torch

from filodb_tpu.ops import aggregations as JAGG
from filodb_tpu.ops import kernels as JK
from filodb_tpu.ops import mxu_kernels as JMK
from filodb_tpu.ops import staging as JST
from filodb_tpu_torch.ops import mxu_kernels as MK
from filodb_tpu_torch.ops import staging as ST
from filodb_tpu_torch.ops.kernels import RangeParams, pad_steps

BASE = 1_600_000_000_000
INTERVAL = 10_000
START = BASE + 400_000
STEP = 60_000
WINDOW = 300_000
NUM_STEPS = 20
FUNCS = sorted(MK.FUSED_MXU_FUNCS)
# block kinds: gauge values, or a counter staged in each of the four modes
BLOCKS = {
    "gauge": ({}, False),
    "counter-raw": ({}, True),
    "counter-corrected": ({"counter_corrected": True}, True),
    "counter-shifted": ({"subtract_baseline": True}, True),
    "counter-diff": ({"diff_encode": True}, True),
}


def make_series(counter: bool, n_series=6, n=150, seed=0):
    """Series on one shared 10 s grid: gauges, or counters with one reset."""
    rng = np.random.default_rng(seed)
    ts = BASE + 3_000 + np.arange(n, dtype=np.int64) * INTERVAL
    out = []
    for i in range(n_series):
        if counter:
            vals = np.cumsum(rng.uniform(0, 10, n)) + 1e3
            k = n // 2 + i
            vals[k:] -= vals[k] - rng.uniform(0, 5)
        else:
            vals = 50 + 20 * rng.standard_normal(n)
        out.append((ts, vals))
    return out


def blocks(kind: str, seed: int, n_series=6):
    """The same series staged by both packages (the port's on the CPU)."""
    opts, counter = BLOCKS[kind]
    series = make_series(counter, n_series=n_series, seed=seed)
    jb = JST.stage_series(series, BASE, **opts)
    pb = ST.stage_series(series, BASE, **opts).to_device("cpu")
    assert jb.regular_ts is not None and pb.regular_ts is not None
    return jb, pb, counter


def assert_close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=what)
    m = ~np.isnan(want)
    np.testing.assert_allclose(got[m], want[m], rtol=2e-4, atol=1e-4, err_msg=what)


GRIDS = {
    # the main path's shape of grid
    "main": (START - BASE, STEP, WINDOW),
    # steps before the first sample and past the last one
    "outside": (-900_000, 400_000, 100_000),
    # windows narrower than the scrape interval: some hold no sample
    "narrow": (START - BASE, 7_000, 4_000),
}


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_window_matrices_match_jax(grid):
    start_off, step, window = GRIDS[grid]
    jb = JST.stage_series(make_series(False, n_series=3, seed=1), BASE)
    J = pad_steps(NUM_STEPS)
    n_valid = int(jb.lens[0])
    want = JMK.WindowMatrices(jb.regular_ts, n_valid, start_off, step, J, window)
    got = MK.WindowMatrices(jb.regular_ts, n_valid, start_off, step, J, window, device="cpu")
    np.testing.assert_array_equal(got.lo.numpy(), want._lo.astype(np.int32))
    np.testing.assert_array_equal(got.hi.numpy(), want._hi.astype(np.int32))
    for name, jname in (("count", "d_count"), ("t_first", "d_tf"), ("t_last", "d_tl"),
                        ("t_last2", "d_tl2"), ("out_t", "d_out_t"), ("idx", "d_idx"),
                        ("W", "W"), ("F", "F"), ("L", "L"), ("L2", "L2")):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, jname))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    count = got.count.numpy()
    if grid == "outside":
        assert count[0] == 0 and count[-1] == 0 and count.max() > 0
    if grid == "narrow":
        assert (count == 0).any() and (count == 1).any()


def test_window_matrices_memoized_on_block():
    _, pb, _ = blocks("gauge", seed=2)
    a = MK.window_matrices(pb, START - BASE, STEP, 64, WINDOW)
    assert MK.window_matrices(pb, START - BASE, STEP, 64, WINDOW) is a
    assert MK.window_matrices(pb, START - BASE, STEP, 64, 2 * WINDOW) is not a
    assert a.count.device.type == "cpu"


@pytest.mark.parametrize("fetch", ["gather", "matmul"])
@pytest.mark.parametrize("kind", sorted(BLOCKS))
@pytest.mark.parametrize("func", FUNCS)
def test_range_plain_matches_mxu_kernel(func, kind, fetch, monkeypatch):
    monkeypatch.setenv("FILODB_MXU_FETCH", fetch)
    jb, pb, counter = blocks(kind, seed=3 + FUNCS.index(func))
    J = pad_steps(NUM_STEPS)
    start_off = START - BASE
    jwm = JMK.window_matrices(jb, start_off, STEP, J, WINDOW)
    jraw = jb.raw if jb.raw is not None else jb.vals
    want = JMK.mxu_range_kernel(
        func, jb.vals, jraw, jb.baseline, jwm.dW, jwm.dF, jwm.dL, jwm.dL2, jwm.d_count,
        jwm.d_tf, jwm.d_tl, jwm.d_tl2, jwm.d_out_t, np.float32(WINDOW), idx=jwm.d_idx,
        is_counter=counter, fetch=JMK.fetch_strategy())
    wm = MK.window_matrices(pb, start_off, STEP, J, WINDOW)
    raw = pb.raw if pb.raw is not None else pb.vals
    got = MK.mxu_range_plain(func, pb.vals, raw, wm, WINDOW, is_counter=counter)
    n = jb.n_series
    assert_close(got.numpy()[:n, :NUM_STEPS], np.asarray(want)[:n, :NUM_STEPS], func)
    assert not np.isnan(got.numpy()[:n, :NUM_STEPS]).all()


@pytest.mark.parametrize("func", ["rate", "increase", "irate", "idelta"])
def test_range_plain_matches_mxu_kernel_on_delta_columns(func):
    jb, pb, _ = blocks("gauge", seed=4)
    J = pad_steps(NUM_STEPS)
    jwm = JMK.window_matrices(jb, START - BASE, STEP, J, WINDOW)
    want = JMK.mxu_range_kernel(
        func, jb.vals, jb.vals, jb.baseline, jwm.dW, jwm.dF, jwm.dL, jwm.dL2, jwm.d_count,
        jwm.d_tf, jwm.d_tl, jwm.d_tl2, jwm.d_out_t, np.float32(WINDOW), idx=jwm.d_idx,
        is_counter=True, is_delta=True)
    wm = MK.window_matrices(pb, START - BASE, STEP, J, WINDOW)
    got = MK.mxu_range_plain(func, pb.vals, pb.vals, wm, WINDOW, is_counter=True, is_delta=True)
    assert_close(got.numpy()[:6, :NUM_STEPS], np.asarray(want)[:6, :NUM_STEPS], func)


def gids_for(n_series: int, s_pad: int, num_groups: int, seed: int):
    """Real rows spread over ``num_groups`` groups (every group used),
    padded rows in the trash group ``num_groups``."""
    rng = np.random.default_rng(seed)
    g = np.full(s_pad, num_groups, np.int64)
    g[:n_series] = rng.permutation(np.arange(n_series) % num_groups)
    return g


@pytest.mark.parametrize("op", ["sum", "count", "avg", "min", "max"])
@pytest.mark.parametrize("func", ["rate", "irate", "idelta", "sum_over_time", "z_score",
                                  "count_over_time", "last"])
def test_regular_range_aggregate_matches_fused_mxu(func, op, monkeypatch):
    calls = []
    real = JAGG._fused_mxu_jit

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    counted._cache_size = real._cache_size
    monkeypatch.setattr(JAGG, "_fused_mxu_jit", counted)
    kind = {"rate": "counter-corrected", "irate": "counter-corrected",
            "idelta": "counter-diff"}.get(func, "gauge")
    jb, pb, counter = blocks(kind, seed=20, n_series=13)
    G = 3
    gids = gids_for(13, pb.vals.shape[0], G, seed=21)
    assert (gids == G).sum() == pb.vals.shape[0] - 13 > 0
    params = RangeParams(START, STEP, NUM_STEPS, WINDOW)
    want = JAGG.fused_range_aggregate(func, op, jb, gids.astype(np.int32), G,
                                      JK.RangeParams(START, STEP, NUM_STEPS, WINDOW),
                                      is_counter=counter)
    assert calls == [1]
    monkeypatch.setattr(MK, "LAUNCHES", 0)
    got = MK.regular_range_aggregate(func, op, pb, torch.from_numpy(gids), G, params,
                                     is_counter=counter)
    assert MK.LAUNCHES == 0
    assert got.shape == (G, pad_steps(NUM_STEPS))
    assert_close(got.numpy()[:, :NUM_STEPS], np.asarray(want)[:, :NUM_STEPS], f"{op}({func})")


def test_regular_range_aggregate_rejects_bad_inputs():
    _, pb, _ = blocks("gauge", seed=5)
    params = RangeParams(START, STEP, NUM_STEPS, WINDOW)
    gids = torch.zeros(pb.vals.shape[0], dtype=torch.int64)
    with pytest.raises(TypeError):
        MK.regular_range_aggregate("rate", "sum", pb, gids.to(torch.int32), 1, params)
    with pytest.raises(ValueError):
        MK.regular_range_aggregate("rate", "sum", pb, gids[:3], 1, params)
    with pytest.raises(NotImplementedError):
        MK.regular_range_aggregate("quantile_over_time", "sum", pb, gids, 1, params)
    with pytest.raises(NotImplementedError):
        MK.regular_range_aggregate("rate", "stddev", pb, gids, 1, params)
    irregular = ST.stage_series([(np.array([BASE, BASE + 7_000]), np.array([1.0, 2.0])),
                                 (np.array([BASE]), np.array([1.0]))], BASE).to_device("cpu")
    with pytest.raises(ValueError, match="regular grid"):
        MK.regular_range_aggregate("rate", "sum", irregular,
                                   torch.zeros(8, dtype=torch.int64), 1, params)


def test_kernel_codes_cover_the_functions():
    """The fused set is the JAX package's; the kernel codes cover the rest
    of its MXU rung (the tree's), timestamp being the host's."""
    assert MK.FUSED_MXU_FUNCS == JAGG.FUSED_MXU_FUNCS
    assert MK.MXU_FUNCS == JMK.MXU_FUNCS
    assert set(MK.FUNC_CODES) == MK.MXU_FUNCS - {"timestamp"}
    assert set(MK.ACC_CODES) == {"sum", "count", "avg", "min", "max"}


# -- B5: the rest of the MXU rung ----------------------------------------------------------

B5_FUNCS = sorted(MK.MXU_FUNCS - MK.FUSED_MXU_FUNCS - {"timestamp"})


def regression_oracle(func, ts1, vals, n_valid, start_off, step, J, window, lead):
    """deriv/predict_linear in float64 over the regular windows of the f32
    values (tc rounded to f32 once, as both packages take it), and the
    windows' sample counts."""
    ts = ts1[:n_valid].astype(np.int64)
    out_t = start_off + np.arange(J, dtype=np.int64) * step
    hi = np.searchsorted(ts, out_t, side="right")
    lo = np.searchsorted(ts, out_t - window, side="right")
    v64 = np.asarray(vals, np.float64)
    out = np.full((v64.shape[0], J), np.nan)
    for j in range(J):
        if hi[j] - lo[j] < 2:
            continue
        tc = ((ts[lo[j]:hi[j]] - out_t[j]) * 1e-3).astype(np.float32).astype(np.float64)
        w = v64[:, lo[j]:hi[j]]
        n = float(hi[j] - lo[j])
        denom = n * (tc * tc).sum() - tc.sum() ** 2
        slope = (n * (w * tc).sum(1) - tc.sum() * w.sum(1)) / denom
        out[:, j] = slope if func == "deriv" else (w.sum(1) - slope * tc.sum()) / n + slope * lead
    return out, np.broadcast_to(hi - lo, out.shape)


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("kind", ["gauge", "counter-corrected", "counter-shifted",
                                  "counter-diff"])
@pytest.mark.parametrize("func", B5_FUNCS)
def test_b5_codes_match_jax(func, kind, grid):
    """The regular rung's B5 codes through ``mxu_range_plain`` against the
    JAX package's ``run_mxu_range_function`` (``mxu_pair_count``,
    ``mxu_minmax``, ``mxu_regression``, the absent arm): counts and
    extremes exact, deriv and predict_linear by the JAX-or-oracle rule."""
    from tests.test_torch_general import assert_jax_or_oracle

    jb, pb, counter = blocks(kind, seed=31 + len(grid))
    start_off, step, window = GRIDS[grid]
    args = (600.0,) if func == "predict_linear" else ()
    want = np.asarray(JMK.run_mxu_range_function(
        func, jb, JK.RangeParams(BASE + start_off, step, NUM_STEPS, window),
        is_counter=counter, args=args))[:, :NUM_STEPS]
    params = RangeParams(BASE + start_off, step, NUM_STEPS, window)
    got = MK.regular_range_series(func, pb, torch.from_numpy(
        np.where(np.arange(pb.vals.shape[0]) < pb.n_series, 0, 1)), 1, params,
        is_counter=counter, args=args).T.numpy()[:, :NUM_STEPS]
    n = pb.n_series
    what = f"{func} {kind} {grid}"
    if func in ("deriv", "predict_linear"):
        exact, count = regression_oracle(func, pb.regular_ts, pb.vals.numpy()[:n],
                                         int(pb.lens[0]), start_off, step, NUM_STEPS, window,
                                         600.0)
        assert_jax_or_oracle(got[:n], want[:n], exact, count, what)
    elif func in ("changes", "resets", "min_over_time", "max_over_time"):
        np.testing.assert_array_equal(np.isnan(got[:n]), np.isnan(want[:n]), err_msg=what)
        np.testing.assert_array_equal(got[:n][~np.isnan(want[:n])],
                                      want[:n][~np.isnan(want[:n])], err_msg=what)
    else:
        assert_close(got[:n], want[:n], what)


def test_window_matrices_lazy_builders_match_jax():
    """``ensure_pairs`` and ``ensure_regression`` build the JAX package's
    P, Wt, st and stt."""
    jb, pb, _ = blocks("gauge", seed=3)
    jwm = JMK.window_matrices(jb, START - BASE, STEP, pad_steps(NUM_STEPS), WINDOW)
    pwm = MK.window_matrices(pb, START - BASE, STEP, pad_steps(NUM_STEPS), WINDOW)
    jwm.ensure_pairs()
    jwm.ensure_regression()
    pwm.ensure_pairs()
    pwm.ensure_regression()
    np.testing.assert_array_equal(pwm.P.numpy(), jwm.P)
    np.testing.assert_array_equal(pwm.Wt.numpy(), jwm.Wt)
    np.testing.assert_array_equal(pwm.st.numpy(), jwm.st)
    np.testing.assert_array_equal(pwm.stt.numpy(), jwm.stt.astype(np.float32))
