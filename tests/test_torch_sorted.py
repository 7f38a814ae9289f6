"""The sorted-window kernel's plain version (B8) against the JAX package's
``sorted_window_kernel``, and the general kernel's argument functions (B4:
predict_linear, Holt-Winters) in ``range_kernel_plain`` against
``range_kernel``, on the seeded blocks chip_smoke.py's phase 2d holds the
Hopper kernels on (irregular rows with tied timestamps, NaN samples, a row
with no sample, -0.0 among gauge values, shifted counters, one shared 10 s
grid, and 5 s rows whose 1 h windows hold up to 720 samples); plus the
launch plan's routes and numpy restatements of the kernel's key order,
lane count select and radix select.

Tolerances: order statistics of the sorted windows bit-equal and
interpolations within 2 ulp (XLA may fuse the interpolation's multiply-add
on the CPU, the port rounds twice), NaN masks and infinities equal;
Holt-Winters rtol 2e-4 / atol 1e-4; predict_linear by the JAX-or-oracle
rule (the port sums in f64, range_kernel in f32; ROADMAP C): rtol 2e-4 /
atol 1e-4 against JAX where JAX agrees with a float64 oracle, else
against the oracle."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from filodb_tpu.ops.kernels import range_kernel as jax_range_kernel
from filodb_tpu.ops.kernels import sorted_window_kernel
from filodb_tpu_torch.ops import sorted_window as SW
from filodb_tpu_torch.ops.kernels import pad_steps, range_kernel_plain

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

BASE = chip_smoke.BASE
RTOL, ATOL = 2e-4, 1e-4
J = 48
CASES = {  # name -> (kind, n_real, T, start offset ms, step ms, window ms)
    "irregular-5m": ("irregular", 20, 128, -60_000, 30_000, 300_000),
    "irregular-8s": ("irregular", 20, 128, -60_000, 30_000, 8_000),
    "regular-5m": ("regular", 12, 256, -60_000, 50_000, 300_000),
    "long-1h": ("long", 6, 768, 3_000_000, 20_000, 3_600_000),
}


def arrays(case: str, counter: bool):
    kind, n, T, *_ = CASES[case]
    b = chip_smoke.window_block(n, T, kind, counter, 11, "cpu")
    return b, tuple(np.asarray(a) for a in (b.ts, b.vals, b.lens))


def ulp_gap(got: np.ndarray, want: np.ndarray) -> int:
    return chip_smoke.ulp_gap(torch.from_numpy(np.ascontiguousarray(got)),
                              torch.from_numpy(np.ascontiguousarray(want)))


@pytest.mark.parametrize("counter", [False, True], ids=["gauge", "counter"])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("func, args", [
    ("quantile_over_time", (-0.1,)), ("quantile_over_time", (0.0,)),
    ("quantile_over_time", (0.5,)), ("quantile_over_time", (0.9,)),
    ("quantile_over_time", (1.0,)), ("quantile_over_time", (1.1,)),
    ("median_absolute_deviation_over_time", ()),
    ("last_over_time_is_mad_outlier", (0.0, 1.0)), ("last_over_time_is_mad_outlier", (1.0, 0.0)),
    ("last_over_time_is_mad_outlier", (2.0, 1.0)), ("last_over_time_is_mad_outlier", (0.5, 2.0)),
])
def test_sorted_window_plain_matches_jax(func, args, case, counter):
    _, (ts, vals, lens) = arrays(case, counter)
    _, _, _, start, step, window = CASES[case]
    q, a1 = SW.func_args(args)
    want = np.asarray(sorted_window_kernel(
        func, ts, vals, lens, np.int32(start), np.int32(step), np.int32(window), pad_steps(J),
        q=np.float32(q), arg1=np.float32(a1)))[:, :J]
    got = SW.sorted_window_plain(func, *(torch.from_numpy(a) for a in (ts, vals, lens)), start,
                                 step, window, J, q, a1).numpy()
    assert got.shape == want.shape
    assert ulp_gap(got, want) <= 2, (func, args, case)
    if func != "last_over_time_is_mad_outlier" or args[0] == 0.0:  # (tolerance 0: most flag)
        assert np.isfinite(got).any(), (func, case)


def test_sorted_window_entry_pads_rows_and_steps():
    """The wrapper's [S_pad, J_pad] grid on a CPU block: the plain values in
    the real rows' real steps, NaN elsewhere; nothing counted as a launch."""
    from filodb_tpu_torch.ops.kernels import RangeParams

    b, (ts, vals, lens) = arrays("irregular-5m", False)
    params = RangeParams(BASE - 60_000, 30_000, 21, 300_000)
    before = SW.LAUNCHES
    out = SW.sorted_window("quantile_over_time", b, params, (0.9,)).numpy()
    assert SW.LAUNCHES == before
    assert out.shape == (ts.shape[0], pad_steps(21))
    assert np.isnan(out[:, 21:]).all() and np.isnan(out[b.n_series:]).all()
    want = SW.sorted_window_plain("quantile_over_time", b.ts, b.vals, b.lens, -60_000, 30_000,
                                  300_000, 21, 0.9).numpy()
    np.testing.assert_array_equal(out[: b.n_series, :21], want[: b.n_series])
    with pytest.raises(NotImplementedError):
        SW.sorted_window("rate", b, params)


@pytest.mark.parametrize("T, staged", [
    (1, True), (128, True), (768, True), (7_136, True), (7_137, False), (100_000, False),
])
def test_sorted_plan_routes_from_the_width(T, staged):
    """Rows staged (timestamps, keys and the warp's bins) while WARPS of
    them fit a block's shared memory, else read in place (the bins alone)."""
    plan = SW.sorted_plan(T)
    assert plan.staged == staged
    assert plan.words == (2 * T + SW.BINS if staged else SW.BINS)
    assert plan.smem_bytes == 4 * SW.WARPS * plan.words <= SW.BLOCK_SMEM


# -- numpy restatements of the kernel's order (csrc/sorted_window.cu) ---------------


def key_of(x: np.ndarray) -> np.ndarray:
    """key_of: -0 -> +0 and NaN -> the canonical NaN, then the sign bit set
    (positive) or every bit flipped (negative)."""
    c = np.where(np.isnan(x), np.float32(np.nan), np.where(x == 0, np.float32(0), x))
    u = c.astype(np.float32).view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def value_of(k: np.ndarray) -> np.ndarray:
    return np.where(k & 0x80000000, k & 0x7FFFFFFF, ~k).astype(np.uint32).view(np.float32)


def count_select(keys: np.ndarray, r: int) -> int:
    """The lane route: the key k_i with #{k < k_i} <= r < #{k <= k_i}."""
    for ki in keys:
        if (keys < ki).sum() <= r < (keys <= ki).sum():
            return int(ki)
    raise AssertionError("no key holds the rank")


def radix_select(keys: np.ndarray, r: int) -> int:
    """The kernel's four 8-bit passes: the key of rank r."""
    prefix = mask = 0
    for shift in (24, 16, 8, 0):
        match = keys[(keys & mask) == prefix]
        hist = np.bincount((match >> shift) & 0xFF, minlength=256)
        cum = np.cumsum(hist)
        b = int(np.searchsorted(cum, r, side="right"))
        r -= int(cum[b - 1]) if b else 0
        prefix |= b << shift
        mask |= 0xFF << shift
    return prefix


@pytest.mark.parametrize("seed", range(4))
def test_kernel_key_order_sorts_as_jnp_sort(seed):
    """Keys of finite values, +-0, +-inf and NaN sort as jnp.sort sorts the
    values (NaN last; -0 and +0 tie -- jnp.sort keeps each zero's sign
    where the keys make it +0, and no interpolation tells them apart: a
    zero result rounds to +0); every rank's lane count and radix select
    agree."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 90))
    x = np.round(rng.standard_normal(n) * 4).astype(np.float32) / 2
    x[rng.random(n) < 0.1] = -0.0
    x[rng.random(n) < 0.1] = np.nan
    x[rng.random(n) < 0.05] = np.inf
    x[rng.random(n) < 0.05] = -np.inf
    want = np.asarray(jnp.sort(jnp.asarray(x)))
    keys = key_of(x)
    got = value_of(np.array([count_select(keys, r) for r in range(n)], np.uint32))
    np.testing.assert_array_equal(got, want)
    for r in range(n):
        assert radix_select(keys, r) == np.sort(keys)[r]


# -- the general kernel's argument functions (B4) ----------------------------------


def f64_predict(ts, vals, lens, start, step, window, horizon):
    out = np.full((ts.shape[0], J), np.nan)
    for s in range(ts.shape[0]):
        t_row, v_row = ts[s, : lens[s]].astype(np.int64), vals[s, : lens[s]].astype(np.float64)
        for j in range(J):
            t = start + j * step
            m = (t_row > t - window) & (t_row <= t)
            w, n = v_row[m], int(m.sum())
            tc = ((t_row[m] - t).astype(np.float32) * np.float32(1e-3)).astype(np.float64)
            denom = n * (tc * tc).sum() - tc.sum() ** 2
            if n < 2 or abs(denom) < 1e-30:
                continue
            slope = (n * (tc * w).sum() - tc.sum() * w.sum()) / denom
            out[s, j] = (w.sum() - slope * tc.sum()) / n + slope * horizon
    return out


@pytest.mark.parametrize("counter", [False, True], ids=["gauge", "counter"])
@pytest.mark.parametrize("case", ["irregular-5m", "regular-5m", "long-1h"])
@pytest.mark.parametrize("func, args", [
    ("predict_linear", (600.0,)), ("predict_linear", (-45.5,)),
    ("double_exponential_smoothing", (0.3, 0.1)), ("double_exponential_smoothing", (0.9, 0.5)),
])
def test_argument_functions_match_range_kernel(func, args, case, counter):
    b, (ts, vals, lens) = arrays(case, counter)
    _, _, _, start, step, window = CASES[case]
    vals = np.nan_to_num(vals)  # range_kernel's windows assume NaN-free staging
    baseline = np.zeros(ts.shape[0], np.float32)
    a0, a1 = (list(args) + [0.0])[:2]
    want = np.asarray(jax_range_kernel(
        func, ts, vals, lens, baseline, vals, np.int32(start), np.int32(step), np.int32(window),
        J, arg0=np.float32(a0), arg1=np.float32(a1)))
    got = range_kernel_plain(func, *(torch.from_numpy(a) for a in (ts, vals, lens, baseline,
                                                                     vals)),
                             start, step, window, J, arg0=a0, arg1=a1).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=func)
    m = ~np.isnan(want)
    assert m.any()
    if func == "predict_linear":
        exact = f64_predict(ts, vals, lens, start, step, window, np.float32(a0))
        ok = ~m | np.isclose(want, exact, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got[m & ok], want[m & ok], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got[~ok], exact[~ok], rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_allclose(got[m], want[m], rtol=RTOL, atol=ATOL)
