"""Host side and plain twins of the general range kernel
(``csrc/general_range.cu``) on the CPU: the launch plan
(``general_range.general_plan``) against the shared-memory budget; the
kernel's branchless window searches and its shared bounds table on a
regular grid, restated here in torch (``window_bounds``,
``shared_window_bounds``), against ``kernels._bounds`` and the JAX
package's ``_bounds`` on edge grids; the kernel's pair-flag prefix
(``flag_prefix``) against ``range_kernel_plain`` (bit-equal); and
``range_kernel_plain`` against the JAX ``range_kernel`` at window lengths
around the kernel's four-sample walk and lockstep widths. Inputs are made
by numpy from a seed.

Tolerance rtol 2e-4 / atol 1e-4 (f32 sums in another order), NaN masks
identical; the moments and deriv are held to JAX, and where the two differ
by more, to a float64 oracle that JAX is further from (the port's mean is
the window's own sum and its deriv sums run in f64; ROADMAP C).
"""

import importlib.util
from pathlib import Path

import hypothesis.strategies as st
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings

from filodb_tpu.ops.kernels import _bounds as jax_bounds
from filodb_tpu.ops.kernels import range_kernel as jax_range_kernel
from filodb_tpu_torch.ops import general_range as GR
from filodb_tpu_torch.ops import group_acc as GA
from filodb_tpu_torch.ops.kernels import _bounds, range_kernel_plain
from filodb_tpu_torch.ops.staging import TS_PAD, stage_series

_spec = importlib.util.spec_from_file_location(
    "tile_sweep", Path(__file__).resolve().parents[1] / "tile_sweep.py")
tile_sweep = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tile_sweep)

BASE = 1_600_000_000_000
RTOL, ATOL = 2e-4, 1e-4
FUNCS = sorted(GR.GENERAL_FUNCS)


# -- the launch plan -------------------------------------------------------------


@pytest.mark.parametrize("func", FUNCS)
@settings(max_examples=60, deadline=None)
@given(G=st.integers(1, 20_000), J=st.integers(1, 3_000), T=st.sampled_from([4, 128, 768,
                                                                             4096, 32_768]),
       staging=st.sampled_from([(False, False), (True, False), (True, True)]),
       distinct_raw=st.booleans(), shared_bounds=st.booleans())
def test_general_plan_fits_the_block(func, G, J, T, staging, distinct_raw, shared_bounds):
    """The plan of a launch of ``func`` (staging the arrays
    ``staged_arrays`` counts, as the wrapper does) fits the block's shared
    memory, sizes it as the C entry does, keeps shared partials only within
    their budget, and reads rows in place only where one warp's staged row
    would not fit."""
    n_arrays = GR.staged_arrays(func, *staging, distinct_raw=distinct_raw)
    plan = GR.general_plan(G, J, T, n_arrays, shared_bounds)
    assert plan.smem_bytes <= GA.BLOCK_SMEM
    assert plan.smem_bytes == GR.general_smem_bytes(G, plan.steps, plan.warps, T, plan.n_arrays,
                                                    plan.shared, shared_bounds)
    assert plan.steps == min(J, GR.MAX_SLICE_STEPS) and plan.shared_bounds == shared_bounds
    assert plan.shared == (2 * G * plan.steps * 4 <= GA.PARTIALS_BUDGET)
    assert 1 <= plan.warps <= GR.MAX_WARPS
    if plan.staged:
        assert plan.n_arrays == n_arrays
    else:
        assert plan.warps == GR.WARPS
        one = GR.general_smem_bytes(G, plan.steps, 1, T, n_arrays, plan.shared, shared_bounds)
        assert one > GA.BLOCK_SMEM


@pytest.mark.parametrize("func", FUNCS)
def test_general_plan_of_the_main_path(func):
    """Phase 4's shape (one group, 111 steps, [., 768] rows of a counter,
    ts and vals): ``WARPS`` warps, one slice, shared partials."""
    plan = GR.general_plan(1, 111, 768, GR.staged_arrays(func, True, False))
    assert (plan.warps, plan.steps, plan.n_arrays) == (GR.WARPS, 111, 2)
    assert plan.shared and plan.staged and not plan.shared_bounds and plan.partials == "shared"
    assert plan.smem_bytes == 4 * (224 + GR.WARPS * (4 * 112 + 2 * 768))


@pytest.mark.parametrize("n_arrays", [2, 3])
def test_general_plan_reads_wide_rows_in_place(n_arrays):
    """Rows of 32,768 samples read in place (changes/resets then walk their
    windows: no staged prefix)."""
    plan = GR.general_plan(2, 100, 32_768, n_arrays)
    assert not plan.staged and plan.n_arrays == 0 and plan.warps == GR.WARPS
    assert plan.smem_bytes <= GA.BLOCK_SMEM


def test_general_plan_slices_long_ranges():
    plan = GR.general_plan(3, 10_000, 768, 2)
    assert plan.steps == GR.MAX_SLICE_STEPS and -(-10_000 // plan.steps) == 20


def test_general_codes_and_staged_arrays():
    assert [GR.GENERAL_FUNC_CODES[f] for f in ("irate", "changes", "deriv")] == [0, 5, 7]
    assert GR.staged_arrays("changes", False, False, distinct_raw=True) == 3
    assert GR.staged_arrays("changes", True, False, distinct_raw=True) == 2


@pytest.mark.parametrize("patch", [p for ps in tile_sweep.GENERAL_PATCHES.values() for p in ps]
                         + tile_sweep.general_team_patches(8))
def test_general_split_patch_targets_are_in_the_source(patch):
    """tile_sweep.py --general's split and team builds patch
    csrc/general_range.cu by exact strings: each must occur once."""
    fname, old, _ = patch
    src = (Path(GR.__file__).resolve().parents[1] / "csrc" / fname).read_text()
    assert src.count(old) == 1, old


# -- the kernel's bounds and pair-flag prefix, restated in torch ----------------------

def _step_times(start_off: int, step_ms: int, num_steps: int, device) -> torch.Tensor:
    """t_j = start + j * step in int32 with wrap-around, as the kernel."""
    j = torch.arange(num_steps, dtype=torch.int64, device=device)
    t = (start_off + j * step_ms) & 0xFFFFFFFF
    return torch.where(t >= 2**31, t - 2**32, t).to(torch.int32)


def _wrap(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.int64) & 0xFFFFFFFF
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def window_bounds(ts, lens, start_off: int, step_ms: int, window_ms: int,
                  num_steps: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi) int64 [S, J] by the kernel's own method (``search_bounds``):
    branchless searches of each row's [0, lens) that halve one length for
    all targets at once -- hi counts the samples <= t_j, lo those <= t_j - w,
    at most hi -- with the step times in int32 with wrap-around. An empty
    window (lo = hi) where the bounds wrap or w <= 0, where
    ``kernels._bounds`` gives lo > hi."""
    S, T = ts.shape
    t_j = _step_times(start_off, step_ms, num_steps, ts.device)[None, :].expand(S, -1)
    t_lo = _wrap(t_j.to(torch.int64) - window_ms)
    length = lens.to(torch.int64).clamp(0, T)[:, None]
    lo = torch.zeros((S, num_steps), dtype=torch.int64, device=ts.device)
    hi = torch.zeros_like(lo)

    def le(base, step, x):  # row[base + step] <= x, 0 where the row is done
        i = (base + step).clamp(max=T - 1)
        return torch.where(step > 0, torch.gather(ts, 1, i) <= x, False)

    while bool((length > 1).any()):
        half = torch.where(length > 1, length >> 1, 0)
        hi = hi + torch.where(le(hi, half, t_j), half, 0)
        lo = lo + torch.where(le(lo, half, t_lo), half, 0)
        length = length - half
    last = (length == 1).to(torch.int64)  # the final probe, row[base], of each search
    hi = hi + le(hi - last, last, t_j).to(torch.int64)
    lo = lo + le(lo - last, last, t_lo).to(torch.int64)
    return torch.minimum(lo, hi), hi


def shared_window_bounds(ts, lens, start_off: int, step_ms: int, window_ms: int,
                         num_steps: int):
    """(lo, hi) int64 [S, J] as the kernel takes them on an exact shared
    grid: row 0's windows, searched once, clamped by each row's own
    length."""
    lo0, hi0 = window_bounds(ts[:1], lens[:1], start_off, step_ms, window_ms, num_steps)
    n = lens.to(torch.int64).clamp(0, ts.shape[1])[:, None]
    hi = torch.minimum(hi0, n)
    return torch.minimum(lo0, hi), hi


def flag_prefix(func: str, vals, raw, lens, is_counter: bool, is_delta: bool) -> torch.Tensor:
    """The kernel's int32 [S, T] inclusive prefix of the pair flags over
    each row's [0, lens) (0 past it): flag 0 is 0, flag i >= 1 a cumulative
    counter's diff-staged value != 0 (changes) or < 0 (resets), else
    raw[i] against raw[i-1]. A window [lo, hi) holds P[hi-1] - P[lo]
    flagged pairs (``prefix_pair_counts``)."""
    changes = func == "changes"
    if is_counter and not is_delta:
        flag = (vals != 0) if changes else (vals < 0)
    else:
        prev = torch.cat([raw[:, :1], raw[:, :-1]], dim=1)
        flag = (raw != prev) if changes else (raw < prev)
    T = vals.shape[1]
    lane = torch.arange(T, device=vals.device)[None, :]
    flag = flag & (lane >= 1) & (lane < lens[:, None])
    prefix = torch.cumsum(flag.to(torch.int32), dim=1, dtype=torch.int32)
    return torch.where(lane < lens[:, None], prefix, 0)


def prefix_pair_counts(prefix, lo, hi) -> torch.Tensor:
    """f32 [S, J] flagged pairs lo < i < hi of each window from the
    kernel's prefix, NaN where the window is empty."""
    T = prefix.shape[1]
    at = lambda i: torch.gather(prefix, 1, i.clamp(0, T - 1))  # noqa: E731
    n = (at(hi - 1) - at(lo)).to(torch.float32)
    return torch.where(hi > lo, n, float("nan"))


# -- bounds on edge grids -----------------------------------------------------------

S_EDGE, T_EDGE, N_EDGE = 9, 128, 100


def edge_rows(kind: str, rng):
    """[S, T] int32 offsets and lens: 10 s scrapes (rows with ties, a row
    with no sample and a padded TS_PAD row), or one shared grid."""
    ts = np.full((S_EDGE, T_EDGE), TS_PAD, np.int32)
    lens = np.zeros(S_EDGE, np.int32)
    for s in range(S_EDGE - 2):
        n = N_EDGE if kind == "regular" else N_EDGE - 7 * s
        if kind == "regular":
            row = 5_000 + np.arange(n) * 10_000
        else:
            gaps = rng.integers(5_000, 15_001, n)
            gaps[3::11] = 0  # ties
            row = np.cumsum(gaps)
        ts[s, :n] = row
        lens[s] = n
    return ts, lens  # the last two rows: no sample, all padding


# (start offset, step, window, steps): int32 wrap, w <= 0, before and after
# the data, a step shorter than the scrape interval
EDGE_GRIDS = {
    "inside": (300_000, 60_000, 300_000, 12),
    "before_the_data": (-2_000_000, 120_000, 300_000, 20),
    "after_the_data": (1_200_000, 60_000, 300_000, 10),
    "window_zero": (300_000, 60_000, 0, 12),
    "window_negative": (300_000, 60_000, -30_000, 12),
    "int32_wrap": (2**31 - 200_000, 60_000, 300_000, 12),
    "wrapped_window": (-2**31 + 100_000, 60_000, 300_000, 8),
    "step_under_the_scrape": (200_000, 2_000, 30_000, 40),
}


def jax_bounds_of(ts, lens, start, step, window, J):
    out_t = _step_times(start, step, J, torch.device("cpu")).numpy()
    lo, hi = jax_bounds(jnp.asarray(ts), jnp.asarray(lens), jnp.asarray(out_t),
                        jnp.int32(window))
    return np.asarray(lo), np.asarray(hi)


def assert_bounds_agree(lo, hi, ts, lens, grid):
    """The kernel's (lo, hi) against kernels._bounds and the JAX _bounds: hi
    equal; lo equal on non-empty windows, lo = hi on empty ones (where the
    two count a wrapped lower edge past hi)."""
    start, step, window, J = EDGE_GRIDS[grid]
    out_t = _step_times(start, step, J, torch.device("cpu"))
    plo, phi = (x.numpy() for x in _bounds(torch.from_numpy(ts), torch.from_numpy(lens), out_t,
                                            torch.tensor(window, dtype=torch.int32)))
    jlo, jhi = jax_bounds_of(ts, lens, start, step, window, J)
    lo, hi = lo.numpy(), hi.numpy()
    np.testing.assert_array_equal(hi, phi, err_msg=grid)
    np.testing.assert_array_equal(hi, jhi, err_msg=grid)
    empty = plo >= phi
    np.testing.assert_array_equal(lo[~empty], plo[~empty], err_msg=grid)
    np.testing.assert_array_equal(lo[~empty], jlo[~empty], err_msg=grid)
    np.testing.assert_array_equal(lo[empty], hi[empty], err_msg=grid)


@pytest.mark.parametrize("grid", sorted(EDGE_GRIDS))
def test_window_bounds_match_bounds_on_edge_grids(grid):
    ts, lens = edge_rows("irregular", np.random.default_rng(len(grid)))
    lo, hi = window_bounds(torch.from_numpy(ts), torch.from_numpy(lens), *EDGE_GRIDS[grid])
    assert_bounds_agree(lo, hi, ts, lens, grid)


@pytest.mark.parametrize("grid", sorted(EDGE_GRIDS))
def test_shared_window_bounds_match_bounds_on_edge_grids(grid):
    """A regular block: row 0's windows, searched once and clamped by each
    row's length, equal every row's own (padded rows: empty)."""
    ts, lens = edge_rows("regular", np.random.default_rng(1))
    t, n = torch.from_numpy(ts), torch.from_numpy(lens)
    lo, hi = shared_window_bounds(t, n, *EDGE_GRIDS[grid])
    assert_bounds_agree(lo, hi, ts, lens, grid)
    own_lo, own_hi = window_bounds(t, n, *EDGE_GRIDS[grid])
    assert torch.equal(lo, own_lo) and torch.equal(hi, own_hi)


# -- the pair-flag prefix ----------------------------------------------------------------

PREFIX_STAGINGS = {  # staging mode -> (stage_series flags, is_counter, is_delta, distinct raw)
    "gauge": ({}, False, False, False), "gauge_with_raw": ({}, False, False, True),
    "diff": ({"diff_encode": True}, True, False, False), "delta": ({}, True, True, False),
}


@pytest.mark.parametrize("grid", ["irregular", "regular"])
@pytest.mark.parametrize("staging", sorted(PREFIX_STAGINGS))
@pytest.mark.parametrize("func", ["changes", "resets"])
def test_flag_prefix_counts_equal_range_kernel_plain(func, staging, grid):
    """The kernel's window count P[hi-1] - P[lo] over its inclusive flag
    prefix is bit-equal to range_kernel_plain's changes/resets, on the
    kernel's own bounds."""
    flags, is_counter, is_delta, distinct = PREFIX_STAGINGS[staging]
    rng = np.random.default_rng(7)
    series = []
    for i in range(10):
        n = 80 - 3 * i
        t = (BASE + 5_000 + np.arange(n) * 10_000 if grid == "regular"
             else BASE + np.cumsum(rng.integers(5_000, 15_001, n)))
        v = np.round(rng.uniform(0, 5, n)) if is_delta else np.round(np.cumsum(
            rng.uniform(-3, 6, n)))
        v[5::9] = v[4::9][: len(v[5::9])]  # unchanged neighbours
        series.append((t.astype(np.int64), v))
    if grid == "regular":
        series = [(t[:80 - 27], v[:80 - 27]) for t, v in series]
    b = stage_series(series, BASE, **flags)
    vals = torch.as_tensor(b.vals)
    raw = torch.round(vals / 3.0) if distinct else (
        torch.as_tensor(b.raw) if b.raw is not None else vals)
    ts, lens = torch.as_tensor(b.ts), torch.as_tensor(b.lens)
    start, step, window, J = (250_000, 30_000, 120_000, 25)
    prefix = flag_prefix(func, vals, raw, lens, is_counter, is_delta)
    assert prefix.dtype == torch.int32
    lo, hi = (shared_window_bounds if b.regular_ts is not None else window_bounds)(
        ts, lens, start, step, window, J)
    got = prefix_pair_counts(prefix, lo, hi)
    want = range_kernel_plain(func, ts, vals, lens, torch.as_tensor(b.baseline), raw, start, step,
                              window, J, is_counter=is_counter, is_delta=is_delta)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert (got.nan_to_num() > 0).any()


# -- range_kernel_plain at window lengths around the kernel's widths -------------------

# the kernel walks a window four samples at a time (four partial sums) and
# takes two or four steps a lane at once: lengths 0, 1, 2, L-1, L, L+1,
# 2L+1 for L = 4 and 8
WINDOW_SAMPLES = (0, 1, 2, 3, 4, 5, 7, 8, 9, 17)
ORACLE_FUNCS = ("stddev_over_time", "stdvar_over_time", "z_score", "deriv")
N_ROWS, N_PTS, J_LEN = 8, 60, 16


def fixed_length_block(seed: int):
    """Rows sampled every 10 s (gauges, and one counter as the shifted
    staging gives it to the moments and deriv: minus its first value), so
    a window of k * 10 s ending on a sample holds exactly k samples."""
    rng = np.random.default_rng(seed)
    ts = np.full((N_ROWS, 64), TS_PAD, np.int32)
    vals = np.zeros((N_ROWS, 64), np.float32)
    ts[:, :N_PTS] = np.arange(N_PTS) * 10_000
    vals[:, :N_PTS] = 50 + 20 * rng.standard_normal((N_ROWS, N_PTS))
    vals[0, :N_PTS] = np.cumsum(rng.uniform(0, 4, N_PTS))
    lens = np.full(N_ROWS, N_PTS, np.int32)
    return ts, vals, lens, np.zeros(N_ROWS, np.float32)


def f64_window_oracle(func, ts, vals, lens, start, step, window):
    """The moments and deriv in float64 over the windows of the f32 inputs
    (deriv's tc rounded to f32 first, as both packages do)."""
    out_t = (start + np.arange(J_LEN) * step).astype(np.int32)
    lo, hi = (x.numpy() for x in _bounds(torch.from_numpy(ts), torch.from_numpy(lens),
                                          torch.from_numpy(out_t),
                                          torch.tensor(window, dtype=torch.int32)))
    out = np.full(lo.shape, np.nan)
    for s, j in zip(*np.nonzero(hi > lo)):
        w = vals[s, lo[s, j]:hi[s, j]].astype(np.float64)
        if func == "deriv":
            dt = (ts[s, lo[s, j]:hi[s, j]] - out_t[j]).astype(np.int32)
            tc = (dt.astype(np.float32) * np.float32(1e-3)).astype(np.float64)
            n = float(len(w))
            denom = n * (tc * tc).sum() - tc.sum() ** 2
            if n >= 2 and abs(denom) >= 1e-30:
                out[s, j] = (n * (tc * w).sum() - tc.sum() * w.sum()) / denom
            continue
        var = ((w - w.mean()) ** 2).mean()
        out[s, j] = {"stdvar_over_time": var, "stddev_over_time": np.sqrt(var),
                     "z_score": (w[-1] - w.mean()) / max(np.sqrt(var), 1e-30)}[func]
    return out


@pytest.mark.parametrize("k", WINDOW_SAMPLES)
@pytest.mark.parametrize("func", FUNCS)
def test_range_kernel_plain_at_window_lengths(func, k):
    ts, vals, lens, baseline = fixed_length_block(k)
    start, step, window = 200_000, 20_000, k * 10_000  # every window within the data
    args = (ts, vals, lens, baseline, vals)
    want = np.asarray(jax_range_kernel(func, *args, np.int32(start), np.int32(step),
                                       np.int32(window), J_LEN))
    got = range_kernel_plain(func, *(torch.from_numpy(a) for a in args), start, step, window,
                             J_LEN).numpy()
    what = f"{func} {k} samples"
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=what)
    if k < {"irate": 2, "idelta": 2, "deriv": 2}.get(func, 1):
        assert np.isnan(got).all(), what
        return
    m = ~np.isnan(want)
    if func in ORACLE_FUNCS:
        # the port against JAX; where they differ by more than the
        # tolerance, the port within it of the float64 oracle, and JAX
        # further from the oracle than the port (its f32 prefix-sum mean or
        # f32 normal equations)
        exact = f64_window_oracle(func, ts, vals, lens, start, step, window)
        np.testing.assert_array_equal(np.isnan(exact), np.isnan(want), err_msg=what)
        g, w, e = got[m], want[m], exact[m]
        off = ~np.isclose(g, w, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(g[off], e[off], rtol=RTOL, atol=ATOL, err_msg=what)
        assert (np.abs(w - e)[off] > np.abs(g - e)[off]).all(), what
    elif func in ("changes", "resets"):
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got[m], want[m], rtol=RTOL, atol=ATOL, err_msg=what)
