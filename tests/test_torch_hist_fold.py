"""The histogram rung with the quantile folded into the range launch:
``hist_kernels.hist_range_quantile`` (the one-launch entry) on CPU tensors
against the JAX package's ``_fused_hist_jit`` / ``_fused_hist_shared_jit``
with ``quantile=True`` on the same seeded blocks (rtol 2e-4 / atol 1e-4,
the repo's tolerance; NaN and +-inf masks equal), and the range kernel's
host-side plan (``hist_plan``, ``hist_smem_bytes``, ``hist_grid``,
``hist_buffers``), which must be exact: the C entry refuses a launch whose
shared memory differs from its own count, and the arrival counters must
cover every slice's blocks."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from filodb_tpu.ops import hist_kernels as JHK
from filodb_tpu.ops import staging as JST
from filodb_tpu_torch.ops import aggregations as AGG
from filodb_tpu_torch.ops import cuda_build
from filodb_tpu_torch.ops import group_acc as GA
from filodb_tpu_torch.ops import hist_kernels as HK
from filodb_tpu_torch.ops import staging as ST
from filodb_tpu_torch.ops.kernels import RangeParams, pad_steps

_spec = importlib.util.spec_from_file_location(
    "tile_sweep", Path(__file__).resolve().parents[1] / "tile_sweep.py")
tile_sweep = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tile_sweep)

BASE = 1_600_000_000_000
RTOL, ATOL = 2e-4, 1e-4
N_REAL, T_SAMPLES = 24, 120
PARAMS = RangeParams(BASE - 120_000, 60_000, 24, 300_000)
LES = {1: [np.inf], 3: [0.5, 2.0, np.inf],
       12: [0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, np.inf]}
QS = [-0.5, 0.0, 0.25, 0.5, 0.99, 1.0, 1.5]
GRIDS = {"hist_shared": "regular", "hist_general": "irregular"}


def hist_blocks(grid: str, B: int, seed: int = 0):
    """Seeded cumulative histograms of B buckets staged by both packages:
    ``regular`` (one 10 s grid) or ``irregular`` (5-15 s apart, ragged, one
    empty series); padded rows past N_REAL."""
    rng = np.random.default_rng(seed)
    series = []
    for i in range(N_REAL):
        k = T_SAMPLES if grid == "regular" else int(rng.integers(T_SAMPLES // 2, T_SAMPLES + 1))
        if grid == "irregular" and i == N_REAL // 2:
            k = 0
        ts = (BASE + 3_000 + np.arange(k, dtype=np.int64) * 10_000 if grid == "regular"
              else BASE + np.cumsum(rng.integers(5_000, 15_001, k)).astype(np.int64))
        incr = rng.poisson(2.0, size=(k, B)).astype(np.float64)
        incr[:, -1] = incr.sum(1)
        series.append((ts, np.cumsum(np.cumsum(incr, axis=1), axis=0)))
    refs = [(0, i) for i in range(N_REAL)]
    return (ST.stage_histogram_series(series, BASE, B, refs).to_device("cpu"),
            JST.stage_histogram_series(series, BASE, B, refs))


def jax_quantile(variant: str, jblk, gids, G: int, les, q: float):
    """The JAX package's fused histogram program with quantile=True."""
    j_pad = pad_steps(PARAMS.num_steps)
    les_j = jnp.asarray(np.asarray(les, np.float32))
    if variant == "hist_shared":
        m = int(jblk.lens[0])
        tsv = np.asarray(jblk.regular_ts)[:m].astype(np.int64)
        out_t = PARAMS.start_ms - BASE + np.arange(j_pad, dtype=np.int64) * PARAMS.step_ms
        hi = np.searchsorted(tsv, out_t, side="right")
        lo = np.searchsorted(tsv, out_t - PARAMS.window_ms, side="right")
        bounds = [lo, hi, tsv[np.minimum(lo, m - 1)], tsv[np.minimum(hi - 1, m - 1)], out_t]
        lo, hi, tf, tl, out_t = (jnp.asarray(b.astype(np.int32)) for b in bounds)
        return np.asarray(JHK._fused_hist_shared_jit(
            "rate", jnp.asarray(jblk.vals), lo, hi, tf, tl, out_t, np.int32(PARAMS.window_ms),
            jnp.asarray(gids.astype(np.int32)), les_j, np.float32(q), G, False, True))
    return np.asarray(JHK._fused_hist_jit(
        "rate", jnp.asarray(jblk.ts), jnp.asarray(jblk.vals), jnp.asarray(jblk.lens),
        jnp.asarray(gids.astype(np.int32)), les_j, np.float32(q),
        np.int32(PARAMS.start_ms - BASE), np.int32(PARAMS.step_ms), np.int32(PARAMS.window_ms),
        j_pad, G, False, True))


@pytest.mark.parametrize("B", [1, 3, 12])
@pytest.mark.parametrize("G", [1, 5])
@pytest.mark.parametrize("variant", sorted(GRIDS))
@pytest.mark.parametrize("q", QS)
def test_hist_range_quantile_matches_jax(q, variant, G, B):
    """One entry, range function and quantile: [G, J] equal to the JAX
    package's fused program with quantile=True; padded rows go to the trash
    group; no launch is counted on the CPU."""
    port, jblk = hist_blocks(GRIDS[variant], B, seed=B + G)
    S = port.vals.shape[0]
    gids = np.full(S, G, np.int64)
    gids[:N_REAL] = np.arange(N_REAL) % G
    les = torch.tensor(LES[B], dtype=torch.float32)
    j_pad = pad_steps(PARAMS.num_steps)
    windows = (AGG._hist_shared_windows(port, PARAMS, j_pad) if variant == "hist_shared"
               else None)
    before = (HK.RANGE_LAUNCHES, HK.FOLDED_QUANTILES)
    out, acc, cnt = HK.hist_range_quantile(q, "rate", port, torch.from_numpy(gids), G, PARAMS,
                                           les, windows)
    assert (HK.RANGE_LAUNCHES, HK.FOLDED_QUANTILES) == before
    assert out.shape == (G, j_pad) and acc.shape == cnt.shape == (G + 1, j_pad * B)
    J = PARAMS.num_steps
    assert torch.isnan(out[:, J:]).all()
    got = out.numpy()[:, :J].astype(np.float64)
    want = jax_quantile(variant, jblk, gids, G, LES[B], q)[:, :J].astype(np.float64)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    m = np.isfinite(want)
    np.testing.assert_allclose(got[m], want[m], rtol=RTOL, atol=ATOL)
    # the partials it returns are the ones the quantile was taken of
    np.testing.assert_array_equal(
        out.numpy(), HK.hist_quantile_plain(q, acc, cnt, G, les, J).numpy())


@pytest.mark.parametrize("variant", sorted(GRIDS))
def test_fused_aggregate_quantile_is_the_folded_entry(variant):
    """``fused_hist_range_aggregate(q=...)`` returns the one-launch entry's
    [G, J_pad] quantiles."""
    port, _ = hist_blocks(GRIDS[variant], 12)
    S = port.vals.shape[0]
    gids = torch.full((S,), 2, dtype=torch.int64)
    gids[:N_REAL] = torch.arange(N_REAL) % 2
    les = torch.tensor(LES[12], dtype=torch.float32)
    got = AGG.fused_hist_range_aggregate("increase", port, gids, 2, PARAMS, les, q=0.9)
    windows = (AGG._hist_shared_windows(port, PARAMS, pad_steps(PARAMS.num_steps))
               if variant == "hist_shared" else None)
    want = HK.hist_range_quantile(0.9, "increase", port, gids, 2, PARAMS, les, windows)[0]
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_quantile_wrappers_check_their_inputs():
    port, _ = hist_blocks("regular", 3)
    gids = torch.zeros(port.vals.shape[0], dtype=torch.int64)
    with pytest.raises(ValueError, match="les"):
        HK.hist_range_quantile(0.5, "rate", port, gids, 1, PARAMS, torch.ones(4))
    with pytest.raises(NotImplementedError, match="avg_over_time"):
        HK.hist_range_quantile(0.5, "avg_over_time", port, gids, 1, PARAMS, torch.ones(3))
    acc = torch.zeros((2, 96), device="meta")
    les = torch.ones(3, device="meta")
    with pytest.raises(ValueError, match="folded into the range launch"):
        HK.hist_quantile(0.5, acc, acc, 1, les, 24)


# -- the host-side plan ------------------------------------------------------------


def smem_words(G, B, steps, rows, T, shared_bounds, shared, staged):
    """csrc/hist_range.cu smem_words, written out again."""
    r4 = lambda n: (n + 3) // 4 * 4  # noqa: E731
    part = r4(2 * G * steps * B) if shared else 0
    nb = (1 if shared_bounds else rows) * steps
    return part + r4(rows) + r4(3 * nb) + (2 * rows * T if staged else 0)


PLAN_CASES = {
    # (T, J, B, G, shared_bounds): (rows, steps, slices, vec, threads, shared, staged)
    "bench_shared": ((768, 111, 12, 1, True), (16, 111, 1, 4, 352, True, False)),
    "bench_per_series": ((768, 111, 12, 1, False), (8, 111, 1, 4, 352, True, True)),
    "zone_groups": ((768, 111, 12, 8, False), (8, 56, 2, 4, 192, True, True)),
    "b300_per_series": ((768, 40, 300, 1, False), (8, 20, 2, 4, 384, True, True)),
    "b300_shared": ((768, 111, 300, 1, True), (16, 23, 5, 4, 352, True, False)),
    "many_groups": ((768, 111, 12, 1000, False), (8, 111, 1, 4, 352, False, True)),
    "odd_buckets": ((256, 30, 3, 5, False), (16, 30, 1, 1, 96, True, True)),
    "pairs": ((1536, 111, 6, 1, False), (4, 111, 1, 2, 352, True, True)),
    "long_rows": ((8192, 111, 1, 1, False), (16, 111, 1, 1, 128, True, False)),
    "many_steps": ((768, 1000, 1, 1, False), (8, 250, 4, 1, 256, True, True)),
    "one_step_of_partials": ((768, 40, 12, 500, True), (16, 40, 1, 4, 128, False, False)),
}


STORE_PLAN_CASES = {
    # (T, J, B, shared_bounds): (rows, steps, slices, threads, staged)
    "bench_shared": ((768, 111, 12, True), (8, 111, 1, 384, False)),
    "bench_per_series": ((768, 111, 12, False), (8, 111, 1, 384, True)),
    "short_rows": ((64, 111, 12, False), (8, 111, 1, 384, True)),
    "long_rows": ((8192, 111, 12, False), (8, 111, 1, 384, False)),
    "wide_rows": ((1536, 111, 6, False), (4, 111, 1, 352, True)),
    "many_steps": ((768, 1000, 12, False), (8, 250, 4, 384, True)),
}


@pytest.mark.parametrize("case", sorted(STORE_PLAN_CASES))
def test_hist_store_plan_is_exact(case):
    """The store mode's layout: at most SERIES_TILE_ROWS rows per tile (fewer
    when both staged ts buffers must fit), no partials, the bounds table
    within its budget, a block's threads over (column vector, row) items."""
    (T, J, B, sb), want = STORE_PLAN_CASES[case]
    plan = HK.hist_plan(T, J, B, 1, sb, store=True)
    assert (plan.rows, plan.steps, plan.slices, plan.threads, plan.staged) == want
    assert plan.store and not plan.shared and plan.rows <= HK.SERIES_TILE_ROWS
    assert plan.smem_bytes == 4 * smem_words(1, B, plan.steps, plan.rows, T, sb, False,
                                             plan.staged)
    assert 12 * (1 if sb else plan.rows) * plan.steps <= HK.BOUNDS_BUDGET
    assert plan.smem_bytes <= GA.BLOCK_SMEM
    if plan.staged:
        assert 2 * plan.rows * T * 4 <= HK.STAGE_BUDGET


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_hist_plan_is_exact(case):
    (T, J, B, G, sb), want = PLAN_CASES[case]
    plan = HK.hist_plan(T, J, B, G, sb)
    assert (plan.rows, plan.steps, plan.slices, plan.vec, plan.threads, plan.shared,
            plan.staged) == want
    assert plan.smem_bytes == 4 * smem_words(G, B, plan.steps, plan.rows, T, sb, plan.shared,
                                             plan.staged)
    assert plan.smem_bytes == HK.hist_smem_bytes(G, B, plan.steps, plan.rows, T, sb,
                                                 plan.shared, plan.staged)
    # whole-step slices, balanced: every step in exactly one slice
    assert plan.slices * plan.steps >= J > (plan.slices - 1) * plan.steps
    assert plan.steps == -(-J // plan.slices)
    assert B % plan.vec == 0
    # one thread per column vector, in as few passes of at most 384 as cover them
    cols = plan.steps * B // plan.vec
    passes = -(-cols // HK.MAX_THREADS)
    assert plan.threads % 32 == 0 and plan.threads <= HK.MAX_THREADS
    assert passes * plan.threads >= cols > passes * (plan.threads - 32)
    assert plan.smem_bytes <= GA.BLOCK_SMEM
    if plan.shared:
        assert 2 * G * plan.steps * B * 4 <= GA.PARTIALS_BUDGET
        assert plan.slices <= HK.MAX_PART_SLICES
    if plan.staged:
        assert 2 * plan.rows * T * 4 <= HK.STAGE_BUDGET
    assert 12 * (1 if sb else plan.rows) * plan.steps <= HK.BOUNDS_BUDGET


@pytest.mark.parametrize("S, rows, slices, resident, want", [
    (131072, 16, 1, 528, (528, 1)),     # the main path: every resident block
    (131072, 8, 2, 396, (198, 2)),      # shared among the slices
    (16, 8, 1, 396, (2, 1)),            # no more than the tiles
    (64, 16, 5, 3, (1, 5)),             # at least one block per slice
])
def test_hist_grid_is_exact(S, rows, slices, resident, want):
    plan = HK.HistPlan(rows, 10, slices, 4, 128, True, False, 0)
    assert HK.hist_grid(plan, S, resident) == want


@pytest.mark.parametrize("slices", [1, 2, 5])
def test_hist_buffers_carve_counters_from_the_zeroed_allocation(slices):
    acc, cnt, arrivals = HK.hist_buffers(3, 40, slices, "cpu")
    assert acc.shape == cnt.shape == (4, 40) and acc.dtype == cnt.dtype == torch.float32
    assert arrivals.shape == (slices,) and arrivals.dtype == torch.int32
    assert not acc.any() and not cnt.any() and not arrivals.any()
    base = acc.untyped_storage().data_ptr()
    assert cnt.untyped_storage().data_ptr() == arrivals.untyped_storage().data_ptr() == base
    assert cnt.data_ptr() == acc.data_ptr() + 4 * 160
    assert arrivals.data_ptr() == cnt.data_ptr() + 4 * 160
    assert acc.is_contiguous() and cnt.is_contiguous()


@pytest.mark.parametrize("patch", [p for ps in (*tile_sweep.HIST_PATCHES.values(),
                                                *tile_sweep.HIST_BUILDS.values()) for p in ps])
def test_hist_split_patch_targets_are_in_the_source(patch):
    """chip_smoke.py's split timings and tile_sweep.py --hist's register
    budgets patch these lines of csrc/: each must appear exactly once, or
    the build cannot be made on the card."""
    fname, old, new = patch
    text = (cuda_build.CSRC / fname).read_text()
    assert text.count(old) == 1, f"{fname}: {old.strip()}"
    assert new != old
