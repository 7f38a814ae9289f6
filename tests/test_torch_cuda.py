"""The window-stats kernels (nine planes, and fused with finish and the
group aggregate), the general range kernel (csrc/general_range.cu) and
the regular-range kernel on the card against their plain versions, on both group-partial variants and on rows staged in
shared memory or read in place; a cached superblock's warm hit and
live-edge extension on the card; and the histogram range kernel
(csrc/hist_range.cu) and the quantile folded into its launch against
their plain versions, with one launch per histogram query; and the
reference tree's kernels -- the sorted-window kernel
(csrc/sorted_window.cu, both routes, q outside [0, 1]), predict_linear and
Holt-Winters on the general kernel, the standalone quantile over gathered
classic rows, the tree's segment aggregate (csrc/segment_agg.cu) and
grouped top-k (csrc/order_stats.cu) -- against their plain versions; the
regular kernel's B5 codes and both variants of the jitter kernel
(csrc/jitter_range.cu) against theirs, and jittered and holey stores
through the engine; and the lane modes of the four fused kernels
(cross-query batching) against their plain versions, at a lane count with
shared partials and one past the shared-memory budget. These tests need an NVIDIA card and skip without one; the
file imports no JAX so that it runs on a machine with only torch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from filodb_tpu_torch.ops import aggregations as AGG
from filodb_tpu_torch.ops import general_range as GR
from filodb_tpu_torch.ops import group_acc as GA
from filodb_tpu_torch.ops import hist_kernels as HK
from filodb_tpu_torch.ops import mxu_jitter as JR
from filodb_tpu_torch.ops import mxu_kernels as MK
from filodb_tpu_torch.ops import staging as ST
from filodb_tpu_torch.ops import window_stats as WS
from filodb_tpu_torch.ops.kernels import RangeParams, pad_steps
from filodb_tpu_torch.ops.staging import TS_PAD, stage_series

BASE = 1_600_000_000_000
EXACT = ("count", "t_first", "t_last")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def block(counter: bool, n_series=65, n=300, seed=0):
    rng = np.random.default_rng(seed)
    series = []
    for _ in range(n_series):
        ts = BASE + np.cumsum(rng.integers(5000, 15000, n)).astype(np.int64)
        vals = (np.cumsum(rng.uniform(0, 10, n)) + 1e9) if counter else 50 + 20 * rng.standard_normal(n)
        series.append((ts, vals))
    return stage_series(series, BASE, counter_corrected=counter)


@pytest.mark.cuda
@pytest.mark.parametrize("counter", [False, True], ids=["gauge", "counter"])
def test_kernel_matches_plain_on_card(card, counter):
    b = block(counter).to_device(card)
    raw = b.raw if b.raw is not None else b.vals
    args = (b.ts, b.vals, raw, b.lens, 400_000, 60_000, 300_000, 64)
    before = WS.LAUNCHES
    got = WS.window_stats(*args)
    assert WS.LAUNCHES == before + 1
    want = WS.window_stats_plain(*args)
    torch.cuda.synchronize()
    for name in WS.STAT_NAMES:
        g, w = got[name].cpu().numpy(), want[name].cpu().numpy()
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=name)
        if name in EXACT:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=2e-4, atol=1e-4, err_msg=name)


@pytest.mark.cuda
def test_duplicate_timestamps_sum_ties_on_card(card):
    """Tied first/last timestamps sum their values, as the TPU kernel and
    the plain version do."""
    ts = np.full((8, 128), TS_PAD, np.int32)
    ts[0, :4] = [1000, 1000, 2000, 2000]
    vals = np.zeros((8, 128), np.float32)
    vals[0, :4] = [1.0, 10.0, 3.0, 4.0]
    raw = np.zeros((8, 128), np.float32)
    raw[0, :4] = [100.0, 200.0, 300.0, 400.0]
    lens = np.zeros(8, np.int32)
    lens[0] = 4
    t = [torch.from_numpy(a).to(card) for a in (ts, vals, raw, lens)]
    got = WS.window_stats(*t, 2000, 1000, 5000, 64)
    want = WS.window_stats_plain(*t, 2000, 1000, 5000, 64)
    torch.cuda.synchronize()
    assert float(got["v_first"][0, 0]) == 11.0
    assert float(got["raw_first"][0, 0]) == 300.0
    assert float(got["v_last"][0, 0]) == 7.0
    for name in WS.STAT_NAMES:
        assert torch.equal(torch.isnan(got[name]), torch.isnan(want[name])), name
        m = ~torch.isnan(want[name])
        assert torch.equal(got[name][m], want[name][m]), name


def regular_block(counter: bool, mode: dict, n_series=65, n=300, seed=0):
    rng = np.random.default_rng(seed)
    ts = BASE + 3_000 + np.arange(n, dtype=np.int64) * 10_000
    series = []
    for _ in range(n_series):
        vals = (np.cumsum(rng.uniform(0, 10, n)) + 1e3) if counter else 50 + 20 * rng.standard_normal(n)
        series.append((ts, vals))
    block = stage_series(series, BASE, **mode)
    assert block.regular_ts is not None
    return block


def plain_aggregate(func, op, block, gids, G, params, counter):
    """The regular rung's plain version; the kernel computes no step past
    ``params.num_steps``, which are NaN in both."""
    wm = MK.window_matrices(block, params.start_ms - BASE, params.step_ms,
                            pad_steps(params.num_steps), params.window_ms)
    raw = block.raw if block.raw is not None else block.vals
    sj = MK.mxu_range_plain(func, block.vals, raw, wm, params.window_ms, is_counter=counter)
    return GA.mask_steps(AGG.apply_epilogue(sj, ("agg", op), gids, G), params.num_steps)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gauge", "corrected", "diff"])
@pytest.mark.parametrize("func", sorted(MK.FUSED_MXU_FUNCS))
def test_regular_kernel_matches_plain_on_card(card, func, kind):
    """Each row its own group (G = S), so no atomic reorders a sum."""
    mode = {"gauge": {}, "corrected": {"counter_corrected": True},
            "diff": {"diff_encode": True}}[kind]
    counter = kind != "gauge"
    b = regular_block(counter, mode).to_device(card)
    S = b.vals.shape[0]
    gids = torch.full((S,), b.n_series, dtype=torch.int64, device=card)
    gids[: b.n_series] = torch.arange(b.n_series, device=card)
    params = RangeParams(BASE + 400_000, 60_000, 40, 300_000)
    before = MK.LAUNCHES
    got = MK.regular_range_aggregate(func, "sum", b, gids, b.n_series, params, is_counter=counter)
    assert MK.LAUNCHES == before + 1
    want = plain_aggregate(func, "sum", b, gids, b.n_series, params, counter)
    torch.cuda.synchronize()
    g, w = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=func)
    m = ~np.isnan(w)
    assert m.any()
    np.testing.assert_allclose(g[m], w[m], rtol=2e-4, atol=1e-4, err_msg=func)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["sum", "count", "avg", "min", "max"])
@pytest.mark.parametrize("G", [1, 8])
def test_regular_kernel_group_ops_on_card(card, op, G):
    """Atomics reorder the f32 sums of a group: rtol 1e-3."""
    b = regular_block(True, {"counter_corrected": True}, n_series=300, seed=1).to_device(card)
    S = b.vals.shape[0]
    gids = torch.full((S,), G, dtype=torch.int64, device=card)
    gids[: b.n_series] = torch.arange(b.n_series, device=card) % G
    params = RangeParams(BASE + 400_000, 60_000, 40, 300_000)
    got = MK.regular_range_aggregate("rate", op, b, gids, G, params, is_counter=True)
    want = plain_aggregate("rate", op, b, gids, G, params, True)
    torch.cuda.synchronize()
    g, w = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    m = ~np.isnan(w)
    np.testing.assert_allclose(g[m], w[m], rtol=1e-3)


# ---- the fused window-stats kernel (window_range_aggregate) ----

def params_for(num_steps=60, start=BASE + 400_000, step=60_000, window=300_000):
    return RangeParams(start, step, num_steps, window)


def own_groups(b, device):
    """Each real row its own group (G = S), padded rows in the trash group."""
    S = b.ts.shape[0]
    gids = torch.full((S,), b.n_series, dtype=torch.int64, device=device)
    gids[: b.n_series] = torch.arange(b.n_series, device=device)
    return gids


def spread_groups(b, G, device, interleave=True):
    """Real rows spread over G groups, row by row (interleaved) or in runs."""
    S = b.ts.shape[0]
    gids = torch.full((S,), G, dtype=torch.int64, device=device)
    rows = torch.arange(b.n_series, device=device)
    gids[: b.n_series] = rows % G if interleave else rows * G // b.n_series
    return gids


def assert_same(got, want, rtol, atol=0.0, what=""):
    g, w = got.cpu().numpy(), want.cpu().numpy()
    assert g.shape == w.shape, what
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=what)
    m = ~np.isnan(w)
    assert m.any(), what
    np.testing.assert_allclose(g[m], w[m], rtol=rtol, atol=atol, err_msg=what)


def fused_pair(b, func, op, gids, G, params, counter):
    before = WS.RANGE_LAUNCHES
    got = WS.window_range_aggregate(func, op, b, gids, G, params, is_counter=counter)
    assert WS.RANGE_LAUNCHES == before + 1
    want = WS.window_range_aggregate_plain(func, op, b, gids, G, params, is_counter=counter)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("counter", [False, True], ids=["gauge", "counter"])
@pytest.mark.parametrize("func", sorted(WS.PALLAS_FUNCS))
def test_window_range_matches_plain_on_card(card, func, counter):
    """G = S: each (group, step) gets one value, so no atomic reorders a
    sum (rtol 2e-4 / atol 1e-4, the window sums' order differs)."""
    b = block(counter).to_device(card)
    got, want = fused_pair(b, func, "sum", own_groups(b, card), b.n_series, params_for(), counter)
    assert WS.LAST_PLAN.staged
    assert_same(got, want, 2e-4, 1e-4, func)


@pytest.mark.cuda
@pytest.mark.parametrize("interleave", [True, False], ids=["interleaved", "runs"])
@pytest.mark.parametrize("op", ["sum", "count", "avg", "min", "max"])
@pytest.mark.parametrize("G", [1, 8])
def test_window_range_group_ops_on_card(card, op, G, interleave):
    """Shared-memory partials: atomics reorder a group's f32 sums (rtol 1e-3)."""
    b = block(True, n_series=300, seed=1).to_device(card)
    gids = spread_groups(b, G, card, interleave)
    got, want = fused_pair(b, "rate", op, gids, G, params_for(), True)
    assert WS.LAST_PLAN.partials == "shared"
    assert_same(got, want, 1e-3, what=f"{op} G={G}")


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_window_range_groups_above_shared_budget_on_card(card, op):
    """G past the shared-memory budget takes the global-atomic partials."""
    b = block(False, n_series=300, seed=2).to_device(card)
    params = params_for(num_steps=40)
    G = GA.PARTIALS_BUDGET // (2 * 40 * 4) + 1
    assert not GA.tile_plan(G, 40, b.ts.shape[1], 2).shared
    got, want = fused_pair(b, "avg_over_time", op, spread_groups(b, G, card), G, params, False)
    assert WS.LAST_PLAN.partials == "global"
    assert_same(got, want, 1e-3, what=op)


def array_block(S, T, seed, counter, device, nan_every=0):
    """A block from plain arrays with S rows (any S), irregular rows and
    ragged lengths; NaN at every ``nan_every``-th sample when given."""
    from filodb_tpu_torch.ops.staging import block_from_arrays

    rng = np.random.default_rng(seed)
    lens = rng.integers(T // 3, T + 1, S).astype(np.int32)
    lens[S // 2] = 0  # a series with no sample in range
    real = rng.integers(0, 20_000, (S, 1)) + np.cumsum(rng.integers(5_000, 15_001, (S, T)), axis=1)
    mask = np.arange(T)[None, :] < lens[:, None]
    ts = np.where(mask, real, int(TS_PAD)).astype(np.int32)
    if counter:
        vals = np.cumsum(rng.uniform(0, 10, (S, T)), axis=1)
    else:
        vals = 50 + 20 * rng.standard_normal((S, T))
    if nan_every:
        vals[:, ::nan_every] = np.nan
    vals = np.where(mask, vals, 0).astype(np.float32)
    raw = (vals + 5.0).astype(np.float32) if counter else None
    return block_from_arrays(ts, vals, lens, BASE, np.zeros(S, np.float32), S, raw=raw,
                             device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("func", ["rate", "sum_over_time", "max_over_time", "last",
                                  "absent_over_time"])
def test_window_range_ragged_rows_and_nans_on_card(card, func):
    """S = 13 rows (not a multiple of the tile's rows), a row with no
    sample, NaN samples confined to their windows, and steps before the
    first sample (empty windows)."""
    b = array_block(13, 256, seed=3, counter=func == "rate", device=card, nan_every=7)
    params = RangeParams(BASE - 600_000, 60_000, 50, 300_000)
    gids = torch.arange(13, dtype=torch.int64, device=card)
    got, want = fused_pair(b, func, "sum", gids, 13, params, func == "rate")
    assert b.ts.shape[0] % WS.LAST_PLAN.rows != 0
    assert_same(got, want, 2e-4, 1e-4, func)


@pytest.mark.cuda
@pytest.mark.parametrize("func", ["rate", "increase", "first_over_time", "last"])
def test_window_range_tied_timestamps_on_card(card, func):
    """Tied first/last timestamps sum their values, as the plain version."""
    ts = np.full((8, 128), TS_PAD, np.int32)
    ts[0, :6] = [1000, 1000, 2000, 3000, 4000, 4000]
    vals = np.zeros((8, 128), np.float32)
    vals[0, :6] = [1.0, 10.0, 3.0, 4.0, 6.0, 8.0]
    raw = vals + 100.0
    lens = np.zeros(8, np.int32)
    lens[0] = 6
    from filodb_tpu_torch.ops.staging import block_from_arrays

    b = block_from_arrays(ts, vals, lens, BASE, np.zeros(8, np.float32), 1, raw=raw, device=card)
    gids = torch.tensor([0] + [1] * 7, dtype=torch.int64, device=card)
    params = RangeParams(BASE + 4000, 1000, 3, 5000)
    got, want = fused_pair(b, func, "sum", gids, 1, params, True)
    assert_same(got, want, 0.0, 0.0, func)


@pytest.mark.cuda
@pytest.mark.parametrize("func", ["rate", "sum_over_time", "count_over_time"])
def test_window_range_rows_read_in_place_on_card(card, func):
    """Rows too wide for the shared-memory budget are read in place."""
    b = array_block(5, 32_768, seed=4, counter=True, device=card)
    params = RangeParams(BASE + 600_000, 600_000, 100, 3_600_000)
    gids = torch.tensor([0, 1, 0, 1, 0], dtype=torch.int64, device=card)
    got, want = fused_pair(b, func, "sum", gids, 2, params, True)
    assert not WS.LAST_PLAN.staged
    assert_same(got, want, 1e-3, what=func)


@pytest.mark.cuda
def test_fused_path_allocates_no_grid_on_card(card):
    """The window-stats rung makes one launch and no [S, J] tensor."""
    b = block(True, n_series=2000, seed=5).to_device(card)
    gids = spread_groups(b, 8, card)
    params = params_for()
    before = (WS.LAUNCHES, WS.RANGE_LAUNCHES, MK.LAUNCHES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(card)
    base = torch.cuda.memory_allocated(card)
    AGG.fused_range_aggregate("rate", "sum", b, gids, 8, params, is_counter=True)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated(card) - base < b.ts.shape[0] * params.num_steps * 4
    assert (WS.LAUNCHES, WS.RANGE_LAUNCHES, MK.LAUNCHES) == (before[0], before[1] + 1, before[2])


# ---- the general range kernel (csrc/general_range.cu, B4) ----

GENERAL_STAGINGS = {
    "gauge": ({}, False, False), "corrected": ({"counter_corrected": True}, True, False),
    "shifted": ({"subtract_baseline": True}, True, False),
    "diff": ({"diff_encode": True}, True, False), "delta": ({}, True, True),
}


def general_block(staging: str, n_series=65, n=300, seed=0):
    """Irregular rows (5-15 s, a tie every 13 samples, ragged lengths) in a
    staging mode: gauges, counters with a reset, or delta increments."""
    mode, counter, is_delta = GENERAL_STAGINGS[staging]
    rng = np.random.default_rng(seed)
    series = []
    for i in range(n_series):
        gaps = rng.integers(5_000, 15_001, n - i % 40)
        gaps[7::13] = 0
        ts = BASE + np.cumsum(gaps).astype(np.int64)
        m = len(ts)
        if is_delta:
            vals = rng.uniform(0, 10, m)
        elif counter:
            vals = np.cumsum(rng.uniform(0, 10, m)) + 1e3
            vals[m // 2:] -= vals[m // 2] - 2.0
        else:
            vals = 50 + 20 * rng.standard_normal(m)
        series.append((ts, vals))
    return stage_series(series, BASE, **mode), counter, is_delta


def general_pair(b, func, op, gids, G, params, counter, is_delta):
    before = GR.LAUNCHES
    got = GR.general_range_aggregate(func, op, b, gids, G, params, is_counter=counter,
                                     is_delta=is_delta)
    assert GR.LAUNCHES == before + 1
    want = GR.general_range_aggregate_plain(func, op, b, gids, G, params, is_counter=counter,
                                            is_delta=is_delta)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("staging", sorted(GENERAL_STAGINGS))
@pytest.mark.parametrize("func", sorted(GR.GENERAL_FUNCS))
def test_general_kernel_matches_plain_on_card(card, func, staging):
    """G = S, a grid from before the first sample to past the last (empty
    and one-sample windows): rtol 2e-4 / atol 1e-4, NaN masks equal."""
    hb, counter, is_delta = general_block(staging)
    b = hb.to_device(card)
    params = RangeParams(BASE - 200_000, 60_000, 70, 300_000)
    got, want = general_pair(b, func, "sum", own_groups(b, card), b.n_series, params, counter,
                             is_delta)
    assert GR.LAST_PLAN.staged
    assert_same(got, want, 2e-4, 1e-4, f"{func} {staging}")


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["sum", "count", "avg", "min", "max"])
@pytest.mark.parametrize("G", [1, 8])
@pytest.mark.parametrize("func", sorted(GR.GENERAL_FUNCS))
def test_general_kernel_group_ops_on_card(card, func, G, op):
    """Shared-memory partials: atomics reorder a group's f32 sums (rtol 1e-3)."""
    staging = {"changes": "diff", "resets": "diff", "idelta": "diff",
               "irate": "corrected"}.get(func, "shifted")
    hb, counter, is_delta = general_block(staging, n_series=300, seed=1)
    b = hb.to_device(card)
    got, want = general_pair(b, func, op, spread_groups(b, G, card), G, params_for(), counter,
                             is_delta)
    assert GR.LAST_PLAN.partials == "shared"
    assert_same(got, want, 1e-3, 1e-5 * float(np.nanmax(np.abs(want.cpu().numpy()))),
                f"{op}({func}) G={G}")


@pytest.mark.cuda
@pytest.mark.parametrize("func", sorted(GR.GENERAL_FUNCS))
def test_general_kernel_groups_above_shared_budget_on_card(card, func):
    """G past the shared-memory budget takes the global-atomic partials."""
    hb, counter, is_delta = general_block("gauge", n_series=300, seed=2)
    b = hb.to_device(card)
    params = params_for(num_steps=40)
    G = GA.PARTIALS_BUDGET // (2 * 40 * 4) + 1
    got, want = general_pair(b, func, "max", spread_groups(b, G, card), G, params, counter,
                             is_delta)
    assert GR.LAST_PLAN.partials == "global"
    assert_same(got, want, 1e-3, 1e-4, func)


@pytest.mark.cuda
@pytest.mark.parametrize("func", sorted(GR.GENERAL_FUNCS))
def test_general_kernel_gathers_tied_samples_on_card(card, func):
    """Tied timestamps: the general kinds gather the single samples at hi-1
    and hi-2 (irate over a tied last pair divides by 1e-30), never the
    tied runs window stats sum; a window of one sample has stddev and
    z_score 0."""
    ts = np.full((8, 128), TS_PAD, np.int32)
    ts[0, :8] = [1000, 1000, 2000, 3000, 4000, 4000, 9000, 20000]
    ts[1, :3] = [5000, 6000, 6000]
    vals = np.zeros((8, 128), np.float32)
    vals[0, :8] = [1.0, 10.0, 3.0, 4.0, 6.0, 8.0, 8.0, 2.0]
    vals[1, :3] = [7.0, 7.5, 9.0]
    lens = np.zeros(8, np.int32)
    lens[:2] = [8, 3]
    from filodb_tpu_torch.ops.staging import block_from_arrays

    b = block_from_arrays(ts, vals, lens, BASE, np.zeros(8, np.float32), 2, device=card)
    gids = torch.tensor([0, 1] + [2] * 6, dtype=torch.int64, device=card)
    params = RangeParams(BASE, 1000, 25, 5000)
    got, want = general_pair(b, func, "sum", gids, 2, params, False, False)
    assert_same(got, want, 2e-4, 1e-4, func)
    if func in ("stddev_over_time", "z_score"):
        g = got.cpu().numpy()
        assert g[0, 20] == 0.0  # (15 s, 20 s]: one sample


@pytest.mark.cuda
@pytest.mark.parametrize("func", ["changes", "resets"])
def test_general_kernel_stages_a_distinct_raw_on_card(card, func):
    """A gauge's changes/resets compare raw neighbours; a block with a raw
    row of its own stages it as a third array."""
    hb, _, _ = general_block("gauge", seed=3)
    b = hb.to_device(card)
    b.raw = torch.round(b.vals / 7.0).contiguous()
    got, want = general_pair(b, func, "sum", own_groups(b, card), b.n_series, params_for(),
                             False, False)
    assert GR.LAST_PLAN.n_arrays == 3
    assert_same(got, want, 0.0, 0.0, func)


@pytest.mark.cuda
@pytest.mark.parametrize("func", ["irate", "stddev_over_time", "changes", "deriv"])
def test_general_kernel_rows_read_in_place_on_card(card, func):
    """Rows too wide for the shared-memory budget are read in place."""
    b = array_block(5, 32_768, seed=4, counter=False, device=card)
    params = RangeParams(BASE + 600_000, 600_000, 100, 3_600_000)
    gids = torch.tensor([0, 1, 0, 1, 0], dtype=torch.int64, device=card)
    got, want = general_pair(b, func, "sum", gids, 2, params, False, False)
    assert not GR.LAST_PLAN.staged
    assert_same(got, want, 1e-3, 1e-4, func)


@pytest.mark.cuda
@pytest.mark.parametrize("func", sorted(GR.GENERAL_FUNCS))
def test_general_query_launches_once_on_card(card, func):
    """The fused dispatch of a general function is one launch of the
    general kernel and no other kernel."""
    hb, counter, is_delta = general_block("shifted", n_series=200, seed=6)
    b = hb.to_device(card)
    gids = spread_groups(b, 8, card)
    before = (WS.LAUNCHES, WS.RANGE_LAUNCHES, MK.LAUNCHES, GR.LAUNCHES)
    obs = {}
    AGG.fused_range_aggregate(func, "sum", b, gids, 8, params_for(), is_counter=counter,
                              is_delta=is_delta, obs=obs)
    torch.cuda.synchronize()
    assert obs == {"variant": "general"}
    assert (WS.LAUNCHES, WS.RANGE_LAUNCHES, MK.LAUNCHES, GR.LAUNCHES) == (
        before[0], before[1], before[2], before[3] + 1)


def regular_general_block(staging: str, n_series=65, n=300, seed=0):
    """The series of ``general_block`` moved onto one 10 s grid (a block
    with shared bounds)."""
    mode, counter, is_delta = GENERAL_STAGINGS[staging]
    hb, _, _ = general_block(staging, n_series, n, seed)
    rng = np.random.default_rng(seed + 1)
    grid = BASE + 5_000 + np.arange(n, dtype=np.int64) * 10_000
    series = [(grid, (rng.uniform(0, 10, n) if is_delta else
                      np.cumsum(rng.uniform(0, 10, n)) if counter else
                      np.round(50 + 20 * rng.standard_normal(n))))
              for _ in range(n_series)]
    b = stage_series(series, BASE, **mode)
    assert b.regular_ts is not None
    return b, counter, is_delta


def assert_general(got, want, func, what):
    """changes/resets bit-equal (integer counts), the rest rtol 2e-4 /
    atol 1e-4; a grid of empty windows NaN throughout."""
    if torch.isnan(want).all():
        assert torch.isnan(got).all(), what
    elif func in ("changes", "resets"):
        np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy(), err_msg=what)
    else:
        assert_same(got, want, 2e-4, 1e-4, what)


@pytest.mark.cuda
@pytest.mark.parametrize("staging", ["gauge", "diff", "shifted", "corrected"])
@pytest.mark.parametrize("func", sorted(GR.GENERAL_FUNCS))
def test_general_kernel_shared_bounds_on_card(card, func, staging):
    """A regular block takes its windows from one [steps] table per block
    (clamped by each row's length; padded rows empty)."""
    hb, counter, is_delta = regular_general_block(staging)
    b = hb.to_device(card)
    params = RangeParams(BASE - 200_000, 60_000, 70, 300_000)
    got, want = general_pair(b, func, "sum", own_groups(b, card), b.n_series, params, counter,
                             is_delta)
    assert GR.LAST_PLAN.shared_bounds and GR.LAST_PLAN.staged
    assert_general(got, want, func, f"{func} {staging}")


@pytest.mark.cuda
@pytest.mark.parametrize("func", sorted(GR.GENERAL_FUNCS))
def test_general_kernel_long_windows_on_card(card, func):
    """1 h windows (~360 samples: many times a lane's four-sample walk)."""
    staging = {"changes": "diff", "resets": "diff", "idelta": "diff"}.get(func, "shifted")
    hb, counter, is_delta = general_block(staging, n_series=40, n=1_500, seed=5)
    b = hb.to_device(card)
    params = RangeParams(BASE + 600_000, 300_000, 40, 3_600_000)
    got, want = general_pair(b, func, "sum", own_groups(b, card), b.n_series, params, counter,
                             is_delta)
    assert_general(got, want, func, func)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [0, 1, 2, 3, 5])
@pytest.mark.parametrize("func", sorted(GR.GENERAL_FUNCS))
def test_general_kernel_short_windows_on_card(card, func, k):
    """Windows of exactly k samples (10 s scrapes, k * 10 s windows ending
    on a sample): empty, one and two samples included."""
    from filodb_tpu_torch.ops.staging import block_from_arrays

    rng = np.random.default_rng(k)
    ts = np.full((8, 128), TS_PAD, np.int32)
    ts[:6, :100] = np.arange(100) * 10_000 + np.arange(6)[:, None] * 1_000
    vals = np.zeros((8, 128), np.float32)
    vals[:6, :100] = np.round(50 + 20 * rng.standard_normal((6, 100)))
    lens = np.array([100] * 6 + [0, 0], np.int32)
    b = block_from_arrays(ts, vals, lens, BASE, np.zeros(8, np.float32), 6, device=card)
    gids = torch.tensor([0, 1, 2, 3, 4, 5, 6, 6], dtype=torch.int64, device=card)
    params = RangeParams(BASE + 300_000, 20_000, 30, k * 10_000)
    got, want = general_pair(b, func, "sum", gids, 6, params, False, False)
    assert_general(got, want, func, f"{func} k={k}")


@pytest.mark.cuda
@pytest.mark.parametrize("staged", [True, False])
@pytest.mark.parametrize("func", ["stddev_over_time", "z_score", "deriv", "changes"])
def test_general_kernel_odd_step_counts_on_card(card, func, staged):
    """37 steps (not a multiple of a warp's 32 lanes), rows staged or read
    in place (changes then walks its windows instead of a prefix)."""
    staging = "diff" if func == "changes" else "shifted"
    hb, counter, is_delta = general_block(staging, n_series=100, seed=8)
    b = hb.to_device(card)
    params = params_for(num_steps=37)
    G = b.n_series
    gids = own_groups(b, card)
    n_arrays = GR.staged_arrays(func, counter, is_delta) if staged else 0
    plan = GR.general_plan(G, 37, b.ts.shape[1], n_arrays)
    acc, cnt = GA.accumulators("sum", G, pad_steps(37), card)
    GR._launch(func, "sum", b, gids, G, params, counter, is_delta, acc, cnt, plan=plan)
    got = GA.mask_steps(GA.finish_groups("sum", acc, cnt, G), 37)
    want = GR.general_range_aggregate_plain(func, "sum", b, gids, G, params, is_counter=counter,
                                            is_delta=is_delta)
    torch.cuda.synchronize()
    assert GR.LAST_PLAN.staged == staged
    assert_general(got, want, func, f"{func} staged={staged}")


@pytest.mark.cuda
@pytest.mark.parametrize("warps", [1, 2, 3, 8])
@pytest.mark.parametrize("func", ["irate", "changes", "stddev_over_time", "deriv"])
def test_general_kernel_layouts_on_card(card, func, warps):
    """Other warps per block, grouped by zone."""
    staging = "diff" if func == "changes" else "corrected" if func == "irate" else "shifted"
    hb, counter, is_delta = general_block(staging, n_series=300, seed=9)
    b = hb.to_device(card)
    params = params_for()
    gids = spread_groups(b, 8, card)
    plan = GR.general_plan(8, params.num_steps, b.ts.shape[1],
                           GR.staged_arrays(func, counter, is_delta))
    plan = dataclasses.replace(plan, warps=warps, smem_bytes=GR.general_smem_bytes(
        8, plan.steps, warps, b.ts.shape[1], plan.n_arrays, plan.shared, False))
    acc, cnt = GA.accumulators("sum", 8, pad_steps(params.num_steps), card)
    GR._launch(func, "sum", b, gids, 8, params, counter, is_delta, acc, cnt, plan=plan)
    got = GA.mask_steps(GA.finish_groups("sum", acc, cnt, 8), params.num_steps)
    want = GR.general_range_aggregate_plain(func, "sum", b, gids, 8, params, is_counter=counter,
                                            is_delta=is_delta)
    torch.cuda.synchronize()
    if func == "changes":
        np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    else:
        assert_same(got, want, 1e-3, 1e-5 * float(np.nanmax(np.abs(want.cpu().numpy()))), func)


@pytest.mark.cuda
@pytest.mark.parametrize("func", ["idelta", "resets", "stdvar_over_time", "deriv"])
def test_general_kernel_slices_long_ranges_on_card(card, func):
    """More steps than one slice: blockIdx.y slices of MAX_SLICE_STEPS."""
    staging = "diff" if func in ("idelta", "resets") else "shifted"
    hb, counter, is_delta = general_block(staging, n_series=20, n=2_000, seed=10)
    b = hb.to_device(card)
    params = RangeParams(BASE, 10_000, GR.MAX_SLICE_STEPS * 2 + 37, 120_000)
    got, want = general_pair(b, func, "sum", own_groups(b, card), b.n_series, params, counter,
                             is_delta)
    assert GR.LAST_PLAN.steps == GR.MAX_SLICE_STEPS
    assert_general(got, want, func, func)


# ---- the regular kernel's group-partial variants and wide rows ----

@pytest.mark.cuda
@pytest.mark.parametrize("op", ["sum", "count", "avg", "min", "max"])
@pytest.mark.parametrize("variant", ["shared", "global"])
def test_regular_kernel_partial_variants_on_card(card, op, variant):
    """G on each side of the shared-memory budget (rtol 1e-3: atomics)."""
    b = regular_block(True, {"counter_corrected": True}, n_series=300, seed=2).to_device(card)
    params = RangeParams(BASE + 400_000, 60_000, 40, 300_000)
    G = 8 if variant == "shared" else GA.PARTIALS_BUDGET // (2 * 40 * 4) + 1
    gids = spread_groups(b, G, card)
    got = MK.regular_range_aggregate("rate", op, b, gids, G, params, is_counter=True)
    assert MK.LAST_PLAN.partials == variant
    want = plain_aggregate("rate", op, b, gids, G, params, True)
    torch.cuda.synchronize()
    assert_same(got, want, 1e-3, what=f"{op} {variant}")


@pytest.mark.cuda
@pytest.mark.parametrize("func", ["rate", "sum_over_time", "stddev_over_time"])
def test_regular_kernel_rows_read_in_place_on_card(card, func):
    """Long rows (32,000 samples, 520 steps of 1 h windows) are read in
    place; at G = S the kernel still equals the plain version bit for bit."""
    b = regular_block(True, {"counter_corrected": True}, n_series=9, n=32_000,
                      seed=3).to_device(card)
    params = RangeParams(BASE + 400_000, 600_000, 520, 3_600_000)
    gids = own_groups(b, card)
    got = MK.regular_range_aggregate(func, "sum", b, gids, b.n_series, params, is_counter=True)
    assert not MK.LAST_PLAN.staged
    want = plain_aggregate(func, "sum", b, gids, b.n_series, params, True)
    torch.cuda.synchronize()
    g, w = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_array_equal(g, w, err_msg=func)


@pytest.mark.cuda
def test_launch_sizes_up_and_down_on_card(card):
    """One kernel launched with more, then less, then more shared memory:
    its allowance never drops below a size already launched."""
    small = block(True, n_series=9, n=60, seed=6).to_device(card)
    large = block(True, n_series=9, n=700, seed=7).to_device(card)
    params = params_for(num_steps=8)
    for b in (large, small, large, small):
        gids = own_groups(b, card)
        got, want = fused_pair(b, "rate", "sum", gids, b.n_series, params, True)
        assert_same(got, want, 2e-4, 1e-4, f"T={b.ts.shape[1]}")
        sizes = WS.LAST_PLAN.smem_bytes
    assert sizes < GA.tile_plan(9, 8, large.ts.shape[1], 3).smem_bytes


# ---- cached and extended superblocks on the card ----

def live_store(grid: str, n_series=64, n=120, seed=0):
    """A port memstore of counters on a 10 s grid (exact, or +-4 % jitter
    around a 5 s phase), and a function appending one sample per series at
    the next slot through ``ingest_routed``."""
    from filodb_tpu_torch.core.records import RecordBatch, SeriesBatch
    from filodb_tpu_torch.core.schemas import METRIC_TAG, PROM_COUNTER, Dataset, shard_for
    from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore

    rng = np.random.default_rng(seed)
    ms = TimeSeriesMemStore()
    ms.setup(Dataset("ds"), range(4))
    tags = [{METRIC_TAG: "m", "_ws_": "demo", "_ns_": "App-2", "instance": f"h{i}",
             "zone": f"z{i % 4}"} for i in range(n_series)]

    def slot_ts(slots):
        ts = BASE + 5_000 + np.asarray(slots, np.int64) * 10_000
        if grid == "jitter":
            ts = ts + np.rint(rng.uniform(-0.04, 0.04, ts.shape) * 10_000).astype(np.int64)
        return ts

    for t in tags:
        vals = np.cumsum(rng.uniform(0, 10, n)) + 1e9
        ms.shard("ds", shard_for(t, 1, 4)).ingest_series(
            SeriesBatch(PROM_COUNTER, t, slot_ts(np.arange(n)), {"count": vals}))
    head = [n]

    def append():
        ts = slot_ts(np.full(n_series, head[0]))
        ms.ingest_routed("ds", RecordBatch(PROM_COUNTER, ts, {"count": np.full(n_series, 2e9)},
                                           tags), spread=1)
        head[0] += 1

    return ms, append


@pytest.mark.cuda
@pytest.mark.parametrize("grid", ["regular", "jitter"])
def test_warm_hit_and_extension_on_card(card, grid):
    """A warm query is one launch from the cache, of the rung the JAX
    ladder takes (the regular kernel on the regular grid, the jitter
    kernel on the jittered one); a live-edge append extends
    the superblock on the card: its tensors equal a fresh upload of its
    mirrors, and the old block's tensors are untouched."""
    from filodb_tpu_torch import metrics as M
    from filodb_tpu_torch.coordinator.planner import QueryEngine

    ms, append = live_store(grid)
    eng = QueryEngine(ms, "ds")
    q, start, end = "sum(rate(m[5m]))", (BASE + 400_000) / 1000, (BASE + 2_000_000) / 1000
    eng.query_range(q, start, end, 60)
    launches = (WS.RANGE_LAUNCHES, MK.LAUNCHES, JR.JITTER_LAUNCHES)
    res = eng.query_range(q, start, end, 60)
    assert res.stats.cache_hits == 1 and res.stats.cache_misses == 0
    counts = (WS.RANGE_LAUNCHES - launches[0], MK.LAUNCHES - launches[1],
              JR.JITTER_LAUNCHES - launches[2])
    assert counts == ((0, 1, 0) if grid == "regular" else (0, 0, 1))
    old = next(iter(ms._superblock_cache._d.values()))[1].block
    before = {k: getattr(old, k).clone() for k in ("ts", "vals", "raw", "lens")}
    extends = M.superblock_events()["extend"]
    append()
    res = eng.query_range(q, start, end, 60)
    assert res.stats.cache_extends == 1 and M.superblock_events()["extend"] == extends + 1
    new = next(iter(ms._superblock_cache._d.values()))[1].block
    assert new is not old and new.ts.is_cuda
    for k, mirror in (("ts", new.h_ts), ("vals", new.h_vals), ("raw", new.h_raw),
                      ("lens", new.h_lens)):
        assert torch.equal(getattr(new, k), torch.from_numpy(mirror).to(card)), k
        assert torch.equal(getattr(old, k), before[k]), k
    assert int(new.lens[0]) == int(old.lens[0]) + 1


# -- the histogram kernel (csrc/hist_range.cu) -------------------------------------

HIST_LES = np.array([0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, np.inf])
HIST_PARAMS = RangeParams(BASE - 120_000, 60_000, 40, 300_000)
HIST_FUNCS = sorted(["rate", "increase", "delta", "sum_over_time", "last"])


def hist_les(B: int) -> np.ndarray:
    """B increasing bucket bounds, the last +inf."""
    return np.append(np.geomspace(0.01, 50.0, B - 1), np.inf) if B > 1 else np.array([np.inf])


def hist_block(grid: str, card, n_real=300, m=400, seed=0, B=None):
    """Seeded cumulative histograms of B buckets (default len(HIST_LES))
    staged by the port, on the card: ``regular`` (one 10 s grid) or
    ``irregular`` (5-15 s apart, ragged lengths below T, an empty series,
    and series 5 sampled every 400 s, so its windows hold one sample or
    none); a few NaN bucket counts in series 3; padded rows past
    ``n_real``. The query grid starts before the first sample (empty
    windows)."""
    from filodb_tpu_torch.ops.staging import stage_histogram_series

    rng = np.random.default_rng(seed)
    B = B or len(HIST_LES)
    series = []
    for i in range(n_real):
        k = m if grid == "regular" else int(rng.integers(m // 2, m + 1)) * (i != n_real // 2)
        if grid == "regular":
            ts = BASE + 3_000 + np.arange(k, dtype=np.int64) * 10_000
        elif i == 5:
            k = m // 40
            ts = BASE + 1_000 + np.arange(k, dtype=np.int64) * 400_000
        else:
            ts = BASE + np.cumsum(rng.integers(5_000, 15_001, k)).astype(np.int64)
        incr = rng.poisson(2.0, size=(k, B)).astype(np.float64)
        incr[:, -1] = incr.sum(1)
        h = np.cumsum(np.cumsum(incr, axis=1), axis=0)
        if i == 3 and k > 40:
            h[20:24, min(2, B - 1)] = np.nan
        series.append((ts, h))
    return stage_histogram_series(series, BASE, B, [(0, i) for i in range(n_real)]).to_device(card)


@functools.lru_cache(maxsize=12)
def shared_hist_block(grid: str, card, n_real: int, m: int, seed: int, B: int):
    """``hist_block`` built once per shape for the tests that only read it."""
    return hist_block(grid, card, n_real=n_real, m=m, seed=seed, B=B)


def hist_gids(G: int, S: int, n_real: int, card):
    gids = torch.full((S,), G, dtype=torch.int64, device=card)
    gids[:n_real] = torch.arange(n_real, device=card) % G
    return gids


def hist_windows(b, params):
    return (AGG._hist_shared_windows(b, params, pad_steps(params.num_steps))
            if b.regular_ts is not None else None)


def assert_partials_match(acc, cnt, want_acc, want_cnt, G: int, rtol: float, atol: float = 0.0):
    """Member counts equal, finished [G, J*B] sums within rtol, NaN masks
    equal (the trash group's row is dropped: padded rows reach it in the
    plain version's index_add, never in the kernel)."""
    assert torch.equal(cnt[:G], want_cnt[:G])
    got = GA.finish_groups("sum", acc, cnt, G).cpu().numpy()
    want = GA.finish_groups("sum", want_acc, want_cnt, G).cpu().numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    m = ~np.isnan(want)
    np.testing.assert_allclose(got[m], want[m], rtol=rtol, atol=atol)


def assert_quantiles_match(got, want):
    """NaN and +-inf masks equal, the finite values within rtol 1e-3."""
    g, w = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    np.testing.assert_array_equal(np.isposinf(g), np.isposinf(w))
    np.testing.assert_array_equal(np.isneginf(g), np.isneginf(w))
    m = np.isfinite(w)
    np.testing.assert_allclose(g[m], w[m], rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("is_delta", [False, True], ids=["cumulative", "delta"])
@pytest.mark.parametrize("func", HIST_FUNCS)
@pytest.mark.parametrize("grid", ["regular", "irregular"])
def test_hist_range_kernel_matches_plain_on_card(card, grid, func, is_delta):
    """Each row its own group: the kernel's sums are the plain version's
    values bit for bit (one member each), NaN masks equal; padded steps
    empty."""
    from filodb_tpu_torch.ops import hist_kernels as HK

    b = hist_block(grid, card)
    n = b.n_series
    gids = hist_gids(n, b.vals.shape[0], n, card)
    windows = hist_windows(b, HIST_PARAMS)
    before = HK.RANGE_LAUNCHES
    acc, cnt = HK.hist_range_partials(func, b, gids, n, HIST_PARAMS, windows, is_delta)
    assert HK.RANGE_LAUNCHES == before + 1
    want_acc, want_cnt = HK.hist_partials_plain(func, b, gids, n, HIST_PARAMS, windows, is_delta)
    torch.cuda.synchronize()
    assert_partials_match(acc, cnt, want_acc, want_cnt, n, rtol=0.0)
    assert not cnt[:, HIST_PARAMS.num_steps * b.vals.shape[2]:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 1000])
@pytest.mark.parametrize("B", [1, 3, 12, 40, 300])
@pytest.mark.parametrize("is_delta", [False, True], ids=["cumulative", "delta"])
@pytest.mark.parametrize("func", HIST_FUNCS)
@pytest.mark.parametrize("grid", ["regular", "irregular"])
def test_hist_range_buckets_and_groups_on_card(card, grid, func, is_delta, B, G):
    """Every vector width (B = 1, 3: one bucket at a time; 12, 40, 300:
    four), B above the block's threads, one group (shared partials, sliced
    for B = 300) and 1000 (global atomics), against the plain group sums
    (rtol 1e-3 with atol 1e-5 of the largest sum: atomics reorder the f32
    sums), and the folded quantile against hist_quantile_plain on the same
    launch's partials."""
    from filodb_tpu_torch.ops import hist_kernels as HK

    b = shared_hist_block(grid, card, 1200, 200, B, B)
    gids = hist_gids(G, b.vals.shape[0], b.n_series, card)
    windows = hist_windows(b, HIST_PARAMS)
    les = torch.tensor(hist_les(B), dtype=torch.float32, device=card)
    out, acc, cnt = HK.hist_range_quantile(0.75, func, b, gids, G, HIST_PARAMS, les, windows,
                                           is_delta)
    plan = HK.LAST_PLAN
    assert plan == HK.hist_plan(b.vals.shape[1], HIST_PARAMS.num_steps, B, G,
                                windows is not None)
    assert plan.shared or G > 1
    assert plan.vec == (4 if B % 4 == 0 else 1)
    want_acc, want_cnt = HK.hist_partials_plain(func, b, gids, G, HIST_PARAMS, windows, is_delta)
    torch.cuda.synchronize()
    fin = GA.finish_groups("sum", want_acc, want_cnt, G)
    atol = 1e-5 * float(torch.nan_to_num(fin, nan=0.0).abs().max())
    assert_partials_match(acc, cnt, want_acc, want_cnt, G, rtol=1e-3, atol=atol)
    assert_quantiles_match(out, HK.hist_quantile_plain(0.75, acc, cnt, G, les,
                                                       HIST_PARAMS.num_steps))


@pytest.mark.cuda
@pytest.mark.parametrize("n_real", [300, 3000], ids=["one_row_per_block", "rows_per_block"])
@pytest.mark.parametrize("G", [1, 8, 40])
@pytest.mark.parametrize("grid", ["regular", "irregular"])
def test_hist_range_group_partials_on_card(card, grid, G, n_real):
    """The plan's partials (shared, in slices of whole steps where G = 8
    and 40 need them) against the plain group sums (rtol 1e-3: atomics and
    run sums reorder the f32 sums), with a few rows per block and with
    many."""
    from filodb_tpu_torch.ops import hist_kernels as HK

    b = hist_block(grid, card, n_real=n_real, seed=1)
    gids = hist_gids(G, b.vals.shape[0], b.n_series, card)
    les = torch.tensor(HIST_LES, dtype=torch.float32, device=card)
    got = AGG.fused_hist_range_aggregate("rate", b, gids, G, HIST_PARAMS, les)
    windows = hist_windows(b, HIST_PARAMS)
    assert HK.LAST_PLAN == HK.hist_plan(b.vals.shape[1], HIST_PARAMS.num_steps, len(HIST_LES),
                                        G, windows is not None)
    acc, cnt = HK.hist_partials_plain("rate", b, gids, G, HIST_PARAMS, windows)
    want = GA.finish_groups("sum", acc, cnt, G).reshape(got.shape)
    torch.cuda.synchronize()
    g, w = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    np.testing.assert_allclose(g[~np.isnan(w)], w[~np.isnan(w)], rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("func", ["rate", "sum_over_time"])
@pytest.mark.parametrize("G", [1, 7])
def test_hist_range_many_tiles_per_block_on_card(card, func, G):
    """A block of 40000 short rows: every persistent block walks several
    tiles (ts copies of the next tile in flight while one is computed), run
    sums carry across a block's tiles; partials and the folded quantile
    against plain."""
    from filodb_tpu_torch.ops import hist_kernels as HK

    params = RangeParams(BASE - 60_000, 60_000, 12, 300_000)
    b = shared_hist_block("irregular", card, 40_000, 60, 3, len(HIST_LES))
    S = b.vals.shape[0]
    gids = hist_gids(G, S, b.n_series, card)
    les = torch.tensor(HIST_LES, dtype=torch.float32, device=card)
    out, acc, cnt = HK.hist_range_quantile(0.5, func, b, gids, G, params, les)
    plan, grid = HK.LAST_PLAN, HK.LAST_GRID
    assert plan.staged and grid[0] * plan.rows < S
    want_acc, want_cnt = HK.hist_partials_plain(func, b, gids, G, params)
    torch.cuda.synchronize()
    assert_partials_match(acc, cnt, want_acc, want_cnt, G, rtol=1e-3)
    assert_quantiles_match(out, HK.hist_quantile_plain(0.5, acc, cnt, G, les, params.num_steps))


@pytest.mark.cuda
@pytest.mark.parametrize("first_le", [0.1, 0.0, -1.0])
@pytest.mark.parametrize("q", [-0.1, 0.0, 0.5, 0.99, 1.0, 1.1])
def test_hist_quantile_kernel_matches_plain_on_card(card, q, first_le):
    """The quantile folded into the range launch, against
    hist_quantile_plain on that launch's partials, with a zero-total group,
    a group with no member and buckets without members (series 3's NaN
    counts, alone in its group): NaN and infinity masks equal, rtol 1e-3.
    Exactly one launch, counted as a folded quantile."""
    from filodb_tpu_torch.ops import hist_kernels as HK

    b = hist_block("irregular", card, seed=2)
    S, n = b.vals.shape[0], b.n_series
    G = 6
    gids = torch.full((S,), G, dtype=torch.int64, device=card)
    gids[:n] = 4 + torch.arange(n, device=card) % 2  # groups 4 and 5: the bulk
    gids[3] = 3  # NaN buckets alone
    gids[7:n:50] = 1
    b.vals[7:n:50] = 0.0  # group 1: zero totals
    # group 0 and group 2 have no member
    les = HIST_LES.copy()
    les[0] = first_le
    les_t = torch.tensor(les, dtype=torch.float32, device=card)
    before = (HK.RANGE_LAUNCHES, HK.FOLDED_QUANTILES)
    got, acc, cnt = HK.hist_range_quantile(q, "rate", b, gids, G, HIST_PARAMS, les_t)
    assert (HK.RANGE_LAUNCHES, HK.FOLDED_QUANTILES) == (before[0] + 1, before[1] + 1)
    want = HK.hist_quantile_plain(q, acc, cnt, G, les_t, HIST_PARAMS.num_steps)
    torch.cuda.synchronize()
    assert_quantiles_match(got, want)
    if 0.0 <= q <= 1.0:
        J = HIST_PARAMS.num_steps
        assert torch.isnan(got[[0, 2]]).all() and torch.isnan(got[1, :J]).any()


@pytest.mark.cuda
@pytest.mark.parametrize("B", [12, 300], ids=["one_slice", "slices"])
@pytest.mark.parametrize("grid", ["regular", "irregular"])
def test_hist_quantile_counter_reset_between_launches_on_card(card, grid, B):
    """Two launches in a row on one stream into the same buffers: the last
    block of each slice sets its arrival counter back to 0, so the second
    launch folds its quantile too (with the counters left stale it would
    leave NaN) and equals the first."""
    from filodb_tpu_torch.ops import hist_kernels as HK

    b = hist_block(grid, card, n_real=500, m=200, seed=4, B=B)
    S = b.vals.shape[0]
    gids = hist_gids(3, S, b.n_series, card)
    windows = hist_windows(b, HIST_PARAMS)
    les = torch.tensor(hist_les(B), dtype=torch.float32, device=card)
    plan = HK.hist_plan(b.vals.shape[1], HIST_PARAMS.num_steps, B, 3, windows is not None)
    assert (plan.slices > 1) == (B == 300)
    j_pad = pad_steps(HIST_PARAMS.num_steps)
    acc, cnt, arrivals = HK.hist_buffers(3, j_pad * B, plan.slices, card)
    outs = []
    for _ in range(2):
        acc.zero_()
        cnt.zero_()
        out = torch.full((3, j_pad), float("nan"), device=card)
        HK._launch_range("rate", b, gids, 3, HIST_PARAMS, windows, False, acc, cnt,
                         quantile=(0.9, les, out, arrivals))
        torch.cuda.synchronize()
        assert not arrivals.any()
        outs.append(out)
    J = HIST_PARAMS.num_steps
    assert torch.isfinite(outs[1][:, 10:J]).all()
    assert_quantiles_match(outs[1], outs[0])
    assert_quantiles_match(outs[1], HK.hist_quantile_plain(0.9, acc, cnt, 3, les, J))


@pytest.mark.cuda
def test_hist_quantile_query_launches_both_kernels_once_on_card(card):
    """histogram_quantile(q, sum by (le) (rate(m_bucket[5m]))) on the card:
    exactly one launch of the port (the range kernel, its quantile folded
    in), cold and warm (a superblock-cache hit); a plain sum by (le) of the
    same selection launches once too, with no quantile."""
    from filodb_tpu_torch.coordinator.planner import QueryEngine
    from filodb_tpu_torch.core.histograms import custom_buckets
    from filodb_tpu_torch.core.records import RecordBatch
    from filodb_tpu_torch.core.schemas import METRIC_TAG, PROM_HISTOGRAM, Dataset
    from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore
    from filodb_tpu_torch.ops import hist_kernels as HK

    rng = np.random.default_rng(5)
    les = custom_buckets(HIST_LES[:-1]).bounds()
    n, m = 64, 200
    ts = BASE + np.arange(m, dtype=np.int64) * 10_000
    incr = rng.poisson(2.0, size=(n, m, len(les))).astype(np.float64)
    h = np.cumsum(np.cumsum(incr, axis=2), axis=1)
    tags = [{METRIC_TAG: "lat", "_ws_": "w", "_ns_": "n", "instance": f"h{i}"} for i in range(n)]
    ms = TimeSeriesMemStore()
    ms.setup(Dataset("ds"), range(4))
    ms.ingest_routed("ds", RecordBatch(
        PROM_HISTOGRAM, np.tile(ts, n), {"sum": h[..., -1].ravel(), "count": h[..., -1].ravel(),
                                         "h": h.reshape(-1, len(les))},
        [t for t in tags for _ in range(m)], les), spread=2)
    eng = QueryEngine(ms, "ds")
    start, end = (BASE + 400_000) / 1000, (BASE + 1_900_000) / 1000
    for q, folds in (("histogram_quantile(0.99, sum by (le) (rate(lat_bucket[5m])))", 1),
                     ("sum by (le) (rate(lat_bucket[5m]))", 0)):
        outs = []
        for _ in range(2):
            before = (HK.RANGE_LAUNCHES, HK.FOLDED_QUANTILES, WS.RANGE_LAUNCHES, WS.LAUNCHES,
                      MK.LAUNCHES)
            res = eng.query_range(q, start, end, 60)
            after = (HK.RANGE_LAUNCHES, HK.FOLDED_QUANTILES, WS.RANGE_LAUNCHES, WS.LAUNCHES,
                     MK.LAUNCHES)
            assert tuple(a - b for a, b in zip(after, before)) == (1, folds, 0, 0, 0)
            outs.append(np.stack([g.values_np() if g.hist is None else g.hist_np()
                                  for g in res.grids]))
        assert res.stats.cache_hits == 1 and res.stats.cache_misses == 0
        assert np.isfinite(outs[0]).all()
        np.testing.assert_allclose(outs[1], outs[0], rtol=1e-3)


# ---- the reference tree over native histograms: K1's store mode, K2 ----

def hist_store_pair(b, func, is_delta, params=HIST_PARAMS):
    """One store-mode launch (K1) and its plain grid, both [J, B, S]."""
    from filodb_tpu_torch.ops import hist_kernels as HK

    gids = AGG.zero_gids(b)
    windows = hist_windows(b, params)
    before = HK.SERIES_LAUNCHES
    got = HK.hist_range_series(func, b, gids, params, windows, is_delta)
    assert HK.SERIES_LAUNCHES == before + 1
    want = HK.hist_series_plain(func, b, gids, params, windows, is_delta)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("is_delta", [False, True], ids=["cumulative", "delta"])
@pytest.mark.parametrize("func", HIST_FUNCS)
@pytest.mark.parametrize("grid", ["regular", "irregular"])
def test_hist_store_matches_plain_on_card(card, grid, func, is_delta):
    """K1, the range kernel's store mode: every (step, bucket, row) equals
    the plain version bit for bit (NaN bucket counts inside their windows,
    padded rows NaN)."""
    from filodb_tpu_torch.ops import hist_kernels as HK

    b = hist_block(grid, card)
    got, want = hist_store_pair(b, func, is_delta)
    assert got.shape == (HIST_PARAMS.num_steps, len(HIST_LES), b.vals.shape[0])
    assert HK.LAST_SERIES_PLAN.store and not HK.LAST_SERIES_PLAN.shared
    assert torch.isnan(got[:, :, b.n_series:]).all()
    assert_store(got, want, f"{grid} {func}", exact=True)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 12, 40])
@pytest.mark.parametrize("grid", ["regular", "irregular"])
def test_hist_store_bucket_widths_on_card(card, grid, B):
    """Every vector width (B = 1, 3: one bucket at a time; 12, 40: four)."""
    b = shared_hist_block(grid, card, 700, 200, 3, B)
    got, want = hist_store_pair(b, "rate", False)
    assert_store(got, want, f"{grid} B={B}", exact=True)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["shared", "staged", "in_place"])
def test_hist_store_writes_only_its_grid_on_card(card, route):
    """13 rows (a partial last tile for every rows-per-tile choice) into a
    grid of 20 columns filled with a sentinel: the launch writes exactly
    the [J, B, :13] part -- the sentinel in columns 13.. survives -- and
    that part equals the plain grid. (The store's own row bound: nvcc 12.8
    once compiled a store variant's partial last tile to run all its
    rows.)"""
    from filodb_tpu_torch.ops import hist_kernels as HK

    b = hist_rows_block(card, 13, route)
    params = RangeParams(BASE + 400_000, 60_000, 37, 300_000)
    S_pad, B = b.vals.shape[0], b.vals.shape[2]
    out = torch.full((37, B, S_pad + 7), 12345.0, device=card)
    windows = hist_windows(b, params)
    assert (windows is not None) == (route == "shared")
    HK._launch_series("rate", b, AGG.zero_gids(b), params, windows, False, out)
    plan = HK.LAST_SERIES_PLAN
    assert plan.staged == (route == "staged") and S_pad % plan.rows
    torch.cuda.synchronize()
    assert bool((out[:, :, S_pad:] == 12345.0).all()), route
    want = HK.hist_series_plain("rate", b, AGG.zero_gids(b), params, windows)
    assert_store(out[:, :, :S_pad], want, route, exact=True)


def hist_rows_block(card, S: int, route: str, B: int = 12, n: int = 300, seed: int = 23):
    """S histogram rows with no padded row (every tile partial where S is
    not a multiple of the tile): on one 10 s grid (``shared``) or 5-15 s
    apart, staged (``staged``) or with rows past the staging budget
    (``in_place``)."""
    from filodb_tpu_torch.ops.staging import stage_histogram_series

    rng = np.random.default_rng(seed)
    series = []
    for _ in range(S):
        ts = (BASE + 5_000 + np.arange(n, dtype=np.int64) * 10_000 if route == "shared"
              else BASE + np.cumsum(rng.integers(5_000, 15_001, n)).astype(np.int64))
        incr = rng.poisson(2.0, size=(n, B)).astype(np.float64)
        series.append((ts, np.cumsum(np.cumsum(incr, axis=1), axis=0)))
    b = stage_histogram_series(series, BASE, B, [(0, i) for i in range(S)])
    T = 8192 if route == "in_place" else b.ts.shape[1]  # in place: past the staging budget
    ts = np.full((S, T), TS_PAD, np.int32)
    ts[:, : b.ts.shape[1]] = b.ts[:S]
    vals = np.zeros((S, T, B), np.float32)
    vals[:, : b.ts.shape[1]] = b.vals[:S]
    b = dataclasses.replace(b, ts=ts, vals=vals, lens=b.lens[:S], baseline=b.baseline[:S])
    return b.to_device(card)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 37, 95])
@pytest.mark.parametrize("route", ["shared", "staged", "in_place"])
def test_hist_store_odd_row_counts_on_card(card, route, S):
    """S = 1, and row counts that are not a multiple of 4 or of the tile:
    the wrapper's [J, B, S] grid equals the plain grid bit for bit, on
    every bound route."""
    from filodb_tpu_torch.ops import hist_kernels as HK

    b = hist_rows_block(card, S, route, seed=23 + S)
    params = RangeParams(BASE + 400_000, 60_000, 37, 300_000)
    gids = AGG.zero_gids(b)
    windows = hist_windows(b, params)
    got = HK.hist_range_series("rate", b, gids, params, windows)
    assert got.shape == (37, 12, S)
    want = HK.hist_series_plain("rate", b, gids, params, windows)
    torch.cuda.synchronize()
    assert_store(got, want, f"{route} S={S}", exact=True)


@pytest.mark.cuda
@pytest.mark.parametrize("grid", ["regular", "irregular"])
def test_hist_store_many_buckets_on_card(card, grid):
    """300 buckets a sample (the slices of a wide step): bit-equal to
    plain, padded rows NaN."""
    from filodb_tpu_torch.ops import hist_kernels as HK

    b = shared_hist_block(grid, card, 150, 120, 5, 300)
    params = RangeParams(BASE - 120_000, 60_000, 23, 300_000)
    got, want = hist_store_pair(b, "rate", False, params)
    assert torch.isnan(got[:, :, b.n_series:]).all()
    assert_store(got, want, f"{grid} B=300", exact=True)


def instant_edge_grid(card, first_le: float):
    """[rows, J, B] cumulative counts on the card with the edge rows: all
    NaN, a zero total, a NaN inside, counts only in the +Inf bucket, ties
    across buckets; and bounds with ``first_le`` first."""
    rng = np.random.default_rng(31)
    les = np.array([first_le, 0.1, 0.25, 0.5, 1.0, 2.5, np.inf], np.float32)
    h = np.cumsum(rng.poisson(1.5, size=(300, 9, len(les))).astype(np.float32), axis=-1)
    h[0] = np.nan
    h[1] = 0.0
    h[2, :, 3] = np.nan
    h[3, :, :-1] = 0.0
    h[4, :, 1:4] = h[4, :, 1:2]
    return torch.from_numpy(h).to(card), torch.from_numpy(les).to(card)


def assert_within_ulps(got, want, ulps: int, what: str):
    """NaN and infinity masks equal, finite values within ``ulps`` f32 ulps."""
    g, w = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=what)
    np.testing.assert_array_equal(np.isinf(g), np.isinf(w), err_msg=what)
    np.testing.assert_array_equal(g[np.isinf(w)], w[np.isinf(w)], err_msg=what)
    m = np.isfinite(w)
    gap = np.abs(g[m].view(np.int32).astype(np.int64) - w[m].view(np.int32).astype(np.int64))
    assert (gap <= ulps).all() or np.allclose(g[m], w[m], rtol=0, atol=1e-30), (what, gap.max())


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["row_major", "store"])
@pytest.mark.parametrize("first_le", [0.005, 0.0, -1.0])
@pytest.mark.parametrize("op, arg", [("quantile", q) for q in (-0.1, 0.0, 0.5, 0.99, 1.0, 1.1)]
                         + [("quantile_even", q) for q in (0.25, 0.9)]
                         + [("fraction", b) for b in ((0.0, 0.25), (-np.inf, np.inf),
                                                      (-np.inf, 0.1), (0.001, 0.002),
                                                      (0.25, 0.5), (1.0, np.inf))])
def test_hist_instant_matches_plain_on_card(card, op, arg, first_le, layout):
    """K2 against its plain versions on edge rows, over a row-major grid and
    the store's permuted view: within 2 ulp (the interpolations round as
    the plain version's separate f32 operations do), NaN and infinity masks
    equal; one launch each."""
    from filodb_tpu_torch.ops import hist_kernels as HK

    h, les = instant_edge_grid(card, first_le)
    if layout == "store":
        h = h.permute(1, 2, 0).contiguous().permute(2, 0, 1)
    # a second grid of other bounds (and fewer buckets) in the same launch
    h2, les2 = h[:77, :, :5].contiguous(), les[:5].clone()
    les2[-1] = float("inf")
    kw = {"lower": arg[0], "upper": arg[1]} if op == "fraction" else {"q": arg}
    before = HK.INSTANT_LAUNCHES
    got, got2 = HK.hist_instant(op, [h, h2], [les, les2], **kw)
    assert HK.INSTANT_LAUNCHES == before + 1 and got.shape == h.shape[:2]
    assert got.stride() == (1, h.shape[0] + 77)  # a view of the step-major [J, sum S] buffer
    for g, grid, b in ((got, h, les), (got2, h2, les2)):
        want = (HK.histogram_fraction_plain(arg[0], arg[1], grid, b) if op == "fraction"
                else HK.histogram_quantile_plain(arg, grid, b, even=op == "quantile_even"))
        assert_within_ulps(g, want, 2, f"{op} {arg} les[0]={first_le} B={grid.shape[2]}")


@pytest.mark.cuda
def test_hist_instant_takes_many_grids_on_card(card):
    """More grids than one launch takes (MAX_GRIDS): one launch per
    MAX_GRIDS, each grid's answer its own plain one."""
    from filodb_tpu_torch.ops import hist_kernels as HK

    h, les = instant_edge_grid(card, 0.005)
    grids = [h[i * 7: i * 7 + 5 + i % 3] for i in range(HK.MAX_GRIDS + 3)]
    before = HK.INSTANT_LAUNCHES
    outs = HK.hist_instant("quantile", grids, [les] * len(grids), q=0.9)
    assert HK.INSTANT_LAUNCHES == before + 2
    for g, o in zip(grids, outs):
        assert_within_ulps(o, HK.histogram_quantile_plain(0.9, g, les), 2, "many grids")


@pytest.mark.cuda
@pytest.mark.parametrize("grid", ["regular", "irregular"])
def test_hist_store_then_segment_sum_equals_fused_on_card(card, grid):
    """A leaf's K1 grid read in place by one segment-aggregate launch (the
    map phase's per-bucket sum, J * B steps) equals the fused kernel's
    group sums of the same block (rtol 1e-3: both reorder f32 sums)."""
    from filodb_tpu_torch.ops import hist_kernels as HK
    from filodb_tpu_torch.ops import segment_agg as SA

    b = hist_block(grid, card, n_real=900)
    n, G = b.n_series, 7
    grid_t = HK.run_hist_range_function("rate", b, HIST_PARAMS)[:n]  # [n, J, B] view
    J, B = grid_t.shape[1:]
    gids = torch.arange(n, device=card) % G
    before = (SA.LAUNCHES, SA.TRANSPOSES)
    sums = SA.segment_components(grid_t.reshape(n, J * B), gids, G, ("sum",))["sum"]
    assert (SA.LAUNCHES, SA.TRANSPOSES) == (before[0] + 1, before[1])  # read in place
    padded = hist_gids(G, b.vals.shape[0], n, card)
    acc, cnt = HK.hist_range_partials("rate", b, padded, G, HIST_PARAMS, hist_windows(
        b, HIST_PARAMS))
    want = GA.finish_groups("sum", acc, cnt, G)[:, : J * B]
    torch.cuda.synchronize()
    g, w = sums.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    m = ~np.isnan(w)
    np.testing.assert_allclose(g[m], w[m], rtol=1e-3, atol=1e-5 * float(np.abs(w[m]).max()))


@pytest.mark.cuda
def test_hist_tree_launches_on_card(card):
    """The tree over native histograms on the card: one K1 launch per shard
    leaf, one K2 launch per histogram-function node (all its grids: the
    leaves', or the root's merged one), one segment aggregate per map
    phase, nothing on the fused kernel; the answers equal the same queries
    on the CPU engine (plain versions; rtol 1e-3)."""
    from filodb_tpu_torch.coordinator.planner import PlannerParams, QueryEngine
    from filodb_tpu_torch.core.histograms import custom_buckets
    from filodb_tpu_torch.core.records import RecordBatch
    from filodb_tpu_torch.core.schemas import METRIC_TAG, PROM_HISTOGRAM, Dataset
    from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore
    from filodb_tpu_torch.ops import hist_kernels as HK
    from filodb_tpu_torch.ops import segment_agg as SA

    rng = np.random.default_rng(6)
    les = custom_buckets(HIST_LES[:-1]).bounds()
    n, m = 64, 200
    ts = BASE + np.cumsum(rng.integers(5_000, 15_001, (n, m)), axis=1)
    incr = rng.poisson(2.0, size=(n, m, len(les))).astype(np.float64)
    h = np.cumsum(np.cumsum(incr, axis=2), axis=1)
    tags = [{METRIC_TAG: "lat", "_ws_": "w", "_ns_": "n", "instance": f"h{i}",
             "zone": f"z{i % 3}"} for i in range(n)]
    ms = TimeSeriesMemStore()
    ms.setup(Dataset("ds"), range(4))
    ms.ingest_routed("ds", RecordBatch(
        PROM_HISTOGRAM, ts.ravel(), {"sum": h[..., -1].ravel(), "count": h[..., -1].ravel(),
                                     "h": h.reshape(-1, len(les))},
        [t for t in tags for _ in range(m)], les), spread=2)
    params = PlannerParams(fused_aggregate=False)
    eng, cpu = QueryEngine(ms, "ds", params=params), QueryEngine(ms, "ds", params=params,
                                                                   device="cpu")
    start, end = (BASE + 400_000) / 1000, (BASE + 1_500_000) / 1000
    leaves = len(cpu.query_range("rate(lat[5m])", start, end, 60).grids)  # shards with data
    assert leaves > 1
    for q, k2, sa in (("rate(lat[5m])", 0, 0),
                      ("histogram_quantile(0.9, rate(lat[5m]))", 1, 0),
                      ("histogram_fraction(0, 0.25, rate(lat[5m]))", 1, 0),
                      ("histogram_bucket(0.5, rate(lat[5m]))", 0, 0),
                      ("histogram_quantile(0.9, sum by (zone) (rate(lat[5m])))", 1, 1)):
        before = (HK.SERIES_LAUNCHES, HK.INSTANT_LAUNCHES, SA.LAUNCHES, HK.RANGE_LAUNCHES)
        res = eng.query_range(q, start, end, 60)
        after = (HK.SERIES_LAUNCHES, HK.INSTANT_LAUNCHES, SA.LAUNCHES, HK.RANGE_LAUNCHES)
        want_sa = sa * leaves
        assert tuple(a - b for a, b in zip(after, before)) == (leaves, k2, want_sa, 0), q

        def rows(r):
            return {tuple(sorted(l.items())): v for g in r.grids
                    for l, v in zip(g.labels, g.values_np())}

        got, want = rows(res), rows(cpu.query_range(q, start, end, 60))
        assert sorted(got) == sorted(want) and want, q
        for k, w in want.items():
            np.testing.assert_array_equal(np.isnan(got[k]), np.isnan(w))
            mm = ~np.isnan(w)
            np.testing.assert_allclose(got[k][mm], w[mm], rtol=1e-3, atol=1e-6)


# ---- the fused epilogues (B9): store modes and order statistics ----

def assert_store(got, want, what, exact=False):
    """A store-mode grid against its plain version: NaN masks equal, values
    within rtol 2e-4 / atol 1e-4 (``exact``: bit-equal)."""
    g, w = got.cpu().numpy(), want.cpu().numpy()
    assert g.shape == w.shape, what
    differ = np.argwhere(np.isnan(g) != np.isnan(w))
    assert not len(differ), (what, [(tuple(i), g[tuple(i)], w[tuple(i)]) for i in differ[:10]])
    m = ~np.isnan(w)
    assert m.any(), what
    if exact:
        np.testing.assert_array_equal(g[m], w[m], err_msg=what)
    else:
        np.testing.assert_allclose(g[m], w[m], rtol=2e-4, atol=1e-4, err_msg=what)


def store_pair(series_fn, plain_fn, func, b, params, counter, is_delta=False, launches=None):
    """One store-mode launch of a rung and its plain grid: padded rows (the
    trash group) and steps past num_steps NaN in both."""
    gids = AGG.zero_gids(b)
    mod, attr = launches
    before = getattr(mod, attr)
    got = series_fn(func, b, gids, 1, params, is_counter=counter, is_delta=is_delta)
    assert getattr(mod, attr) == before + 1
    sj = plain_fn(func, b, params, counter, is_delta)
    want = GA.series_grid(sj, gids, 1, params.num_steps)
    torch.cuda.synchronize()
    assert got.shape == (pad_steps(params.num_steps), b.ts.shape[0])
    return got, want


def regular_series_plain(func, b, params, counter, is_delta):
    wm = MK.window_matrices(b, params.start_ms - BASE, params.step_ms,
                            pad_steps(params.num_steps), params.window_ms)
    raw = b.raw if b.raw is not None else b.vals
    return MK.mxu_range_plain(func, b.vals, raw, wm, params.window_ms, is_counter=counter,
                              is_delta=is_delta)


def window_series_plain(func, b, params, counter, is_delta):
    return WS.window_range_series_plain(func, b, params, is_counter=counter, is_delta=is_delta)


def general_series_plain(func, b, params, counter, is_delta):
    return GR.general_range_series_plain(func, b, params, is_counter=counter, is_delta=is_delta)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gauge", "corrected", "diff"])
@pytest.mark.parametrize("func", sorted(MK.FUSED_MXU_FUNCS))
def test_regular_store_matches_plain_on_card(card, func, kind):
    """The regular kernel's store variant: every row's value, bit-equal to
    the plain version (no sum across rows to reorder)."""
    mode = {"gauge": {}, "corrected": {"counter_corrected": True},
            "diff": {"diff_encode": True}}[kind]
    counter = kind != "gauge"
    b = regular_block(counter, mode).to_device(card)
    got, want = store_pair(MK.regular_range_series, regular_series_plain, func, b,
                           RangeParams(BASE + 400_000, 60_000, 40, 300_000), counter,
                           launches=(MK, "LAUNCHES"))
    assert MK.LAST_PLAN.partials == "store"
    assert_store(got, want, f"{func} {kind}", exact=True)


@pytest.mark.cuda
@pytest.mark.parametrize("counter", [False, True], ids=["gauge", "counter"])
@pytest.mark.parametrize("func", sorted(WS.PALLAS_FUNCS))
def test_window_store_matches_plain_on_card(card, func, counter):
    """The fused window-stats kernel's store variant, staged rows, on a
    grid from before the first sample to past the last."""
    b = block(counter).to_device(card)
    got, want = store_pair(WS.window_range_series, window_series_plain, func, b,
                           RangeParams(BASE - 200_000, 60_000, 70, 300_000), counter,
                           launches=(WS, "RANGE_LAUNCHES"))
    assert WS.LAST_PLAN.partials == "store" and WS.LAST_PLAN.staged
    assert_store(got, want, func)


@pytest.mark.cuda
@pytest.mark.parametrize("func", ["rate", "sum_over_time", "count_over_time"])
def test_window_store_rows_read_in_place_on_card(card, func):
    b = array_block(9, 32_768, 4, True, card)
    params = RangeParams(BASE + 400_000, 600_000, 30, 3_600_000)
    got, want = store_pair(WS.window_range_series, window_series_plain, func, b, params, True,
                           launches=(WS, "RANGE_LAUNCHES"))
    assert not WS.LAST_PLAN.staged
    assert_store(got, want, func)


@pytest.mark.cuda
@pytest.mark.parametrize("staging, grid", [(s, "irregular") for s in sorted(GENERAL_STAGINGS)]
                         + [(s, "regular") for s in ("gauge", "diff", "shifted", "corrected")])
@pytest.mark.parametrize("func", sorted(GR.GENERAL_FUNCS))
def test_general_store_matches_plain_on_card(card, func, staging, grid):
    """The general kernel's store variant, on irregular rows and on one
    10 s grid (the shared bounds table); changes/resets bit-equal."""
    make = general_block if grid == "irregular" else regular_general_block
    hb, counter, is_delta = make(staging)
    b = hb.to_device(card)
    got, want = store_pair(GR.general_range_series, general_series_plain, func, b,
                           RangeParams(BASE - 200_000, 60_000, 70, 300_000), counter, is_delta,
                           launches=(GR, "LAUNCHES"))
    assert GR.LAST_PLAN.partials == "store" and GR.LAST_PLAN.smem_bytes == GR.general_smem_bytes(
        1, GR.LAST_PLAN.steps, GR.LAST_PLAN.warps, b.ts.shape[1], GR.LAST_PLAN.n_arrays, False,
        grid == "regular", True)
    assert_store(got, want, f"{func} {staging} {grid}", exact=func in ("changes", "resets"))


def order_grid(kind: str, J: int, S: int, n_real: int, seed: int, device):
    """A seeded [J, S] store-mode grid (rows past n_real NaN): normal
    values, small integers (exact ties), or with NaN columns, +-inf and
    signed zeros."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        v = rng.integers(0, 5, (J, S)).astype(np.float32)
    else:
        v = (50 + 20 * rng.standard_normal((J, S))).astype(np.float32)
    if kind == "special":
        for x, p in ((np.nan, 0.2), (np.inf, 0.05), (-np.inf, 0.05), (0.0, 0.05), (-0.0, 0.05)):
            v[rng.random((J, S)) < p] = x
        v[1] = np.nan  # an all-NaN step
    v[:, n_real:] = np.nan
    return torch.from_numpy(v).to(device)


def assert_topk_sets(got, want, what):
    """Per step the same winners (indices) with bit-equal values; the order
    inside the k slots is free."""
    (gv, gi), (wv, wi) = (tuple(t.cpu().numpy() for t in x) for x in (got, want))
    assert gv.shape == wv.shape and gi.shape == wi.shape, what
    go, wo = np.argsort(gi, axis=0), np.argsort(wi, axis=0)
    np.testing.assert_array_equal(np.take_along_axis(gi, go, 0), np.take_along_axis(wi, wo, 0),
                                  err_msg=what)
    np.testing.assert_array_equal(np.take_along_axis(gv, go, 0).view(np.int32),
                                  np.take_along_axis(wv, wo, 0).view(np.int32), err_msg=what)


@pytest.mark.cuda
@pytest.mark.parametrize("n_real", [None, 900], ids=["all_rows", "real_rows"])
@pytest.mark.parametrize("bottom", [False, True], ids=["topk", "bottomk"])
@pytest.mark.parametrize("k", [1, 5, 100, 999, 1000])
@pytest.mark.parametrize("kind", ["normal", "ties", "special"])
def test_topk_kernel_matches_plain_on_card(card, kind, k, bottom, n_real):
    """filodb_topk_steps against topk_steps_plain, k up to S (1000 rows,
    900 real), the kernel reading every row or only the real ones (k past
    900 fills the rest with the padded rows): the same winner sets,
    bit-equal values."""
    from filodb_tpu_torch.ops import order_stats as OS

    grid = order_grid(kind, 16, 1000, 900, seed=k, device=card)
    before = OS.LAUNCHES
    got = OS.topk_steps(grid, k, bottom, n_real=n_real)
    assert OS.LAUNCHES == before + 1 and OS.LAST_PLAN.kernel == "topk_steps"
    want = OS.topk_steps_plain(grid, k, bottom)
    torch.cuda.synchronize()
    assert_topk_sets(got, want, f"{kind} k={k}")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 10, 1000])
def test_topk_kernel_full_column_on_card(card, k):
    """A column of 131,072 rows (100,000 real), the main path's width."""
    from filodb_tpu_torch.ops import order_stats as OS

    grid = order_grid("normal", 8, 131_072, 100_000, seed=k, device=card)
    assert_topk_sets(OS.topk_steps(grid, k, n_real=100_000), OS.topk_steps_plain(grid, k),
                     f"k={k}")


def assert_quantiles(got, want, what):
    """Selected order statistics bit-equal; interpolated ones within 2 ulp
    (the kernel is built with -fmad=false, so they should be equal too)."""
    g, w = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=what)
    m = np.isfinite(w)
    np.testing.assert_array_max_ulp(g[m], w[m], maxulp=2)
    np.testing.assert_array_equal(g[~m & ~np.isnan(w)], w[~m & ~np.isnan(w)], err_msg=what)


@pytest.mark.cuda
@pytest.mark.parametrize("q", [-0.5, 0.0, 0.25, 0.5, 0.99, 1.0, 1.5])
@pytest.mark.parametrize("G", [1, 8, 100, 700, 900])
@pytest.mark.parametrize("kind", ["normal", "ties", "special"])
def test_segment_quantile_kernel_matches_plain_on_card(card, kind, G, q):
    """filodb_segment_quantile against segment_quantile_plain on 900 real
    rows of 1000: one group, 8 (large: a block each), 100 (of 9 members:
    one thread each), 700 (mixed sizes, some empty) and 900 (of one)."""
    from filodb_tpu_torch.ops import order_stats as OS

    grid = order_grid(kind, 12, 1000, 900, seed=G, device=card)
    gids = np.full(1000, G, np.int64)
    rng = np.random.default_rng(G)
    gids[:900] = (np.arange(900) % G if G != 700 else
                  np.minimum(rng.zipf(1.5, 900), 700) - 1)
    members = OS.segment_members(torch.from_numpy(gids).to(card), G)
    before = OS.LAUNCHES
    got = OS.segment_quantile(grid, members, q)
    assert OS.LAUNCHES == before + 1 and OS.LAST_PLAN.kernel == "segment_quantile"
    want = OS.segment_quantile_plain(grid, members, q)
    torch.cuda.synchronize()
    assert_quantiles(got, want, f"{kind} G={G} q={q}")


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 8, 100_000])
def test_segment_quantile_kernel_full_width_on_card(card, G):
    """100,000 real rows of 131,072: one group, 8 of 12,500 and 100,000
    groups of one series (quantile by (instance))."""
    from filodb_tpu_torch.ops import order_stats as OS

    grid = order_grid("normal", 8, 131_072, 100_000, seed=G, device=card)
    gids = torch.full((131_072,), G, dtype=torch.int64, device=card)
    gids[:100_000] = torch.arange(100_000, device=card) % G
    members = OS.segment_members(gids, G)
    got = OS.segment_quantile(grid, members, 0.9)
    assert OS.LAST_PLAN.block_segments == (G if G < 100_000 else 0)
    assert_quantiles(got, OS.segment_quantile_plain(grid, members, 0.9), f"G={G}")


@pytest.mark.cuda
@pytest.mark.parametrize("query", ["topk", "bottomk", "quantile"])
@pytest.mark.parametrize("rung", ["mxu", "window_stats", "general"])
def test_epilogue_query_launches_twice_on_card(card, rung, query):
    """A fused epilogue is the rung in its store mode, then one
    order-statistics launch over the real steps, and no other kernel of
    the port; the result equals the plain order statistic of the store
    grid."""
    from filodb_tpu_torch.ops import order_stats as OS

    if rung == "mxu":
        b, func = regular_block(True, {"counter_corrected": True}, n_series=200).to_device(card), "rate"
    else:
        b, func = block(True, n_series=200).to_device(card), "rate" if rung == "window_stats" else "irate"
    counters = ((WS, "LAUNCHES"), (WS, "RANGE_LAUNCHES"), (MK, "LAUNCHES"), (GR, "LAUNCHES"),
                (OS, "LAUNCHES"))
    before = [getattr(m, a) for m, a in counters]
    obs = {}
    if query == "quantile":
        members = OS.segment_members(spread_groups(b, 8, card), 8)
        out = AGG.fused_quantile(func, b, members, 0.9, params_for(), is_counter=True, obs=obs)
        assert out.shape == (8, 60)
    else:
        vals, idx = AGG.fused_topk(func, b, 5, query == "bottomk", params_for(), is_counter=True,
                                   obs=obs)
        assert vals.shape == idx.shape == (5, 60)
    torch.cuda.synchronize()
    assert obs == {"variant": rung}
    rung_counter = {"mxu": 2, "window_stats": 1, "general": 3}[rung]
    after = [getattr(m, a) for m, a in counters]
    assert [a - b for a, b in zip(after, before)] == [
        int(i == rung_counter) + int(i == 4) for i in range(5)]
    grid = AGG.fused_range_series(func, b, params_for(), is_counter=True)[:60]
    if query == "quantile":
        assert_quantiles(out, OS.segment_quantile_plain(grid, members, 0.9), rung)
    else:
        assert_topk_sets((vals, idx), OS.topk_steps_plain(grid, 5, query == "bottomk"), rung)


@pytest.mark.cuda
@pytest.mark.parametrize("rung", ["window_staged", "window_in_place", "regular", "general"])
def test_store_writes_only_its_grid_on_card(card, rung):
    """13 rows (a partial last tile for every rows-per-tile choice): the
    store launch writes exactly the [J, S] part of its grid -- a sentinel
    in the padded steps survives -- and that part equals the plain grid.
    (nvcc 12.8 compiled the window kernel's store variants so that a
    partial last tile ran all its R rows, writing rows past S into the next
    step's row.)"""
    from filodb_tpu_torch.ops.staging import block_from_arrays

    S, n = 13, 300
    rng = np.random.default_rng(21)
    ts = np.full((S, 512 if rung != "window_in_place" else 32_768), TS_PAD, np.int32)
    if rung == "regular":
        ts[:, :n] = 5_000 + np.arange(n) * 10_000
    else:
        ts[:, :n] = np.cumsum(rng.integers(5_000, 15_001, (S, n)), axis=1)
    vals = np.zeros(ts.shape, np.float32)
    vals[:, :n] = np.cumsum(rng.uniform(0, 10, (S, n)), axis=1)
    b = block_from_arrays(ts, vals, np.full(S, n, np.int32), BASE, np.zeros(S, np.float32),
                          S, device=card)
    func = {"general": "irate", "regular": "rate"}.get(rung, "rate")
    params = RangeParams(BASE + 400_000, 60_000, 37, 300_000)
    gids = AGG.zero_gids(b)
    j_pad = pad_steps(37)
    out = torch.full((j_pad, S), 12345.0, device=card)
    if rung == "regular":
        wm = MK.window_matrices(b, 400_000, 60_000, j_pad, 300_000)
        MK._launch(func, GA.STORE, b.vals, b.vals, gids, 1, wm, 37, False, False, out, out)
        plain = regular_series_plain
    elif rung == "general":
        GR._launch(func, GA.STORE, b, gids, 1, params, False, False, out, out)
        plain = general_series_plain
    else:
        WS._launch_range(func, GA.STORE, b, gids, 1, params, False, False, out, out)
        assert WS.LAST_PLAN.staged == (rung == "window_staged")
        assert S % WS.LAST_PLAN.rows
        plain = window_series_plain
    torch.cuda.synchronize()
    assert bool((out[37:] == 12345.0).all()), rung
    want = GA.series_grid(plain(func, b, params, False, False), gids, 1, 37)
    assert_store(out[:37], want[:37], rung)


# -- the order-statistics kernels' routes: staged in one block or a cluster, streaming --

# column and segment sizes at the routes' edges: 1, SMALL_SEGMENT and one past
# it, one block's SLICE_TARGET +-1, the cluster's staging limit
# (MAX_CLUSTER x MAX_SLICE) +-1, and the main path's 100,000
ROUTE_SIZES = (1, 16, 17, 16_383, 16_384, 16_385, 100_000, 393_215, 393_216, 393_217)


def route_column(J: int, n: int, seed: int, device, kind: str = "normal"):
    """A [J, n + 3] grid of seeded values (``order_grid``'s kinds) with
    three padded NaN rows."""
    return order_grid(kind, J, n + 3, n, seed=seed, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("bottom", [False, True], ids=["topk", "bottomk"])
@pytest.mark.parametrize("n", ROUTE_SIZES)
def test_topk_routes_match_plain_on_card(card, n, bottom):
    """Each side of each route threshold: the plan's route and cluster, and
    the winner sets bit-equal to topk_steps_plain's at k = 1, 5 and 1000."""
    from filodb_tpu_torch.ops import order_stats as OS

    grid = route_column(3, n, n, card, "ties")
    want_plan = OS.order_plan("topk_steps", n, 3)
    assert want_plan.route == ("stream" if n > 393_216 else "staged")
    assert want_plan.cluster == min(8, 1 << (-(-n // 16_384) - 1).bit_length())
    for k in (1, 5, 1000):
        got = OS.topk_steps(grid, k, bottom, n_real=n)
        assert OS.LAST_PLAN == want_plan
        assert_topk_sets(got, OS.topk_steps_plain(grid, k, bottom), f"n={n} k={k}")


@pytest.mark.cuda
@pytest.mark.parametrize("q", [0.0, 0.5, 0.99, 1.0, float("nan"), -1.0, 2.0])
@pytest.mark.parametrize("n", ROUTE_SIZES)
def test_segment_quantile_routes_match_plain_on_card(card, n, q):
    """One group of n members spread over every 3rd row beside 40 groups of
    one or two (a launch of both paths): the plan's route for the large
    group and the quantiles against segment_quantile_plain (q outside [0,
    1] clipped, a NaN q gives NaN)."""
    from filodb_tpu_torch.ops import order_stats as OS

    S = 3 * n + 80
    grid = route_column(2, S - 3, n + 1, card, "special")
    gids = torch.full((S,), 41, dtype=torch.int64, device=card)
    gids[0 : 3 * n : 3] = 0
    gids[3 * n : 3 * n + 77] = 1 + torch.arange(77, device=card) % 40
    members = OS.segment_members(gids, 41)
    got = OS.segment_quantile(grid, members, q)
    plan = OS.LAST_PLAN
    assert (plan.block_segments, plan.thread_segments) == ((1, 40) if n > 16 else (0, 41))
    assert plan.route == ("thread" if n <= 16 else "stream" if n > 393_216 else "staged")
    assert_quantiles(got, OS.segment_quantile_plain(grid, members, q), f"n={n} q={q}")


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 4])
@pytest.mark.parametrize("n", ROUTE_SIZES)
def test_segment_quantile_member_runs_match_plain_on_card(card, n, offset):
    """A group whose members are n consecutive series from row ``offset``
    (a bulk copy where its slices start 16-byte aligned: offset 0 and 4;
    key by key through perm at offset 1) beside groups of one: the same
    quantiles as segment_quantile_plain."""
    from filodb_tpu_torch.ops import order_stats as OS

    S = n + offset + 24
    grid = route_column(3, S - 3, n + offset, card, "special")
    gids = torch.full((S,), 22, dtype=torch.int64, device=card)
    gids[offset:offset + n] = 0
    gids[:offset] = 1 + torch.arange(offset, device=card)
    gids[offset + n:offset + n + 20] = 1 + offset + torch.arange(20, device=card) % (21 - offset)
    members = OS.segment_members(gids, 22)
    for q in (0.0, 0.5, 0.99):
        got = OS.segment_quantile(grid, members, q)
        assert_quantiles(got, OS.segment_quantile_plain(grid, members, q), f"n={n} q={q}")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 5, 1000, 12_500, 12_501, 20_000, 100_000])
def test_topk_equal_column_takes_ties_in_index_order_on_card(card, k):
    """100,000 equal keys per step (and NaN rows past them): the winners are
    the first k series, across the cluster's slices (12,500 keys a block)."""
    from filodb_tpu_torch.ops import order_stats as OS

    grid = torch.full((4, 100_003), 7.0, device=card)
    grid[:, 100_000:] = float("nan")
    for bottom in (False, True):
        vals, idx = OS.topk_steps(grid, k, bottom, n_real=100_000)
        assert OS.LAST_PLAN.cluster == 8
        assert_topk_sets((vals, idx), OS.topk_steps_plain(grid, k, bottom), f"k={k}")
        assert sorted(idx[:, 0].tolist()) == list(range(k))


@pytest.mark.cuda
@pytest.mark.parametrize("threads", [32, 256, 512, 1024])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_order_layouts_match_plain_on_card(card, cluster, threads):
    """Every cluster size and block size the C entries take, on the same
    100,000-series column (clusters of 1 and 2 stream it: their slices pass
    MAX_SLICE) and on groups by zone: the same answers."""
    from filodb_tpu_torch.ops import order_stats as OS

    n = 100_000
    grid = route_column(3, n, 5, card, "ties")
    plan = OS.order_plan("topk_steps", n, 3, cluster=cluster, threads=threads)
    assert plan.route == ("stream" if cluster <= 2 else "staged")
    for k in (5, 1000):
        got = OS.topk_steps(grid, k, n_real=n, plan=plan)
        assert_topk_sets(got, OS.topk_steps_plain(grid, k), f"C={cluster} k={k}")
    gids = torch.full((n + 3,), 8, dtype=torch.int64, device=card)
    gids[:n] = torch.arange(n, device=card) % 8
    members = OS.segment_members(gids, 8)
    qplan = OS.order_plan("segment_quantile", members, 3, cluster=cluster, threads=threads)
    got = OS.segment_quantile(grid, members, 0.5, plan=qplan)
    assert_quantiles(got, OS.segment_quantile_plain(grid, members, 0.5), f"C={cluster}")


@pytest.mark.cuda
def test_order_entries_refuse_a_plan_they_do_not_share(card):
    """The C entries count the shared bytes themselves and refuse another
    count, and refuse more than MAX_CLUSTER blocks per cluster."""
    import dataclasses

    from filodb_tpu_torch.ops import order_stats as OS

    grid = route_column(2, 1000, 1, card)
    plan = OS.order_plan("topk_steps", 1000, 2)
    for bad in (dataclasses.replace(plan, smem_bytes=plan.smem_bytes + 4),
                dataclasses.replace(plan, cluster=16)):
        with pytest.raises(RuntimeError, match="launch failed"):
            OS.topk_steps(grid, 5, n_real=1000, plan=bad)


# -- the reference tree's kernels: sorted windows (B8), predict_linear and
# Holt-Winters on the general kernel (B4), the standalone quantile (B7) --

def _chip_smoke():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SORTED_CASES = [  # (kind, n_real, T, window ms)
    ("irregular", 65, 128, 300_000), ("irregular", 65, 128, 8_000), ("regular", 65, 768, 300_000),
    ("long", 65, 768, 3_600_000), ("long", 9, 8_192, 3_600_000),
]


@pytest.mark.cuda
@pytest.mark.parametrize("counter", [False, True], ids=["gauge", "counter"])
@pytest.mark.parametrize("case", SORTED_CASES, ids=lambda c: f"{c[0]}-T{c[2]}-w{c[3]}")
@pytest.mark.parametrize("func, args", [
    ("quantile_over_time", (-0.1,)), ("quantile_over_time", (0.5,)),
    ("quantile_over_time", (0.9,)), ("quantile_over_time", (1.1,)),
    ("median_absolute_deviation_over_time", ()), ("last_over_time_is_mad_outlier", (2.0, 1.0)),
])
def test_sorted_window_matches_plain_on_card(card, func, args, case, counter):
    """The sorted-window kernel against its plain version: order
    statistics bit-equal, interpolations within 2 ulp, NaN masks and
    infinities equal; one launch; the long rows' 1 h windows of up to 720
    samples take the warp's radix route, and rows 8192 wide are read in
    place."""
    from filodb_tpu_torch.ops import sorted_window as SW

    cs = _chip_smoke()
    kind, n_real, T, window = case
    b = cs.window_block(n_real, T, kind, counter, 3, card)
    params = RangeParams(BASE - 60_000, 30_000, 150 if kind != "long" else 120, window)
    before = SW.LAUNCHES
    got = SW.sorted_window(func, b, params, args)
    assert SW.LAUNCHES == before + 1
    assert SW.LAST_PLAN == SW.sorted_plan(T) and SW.LAST_PLAN.staged == (T < 8_192)
    q, a1 = SW.func_args(args)
    want = SW.sorted_window_plain(func, b.ts, b.vals, b.lens, int(params.start_ms - BASE),
                                  params.step_ms, window, params.num_steps, q, a1)
    want[n_real:] = float("nan")
    J = params.num_steps
    assert bool(torch.isnan(got[:, J:]).all())
    assert cs.ulp_gap(got[:, :J], want) <= 2, (func, args, case)
    if kind == "long":
        lens = b.lens.cpu().numpy()
        assert lens.max() > SW.LANE_CAP  # windows past the lane cap: the radix select ran


@pytest.mark.cuda
@pytest.mark.parametrize("counter", [False, True], ids=["gauge", "counter"])
@pytest.mark.parametrize("kind", ["irregular", "regular"])
@pytest.mark.parametrize("func, args", [("predict_linear", (600.0,)), ("predict_linear", (-30.0,)),
                                        ("double_exponential_smoothing", (0.3, 0.1)),
                                        ("double_exponential_smoothing", (0.9, 0.5))])
def test_general_argument_functions_match_plain_on_card(card, func, args, kind, counter):
    """predict_linear and Holt-Winters, the general kernel's store mode with
    its arguments, against range_kernel_plain: rtol 2e-4 / atol 1e-4, NaN
    masks equal."""
    cs = _chip_smoke()
    b = cs.window_block(65, 384, kind, counter, 5, card)
    params = RangeParams(BASE - 60_000, 30_000, 150, 300_000)
    gids = AGG.zero_gids(b)
    before = GR.LAUNCHES
    got = GR.general_range_series(func, b, gids, 1, params, args=args)
    assert GR.LAUNCHES == before + 1
    want = GA.series_grid(GR.general_range_series_plain(func, b, params, args=args), gids, 1,
                          params.num_steps)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(got), torch.isnan(want)), func
    m = ~torch.isnan(want)
    assert torch.allclose(got[m], want[m], rtol=2e-4, atol=1e-4), func


@pytest.mark.cuda
@pytest.mark.parametrize("q", [-0.1, 0.0, 0.25, 0.9, 0.99, 1.0, 1.1])
def test_hist_quantile_gather_matches_plain_on_card(card, q):
    """The standalone quantile over gathered classic rows (two bucket
    schemes, groups with no member at some steps, a first bound <= 0)
    against histogram_quantile_gather_plain, bit-equal (NaN masks too)."""
    from filodb_tpu_torch.ops import hist_kernels as HK

    rng = np.random.default_rng(9)
    G, J = 40, 111
    schemes = [np.array([0.1, 0.5, 1, 5, np.inf], np.float32),
               np.array([-1, 0, 2.5, 10, 50, 100, np.inf], np.float32)]
    rows, tables, row_of = [], [], []
    for g in range(G):
        les = schemes[g % 2]
        c = np.cumsum(rng.poisson(3.0, (len(les), J)), axis=0).astype(np.float32)
        c[:, rng.random(J) < 0.1] = np.nan
        tables.append(np.arange(len(rows), len(rows) + len(les)))
        rows.extend(c)
        row_of.append(g)
    part = torch.tensor(np.stack(rows), device=card)
    out = torch.full((G, 128), float("nan"), device=card)
    want = torch.full_like(out, float("nan"))
    before = HK.QUANTILE_LAUNCHES
    for s, les in enumerate(schemes):
        gs = [g for g in range(G) if g % 2 == s]
        table = torch.tensor(np.stack([tables[g] for g in gs]).astype(np.int32), device=card)
        rws = torch.tensor(np.array(gs, np.int32), device=card)
        les_t = torch.tensor(les, device=card)
        HK.histogram_quantile_gather(q, part, table, rws, les_t, J, out)
        want[rws.long(), :J] = HK.histogram_quantile_gather_plain(q, part, table, les_t, J)
    assert HK.QUANTILE_LAUNCHES == before + 2
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(out), torch.isnan(want))
    m = ~torch.isnan(want)
    assert torch.equal(out[m], want[m])


@pytest.mark.cuda
@pytest.mark.parametrize("G, B", [(g, b) for g in (1, 8, 1000, 3000) for b in (1, 2, 12, 33, 64)])
def test_hist_quantile_gather_phase2d_cases_on_card(card, G, B):
    """chip_smoke.py phase 2d's gather cases (groups with no member, table
    entries < 0, a first bound <= 0) against
    histogram_quantile_gather_plain: bit-equal at every q, one launch a
    call, and no out row written but the group rows (a sentinel elsewhere,
    and past the query's steps, survives)."""
    from filodb_tpu_torch.ops import hist_kernels as HK

    part, table, rows, les, n_out = _chip_smoke().gather_inputs(G, B, 111, G + B, card)
    HK.check_gather_table(table, rows, les)
    for q in (-0.1, 0.0, 0.5, 0.99, 1.0, 1.1):
        out = torch.full((n_out, 128), 7.5, device=card)
        before = HK.QUANTILE_LAUNCHES
        HK.histogram_quantile_gather(q, part, table, rows, les, 111, out)
        assert HK.QUANTILE_LAUNCHES == before + 1
        want = torch.full_like(out, 7.5)
        want[rows.long(), :111] = HK.histogram_quantile_gather_plain(q, part, table, les, 111)
        torch.cuda.synchronize()
        assert torch.equal(torch.isnan(out), torch.isnan(want)), q
        m = ~torch.isnan(want)
        assert torch.equal(out[m], want[m]), q


@pytest.mark.cuda
@pytest.mark.parametrize("query, counter", [
    ("quantile_over_time(0.9, m[5m])", ("sorted_window", "LAUNCHES")),
    ("predict_linear(m[5m], 600)", ("general_range", "LAUNCHES")),
    ("rate(m[5m])", ("window_stats", "RANGE_LAUNCHES")),
])
def test_tree_query_launches_once_per_leaf_on_card(card, query, counter):
    """An unaggregated query on the card: one launch of its rung per shard
    leaf; the warm repeat hits every leaf's staging-cache entry and reads
    the same device copies (none made again: a "cuda" query device against
    copies on "cuda:0"); its rows equal the CPU engine's on the same store
    (rtol 1e-3, NaN masks equal)."""
    import importlib

    from filodb_tpu_torch.coordinator.planner import QueryEngine
    from filodb_tpu_torch.core.records import SeriesBatch
    from filodb_tpu_torch.core.schemas import METRIC_TAG, PROM_COUNTER, Dataset, shard_for
    from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore

    rng = np.random.default_rng(4)
    ms = TimeSeriesMemStore()
    ms.setup(Dataset("prometheus"), range(4))
    for i in range(64):
        tags = {METRIC_TAG: "m", "_ws_": "w", "_ns_": "n", "instance": f"h{i}"}
        ts = BASE + np.cumsum(rng.integers(5_000, 15_001, 200)).astype(np.int64)
        ms.shard("prometheus", shard_for(tags, spread=2, num_shards=4)).ingest_series(
            SeriesBatch(PROM_COUNTER, tags, ts, {"count": np.cumsum(rng.uniform(0, 9, 200))}))
    mod = importlib.import_module(f"filodb_tpu_torch.ops.{counter[0]}")
    eng = QueryEngine(ms, "prometheus")
    start, end = (BASE + 400_000) / 1000, (BASE + 1_400_000) / 1000
    setattr(mod, counter[1], 0)
    cold = eng.query_range(query, start, end, 60)
    leaves = len(cold.grids)
    assert getattr(mod, counter[1]) == leaves > 1

    def copies():
        return {(s, k): id(e.dev_block) for s in range(4)
                for k, e in ms.shard("prometheus", s).stage_cache.items()}

    before = copies()
    warm = eng.query_range(query, start, end, 60)
    assert getattr(mod, counter[1]) == 2 * leaves
    assert warm.stats.cache_hits == leaves and warm.stats.bytes_staged == 0
    assert copies() == before
    want = QueryEngine(ms, "prometheus", device="cpu").query_range(query, start, end, 60)
    for g, w in zip(warm.grids, want.grids):
        assert g.labels == w.labels
        gv, wv = g.values_np(), w.values_np()
        np.testing.assert_array_equal(np.isnan(gv), np.isnan(wv))
        np.testing.assert_allclose(gv[~np.isnan(wv)], wv[~np.isnan(wv)], rtol=1e-3)


# -- the reference tree's aggregate part: the segment aggregate (K1) and the
# grouped top-k (K2) ------------------------------------------------------------------------


def tree_grid(kind: str, S: int, J: int, seed: int, device, store: bool = True):
    """[S, J] values on the card, rate-like to three decimals (ties), with
    2 % NaN; ``special`` adds +-inf and signed zeros. ``store``: the
    transposed view of a step-major [J + 3, S + 5] grid, as a tree leaf
    holds it; else a row-major tensor."""
    rng = np.random.default_rng(seed)
    v = np.round(rng.gamma(2.0, 0.3, (S, J)), 3).astype(np.float32)
    if kind == "special":
        for x, p in ((np.inf, 0.01), (-np.inf, 0.01), (0.0, 0.03), (-0.0, 0.03)):
            v[rng.random((S, J)) < p] = x
    v[rng.random((S, J)) < 0.02] = np.nan
    if not store:
        return torch.from_numpy(v).to(device)
    big = np.full((J + 3, S + 5), np.nan, np.float32)
    big[:J, :S] = v.T
    return torch.from_numpy(big).to(device).T[:S, :J]


def tree_gids(groups: str, S: int, seed: int):
    rng = np.random.default_rng(seed)
    return {"one": np.zeros(S, np.int64), "eight": np.arange(S) % 8, "each": np.arange(S),
            "sparse": rng.integers(0, 3000, S), "skewed": np.minimum(
                rng.geometric(0.002, S) - 1, 999)}[groups]


@pytest.mark.cuda
@pytest.mark.parametrize("store", [True, False], ids=["step_major", "row_major"])
@pytest.mark.parametrize("groups", ["one", "eight", "each", "sparse"])
@pytest.mark.parametrize("kind", ["normal", "special"])
def test_segment_aggregate_kernel_matches_plain_on_card(card, kind, groups, store):
    """filodb_segment_aggregate against segment_aggregate per component on
    9000 series x 111 steps: one group and 8 (shared-memory partials), a
    group each and 3000 sparse groups (global atomics); count, min, max and
    group bit-equal, sum and sumsq within rtol 1e-4 (another order)."""
    from filodb_tpu_torch.ops import segment_agg as SA

    S, J = 9000, 111
    v = tree_grid(kind, S, J, seed=len(groups), device=card, store=store)
    gids = torch.from_numpy(tree_gids(groups, S, 3)).to(card)
    G = int(gids.max()) + 1
    before, transposes = SA.LAUNCHES, SA.TRANSPOSES
    got = SA.segment_components(v, gids, G, SA.COMPONENTS)
    assert SA.LAUNCHES == before + 1 and SA.TRANSPOSES == transposes + (not store)
    want = SA.segment_components(v.cpu(), gids.cpu(), G, SA.COMPONENTS)
    torch.cuda.synchronize()
    for c in SA.COMPONENTS:
        g, w = got[c].cpu(), want[c]
        assert torch.equal(torch.isnan(g), torch.isnan(w)), c
        m = ~torch.isnan(w)
        if c in ("sum", "sumsq"):
            torch.testing.assert_close(g[m], w[m], rtol=1e-4, atol=1e-5)
        else:
            assert torch.equal(g[m].view(torch.int32), w[m].view(torch.int32)), c


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["plan", "group"])
@pytest.mark.parametrize("bottom", [False, True], ids=["topk", "bottomk"])
@pytest.mark.parametrize("k", [1, 3, 16, 32, 33, 1000])
@pytest.mark.parametrize("groups", ["one", "eight", "each", "skewed"])
@pytest.mark.parametrize("kind", ["normal", "special"])
def test_segment_topk_kernel_matches_plain_on_card(card, kind, groups, k, bottom, route):
    """filodb_segment_topk against segment_topk_plain on 20,000 series x
    111 steps read in place from a step-major grid: one group and 8, a
    group each and skewed sizes; as the plan routes it (the step route,
    every group of a step in one block with a thread or a warp a group,
    for k <= STEP_MAX_K; the per-group route past it) and on the
    per-group route (a cluster per (large group, step), a thread per
    small one): kept values and thresholds bit-equal."""
    from filodb_tpu_torch.ops import order_stats as OS
    from filodb_tpu_torch.ops import segment_agg as SA

    S, J = 20_000, 111
    v = tree_grid(kind, S, J, seed=k, device=card)
    gids = tree_gids(groups, S, 5)
    G = int(gids.max()) + 1
    members = OS.segment_members(torch.from_numpy(gids).to(card), G)
    grid = SA.step_major(v)
    before = OS.LAUNCHES
    plan = OS.order_plan("segment_topk", members, J, by_step=False) if route == "group" else None
    out, thr = OS.segment_topk(grid, members, k, bottom, plan=plan)
    assert OS.LAUNCHES == before + 1 and OS.LAST_PLAN.kernel == "segment_topk"
    assert (OS.LAST_PLAN.route == "step") == (route == "plan" and k <= OS.STEP_MAX_K)
    cpu_members = OS.segment_members(torch.from_numpy(gids), G)
    want_out, want_thr = OS.segment_topk_plain(grid.cpu(), cpu_members, k, bottom)
    torch.cuda.synchronize()
    for g, w in ((out.cpu(), want_out), (thr.cpu(), want_thr)):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


def topk_edge_grid(S: int, J: int, seed: int, device):
    """[J, S] step-major values whose columns test the tie rule: step 0 all
    equal, step 1 all NaN, step 2 only +0 and -0, step 3 +-inf and NaN, the
    rest values to one decimal (many ties) with NaN, signed zeros and
    infinities mixed in."""
    rng = np.random.default_rng(seed)
    v = np.round(rng.uniform(-2, 2, (J, S)), 1).astype(np.float32)
    for x, p in ((np.nan, 0.05), (0.0, 0.05), (-0.0, 0.05), (np.inf, 0.01), (-np.inf, 0.01)):
        v[rng.random((J, S)) < p] = x
    v[0] = 1.5
    v[1] = np.nan
    v[2] = np.where(rng.random(S) < 0.5, 0.0, -0.0)
    v[3] = rng.choice(np.array([np.inf, -np.inf, np.nan], np.float32), S)
    return torch.from_numpy(v).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("bottom", [False, True], ids=["topk", "bottomk"])
@pytest.mark.parametrize("k", [1, 3, 16, 32, 33, 1000])
@pytest.mark.parametrize("S", [3000, 60_000])
def test_segment_topk_ties_and_mixed_groups_on_card(card, S, k, bottom):
    """Ties, all-tie and all-NaN columns, +-0 and +-inf, groups of 1 to 16
    members beside groups of 17 to 2,000 and one of the rest, on a column
    the step route stages (3,000 series, k <= STEP_MAX_K) and on one past it
    (60,000: the per-group route): bit-equal to plain."""
    from filodb_tpu_torch.ops import order_stats as OS

    J = 9
    grid = topk_edge_grid(S, J, k + S, card)
    rng = np.random.default_rng(S)
    sizes = [int(x) for x in rng.integers(1, 17, 60)] + [17, 18, 33, 64, 500]
    sizes += [2000] if S > 10_000 else []
    sizes.append(S - sum(sizes))
    gids = rng.permutation(np.repeat(np.arange(len(sizes)), sizes))
    members = OS.segment_members(torch.from_numpy(gids).to(card), len(sizes))
    out, thr = OS.segment_topk(grid, members, k, bottom)
    assert OS.LAST_PLAN.route == ("step" if S <= OS.STEP_KEYS and k <= OS.STEP_MAX_K
                                  else "staged")
    cpu_members = OS.segment_members(torch.from_numpy(gids), len(sizes))
    want_out, want_thr = OS.segment_topk_plain(grid.cpu(), cpu_members, k, bottom)
    torch.cuda.synchronize()
    for g, w in ((out.cpu(), want_out), (thr.cpu(), want_thr)):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("query, launches", [  # kernel: (per leaf, at the root)
    ("stddev by (zone) (rate(m[5m]))", {"segment_agg": (1, 0), "order_stats": (0, 0)}),
    ("topk by (zone) (2, rate(m[5m]))", {"segment_agg": (0, 0), "order_stats": (1, 1)}),
    ("quantile by (zone) (0.5, abs(rate(m[5m])))",
     {"segment_agg": (0, 0), "order_stats": (0, 1)}),
])
def test_tree_aggregates_launch_their_kernels_on_card(card, query, launches):
    """A tree aggregate through the engine on the card: K1 once per shard
    leaf (the map phase), K2 once per leaf filter and once at the root, the
    quantile once at the root; the answer equals the CPU engine's (rtol
    1e-3, NaN masks equal)."""
    import importlib

    from filodb_tpu_torch.coordinator.planner import QueryEngine
    from filodb_tpu_torch.core.records import SeriesBatch
    from filodb_tpu_torch.core.schemas import METRIC_TAG, PROM_COUNTER, Dataset, shard_for
    from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore

    rng = np.random.default_rng(6)
    ms = TimeSeriesMemStore()
    ms.setup(Dataset("prometheus"), range(4))
    for i in range(96):
        tags = {METRIC_TAG: "m", "_ws_": "w", "_ns_": "n", "instance": f"h{i}",
                "zone": f"z{i % 3}"}
        ts = BASE + np.cumsum(rng.integers(5_000, 15_001, 200)).astype(np.int64)
        ms.shard("prometheus", shard_for(tags, spread=2, num_shards=4)).ingest_series(
            SeriesBatch(PROM_COUNTER, tags, ts, {"count": np.cumsum(rng.uniform(0, 9, 200))}))
    mods = {n: importlib.import_module(f"filodb_tpu_torch.ops.{n}")
            for n in ("segment_agg", "order_stats")}
    for m in mods.values():
        m.LAUNCHES = 0
    start, end = (BASE + 400_000) / 1000, (BASE + 1_400_000) / 1000
    got = QueryEngine(ms, "prometheus").query_range(query, start, end, 60)
    leaves = sum(1 for s in range(4) if ms.shard("prometheus", s).stage_cache)
    assert {n: m.LAUNCHES for n, m in mods.items()} == {
        n: a * leaves + b for n, (a, b) in launches.items()}
    want = QueryEngine(ms, "prometheus", device="cpu").query_range(query, start, end, 60)
    rows = {tuple(sorted(l.items())): v for g in got.grids for l, v in zip(g.labels,
                                                                             g.values_np())}
    for g in want.grids:
        for l, w in zip(g.labels, g.values_np()):
            v = rows[tuple(sorted(l.items()))]
            np.testing.assert_array_equal(np.isnan(v), np.isnan(w))
            np.testing.assert_allclose(v[~np.isnan(w)], w[~np.isnan(w)], rtol=1e-3)


# ---- B5: the regular kernel's other functions; B6: the jitter and masked rungs ----

B5_FUNCS = sorted(MK.MXU_FUNCS - MK.FUSED_MXU_FUNCS - {"timestamp"})


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gauge", "diff", "shifted"])
@pytest.mark.parametrize("func", B5_FUNCS)
def test_regular_b5_codes_match_plain_on_card(card, func, kind):
    """changes/resets, min/max, deriv, predict_linear and absent_over_time
    on the regular kernel: the store mode bit-equal to the plain version,
    and the aggregate at G = S within rtol 2e-4."""
    mode = {"gauge": {}, "diff": {"diff_encode": True},
            "shifted": {"subtract_baseline": True}}[kind]
    counter = kind != "gauge"
    b = regular_block(counter, mode).to_device(card)
    args = (600.0,) if func == "predict_linear" else ()
    params = RangeParams(BASE + 400_000, 60_000, 40, 300_000)
    gids = AGG.zero_gids(b)
    before = MK.LAUNCHES
    got = MK.regular_range_series(func, b, gids, 1, params, is_counter=counter, args=args)
    assert MK.LAUNCHES == before + 1
    wm = MK.window_matrices(b, params.start_ms - BASE, params.step_ms,
                            pad_steps(params.num_steps), params.window_ms)
    raw = b.raw if b.raw is not None else b.vals
    sj = MK.mxu_range_plain(func, b.vals, raw, wm, params.window_ms, is_counter=counter,
                            args=args)
    want = GA.series_grid(sj, gids, 1, params.num_steps)
    torch.cuda.synchronize()
    if func == "absent_over_time":
        assert torch.equal(torch.isnan(got), torch.isnan(want))
    else:
        assert_store(got, want, f"{func} {kind}", exact=True)
    own = torch.full((b.vals.shape[0],), b.n_series, dtype=torch.int64, device=card)
    own[: b.n_series] = torch.arange(b.n_series, device=card)
    agg = MK.regular_range_aggregate(func, "sum", b, own, b.n_series, params,
                                     is_counter=counter, args=args)
    ref = GA.mask_steps(AGG.apply_epilogue(sj, ("agg", "sum"), own, b.n_series),
                        params.num_steps)
    g, w = agg.cpu().numpy(), ref.cpu().numpy()
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=func)
    np.testing.assert_allclose(g[~np.isnan(w)], w[~np.isnan(w)], rtol=2e-4, atol=1e-4)


def near_regular_block(kind: str, mode: dict, counter: bool, n_series=65, n=300, seed=0):
    """Series on a 10 s grid, each sample moved by up to +-5 % (``jitter``),
    with two missed scrapes a series (``holes``)."""
    rng = np.random.default_rng(seed)
    nominal = BASE + 5_000 + np.arange(n, dtype=np.int64) * 10_000
    series = []
    for i in range(n_series):
        ts = nominal + np.rint(rng.uniform(-0.05, 0.05, n) * 10_000).astype(np.int64)
        vals = (np.cumsum(rng.uniform(0, 10, n)) + 1e3) if counter else 50 + 20 * rng.standard_normal(n)
        if kind == "holes":
            drop = [7 + i % 50, 100 + (3 * i) % 150]
            ts, vals = np.delete(ts, drop), np.delete(vals, drop)
        series.append((ts, vals))
    blk = stage_series(series, BASE, **mode)
    assert ST.grid_class(blk) == kind
    return blk


JITTER_KINDS = {"gauge": {}, "corrected": {"counter_corrected": True},
                "diff": {"diff_encode": True}}


@pytest.mark.cuda
@pytest.mark.parametrize("staging", sorted(JITTER_KINDS))
@pytest.mark.parametrize("kind", ["jitter", "holes"])
@pytest.mark.parametrize("func", sorted(JR.JITTER_FUNCS))
def test_jitter_kernel_matches_plain_on_card(card, func, kind, staging):
    """Both variants of csrc/jitter_range.cu: the store mode bit-equal to
    the plain version, the aggregate at G = S within rtol 2e-4 and at G = 3
    within rtol 1e-3 (atomics reorder a group's sums); one launch each."""
    counter = staging != "gauge"
    b = near_regular_block(kind, JITTER_KINDS[staging], counter).to_device(card)
    masked = kind == "holes"
    params = RangeParams(BASE + 400_000, 60_000, 40, 300_000)
    attr = "MASKED_LAUNCHES" if masked else "JITTER_LAUNCHES"
    series = JR.masked_range_series if masked else JR.jitter_range_series
    got, want = store_pair(series, lambda f, blk, p, c, d: JR._plain(masked, f, blk, (
        JR.masked_window_matrices if masked else JR.jitter_window_matrices)(
            blk, p.start_ms - BASE, p.step_ms, pad_steps(p.num_steps), p.window_ms),
        p, c, d), func, b, params, counter, launches=(JR, attr))
    if func == "absent_over_time":
        assert torch.equal(torch.isnan(got), torch.isnan(want))
    else:
        assert_store(got, want, f"{func} {kind} {staging}", exact=True)
    agg = JR.masked_range_aggregate if masked else JR.jitter_range_aggregate
    for G, rtol in ((b.n_series, 2e-4), (3, 1e-3)):
        gids = torch.full((b.vals.shape[0],), G, dtype=torch.int64, device=card)
        gids[: b.n_series] = torch.arange(b.n_series, device=card) % G
        got = agg(func, "sum", b, gids, G, params, is_counter=counter)
        ref = GA.mask_steps(AGG.apply_epilogue(want.T, ("agg", "sum"), gids, G),
                            params.num_steps)
        g, w = got.cpu().numpy(), ref.cpu().numpy()
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=f"{func} G={G}")
        np.testing.assert_allclose(g[~np.isnan(w)], w[~np.isnan(w)], rtol=rtol, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["jitter", "holes"])
@pytest.mark.parametrize("query", [
    "sum(rate(m[5m]))", "sum by (zone) (min_over_time(m[5m]))", "topk(3, irate(m[5m]))",
    "changes(m[5m])", "max_over_time(m[5m])",
])
def test_near_regular_engine_on_card(card, kind, query):
    """A jittered or holey store through the engine on the card: the
    fused queries and the tree's leaves on the jitter/masked rung (changes
    on the general one, as the JAX ladder), equal to the CPU engine's."""
    from filodb_tpu_torch.coordinator.planner import QueryEngine
    from filodb_tpu_torch.core.records import SeriesBatch
    from filodb_tpu_torch.core.schemas import METRIC_TAG, PROM_COUNTER, Dataset, shard_for
    from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore

    rng = np.random.default_rng(7)
    ms = TimeSeriesMemStore()
    ms.setup(Dataset("prometheus"), range(2))
    nominal = BASE + 5_000 + np.arange(200, dtype=np.int64) * 10_000
    for i in range(40):
        tags = {METRIC_TAG: "m", "_ws_": "w", "_ns_": "n", "instance": f"h{i}",
                "zone": f"z{i % 3}"}
        ts = nominal + np.rint(rng.uniform(-0.05, 0.05, 200) * 10_000).astype(np.int64)
        vals = np.cumsum(rng.uniform(0, 9, 200))
        if kind == "holes":
            keep = np.ones(200, bool)
            keep[[20 + i, 90 + i]] = False
            ts, vals = ts[keep], vals[keep]
        ms.shard("prometheus", shard_for(tags, spread=1, num_shards=2)).ingest_series(
            SeriesBatch(PROM_COUNTER, tags, ts, {"count": vals}))
    start, end = (BASE + 400_000) / 1000, (BASE + 1_600_000) / 1000
    got = QueryEngine(ms, "prometheus").query_range(query, start, end, 60)
    rung = "general" if query.startswith("changes") else (
        "masked" if kind == "holes" else "jitter")
    assert set(got.stats.rungs) == {rung}, got.stats.rungs
    want = QueryEngine(ms, "prometheus", device="cpu").query_range(query, start, end, 60)
    rows = {tuple(sorted(l.items())): v for g in got.grids for l, v in zip(g.labels,
                                                                             g.values_np())}
    for g in want.grids:
        for l, w in zip(g.labels, g.values_np()):
            v = rows[tuple(sorted(l.items()))]
            np.testing.assert_array_equal(np.isnan(v), np.isnan(w))
            np.testing.assert_allclose(v[~np.isnan(w)], w[~np.isnan(w)], rtol=1e-3)


# -- the histogram range kernel's jitter mode (B1) ------------------------------


def jitter_hist_block(card, n_real=300, m=400, B=12, seed=0, jitter=500):
    """Seeded cumulative histograms on one 10 s nominal grid (phase 5 s),
    each sample within +-``jitter`` ms of it, all the same length; on the
    card, with padded rows past ``n_real``."""
    from filodb_tpu_torch.ops.staging import stage_histogram_series

    rng = np.random.default_rng(seed)
    nominal = BASE + 5_000 + np.arange(m, dtype=np.int64) * 10_000
    series = []
    for _ in range(n_real):
        incr = rng.poisson(2.0, size=(m, B)).astype(np.float64)
        incr[:, -1] = incr.sum(1)
        series.append((nominal + rng.integers(-jitter, jitter + 1, m),
                       np.cumsum(np.cumsum(incr, axis=1), axis=0)))
    b = stage_histogram_series(series, BASE, B, [(0, i) for i in range(n_real)])
    assert b.nominal_ts is not None
    return b.to_device(card)


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 8, "S"])
@pytest.mark.parametrize("is_delta", [False, True], ids=["cumulative", "delta"])
@pytest.mark.parametrize("func", HIST_FUNCS)
def test_hist_jitter_kernel_matches_plain_on_card(card, func, is_delta, G):
    """The jitter mode (one launch, counted in JITTER_LAUNCHES) against
    hist_jitter_plain's group sums on the same step table: at G = S each
    row is its own group, so the sums are the plain values (rtol 2e-4 /
    atol 1e-4 with member counts equal); at G = 1 and 8 atomics reorder
    the f32 sums (rtol 1e-3); the folded quantile against
    hist_quantile_plain of the launch's own partials."""
    from filodb_tpu_torch.ops import hist_kernels as HK

    b = jitter_hist_block(card)
    n = b.n_series
    groups = n if G == "S" else G
    gids = hist_gids(groups, b.vals.shape[0], n, card)
    assert AGG.hist_variant(b, HIST_PARAMS) == "hist_jitter"
    wm = AGG._hist_jitter_windows(b, HIST_PARAMS)
    les = torch.tensor(hist_les(b.vals.shape[2]), dtype=torch.float32, device=card)
    before = (HK.RANGE_LAUNCHES, HK.JITTER_LAUNCHES)
    out, acc, cnt = HK.hist_range_quantile(0.9, func, b, gids, groups, HIST_PARAMS, les,
                                           is_delta=is_delta, jitter=wm)
    assert (HK.RANGE_LAUNCHES, HK.JITTER_LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert not HK.LAST_PLAN.staged
    want_acc, want_cnt = HK.hist_partials_plain(func, b, gids, groups, HIST_PARAMS,
                                                is_delta=is_delta, jitter=wm)
    torch.cuda.synchronize()
    if G == "S":
        assert_partials_match(acc, cnt, want_acc, want_cnt, groups, rtol=2e-4, atol=1e-4)
    else:
        fin = GA.finish_groups("sum", want_acc, want_cnt, groups)
        atol = 1e-5 * float(torch.nan_to_num(fin, nan=0.0).abs().max())
        assert_partials_match(acc, cnt, want_acc, want_cnt, groups, rtol=1e-3, atol=atol)
    assert_quantiles_match(out, HK.hist_quantile_plain(0.9, acc, cnt, groups, les,
                                                       HIST_PARAMS.num_steps))


@pytest.mark.cuda
def test_hist_jitter_through_the_engine_on_card(card):
    """The SRE panel over a store of jittered histograms: one range launch
    in the jitter mode, and the answer of the same engine on the CPU."""
    from filodb_tpu_torch.coordinator.planner import QueryEngine
    from filodb_tpu_torch.core.records import SeriesBatch
    from filodb_tpu_torch.core.schemas import METRIC_TAG, PROM_HISTOGRAM, Dataset, shard_for
    from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore
    from filodb_tpu_torch.ops import hist_kernels as HK

    rng = np.random.default_rng(3)
    les = np.append(hist_les(12)[:-1], np.inf)
    m = 300
    ms = TimeSeriesMemStore()
    ms.setup(Dataset("prometheus"), range(8))
    nominal = BASE + 5_000 + np.arange(m, dtype=np.int64) * 10_000
    for i in range(2000):
        tags = {METRIC_TAG: "http_request_latency", "instance": f"host-{i}"}
        incr = rng.poisson(2.0, size=(m, 12)).astype(np.float64)
        incr[:, -1] = incr.sum(1)
        h = np.cumsum(np.cumsum(incr, axis=1), axis=0)
        ms.shard("prometheus", shard_for(tags, spread=3, num_shards=8)).ingest_series(
            SeriesBatch(PROM_HISTOGRAM, tags, nominal + rng.integers(-500, 501, m),
                        {"sum": h[:, -1], "count": h[:, -1], "h": h}, bucket_les=les))
    q = "histogram_quantile(0.99, sum by (le) (rate(http_request_latency_bucket[5m])))"
    args = ((BASE + 400_000) / 1000, (BASE + 2_800_000) / 1000, 60)
    before = HK.JITTER_LAUNCHES
    got = QueryEngine(ms, "prometheus").query_range(q, *args)
    assert HK.JITTER_LAUNCHES == before + 1
    want = QueryEngine(ms, "prometheus", device="cpu").query_range(q, *args)
    g, w = got.grids[0].values_np(), want.grids[0].values_np()
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    assert np.isfinite(w).any()
    np.testing.assert_allclose(g[~np.isnan(w)], w[~np.isnan(w)], rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [16_384, 15_625, 1, 2])
@pytest.mark.parametrize("M", [1, 2, 3, 6, 64, 65, 130])
def test_postings_intersect_matches_plain(card, M, W):
    """B11 (csrc/postings.cu) bit-equal to its plain version: separate rows
    (16-byte loads where W is even) and rows of one [M, W] tensor (odd W
    leaves odd rows unaligned: the word-at-a-time pass); past 64 rows the
    wrapper chains launches, one per 64."""
    from filodb_tpu_torch.ops import postings_kernels as PK

    rng = np.random.default_rng(M * 7 + W)
    words = (rng.integers(0, 2**64, (M, W), dtype=np.uint64)
             | rng.integers(0, 2**64, (M, W), dtype=np.uint64))
    stacked = PK.host_words_to_device(words, card)
    rows = [PK.host_words_to_device(w, card) for w in words]
    want = PK.intersect_words_plain(stacked)
    np.testing.assert_array_equal(PK.device_words_to_host(want),
                                  np.bitwise_and.reduce(words, axis=0))
    for inp in (rows, stacked):
        before = PK.LAUNCHES
        got = PK.intersect_words(inp)
        torch.cuda.synchronize()
        assert PK.LAUNCHES == before + max(1, -(-(M - 1) // 63))
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_postings_tier_resolves_with_one_launch_on_card(card):
    from filodb_tpu_torch.core.filters import equals
    from filodb_tpu_torch.memstore.index import PartKeyIndex, SetBasedPartKeyIndex
    from filodb_tpu_torch.memstore.index_device import DevicePostingsTier
    from filodb_tpu_torch.ops import postings_kernels as PK

    idx, ref = PartKeyIndex(), SetBasedPartKeyIndex()
    for pid in range(20_000):
        tags = {"_ws_": "demo", "_ns_": f"ns{pid % 20}", "dc": f"dc{pid % 10}",
                "host": f"h{pid % 1000}"}
        idx.add_partkey(pid, tags, 0)
        ref.add_partkey(pid, tags, 0)
    idx.device_tier = DevicePostingsTier(idx, card, min_hits=1)
    f = [equals("_ws_", "demo"), equals("_ns_", "ns3"), equals("dc", "dc3")]
    idx.part_ids_from_filters(f, 0, 2**62)
    assert idx.device_tier.maintain() == 3
    before = PK.LAUNCHES
    got = idx.part_ids_from_filters(f, 0, 2**62)
    assert PK.LAUNCHES == before + 1
    assert got.tolist() == ref.part_ids_from_filters(f, 0, 2**62).tolist()
    assert idx.device_tier.stats["intersections"] == 1


# -- the lane modes of the four fused kernels (cross-query batching, B12) ----------

LANE_WINDOWS = (300_000, 240_000, 180_000)
# (lanes, G): one lane per window with shared partials, and 16 lanes past the
# shared-memory budget (6 lanes of one window x 2 x 64 groups x 40 steps)
LANE_SHAPES = [(3, 4), (16, 64)]


def lane_set(b, card, n_lanes: int, G: int, q=0.0):
    """``n_lanes`` lanes over ``b``: group counts G, G // 2, ... (at least
    1), each its own int64 grouping, windows cycling over LANE_WINDOWS."""
    lanes = []
    for i in range(n_lanes):
        g = max(G >> (i % 3), 1)
        lanes.append((spread_groups(b, g, card, interleave=i % 2 == 0), g,
                      q if not isinstance(q, tuple) else q[i % len(q)],
                      RangeParams(BASE + 400_000, 60_000, 40, LANE_WINDOWS[i % 3])))
    return lanes


LANE_RUNGS = {  # block, function, is_counter, is_delta
    "mxu": (lambda: regular_block(True, {"counter_corrected": True}), "rate", True, False),
    "jitter": (lambda: near_regular_block("jitter", {"counter_corrected": True}, True), "rate",
               True, False),
    "masked": (lambda: near_regular_block("holes", {"counter_corrected": True}, True), "rate",
               True, False),
    "general": (lambda: general_block("corrected")[0], "irate", True, False),
    # window stats on an irregular grid (the JAX ladder's general program
    # for PALLAS_FUNCS), and max_over_time on a regular one
    "window_stats": (lambda: general_block("corrected")[0], "rate", True, False),
    "window_stats_regular": (lambda: regular_block(False, {}), "max_over_time", False, False),
}


def lane_module(rung: str):
    mod, prefix = AGG._LANE_RUNGS[rung.removesuffix("_regular")]
    return mod, prefix


@pytest.mark.cuda
@pytest.mark.parametrize("n_lanes,G", LANE_SHAPES, ids=["shared", "global"])
@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("rung", sorted(LANE_RUNGS))
def test_lane_mode_matches_plain_on_card(card, rung, op, n_lanes, G):
    """One launch of a rung's lane mode against its plain version on the
    same inputs: max bit-equal, sums within rtol 1e-5 (group atomics add in
    launch order); the partials' variant the plan chose."""
    make, func, counter, is_delta = LANE_RUNGS[rung]
    b = make().to_device(card)
    lanes = lane_set(b, card, n_lanes, G)
    variant = rung.removesuffix("_regular")
    assert AGG.lanes_variant(b, func, "agg", is_delta, [l[3] for l in lanes]) == variant
    mod, prefix = lane_module(rung)
    before = mod.LANE_LAUNCHES
    got = AGG.fused_batched_scalar(func, ("agg", op), b, lanes, counter, is_delta)
    assert mod.LANE_LAUNCHES == before + 1
    assert mod.LAST_LANE_PLAN.shared == (n_lanes == 3)
    batch = AGG._batched_stacks(b, lanes, variant, "agg", pad_steps(40))
    want = getattr(mod, f"{prefix}_lanes_plain")(func, op, b, lanes, batch, counter, is_delta)
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got, want)):
        if op == "max":
            assert torch.equal(torch.isnan(g), torch.isnan(w)), (rung, i)
            assert torch.equal(g[~torch.isnan(w)], w[~torch.isnan(w)]), (rung, i)
        else:
            assert_same(g, w, rtol=1e-5, atol=1e-4, what=f"{rung} lane {i}")


@pytest.mark.cuda
@pytest.mark.parametrize("rung", sorted(LANE_RUNGS))
def test_lane_store_mode_and_topk_on_card(card, rung):
    """The lane store mode writes every unique window's grid once, bit-equal
    to the plain version; topk lanes over it equal their solo launches."""
    make, func, counter, is_delta = LANE_RUNGS[rung]
    b = make().to_device(card)
    zero = AGG.zero_gids(b)
    lanes = [(zero, 1, 0.0, RangeParams(BASE + 400_000, 60_000, 40, w))
             for w in LANE_WINDOWS + (300_000,)]
    mod, prefix = lane_module(rung)
    batch = AGG._batched_stacks(b, lanes[:3], rung.removesuffix("_regular"), "topk",
                                pad_steps(40))
    before = mod.LANE_LAUNCHES
    grids = getattr(mod, f"{prefix}_lanes_series")(func, b, batch, counter, is_delta)
    assert mod.LANE_LAUNCHES == before + 1
    want = getattr(mod, f"{prefix}_lanes_series_plain")(func, b, batch, counter, is_delta)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(grids), torch.isnan(want))
    assert torch.equal(grids[~torch.isnan(want)], want[~torch.isnan(want)])
    outs = AGG.fused_batched_scalar(func, ("topk", 3, False), b, lanes, counter, is_delta)
    for (_, _, _, p), (vals, idx) in zip(lanes, outs):
        sv, si = AGG.fused_topk(func, b, 3, False, p, is_counter=counter, is_delta=is_delta)
        assert torch.equal(vals, sv) and torch.equal(idx, si)


@pytest.mark.cuda
@pytest.mark.parametrize("quantile", [False, True], ids=["sums", "quantile"])
@pytest.mark.parametrize("n_lanes,G", LANE_SHAPES, ids=["shared", "global"])
@pytest.mark.parametrize("grid", ["regular", "irregular"])
def test_hist_lane_mode_matches_plain_on_card(card, grid, n_lanes, G, quantile):
    """One launch of the histogram kernel's lane mode (each lane's own q
    folded in) against its plain version: bucket sums within rtol 1e-5,
    quantiles as ``assert_quantiles_match`` holds the solo kernel's."""
    b = shared_hist_block(grid, card, 300, 400, 0, len(HIST_LES))
    les = torch.as_tensor(HIST_LES.astype(np.float32), device=card)
    lanes = []
    for i in range(n_lanes):
        g = max(G >> (i % 3), 1)
        lanes.append((hist_gids(g, b.vals.shape[0], 300, card), g, (0.5, 0.9, 0.99)[i % 3],
                      RangeParams(BASE - 120_000, 60_000, 40, LANE_WINDOWS[i % 3])))
    variant = AGG.lanes_variant(b, "rate", "hist", False, [l[3] for l in lanes])
    assert variant == ("hist_shared" if grid == "regular" else "hist_general")
    batch = AGG._batched_stacks(b, lanes, variant, "hist", pad_steps(40))
    before = (HK.LANE_LAUNCHES, HK.LANE_FOLDED)
    got = AGG.fused_batched_hist("rate", b, lanes, les, quantile, False)
    assert (HK.LANE_LAUNCHES, HK.LANE_FOLDED) == (before[0] + 1, before[1] + int(quantile))
    assert HK.LAST_LANE_PLAN.shared == (n_lanes == 3)
    want = HK.hist_range_lanes_plain("rate", b, lanes, batch, les, quantile)
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got, want)):
        if quantile:
            assert_quantiles_match(g, w)
        else:
            assert_same(g, w, rtol=1e-5, atol=1e-4, what=f"hist lane {i}")


@pytest.mark.cuda
@pytest.mark.parametrize("func", ["rate", "count_over_time", "last", "increase"])
def test_window_stats_lanes_bit_equal_to_solo_on_card(card, func):
    """The window-stats lane mode (each staged tile read once for all its
    windows) against its solo launches on the card: max and count lanes
    bit-equal, sums within rtol 1e-5; the store grids bit-equal."""
    b = general_block("corrected")[0].to_device(card)
    lanes = lane_set(b, card, 5, 8)
    for op in ("max", "sum"):
        got = AGG.fused_batched_scalar(func, ("agg", op), b, lanes, True, False)
        for (gids, G, _q, p), g in zip(lanes, got):
            w = AGG.fused_range_aggregate(func, op, b, gids, G, p, is_counter=True)
            if op == "max" or func == "count_over_time":
                assert torch.equal(torch.isnan(g), torch.isnan(w))
                assert torch.equal(g[~torch.isnan(w)], w[~torch.isnan(w)])
            else:
                assert_same(g, w, rtol=1e-5, atol=1e-4, what=f"{func} {op}")
