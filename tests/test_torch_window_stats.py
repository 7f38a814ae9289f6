"""The port's window statistics and finisher against the JAX package's
Pallas kernel (interpret mode on the CPU) on the same numpy inputs.

Tolerance rtol 2e-4 / atol 1e-4 (as tests/test_pallas.py): f32 sums are
taken in another order. Counts and the int32-selected timestamps must match
exactly; NaN masks must be identical.
"""

import numpy as np
import pytest
import torch

from filodb_tpu.ops import pallas_kernels as PK
from filodb_tpu.ops.staging import stage_series as jax_stage_series
from filodb_tpu_torch.ops import window_stats as WS
from filodb_tpu_torch.ops.kernels import pad_steps

BASE = 1_600_000_000_000
START = BASE + 400_000
STEP = 60_000
WINDOW = 300_000
EXACT = ("count", "t_first", "t_last")


def make_series(n_series=40, n=200, seed=0, counter=False):
    """Strictly increasing irregular timestamps (5-15 s apart)."""
    rng = np.random.default_rng(seed)
    series = []
    for _ in range(n_series):
        ts = BASE + np.cumsum(rng.integers(5000, 15000, n)).astype(np.int64)
        if counter:
            vals = np.cumsum(rng.uniform(0, 10, n)) + 1e9
            k = n // 2
            vals[k:] -= vals[k] - 3.0  # one reset
        else:
            vals = 50 + 20 * rng.standard_normal(n)
        series.append((ts, vals))
    return series


def staged(counter, seed, n_series=40):
    return jax_stage_series(make_series(n_series, seed=seed, counter=counter), BASE,
                            counter_corrected=counter)


def torch_block(block):
    raw = block.raw if block.raw is not None else block.vals
    return (torch.from_numpy(np.asarray(block.ts)), torch.from_numpy(np.asarray(block.vals)),
            torch.from_numpy(np.asarray(raw)), torch.from_numpy(np.asarray(block.lens)))


def both_stats(block, num_steps, start=START, step=STEP, window=WINDOW):
    raw = block.raw if block.raw is not None else block.vals
    want = PK.window_aggregates(block.ts, block.vals, raw, block.lens, np.int32(start - BASE),
                                np.int32(step), np.int32(window), num_steps, interpret=True)
    got = WS.window_stats(*torch_block(block), start - BASE, step, window, num_steps)
    return got, want


def assert_close(got, want, name):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=name)
    m = ~np.isnan(want)
    if name in EXACT:
        np.testing.assert_array_equal(got[m], want[m], err_msg=name)
    else:
        np.testing.assert_allclose(got[m], want[m], rtol=2e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("counter", [False, True], ids=["gauge", "counter"])
def test_stat_planes_match_pallas(counter):
    block = staged(counter, seed=3 if not counter else 4)
    n, J = block.n_series, 24
    got, want = both_stats(block, J)
    for name in WS.STAT_NAMES:
        g = got[name].numpy()
        assert g.shape == (block.ts.shape[0], J)
        assert_close(g[:n, :J], np.asarray(want[name])[:n, :J], name)


def test_empty_window_sentinels_match_pallas():
    # steps before the first sample and after the last: empty windows
    block = staged(False, seed=5, n_series=3)
    got, want = both_stats(block, 8, start=BASE - 600_000, step=400_000, window=100_000)
    for name in WS.STAT_NAMES:
        g, w = got[name].numpy()[:3, :8], np.asarray(want[name])[:3, :8]
        np.testing.assert_array_equal(g[:, 0], w[:, 0], err_msg=name)
        assert_close(g, w, name)
    assert float(got["min"][0, 0]) == np.float32(3.0e38)
    assert float(got["t_first"][0, 0]) == np.float32(2**31 - 1)


def finish_pair(func, counter, seed):
    block = staged(counter, seed)
    J = pad_steps(20)
    got_stats, want_stats = both_stats(block, J)
    got = WS.finish(func, got_stats, START - BASE, STEP, WINDOW, is_counter=counter).numpy()
    want = np.asarray(PK.finish(func, want_stats, np.int32(START - BASE), np.int32(STEP),
                                np.int32(WINDOW), is_counter=counter))
    n = block.n_series
    return got[:n, :20], want[:n, :20]


@pytest.mark.parametrize("func", sorted(PK.PALLAS_FUNCS))
@pytest.mark.parametrize("counter", [False, True], ids=["gauge", "counter"])
def test_finish_matches_pallas(func, counter):
    assert WS.PALLAS_FUNCS == PK.PALLAS_FUNCS
    got, want = finish_pair(func, counter, seed=7 if counter else 8)
    assert_close(got, want, func)


def test_nan_value_confined_to_its_window():
    ts = np.full((8, 128), 2**31 - 1, np.int32)
    ts[0, :5] = np.arange(5) * 1000
    vals = np.zeros((8, 128), np.float32)
    vals[0, :5] = [1.0, 2.0, np.nan, 4.0, 5.0]
    lens = np.zeros(8, np.int32)
    lens[0] = 5
    t = [torch.from_numpy(a) for a in (ts, vals, vals.copy(), lens)]
    out = WS.finish("sum_over_time", WS.window_stats(*t, 1000, 1000, 1000, 4), 1000, 1000, 1000)
    np.testing.assert_allclose(out[0].numpy(), [2.0, np.nan, 4.0, 5.0], equal_nan=True)


def test_cpu_wrapper_runs_plain_and_counts_no_launch(monkeypatch):
    monkeypatch.setattr(WS, "LAUNCHES", 0)
    block = staged(False, seed=9, n_series=5)
    args = torch_block(block)
    got = WS.window_stats(*args, START - BASE, STEP, WINDOW, 64)
    plain = WS.window_stats_plain(*args, START - BASE, STEP, WINDOW, 64)
    for name in WS.STAT_NAMES:
        assert torch.equal(got[name], plain[name]), name
    assert WS.LAUNCHES == 0


def test_wrapper_rejects_bad_inputs():
    block = staged(False, seed=9, n_series=5)
    ts, vals, raw, lens = torch_block(block)
    with pytest.raises(TypeError):
        WS.window_stats(ts.to(torch.int64), vals, raw, lens, 0, STEP, WINDOW, 64)
    with pytest.raises(ValueError):
        WS.window_stats(ts, vals[:, :64], raw, lens, 0, STEP, WINDOW, 64)
    with pytest.raises(ValueError):
        WS.window_stats(ts.t(), vals.t(), raw.t(), lens, 0, STEP, WINDOW, 64)


def duplicate_ts_block():
    ts = np.full((8, 128), 2**31 - 1, np.int32)
    ts[0, :3] = [1000, 1000, 2000]
    vals = np.zeros((8, 128), np.float32)
    vals[0, :3] = [1.0, 10.0, 3.0]
    lens = np.zeros(8, np.int32)
    lens[0] = 3
    return ts, vals, lens


def test_duplicate_timestamps_plain_keeps_tpu_tie_rule():
    """With duplicate timestamps the TPU kernel sums the tied first/last
    values; the plain version keeps that rule, and so does the kernel on the
    card (tests/test_torch_cuda.py). Staging from the memstore never
    produces ties (partitions drop non-increasing rows)."""
    ts, vals, lens = duplicate_ts_block()
    t = [torch.from_numpy(a) for a in (ts, vals, vals.copy(), lens)]
    plain = WS.window_stats_plain(*t, 2000, 1000, 5000, 64)
    want = PK.window_aggregates(ts, vals, vals, lens, np.int32(2000), np.int32(1000),
                                np.int32(5000), 64, interpret=True)
    assert float(plain["v_first"][0, 0]) == float(np.asarray(want["v_first"])[0, 0]) == 11.0
