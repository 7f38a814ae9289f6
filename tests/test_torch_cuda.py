"""The window-stats and regular-range kernels on the card against their
plain versions. These tests need an NVIDIA card and skip without one; the
file imports no JAX so that it runs on a machine with only torch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from filodb_tpu_torch.ops import aggregations as AGG
from filodb_tpu_torch.ops import mxu_kernels as MK
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
    wm = MK.window_matrices(block, params.start_ms - BASE, params.step_ms,
                            pad_steps(params.num_steps), params.window_ms)
    raw = block.raw if block.raw is not None else block.vals
    sj = MK.mxu_range_plain(func, block.vals, raw, wm, params.window_ms, is_counter=counter)
    return AGG.apply_epilogue(sj, ("agg", op), gids, G)


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
