"""The window-stats kernel on the card against its plain version. These
tests need an NVIDIA card and skip without one; the file imports no JAX so
that it runs on a machine with only torch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from filodb_tpu_torch.ops import window_stats as WS
from filodb_tpu_torch.ops.staging import TS_PAD, stage_series

BASE = 1_600_000_000_000
EXACT = ("count", "t_first", "t_last")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the window-stats kernel has no CPU mode")
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
def test_duplicate_timestamps_pick_by_index_on_card(card):
    """The kernel picks first/last by index; the TPU kernel (and the plain
    version) sum tied values (ROADMAP section C)."""
    ts = np.full((8, 128), TS_PAD, np.int32)
    ts[0, :3] = [1000, 1000, 2000]
    vals = np.zeros((8, 128), np.float32)
    vals[0, :3] = [1.0, 10.0, 3.0]
    lens = np.zeros(8, np.int32)
    lens[0] = 3
    t = [torch.from_numpy(a).to(card) for a in (ts, vals, vals.copy(), lens)]
    assert float(WS.window_stats(*t, 2000, 1000, 5000, 64)["v_first"][0, 0]) == 1.0
    assert float(WS.window_stats_plain(*t, 2000, 1000, 5000, 64)["v_first"][0, 0]) == 11.0
