"""The port's staging against the JAX package's on the same series: the
staged arrays must be bit-equal in all three modes (raw, corrected,
shifted), and concatenation must carry them over exactly."""

import numpy as np
import pytest
import torch

from filodb_tpu.ops import staging as JST
from filodb_tpu_torch.ops import staging as ST

BASE = 1_600_000_000_000
MODES = {
    "raw": {},
    "corrected": {"counter_corrected": True},
    "shifted": {"subtract_baseline": True},
}


def make_series(n_series=40, n=200, seed=0):
    """Irregular counters with a reset, a NaN (staleness) sample and ragged
    lengths."""
    rng = np.random.default_rng(seed)
    series = []
    for i in range(n_series):
        m = n - (i % 7)
        ts = BASE + np.cumsum(rng.integers(5000, 15000, m)).astype(np.int64)
        vals = np.cumsum(rng.uniform(0, 10, m)) + 1e9
        vals[m // 2:] -= vals[m // 2] - 3.0
        if i % 5 == 0:
            vals[m // 3] = np.nan
        series.append((ts, vals))
    return series


def assert_block_equal(got, want):
    for name in ("ts", "vals", "lens", "baseline"):
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(want, name)), err_msg=name)
    assert (got.raw is None) == (want.raw is None)
    if want.raw is not None:
        np.testing.assert_array_equal(np.asarray(got.raw), np.asarray(want.raw))
    assert got.n_series == want.n_series and got.base_ms == want.base_ms
    assert list(got.part_refs) == list(want.part_refs)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_stage_series_bit_equal(mode):
    series = make_series(seed=1)
    refs = [(0, i) for i in range(len(series))]
    want = JST.stage_series(series, BASE, refs, **MODES[mode])
    got = ST.stage_series(series, BASE, refs, **MODES[mode])
    assert_block_equal(got, want)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_concat_blocks_bit_equal(mode):
    parts = [make_series(n_series=k, seed=10 + k) for k in (3, 17, 9)]
    want = JST.concat_blocks([JST.stage_series(s, BASE, **MODES[mode]) for s in parts])
    got = ST.concat_blocks([ST.stage_series(s, BASE, **MODES[mode]) for s in parts])
    assert_block_equal(got, want)
    assert got.shape == (32, 256)


def test_block_from_arrays_round_trip():
    want = JST.stage_series(make_series(seed=2), BASE, counter_corrected=True)
    got = ST.block_from_arrays(want.ts, want.vals, want.lens, want.base_ms, want.baseline,
                               want.n_series, raw=want.raw, device="cpu")
    assert isinstance(got.ts, torch.Tensor) and got.ts.device.type == "cpu"
    assert got.ts.dtype == torch.int32 and got.vals.dtype == torch.float32
    assert_block_equal(got, want)


def test_block_from_arrays_rejects_mismatched_shapes():
    want = JST.stage_series(make_series(n_series=3, seed=2), BASE)
    with pytest.raises(ValueError):
        ST.block_from_arrays(want.ts, want.vals[:, :64], want.lens, BASE, want.baseline,
                             3, device="cpu")


def test_to_device_keeps_values():
    block = ST.stage_series(make_series(n_series=5, seed=3), BASE, counter_corrected=True)
    host = {k: np.array(getattr(block, k)) for k in ("ts", "vals", "raw", "lens", "baseline")}
    block.to_device("cpu")
    for k, v in host.items():
        assert torch.equal(getattr(block, k), torch.from_numpy(v)), k
    assert block.nbytes() == sum(v.nbytes for v in host.values())
