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


def grid_series(kind: str, n_series=5, n=120, seed=0):
    """Series on one shared 10 s grid, the same grid with +-5 % jitter, or
    irregular 5-15 s intervals."""
    rng = np.random.default_rng(seed)
    nominal = BASE + 3_000 + np.arange(n, dtype=np.int64) * 10_000
    series = []
    for _ in range(n_series):
        if kind == "regular":
            ts = nominal
        elif kind == "jitter":
            ts = nominal + np.rint(rng.uniform(-0.05, 0.05, n) * 10_000).astype(np.int64)
        else:
            ts = BASE + np.cumsum(rng.integers(5000, 15000, n)).astype(np.int64)
        series.append((ts, np.cumsum(rng.uniform(0, 10, n))))
    return series


@pytest.mark.parametrize("kind", ["regular", "jitter", "irregular"])
def test_block_from_arrays_keeps_jax_grid_class(kind):
    want = JST.stage_series(grid_series(kind, seed=4), BASE, counter_corrected=True)
    got = ST.block_from_arrays(want.ts, want.vals, want.lens, want.base_ms, want.baseline,
                               want.n_series, raw=want.raw, device="cpu")
    assert ST.grid_class(got) == JST.grid_class(want) == kind
    for name in ("regular_ts", "nominal_ts", "ts_dev"):
        w = getattr(want, name)
        if w is None:
            assert getattr(got, name) is None, name
        else:
            np.testing.assert_array_equal(getattr(got, name), np.asarray(w), err_msg=name)
    assert got.maxdev_ms == want.maxdev_ms


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
    assert ST.staged_nbytes(block) == sum(v.nbytes for v in host.values())


def equal_length_series(kind: str, n_series=37, n=150, seed=3):
    """Series of one length (``ragged``: of lengths n - 0..6, which stage
    by the loop): on one 10 s grid, jittered around it, or on irregular
    intervals; counters with a reset and with -0.0 and tied values."""
    rng = np.random.default_rng(seed)
    grid = BASE + 10_000 * np.arange(n, dtype=np.int64)
    series = []
    for i in range(n_series):
        ts = {"regular": grid,
              "jitter": grid + rng.integers(-400, 401, n),
              "irregular": BASE + np.cumsum(rng.integers(5000, 15000, n)),
              "ragged": BASE + np.cumsum(rng.integers(5000, 15000, n))}[kind].astype(np.int64)
        vals = np.cumsum(rng.uniform(0, 10, n)) + 1e9
        vals[n // 2:] -= vals[n // 2] - 3.0
        vals[7] = vals[6]
        if i == 0:
            vals[:3] = -0.0
        m = n - (i % 7 if kind == "ragged" else 0)
        series.append((ts[:m], vals[:m]))
    return series


@pytest.mark.parametrize("kind", ["regular", "jitter", "irregular"])
@pytest.mark.parametrize("mode", sorted(MODES) + ["diff"])
@pytest.mark.parametrize("sidecar", [False, True])
def test_equal_length_rows_stage_as_the_loop_does(kind, mode, sidecar, monkeypatch):
    """The whole-matrix staging of equal-length series (``_stage_rows``) is
    bit-equal to the per-series loop, and to the JAX package's staging."""
    series = equal_length_series(kind)
    refs = [(1, i) for i in range(len(series))]
    kw = {"diff": {"diff_encode": True}}.get(mode, MODES.get(mode, {}))
    assert ST._equal_rows(series) is not None
    got = ST.stage_series(series, BASE, refs, time_headroom=5, sidecar=sidecar, **kw)
    monkeypatch.setattr(ST, "_equal_rows", lambda s: None)
    want = ST.stage_series(series, BASE, refs, time_headroom=5, sidecar=sidecar, **kw)
    assert_block_equal(got, want)
    for name in ("regular_ts", "nominal_ts", "ts_dev", "base64"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.maxdev_ms == want.maxdev_ms and got.mgrid_deferred == want.mgrid_deferred
    assert (got.mgrid is None) == (want.mgrid is None)
    if got.cont is not None:
        for a, b in zip(got.cont, want.cont):
            np.testing.assert_array_equal(a.view(np.int64), b.view(np.int64))
    if mode != "diff":
        assert_block_equal(got, JST.stage_series(series, BASE, refs, time_headroom=5, **kw))


def test_rows_of_other_shapes_take_the_loop():
    """One series, ragged lengths, NaN or f32 values: the loop."""
    series = equal_length_series("regular", n_series=4)
    assert ST._equal_rows(series[:1]) is None  # one series
    assert ST._equal_rows(equal_length_series("ragged", n_series=4)) is None
    assert ST._equal_rows([(t[:-1], v[:-1]) for t, v in series[:1]] + series[1:]) is None
    nan = [(t, v.copy()) for t, v in series]
    nan[2][1][5] = np.nan
    assert ST._equal_rows(nan) is None
    assert ST._equal_rows([(t, v.astype(np.float32)) for t, v in series]) is None
