"""The port's grid classification against the JAX package's on the same
series: ``detect_shared_grid``, ``nominal_midrange``, ``grid_class`` and
``stage_series`` in every staging mode, and what ``concat_blocks`` keeps of
the shared grid. The staged arrays and grids must be bit-equal. The JAX
package's ``holes`` class (its masked missing-scrape grid) is not ported:
the port classes such blocks ``irregular``."""

import numpy as np
import pytest

from filodb_tpu.ops import staging as JST
from filodb_tpu_torch.ops import staging as ST

BASE = 1_600_000_000_000
INTERVAL = 10_000
KINDS = ("regular", "jitter", "irregular", "ragged", "empty")
MODES = {
    "raw": {},
    "corrected": {"counter_corrected": True},
    "shifted": {"subtract_baseline": True},
    "diff": {"diff_encode": True},
}


def make_series(kind: str, n_series=6, n=120, seed=0, phase=3_000):
    """Counters with a reset on a shared 10 s grid (``regular``), the same
    grid with +-5 % jitter, irregular 5-15 s intervals, ragged lengths on the
    shared grid, or no samples at all."""
    rng = np.random.default_rng(seed)
    nominal = BASE + phase + np.arange(n, dtype=np.int64) * INTERVAL
    out = []
    for i in range(n_series):
        if kind == "regular":
            ts = nominal
        elif kind == "jitter":
            ts = nominal + np.rint(rng.uniform(-0.05, 0.05, n) * INTERVAL).astype(np.int64)
        elif kind == "irregular":
            ts = BASE + np.cumsum(rng.integers(5_000, 15_000, n)).astype(np.int64)
        elif kind == "ragged":
            ts = nominal[: n - (i % 3)]
        else:
            ts = nominal[:0]
        vals = np.cumsum(rng.uniform(0, 10, len(ts))) + 1e6
        if len(ts) > 4:
            vals[len(ts) // 2:] -= vals[len(ts) // 2] - 3.0
        out.append((ts, vals))
    return out


def jax_class(block) -> str:
    """The JAX package's grid class, which the port now has for every grid
    (``holes`` included)."""
    return JST.grid_class(block)


def assert_grid_equal(got, want):
    for name in ("regular_ts", "nominal_ts", "ts_dev"):
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if w is not None:
            assert isinstance(g, np.ndarray), name
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
            assert g.dtype == np.asarray(w).dtype, name
    assert got.maxdev_ms == want.maxdev_ms
    assert (got.mgrid is None) == (getattr(want, "mgrid", None) is None)
    assert ST.grid_class(got) == jax_class(want)


def assert_block_equal(got, want):
    for name in ("ts", "vals", "lens", "baseline"):
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(want, name)), err_msg=name)
    assert (got.raw is None) == (want.raw is None)
    if want.raw is not None:
        np.testing.assert_array_equal(np.asarray(got.raw), np.asarray(want.raw))
    assert got.n_series == want.n_series and got.base_ms == want.base_ms
    assert_grid_equal(got, want)


@pytest.mark.parametrize("kind", KINDS)
def test_detect_shared_grid_matches_jax(kind):
    block = JST.stage_series(make_series(kind, seed=1), BASE)
    S, T = block.ts.shape
    n = block.n_series
    ts, lens = np.asarray(block.ts), np.asarray(block.lens)
    want = JST.detect_shared_grid(ts, lens, n, T, S)
    got = ST.detect_shared_grid(ts, lens, n, T, S)
    for g, w in zip(got[:3], want[:3]):
        assert (g is None) == (w is None)
        if w is not None:
            np.testing.assert_array_equal(g, w)
    assert got[3] == want[3]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mode", sorted(MODES))
def test_stage_series_grid_and_arrays_match_jax(kind, mode):
    series = make_series(kind, seed=2)
    refs = [(0, i) for i in range(len(series))]
    want = JST.stage_series(series, BASE, refs, **MODES[mode])
    got = ST.stage_series(series, BASE, refs, **MODES[mode])
    assert_block_equal(got, want)
    assert list(got.part_refs) == list(want.part_refs)


def test_grid_classes_cover_the_ladder():
    classes = {k: ST.grid_class(ST.stage_series(make_series(k, seed=3), BASE)) for k in KINDS}
    assert classes == {"regular": "regular", "jitter": "jitter", "irregular": "irregular",
                       "ragged": "holes", "empty": "irregular"}


def test_nominal_midrange_matches_jax():
    rng = np.random.default_rng(4)
    real = (np.arange(50, dtype=np.int64) * INTERVAL)[None, :] + rng.integers(-900, 900, (7, 50))
    want = JST.nominal_midrange(real)
    got = ST.nominal_midrange(real)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]


def test_diff_encode_holds_adjacent_differences():
    series = make_series("regular", n_series=2, n=9, seed=5)
    got = ST.stage_series(series, BASE, diff_encode=True)
    ts, vals = series[0]
    np.testing.assert_array_equal(got.vals[0, :9], np.concatenate(
        [[0.0], np.diff(vals)]).astype(np.float32))
    assert got.raw is None and not got.baseline.any()


def port_copy(jb):
    """A port block holding a JAX block's host arrays and grid."""
    return ST.StagedBlock(
        np.asarray(jb.ts), np.asarray(jb.vals), np.asarray(jb.lens), jb.base_ms,
        np.asarray(jb.baseline), jb.n_series, list(jb.part_refs),
        raw=None if jb.raw is None else np.asarray(jb.raw), regular_ts=jb.regular_ts,
        nominal_ts=jb.nominal_ts, ts_dev=jb.ts_dev, maxdev_ms=jb.maxdev_ms)


CONCAT_CASES = {
    # three shards on one grid, one padded width
    "same-grid": [("regular", 3, 120), ("regular", 5, 120), ("regular", 2, 120)],
    # equal real rows, members of different padded widths (128 and 256)
    "padded-widths": [("regular", 3, 120), ("regular", 4, 120)],
    # one member irregular: the grid is dropped
    "one-irregular": [("regular", 3, 120), ("irregular", 4, 120), ("regular", 2, 120)],
    # every member near-regular: re-detected as jitter over the rows
    "jitter": [("jitter", 3, 120), ("jitter", 4, 120)],
    # members on one grid but of different lengths
    "different-lengths": [("regular", 3, 120), ("regular", 3, 150)],
    # a member with no series is left out
    "empty-member": [("regular", 3, 120), ("regular", 0, 120), ("regular", 2, 120)],
    # a member whose series have no samples breaks the grid
    "empty-rows": [("regular", 3, 120), ("empty", 2, 120)],
}


@pytest.mark.parametrize("case", sorted(CONCAT_CASES))
@pytest.mark.parametrize("mode", ["raw", "corrected"])
def test_concat_blocks_grid_matches_jax(case, mode):
    parts = [make_series(kind, n_series=k, n=n, seed=10 + i)
             for i, (kind, k, n) in enumerate(CONCAT_CASES[case])]
    jax_blocks = [JST.stage_series(s, BASE, **MODES[mode]) for s in parts]
    port_blocks = [ST.stage_series(s, BASE, **MODES[mode]) for s in parts]
    if case == "padded-widths":
        # one member staged with time headroom, so its padded width differs;
        # the port stages no headroom, so it takes the JAX member's arrays
        jax_blocks[1] = JST.stage_series(parts[1], BASE, time_headroom=100, **MODES[mode])
        port_blocks[1] = port_copy(jax_blocks[1])
        assert port_blocks[1].ts.shape[1] != port_blocks[0].ts.shape[1]
    want = JST.concat_blocks(jax_blocks)
    got = ST.concat_blocks(port_blocks)
    assert_block_equal(got, want)
    expect = {"same-grid": "regular", "padded-widths": "regular", "one-irregular": "irregular",
              "jitter": "jitter", "different-lengths": "irregular", "empty-member": "regular",
              "empty-rows": "irregular"}
    assert ST.grid_class(got) == expect[case]
