"""The tree over native histograms with each leaf's store-mode grid at a
row pitch past its rows: ``hist_kernels._launch_series`` writes any
``[J, B, ld]`` buffer with ld >= S, and a leaf's grid is a view that every
consumer reads through its strides. Here the plain store grid is copied
into such a buffer with a sentinel in the columns past S, so every
consumer of a leaf grid -- the unaggregated answer (``Grid.hist_np``),
the instant histogram functions (``hist_instant``), ``histogram_bucket``,
the map phase's segment aggregate over ``[n, J·B]``, the pass-throughs --
must read it through its strides; each query is held against the JAX
engine as ``tests/test_torch_hist_tree.py`` holds it (rows by labels, NaN
masks equal, rtol 2e-4 / atol 1e-4)."""

import pytest
import torch

import test_torch_hist_tree as HT
from filodb_tpu_torch.coordinator.planner import QueryEngine
from filodb_tpu_torch.ops import hist_kernels as HK

SENTINEL = 12345.0


@pytest.fixture(scope="module")
def stores():
    return {grid: HT.build(HT.series_data(grid)) for grid in ("irregular", "regular")}


@pytest.fixture
def wide_pitch(monkeypatch):
    """The CPU store grid at a wider pitch: a [J, B, S + 5] buffer, the
    columns past S holding SENTINEL; the view of its first S columns is
    the answer."""
    plain = HK.hist_series_plain

    def padded(*args, **kwargs):
        grid = plain(*args, **kwargs)
        J, B, S = grid.shape
        buf = torch.full((J, B, S + 5), SENTINEL, dtype=grid.dtype)
        buf[:, :, :S] = grid
        return buf[:, :, :S]

    monkeypatch.setattr(HK, "hist_series_plain", padded)


def test_leaf_grid_is_a_view_past_its_rows(stores, wide_pitch):
    """The leaf's buckets are the [S, J, B] view of the wider buffer: its
    row pitch exceeds S, and no answer holds the sentinel."""
    _, pms = stores["regular"]
    res = QueryEngine(pms, "prometheus", device="cpu").query_range(
        "rate(lat[5m])", HT.START_S, HT.END_S, HT.STEP_S)
    for g in res.grids:
        S_pad = g.hist.shape[0]
        assert g.hist.stride()[2] == S_pad + 5 and g.hist.stride()[0] == 1
        assert not (g.hist_np() == SENTINEL).any()


@pytest.mark.parametrize("grid", ["irregular", "regular"])
@pytest.mark.parametrize("q", HT.RANGE_QUERIES + HT.FUNC_QUERIES)
def test_leaf_consumers_match_jax(stores, wide_pitch, grid, q):
    got, want = HT.both(stores, grid, q)
    HT.assert_same(got, want, f"{grid} {q}")


@pytest.mark.parametrize("q", HT.AGG_QUERIES)
def test_map_phase_reads_the_wide_grid(stores, wide_pitch, q):
    """The tree's map phase (fused_aggregate off) over the wider leaf grids."""
    got, want = HT.both(stores, "irregular", q, fused=False)
    HT.assert_same(got, want, q)


@pytest.mark.parametrize("q", HT.PASS_QUERIES)
def test_pass_throughs_read_the_wide_grid(stores, wide_pitch, q):
    got, want = HT.both(stores, "regular", q)
    HT.assert_same(got, want, q)

