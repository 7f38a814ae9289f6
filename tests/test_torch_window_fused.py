"""The port's fused window-stats rung (``window_range_aggregate``: window
stats -> finish -> group aggregate in one launch on the card) against the
JAX package's ``_fused_pallas_jit`` in interpret mode, on the same seeded
numpy inputs; and the host side of the fused kernels (tile plan,
accumulators, alignment check, build digest, the timing script's patch
targets).

On the CPU ``window_range_aggregate`` runs its plain version. Tolerance
rtol 2e-4 / atol 1e-4 (as tests/test_pallas.py): f32 sums are taken in
another order. NaN masks must be identical.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from filodb_tpu.ops import aggregations as JAGG
from filodb_tpu.ops.pallas_kernels import PALLAS_FUNCS as JAX_PALLAS_FUNCS
from filodb_tpu.ops.staging import stage_series as jax_stage_series
from filodb_tpu_torch.ops import aggregations as AGG
from filodb_tpu_torch.ops import cuda_build
from filodb_tpu_torch.ops import group_acc as GA
from filodb_tpu_torch.ops import mxu_kernels as MK
from filodb_tpu_torch.ops import window_stats as WS
from filodb_tpu_torch.ops.kernels import RangeParams, pad_steps
from filodb_tpu_torch.ops.staging import block_from_arrays, stage_series

_spec = importlib.util.spec_from_file_location(
    "tile_sweep", Path(__file__).resolve().parents[1] / "tile_sweep.py")
tile_sweep = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tile_sweep)

BASE = 1_600_000_000_000
START = BASE + 400_000
STEP = 60_000
WINDOW = 300_000
NUM_STEPS = 20
N_SERIES = 13  # pads to 32 rows: 19 trash rows
OPS = ("sum", "count", "avg", "min", "max")


def make_series(counter: bool, seed: int):
    """Irregular series, 5-15 s apart, ending at different times (so later
    steps find empty windows in some); counters with one reset."""
    rng = np.random.default_rng(seed)
    series = []
    for i in range(N_SERIES):
        n = 60 + 10 * i
        ts = BASE + np.cumsum(rng.integers(5000, 15000, n)).astype(np.int64)
        if counter:
            vals = np.cumsum(rng.uniform(0, 10, n)) + 1e3
            k = n // 2
            vals[k:] -= vals[k] - rng.uniform(0, 5)
        else:
            vals = 50 + 20 * rng.standard_normal(n)
        series.append((ts, vals))
    return series


def both_blocks(counter: bool, seed: int):
    series = make_series(counter, seed)
    jb = jax_stage_series(series, BASE, counter_corrected=counter)
    pb = stage_series(series, BASE, counter_corrected=counter).to_device("cpu")
    assert pb.regular_ts is None and jb.ts.shape == pb.ts.shape
    return jb, pb


def group_ids(G: int, s_pad: int, seed: int) -> np.ndarray:
    """Real rows spread over G groups (each used), padded rows in group G."""
    rng = np.random.default_rng(seed)
    g = np.full(s_pad, G, np.int64)
    g[:N_SERIES] = rng.permutation(np.arange(N_SERIES) % G)
    return g


def jax_fused(func, op, ts, vals, raw, lens, gids, n_real, G, counter, start_off=START - BASE,
              step=STEP, window=WINDOW, num_steps=NUM_STEPS):
    return np.asarray(JAGG._fused_pallas_jit(
        func, ("agg", op), ts, vals, raw, lens, gids.astype(np.int32), np.int32(n_real),
        np.float32(0.0), np.int32(start_off), np.int32(step), np.int32(window),
        j_pad=pad_steps(num_steps), num_groups=G, is_counter=counter, is_delta=False,
        interpret=True))


def assert_close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=what)
    m = ~np.isnan(want)
    np.testing.assert_allclose(got[m], want[m], rtol=2e-4, atol=1e-4, err_msg=what)


@pytest.mark.parametrize("G", [1, 3, N_SERIES], ids=["G1", "G3", "GS"])
@pytest.mark.parametrize("counter", [False, True], ids=["gauge", "counter"])
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("func", sorted(WS.PALLAS_FUNCS))
def test_window_range_matches_fused_pallas(func, op, counter, G, monkeypatch):
    jb, pb = both_blocks(counter, seed=11 + sorted(WS.PALLAS_FUNCS).index(func))
    s_pad = pb.ts.shape[0]
    gids = group_ids(G, s_pad, seed=G)
    assert (gids == G).sum() == s_pad - N_SERIES > 0
    jraw = jb.raw if jb.raw is not None else jb.vals
    want = jax_fused(func, op, jb.ts, jb.vals, jraw, jb.lens, gids, N_SERIES, G, counter)
    monkeypatch.setattr(WS, "RANGE_LAUNCHES", 0)
    got = WS.window_range_aggregate(func, op, pb, torch.from_numpy(gids), G,
                                    RangeParams(START, STEP, NUM_STEPS, WINDOW),
                                    is_counter=counter).numpy()
    assert WS.RANGE_LAUNCHES == 0
    assert got.shape == (G, pad_steps(NUM_STEPS))
    assert np.isnan(got[:, NUM_STEPS:]).all()  # steps past the query are not computed
    assert_close(got[:, :NUM_STEPS], want[:, :NUM_STEPS], f"{op}({func})")
    assert not np.isnan(got[:, :NUM_STEPS]).all()


def edge_arrays(counter: bool):
    """Six rows by hand: tied timestamps at a window's first and last
    sample, a NaN sample, a row with no sample, and trash rows; the grid
    starts before the first sample (empty windows)."""
    S, T = 8, 128
    ts = np.full((S, T), 2**31 - 1, np.int32)
    vals = np.zeros((S, T), np.float32)
    lens = np.zeros(S, np.int32)
    rng = np.random.default_rng(5)
    for r in range(6):
        if r == 3:
            continue  # no sample
        n = 40 + 7 * r
        t = np.cumsum(rng.integers(5_000, 15_001, n)).astype(np.int64) + 100_000
        t[10] = t[9]  # a tie
        t[25:27] = t[24]  # a run of three
        ts[r, :n] = t
        v = np.cumsum(rng.uniform(0, 10, n)) if counter else 50 + 20 * rng.standard_normal(n)
        if not counter and r == 1:
            v[17] = np.nan
        vals[r, :n] = v
        lens[r] = n
    raw = (vals + 2.0).astype(np.float32) if counter else vals
    return ts, vals, raw, lens


@pytest.mark.parametrize("counter", [False, True], ids=["gauge", "counter"])
@pytest.mark.parametrize("func", ["rate", "increase", "delta", "sum_over_time", "min_over_time",
                                  "last", "first_over_time", "absent_over_time"])
def test_window_range_edges_match_fused_pallas(func, counter):
    ts, vals, raw, lens = edge_arrays(counter)
    gids = np.array([0, 1, 0, 1, 0, 1, 2, 2], np.int64)  # rows 6, 7: trash group 2
    start_off, step, num_steps = -120_000, 45_000, 30
    want = jax_fused(func, "sum", ts, vals, raw, lens, gids, 6, 2, counter,
                     start_off=start_off, step=step, num_steps=num_steps)
    block = block_from_arrays(ts, vals, lens, BASE, np.zeros(8, np.float32), 6,
                              raw=raw if counter else None, device="cpu")
    got = WS.window_range_aggregate(func, "sum", block, torch.from_numpy(gids), 2,
                                    RangeParams(BASE + start_off, step, num_steps, WINDOW),
                                    is_counter=counter).numpy()
    assert_close(got[:, :num_steps], want[:, :num_steps], func)


def test_fused_range_aggregate_takes_one_window_range_call(monkeypatch):
    """The window-stats rung is one call of window_range_aggregate: no
    nine-plane stats and no [S, J] grid."""
    _, pb = both_blocks(True, seed=3)
    calls = []
    real = WS.window_range_aggregate

    def counted(*a, **k):
        calls.append(a[0])
        return real(*a, **k)

    def forbidden(*a, **k):
        raise AssertionError("the nine-plane stats are not on the main path")

    monkeypatch.setattr(WS, "window_range_aggregate", counted)
    monkeypatch.setattr(WS, "window_stats", forbidden)
    gids = torch.from_numpy(group_ids(3, pb.ts.shape[0], seed=1))
    obs = {}
    out = AGG.fused_range_aggregate("rate", "sum", pb, gids, 3,
                                    RangeParams(START, STEP, NUM_STEPS, WINDOW),
                                    is_counter=True, obs=obs)
    assert calls == ["rate"] and obs == {"variant": "window_stats"}
    assert out.shape == (3, pad_steps(NUM_STEPS))


def test_window_range_rejects_bad_inputs():
    _, pb = both_blocks(False, seed=4)
    params = RangeParams(START, STEP, NUM_STEPS, WINDOW)
    gids = torch.zeros(pb.ts.shape[0], dtype=torch.int64)
    with pytest.raises(NotImplementedError):
        WS.window_range_aggregate("irate", "sum", pb, gids, 1, params)
    with pytest.raises(NotImplementedError):
        WS.window_range_aggregate("rate", "stddev", pb, gids, 1, params)
    with pytest.raises(TypeError):
        WS.window_range_aggregate("rate", "sum", pb, gids.to(torch.int32), 1, params)
    with pytest.raises(ValueError):
        WS.window_range_aggregate("rate", "sum", pb, gids[:5], 1, params)


def test_function_codes_cover_pallas_funcs():
    assert set(WS.WINDOW_FUNC_CODES) == WS.PALLAS_FUNCS == JAX_PALLAS_FUNCS
    assert WS.WINDOW_FUNC_CODES["last"] == WS.WINDOW_FUNC_CODES["last_over_time"]


@pytest.mark.parametrize("func,counter,is_delta,want", [
    ("count_over_time", True, False, 1), ("absent_over_time", False, False, 1),
    ("rate", True, False, 3), ("increase", True, False, 3), ("delta", True, False, 2),
    ("rate", False, False, 2), ("rate", True, True, 2), ("sum_over_time", True, False, 2),
])
def test_staged_arrays(func, counter, is_delta, want):
    """ts; vals unless the function only counts; raw for the counter cap."""
    assert WS.staged_arrays(func, counter, is_delta) == want


# ---- host side of the fused kernels ----

def test_tile_plan_picks_partials_from_groups_alone():
    small = GA.tile_plan(8, 111, 768, 3)
    big = GA.tile_plan(100_000, 111, 768, 3)
    assert small.partials == "shared" and big.partials == "global"
    edge = GA.PARTIALS_BUDGET // (2 * 111 * 4)
    assert GA.tile_plan(edge, 111, 768, 3).shared
    assert not GA.tile_plan(edge + 1, 111, 768, 3).shared


@pytest.mark.parametrize("span,n_arrays", [(128, 1), (768, 2), (768, 3), (4096, 3), (40_000, 1),
                                            (768, 0), (0, 0)])
def test_tile_plan_fits_shared_memory(span, n_arrays):
    plan = GA.tile_plan(8, 111, span, n_arrays)
    part = -(-2 * 8 * 111 * 4 // 16) * 16  # the C entry's rounding of the partials
    if plan.staged:
        assert plan.n_arrays == n_arrays
        assert 1 <= plan.rows <= GA.MAX_TILE_ROWS
        assert plan.smem_bytes == part + 2 * plan.rows * span * 4 * n_arrays
        assert plan.smem_bytes <= GA.BLOCK_SMEM
        assert plan.rows == GA.MAX_TILE_ROWS or plan.rows == 1 or (
            (plan.rows + 1) * 2 * span * 4 * n_arrays > GA.STAGE_BUDGET)
    else:
        assert n_arrays == 0 or part + 2 * span * 4 * n_arrays > GA.BLOCK_SMEM
        assert plan.n_arrays == 0 and plan.rows == GA.MAX_TILE_ROWS
        assert plan.smem_bytes == part
    assert plan.smem_bytes % 16 == 0


@pytest.mark.parametrize("G,rows,n_arrays", [(1, 2, 3), (8, 8, 0), (10_000, 3, 2)])
def test_layout_sizes_what_it_stages(G, rows, n_arrays):
    """``layout`` sizes the partials (shared only within the budget) and
    both buffers of ``rows`` rows of ``n_arrays`` arrays, as the C entries
    check it."""
    plan = GA.layout(G, 111, 768, n_arrays, rows)
    part = 2 * G * 111 * 4
    shared = part <= GA.PARTIALS_BUDGET
    assert plan.shared == shared and plan.rows == rows and plan.staged == (n_arrays > 0)
    assert plan.smem_bytes == (-(-part // 16) * 16 if shared else 0) + 2 * rows * 768 * 4 * n_arrays


def test_regular_plan_reads_in_place():
    """The regular kernel stages nothing: its plan reads rows in place at
    MAX_TILE_ROWS rows per tile, with shared partials while they fit."""
    plan = GA.tile_plan(8, 111, 0, 0)
    assert not plan.staged and plan.rows == GA.MAX_TILE_ROWS and plan.shared
    assert plan.smem_bytes == -(-2 * 8 * 111 * 4 // 16) * 16
    assert not GA.tile_plan(100_000, 111, 0, 0).shared


def test_accumulators_and_finish():
    acc, cnt = GA.accumulators("min", 2, 4, "cpu")
    assert acc.shape == cnt.shape == (3, 4) and torch.isinf(acc).all() and (cnt == 0).all()
    acc[0, 0], cnt[0, 0] = 5.0, 2.0
    acc[1, 1], cnt[1, 1] = 6.0, 3.0
    out = GA.finish_groups("avg", acc, cnt, 2)
    assert out.shape == (2, 4)
    assert out[0, 0] == 2.5 and out[1, 1] == 2.0 and torch.isnan(out[0, 1])
    assert GA.finish_groups("count", acc, cnt, 2)[1, 1] == 3.0


def test_check_aligned():
    x = torch.zeros((4, 128), dtype=torch.float32)
    GA.check_aligned(x=x)
    with pytest.raises(ValueError, match="16-byte"):
        GA.check_aligned(x=x.view(-1)[1:].view(-1)[: 4 * 127].view(4, 127))
    with pytest.raises(ValueError, match="16-byte"):
        GA.check_aligned(x=torch.zeros((4, 130), dtype=torch.float32))


def test_regular_rung_masks_steps_past_the_query():
    series = [(BASE + 3_000 + np.arange(150, dtype=np.int64) * 10_000,
               50 + np.arange(150, dtype=np.float64)) for _ in range(3)]
    pb = stage_series(series, BASE).to_device("cpu")
    gids = torch.tensor([0, 0, 1] + [2] * (pb.vals.shape[0] - 3))
    out = MK.regular_range_aggregate("sum_over_time", "sum", pb, gids, 2,
                                     RangeParams(START, STEP, NUM_STEPS, WINDOW))
    assert out.shape == (2, pad_steps(NUM_STEPS))
    assert np.isnan(out[:, NUM_STEPS:].numpy()).all()
    assert not np.isnan(out[:, :NUM_STEPS].numpy()).any()


@pytest.mark.parametrize("patch", tile_sweep.PATCHES, ids=["no_atomics", "no_search_hi",
                                                            "no_search_lo"])
def test_tile_sweep_patch_targets_are_in_the_sources(patch):
    """``tile_sweep.py --split`` patches these lines of csrc/: each must
    appear exactly once, or the split cannot build on the card."""
    fname, old, new = patch
    text = (cuda_build.CSRC / fname).read_text()
    assert text.count(old) == 1, f"{fname}: {old.strip()}"
    assert new != old


def test_build_digest_covers_headers(tmp_path):
    """An edit to a shared header changes every library's digest (and so
    rebuilds it); the digest needs no nvcc."""
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "shared.cuh").write_text("// v1\n")
    (tmp_path / "notes.txt").write_text("a")
    first = cuda_build.digest("k", tmp_path)
    assert cuda_build.digest("k", tmp_path) == first
    (tmp_path / "notes.txt").write_text("b")
    assert cuda_build.digest("k", tmp_path) == first
    (tmp_path / "shared.cuh").write_text("// v2\n")
    second = cuda_build.digest("k", tmp_path)
    assert second != first
    (tmp_path / "other.cuh").write_text("// new header\n")
    assert cuda_build.digest("k", tmp_path) != second
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\n// edited\n')
    assert cuda_build.digest("k", tmp_path) not in (first, second)


def test_build_digest_of_the_package_sources():
    for name in ("window_stats", "regular_range"):
        d = cuda_build.digest(name)
        assert len(d) == 12 and d != cuda_build.digest(
            "regular_range" if name == "window_stats" else "window_stats")
