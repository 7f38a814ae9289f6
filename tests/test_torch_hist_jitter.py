"""The histogram range kernel's jitter mode (B1) against the JAX package:
the port's plain version (``hist_kernels.hist_jitter_plain``) and its
wrapper dispatch (``aggregations.fused_hist_range_aggregate`` on the
``hist_jitter`` rung, the CPU wrapper running the plain version) against
``_fused_hist_jitter_jit`` on jittered histogram blocks, both packages fed
one window structure (the JAX ``_hist_jwm_args`` converted from numpy,
``mxu_jitter.JitterWindowMatrices.from_hist_args``).

Every histogram range function and ``is_delta`` form, the quantile fold on
and off, G = 1, 8 and S; NaN masks equal and values within rtol 2e-4 /
atol 1e-4 (the port sums a window in index order where the JAX package
differences f32 prefix sums). The blocks carry no NaN (ROADMAP C, "NaN in
histogram window sums"). A window not wider than twice the deviation bound
declines the jitter mode in both packages onto the general kernel."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from filodb_tpu.ops import aggregations as JAGG
from filodb_tpu.ops import hist_kernels as JHK
from filodb_tpu.ops import mxu_jitter as JMJ
from filodb_tpu.ops import staging as JST
from filodb_tpu_torch import metrics as M
from filodb_tpu_torch.ops import aggregations as AGG
from filodb_tpu_torch.ops import hist_kernels as HK
from filodb_tpu_torch.ops import mxu_jitter as MJ
from filodb_tpu_torch.ops import staging as ST
from filodb_tpu_torch.ops.kernels import RangeParams, pad_steps

BASE = 1_600_000_000_000
RTOL, ATOL = 2e-4, 1e-4
N_REAL, T_SAMPLES, B = 40, 120, 6
LES = np.array([0.1, 0.25, 0.5, 1.0, 5.0, np.inf])
INTERVAL, PHASE, JITTER = 10_000, 5_000, 500  # bench.py's fused_jitter: +-5 % of 10 s
# from before the first sample (empty windows) to past the last
PARAMS = RangeParams(BASE - 120_000, 60_000, 24, 300_000)
# (function, is_delta): is_delta changes only rate and increase (window sums)
CASES = [("rate", False), ("rate", True), ("increase", False), ("increase", True),
         ("delta", False), ("sum_over_time", False), ("last", False),
         ("last_over_time", False)]


def jittered_series(n=N_REAL, m=T_SAMPLES, seed=0):
    """Seeded cumulative histograms on a shared 10 s nominal grid, each
    sample within +-500 ms of it, every series the same length."""
    rng = np.random.default_rng(seed)
    nominal = BASE + PHASE + np.arange(m, dtype=np.int64) * INTERVAL
    out = []
    for _ in range(n):
        ts = nominal + rng.integers(-JITTER, JITTER + 1, m)
        incr = rng.poisson(2.0, size=(m, B)).astype(np.float64)
        incr[:, -1] = incr.sum(1)
        out.append((ts, np.cumsum(np.cumsum(incr, axis=1), axis=0)))
    return out


def blocks(seed=0):
    series = jittered_series(seed=seed)
    refs = [(0, i) for i in range(len(series))]
    port = ST.stage_histogram_series(series, BASE, B, refs).to_device("cpu")
    jblk = JST.stage_histogram_series(series, BASE, B, refs)
    assert ST.grid_class(port) == "jitter" and jblk.nominal_ts is not None
    return port, jblk


def jax_structure(jblk, params=PARAMS):
    return JMJ.jitter_window_matrices(jblk, int(params.start_ms - BASE), params.step_ms,
                                      pad_steps(params.num_steps), params.window_ms)


def shared_structure(jblk, jwm, params=PARAMS):
    return MJ.JitterWindowMatrices.from_hist_args(
        JAGG._hist_jwm_args(jwm), np.asarray(jblk.nominal_ts), params.window_ms,
        jblk.maxdev_ms, "cpu")


def gids_for(G: int, S: int):
    gids = np.full(S, G, np.int64)
    gids[:N_REAL] = np.arange(N_REAL) % G
    return gids


def jax_fused(func, jblk, jwm, gids, G, q, is_delta):
    qv = np.float32(q if q is not None else 0.0)
    return np.asarray(JHK._fused_hist_jitter_jit(
        func, jnp.asarray(jblk.vals), jnp.asarray(jblk.ts_dev), JAGG._hist_jwm_args(jwm),
        np.int32(PARAMS.window_ms), jnp.asarray(gids.astype(np.int32)),
        jnp.asarray(LES.astype(np.float32)), qv, G, is_delta, q is not None))


def assert_close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=f"{what}: NaN masks")
    m = ~np.isnan(want)
    np.testing.assert_allclose(got[m], want[m], rtol=RTOL, atol=ATOL, err_msg=what)


@pytest.fixture(scope="module")
def store():
    port, jblk = blocks()
    jwm = jax_structure(jblk)
    assert jwm.ok
    return port, jblk, jwm, shared_structure(jblk, jwm)


def test_port_structure_equals_the_jax_one(store):
    """The port's own window structure of the block is the table the JAX
    structure converts to (the second-to-last slot aside, which the
    histogram kernel does not read)."""
    port, jblk, jwm, shared = store
    own = AGG._hist_jitter_windows(port, PARAMS)
    assert own.ok
    keep = [w for w in range(MJ.STEP_WORDS) if w not in (4, 11, 18)]  # iL2, L2_rel, nL2
    a, b = own.steps.numpy(), shared.steps.numpy()
    np.testing.assert_array_equal(a[:, keep][:, :7], b[:, keep][:, :7])
    np.testing.assert_array_equal(a[:, 7] & ~2, b[:, 7] & ~2)  # c0ge2 aside
    np.testing.assert_array_equal(a[:, keep][:, 8:], b[:, keep][:, 8:])


@pytest.mark.parametrize("G", [1, 8, N_REAL], ids=["G1", "G8", "GS"])
@pytest.mark.parametrize("func,is_delta", CASES)
def test_plain_partials_match_jax(store, func, is_delta, G):
    port, jblk, jwm, shared = store
    gids = gids_for(G, port.vals.shape[0])
    acc, cnt = HK.hist_range_partials(func, port, torch.from_numpy(gids), G, PARAMS,
                                      is_delta=is_delta, jitter=shared)
    J, j_pad = PARAMS.num_steps, pad_steps(PARAMS.num_steps)
    got = torch.where(cnt > 0, acc, float("nan"))[:G].reshape(G, j_pad, B)
    want = jax_fused(func, jblk, jwm, gids, G, None, is_delta)
    assert_close(got.numpy()[:, :J], want[:, :J], f"{func} delta={is_delta} G={G}")
    assert not (cnt[:, J * B:] > 0).any()


@pytest.mark.parametrize("G", [1, 8, N_REAL], ids=["G1", "G8", "GS"])
@pytest.mark.parametrize("func,is_delta", CASES)
def test_quantile_fold_matches_jax(store, func, is_delta, G):
    port, jblk, jwm, shared = store
    gids = gids_for(G, port.vals.shape[0])
    out, _, _ = HK.hist_range_quantile(0.9, func, port, torch.from_numpy(gids), G, PARAMS,
                                       torch.tensor(LES, dtype=torch.float32),
                                       is_delta=is_delta, jitter=shared)
    want = jax_fused(func, jblk, jwm, gids, G, 0.9, is_delta)
    J = PARAMS.num_steps
    assert_close(out.numpy()[:, :J], want[:, :J], f"{func} delta={is_delta} G={G}")
    assert torch.isnan(out[:, J:]).all()


@pytest.mark.parametrize("q", [None, 0.5])
def test_wrapper_takes_the_jitter_rung(store, q):
    """The fused dispatch picks ``hist_jitter`` where the JAX ladder does and
    answers as ``_fused_hist_jitter_jit``; the CPU wrapper runs the plain
    version (no launch counted)."""
    port, jblk, jwm, _ = store
    G = 3
    gids = gids_for(G, port.vals.shape[0])
    obs = {}
    before = (HK.RANGE_LAUNCHES, HK.JITTER_LAUNCHES)
    got = AGG.fused_hist_range_aggregate(
        "rate", port, torch.from_numpy(gids), G, PARAMS, torch.tensor(LES, dtype=torch.float32),
        q=q, obs=obs)
    assert obs == {"variant": "hist_jitter"}
    assert (HK.RANGE_LAUNCHES, HK.JITTER_LAUNCHES) == before
    want = jax_fused("rate", jblk, jwm, gids, G, q, False)
    J = PARAMS.num_steps
    assert_close(got.numpy()[:, :J], want[:, :J], f"q={q}")


def test_narrow_window_declines_onto_the_general_kernel(store):
    """A window not wider than twice the deviation bound: the JAX structure
    is not ``ok`` and the port's ladder takes ``hist_general``, counting
    ``grid_jitter``; the answer equals the general kernel's."""
    port, jblk, _, _ = store
    narrow = RangeParams(PARAMS.start_ms, PARAMS.step_ms, PARAMS.num_steps,
                         2 * port.maxdev_ms)
    assert not jax_structure(jblk, narrow).ok
    key = ("filodb_fused_fallback", (("reason", "grid_jitter"),))
    before = M.REGISTRY.counter("filodb_fused_fallback", reason="grid_jitter").value
    assert AGG.hist_variant(port, narrow) == "hist_general"
    assert M.REGISTRY.counter("filodb_fused_fallback", reason="grid_jitter").value == before + 1
    assert key[0] in M.REGISTRY.expose()
    G = 2
    gids = torch.from_numpy(gids_for(G, port.vals.shape[0]))
    obs = {}
    got = AGG.fused_hist_range_aggregate("rate", port, gids, G, narrow,
                                         torch.tensor(LES, dtype=torch.float32), obs=obs)
    assert obs == {"variant": "hist_general"}
    acc, cnt = HK.hist_range_partials("rate", port, gids, G, narrow)
    j_pad = pad_steps(narrow.num_steps)
    want = torch.where(cnt > 0, acc, float("nan"))[:G].reshape(G, j_pad, B)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_tree_leaves_keep_the_general_kernel(store):
    """The tree asks the ladder without a query grid: a jittered histogram
    leaf takes the general kernel, as the JAX tree does."""
    port, _, _, _ = store
    assert AGG.hist_variant(port) == "hist_general"


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bench_hist_store(C, n_series: int):
    """chip_smoke's regular histogram store as its one-store loop drew
    it (bench.py's ``build_memstore_hist``): the reference for the shared
    draws."""
    from filodb_tpu_torch.core.records import SeriesBatch
    from filodb_tpu_torch.core.schemas import PROM_HISTOGRAM, Dataset, shard_for
    from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore
    from filodb_tpu_torch.memstore.shard import StoreConfig

    rng = np.random.default_rng(C.HIST_SEED)
    ts = C.BASE + np.arange(C.N_SAMPLES, dtype=np.int64) * 10_000
    ms = TimeSeriesMemStore(StoreConfig(max_chunk_size=C.N_SAMPLES))
    ms.setup(Dataset("prometheus"), range(C.N_SHARDS))
    for b0 in range(0, n_series, 2_000):
        n = min(2_000, n_series - b0)
        incr = rng.poisson(2.0, size=(n, C.N_SAMPLES, C.N_BUCKETS)).astype(np.float64)
        incr[..., -1] = incr.sum(-1)
        hist = np.cumsum(np.cumsum(incr, axis=2), axis=1)
        total = np.cumsum(rng.uniform(0, 5, size=(n, C.N_SAMPLES)), axis=1)
        for i in range(n):
            tags = C.hist_tags(b0 + i)
            ms.shard("prometheus", shard_for(tags, spread=C.SPREAD, num_shards=C.N_SHARDS)
                     ).ingest_series(SeriesBatch(
                         PROM_HISTOGRAM, tags, ts,
                         {"sum": total[i], "count": hist[i][..., -1], "h": hist[i]},
                         bucket_les=C.HIST_LES))
    return ms


def test_shared_draws_keep_the_regular_store_bit_equal():
    """The store built in the same pass as the jittered one (one draw of
    each block, ingested twice) is bit for bit the store of bench.py's
    draws; the jittered store carries the same bucket counts on its own
    near-regular timestamps (+-5 % of 10 s around a 5 s phase)."""
    C = _chip_smoke()
    n = 2_500  # two blocks of draws, the second partial
    stores = C.build_memstore_hists(n, ("regular", "jitter"))
    want = _bench_hist_store(C, n)
    for sn in want.shard_nums("prometheus"):
        a = stores["regular"].shard("prometheus", sn).partitions
        b = want.shard("prometheus", sn).partitions
        j = stores["jitter"].shard("prometheus", sn).partitions
        assert [p.tags for p in a.values()] == [p.tags for p in b.values()]
        for pid, p in b.items():
            for col in ("h", "sum", "count"):
                t1, v1 = a[pid].samples_in_range(0, 2**62, col)
                t0, v0 = p.samples_in_range(0, 2**62, col)
                np.testing.assert_array_equal(t1, t0)
                np.testing.assert_array_equal(v1, v0)
            tj, hj = j[pid].samples_in_range(0, 2**62, "h")
            np.testing.assert_array_equal(hj, p.samples_in_range(0, 2**62, "h")[1])
            dev = tj - (t0 + C.JITTER_PHASE_MS)
            assert np.abs(dev).max() <= 500 and dev.any()
