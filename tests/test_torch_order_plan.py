"""Host side and plain twins of the order-statistics kernels
(``csrc/order_stats.cu``, ``csrc/order_select.cuh``) on the CPU.

- The launch plan (``order_stats.order_plan``): every key of a segment in
  one block's slice, the shared bytes within a block's 232,448, at most
  ``MAX_CLUSTER`` blocks a cluster, the route from the segment's size
  alone, and the thread path's tiles covering (groups x steps) once.
- Plain twins, restated here in numpy, of the kernels' own arithmetic:
  the cluster's radix select (``cluster_select``: per-slice 256-bin
  histograms merged into one digit choice per pass, with the counts of the
  slices of lower rank), topk's compaction (``topk_twin``: slots from
  counters, the threshold's ties taken in index order across the slices)
  and the quantile (``quantile_twin``: the select, ``next_above``, the
  counting rank of small groups), held against ``topk_steps_plain`` /
  ``segment_quantile_plain`` and against the JAX ``_apply_epilogue`` topk
  arm, ``topk_mask`` and ``segment_quantile``, on columns made by numpy
  from a seed with ties, all-NaN and all-equal steps, +-0 and +-inf, k in
  {1, 5, n - 1, n, past n, past S} and 1-8 slices.

Tolerance as the epilogue tests hold the plain versions to JAX: winner
sets and values bit-equal; selected quantiles (a whole rank) bit-equal;
interpolated ones within 2 ulp (XLA may fuse the multiply and add on the
CPU; the twin, the plain version and the kernel round them apart).
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from filodb_tpu.ops import aggregations as JAGG
from filodb_tpu_torch.ops import cuda_build
from filodb_tpu_torch.ops import group_acc as GA
from filodb_tpu_torch.ops import order_stats as OS

_spec = importlib.util.spec_from_file_location(
    "tile_sweep", Path(__file__).resolve().parents[1] / "tile_sweep.py")
tile_sweep = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tile_sweep)

ABSENT = np.uint32(0xFFFFFFFF)
BLOCK_SMEM = 232_448  # shared memory a block may use on the card
STATIC_SMEM = 8_192  # the kernels' static shared memory is well inside this (Scratch)


# -- the launch plan ----------------------------------------------------------------

TOPK_SIZES = (0, 1, 2, 16, 17, 1000, 16_383, 16_384, 16_385, 32_769, 100_000, 131_072,
              393_215, 393_216, 393_217, 1_048_576)


def slices_of(n: int, plan) -> list[range]:
    """The index ranges of a segment of n keys the plan's blocks read, as
    the kernel cuts them (block c: [c * slice, min(n, (c + 1) * slice)))."""
    return [range(min(n, c * plan.slice), min(n, (c + 1) * plan.slice))
            for c in range(plan.cluster)]


@pytest.mark.parametrize("J", [1, 111])
@pytest.mark.parametrize("n", TOPK_SIZES)
def test_topk_plan_covers_each_key_once(n, J):
    """The slices partition [0, n); the shared bytes hold the slice's keys
    on the staged route (none on the streaming one) within a block's
    budget; at most MAX_CLUSTER blocks a cluster; J clusters."""
    plan = OS.order_plan("topk_steps", n, J)
    covered = [i for r in slices_of(n, plan) for i in r]
    assert covered == list(range(n))
    assert 1 <= plan.cluster <= OS.MAX_CLUSTER and plan.blocks == J * plan.cluster
    assert plan.smem_bytes + STATIC_SMEM <= BLOCK_SMEM
    if plan.route == "staged":
        assert plan.smem_bytes == 4 * plan.slice and plan.slice <= OS.MAX_SLICE
        assert plan.threads == OS.THREADS
    else:
        assert plan.route == "stream" and plan.smem_bytes == 0 and plan.slice > OS.MAX_SLICE
        assert plan.cluster == OS.MAX_CLUSTER and plan.threads == OS.STREAM_THREADS
    # the least cluster whose slices hold at most SLICE_TARGET keys, up to 8
    assert plan.cluster == 1 or -(-n // (plan.cluster // 2)) > OS.SLICE_TARGET
    assert plan.cluster == OS.MAX_CLUSTER or plan.slice <= OS.SLICE_TARGET
    assert plan.thread_segments == 0 and plan.block_segments == 1


@pytest.mark.parametrize("n", TOPK_SIZES)
def test_route_follows_the_segment_size_alone(n):
    """Steps, k and the kernel do not move a segment's route, cluster or
    shared bytes: a topk column of n series and a quantile group of n
    members plan alike."""
    layout = {(p.route, p.cluster, p.smem_bytes, p.slice)
              for p in (OS.order_plan("topk_steps", n, J) for J in (1, 7, 111, 1000))}
    assert len(layout) == 1
    if n > OS.SMALL_SEGMENT:
        gids = torch.zeros(n, dtype=torch.int64)
        q = OS.order_plan("segment_quantile", OS.segment_members(gids, 1), 111)
        assert {(q.route, q.cluster, q.smem_bytes, q.slice)} == layout


GROUPINGS = {  # name -> gids over 3000 rows (-1 = padded), groups
    "one": (np.zeros(3000, np.int64), 1),
    "zones": (np.arange(3000) % 8, 8),
    "instances": (np.arange(3000), 3000),
    "mixed": (np.minimum(np.random.default_rng(4).zipf(1.3, 3000), 400) - 1, 400),
    "one_large_rest_small": (np.where(np.arange(3000) < 2500, 0, 1 + np.arange(3000) % 77), 78),
}


def tile_cover(plan, n_small: int, J: int) -> np.ndarray:
    """How often the kernel's thread-path blocks (block gt: small groups
    gt * 32 .., every step, walked in tiles of 32 steps) write each (small
    group, step)."""
    tg, ts = plan.tile
    blocks = -(-n_small // tg)
    assert plan.blocks - plan.block_segments * J * plan.cluster >= blocks
    hits = np.zeros((n_small, J), np.int64)
    for gt in range(blocks):
        for j0 in range(0, J, ts):
            g = np.arange(gt * tg, (gt + 1) * tg)
            j = np.arange(j0, j0 + ts)
            g, j = g[g < n_small], j[j < J]
            hits[np.ix_(g, j)] += 1
    return hits


@pytest.mark.parametrize("J", [1, 17, 111])
@pytest.mark.parametrize("grouping", sorted(GROUPINGS))
def test_quantile_plan_covers_groups_and_steps(grouping, J):
    """Large groups: a cluster per (group, step) sized by the largest group,
    its slices holding every member; small groups: tiles covering each
    (group, step) once; blocks a whole number of clusters."""
    gids, G = GROUPINGS[grouping]
    members = OS.segment_members(torch.from_numpy(gids), G)
    plan = OS.order_plan("segment_quantile", members, J)
    sizes = np.bincount(gids[gids >= 0], minlength=G)
    assert members.large_max == (sizes[sizes > OS.SMALL_SEGMENT].max(initial=0))
    assert (plan.block_segments, plan.thread_segments) == (int((sizes > 16).sum()),
                                                           int((sizes <= 16).sum()))
    assert plan.blocks % plan.cluster == 0 and plan.smem_bytes + STATIC_SMEM <= BLOCK_SMEM
    for n in sizes[sizes > OS.SMALL_SEGMENT]:
        assert [i for r in slices_of(int(n), plan) for i in r] == list(range(n))
    if plan.block_segments == 0:
        assert plan.route == "thread" and plan.cluster == 1 and plan.smem_bytes == 0
        assert plan.threads == OS.THREADS
    assert (tile_cover(plan, plan.thread_segments, J) == 1).all()


@pytest.mark.parametrize("threads", [32, 512, 1024])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_plan_overrides_keep_the_shared_bytes_rule(cluster, threads):
    """A forced cluster or block size (``tile_sweep.py --order``) still
    stages a slice only where it fits, as the C entry counts it."""
    plan = OS.order_plan("topk_steps", 100_000, 111, cluster=cluster, threads=threads)
    assert (plan.cluster, plan.threads, plan.blocks) == (cluster, threads, 111 * cluster)
    assert plan.slice == -(-100_000 // cluster) + 3 & ~3 and plan.slice % 4 == 0
    assert plan.smem_bytes == (4 * plan.slice if plan.slice <= OS.MAX_SLICE else 0)
    assert plan.route == ("staged" if plan.smem_bytes else "stream")


def test_plan_refuses_what_the_entries_refuse():
    with pytest.raises(ValueError, match="cluster"):
        OS.order_plan("topk_steps", 1000, 4, cluster=16)
    with pytest.raises(ValueError, match="kernel"):
        OS.order_plan("sort", 1000, 4)


@pytest.mark.parametrize("name", ["SMALL", "MAX_SLICE", "TILE_GROUPS", "TILE_STEPS"])
def test_plan_constants_are_the_kernels(name):
    """The plan's constants are the ones the kernel source compiles in."""
    want = {"SMALL": OS.SMALL_SEGMENT, "MAX_SLICE": OS.MAX_SLICE, "TILE_GROUPS": OS.TILE[0],
            "TILE_STEPS": OS.TILE[1]}[name]
    text = (cuda_build.CSRC / "order_stats.cu").read_text()
    assert f"constexpr int {name} = {want};" in text
    header = (cuda_build.CSRC / "order_select.cuh").read_text()
    assert f"constexpr int MAX_CLUSTER = {OS.MAX_CLUSTER};" in header


# -- plain twins of the kernels' arithmetic -----------------------------------------


def key_of(x: np.ndarray) -> np.ndarray:
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def value_of(k: np.ndarray) -> np.ndarray:
    k = np.asarray(k, np.uint32)
    return np.where(k & 0x80000000, k & 0x7FFFFFFF, ~k).astype(np.uint32).view(np.float32)


def topk_key(v: np.ndarray, bottom: bool) -> np.ndarray:
    x = np.where(np.isnan(v), np.float32(-np.inf), -v if bottom else v).astype(np.float32)
    return ~key_of(x)


def quantile_key(v: np.ndarray) -> np.ndarray:
    return np.where(np.isnan(v), ABSENT, key_of(np.where(np.isnan(v), 0, v))).astype(np.uint32)


def cluster_select(slices: list[np.ndarray], rank_of) -> dict:
    """``order_select::select`` over a cluster: each pass, each slice's
    256-bin histogram of its keys matching the prefix; the digit holding
    the rank from their sum; the slices of lower rank's counts below and
    equal carried per slice."""
    C = len(slices)
    absent = sum(int((s == ABSENT).sum()) for s in slices)
    rank = rank_of(absent)
    prefix, mask, below = 0, 0, 0
    below_before = np.zeros(C, np.int64)
    for shift in (24, 16, 8, 0):
        hists = np.stack([np.bincount((s[(s & mask) == prefix] >> shift) & 255, minlength=256)
                          for s in slices])  # [C, 256]: one per block
        total = hists.sum(axis=0)
        before = np.cumsum(hists, axis=0) - hists  # the blocks of lower rank
        incl = np.cumsum(total)
        digit = int(np.searchsorted(incl, rank - below, side="right"))
        below += int(incl[digit] - total[digit])
        below_before += before[:, :digit].sum(axis=1)
        prefix |= digit << shift
        mask |= 255 << shift
    return {"key": np.uint32(prefix), "below": below, "equal": int(total[digit]),
            "below_before": below_before, "equal_before": before[:, digit],
            "equal_own": hists[:, digit], "absent": absent}


def cut(keys: np.ndarray, C: int) -> list[np.ndarray]:
    size = -(-len(keys) // C)
    return [keys[c * size:(c + 1) * size] for c in range(C)]


def topk_twin(col: np.ndarray, k: int, bottom: bool, C: int):
    """``topk_column`` over one step's n real values in C slices: the
    padded slots past n by index; keys better than the threshold from a
    counter per slice at the slice's offset; of the equal ones the first
    take_eq in index order. Returns ([k] values, [k] indices) and asserts
    that the slots are filled exactly once."""
    n = len(col)
    kr = min(k, n)
    vals = np.full(k, np.nan, np.float32)
    idx = np.full(k, -1, np.int64)
    idx[kr:] = np.arange(kr, k)
    if kr == 0:
        return vals, idx
    slices = cut(topk_key(col, bottom), C)
    sel = cluster_select(slices, lambda absent: kr - 1)
    take_eq = kr - sel["below"]
    filled = np.zeros(k, np.int64)
    filled[kr:] = 1
    for c, s in enumerate(slices):
        i0 = c * -(-n // C)
        room = take_eq - int(sel["equal_before"][c])
        lt = np.nonzero(s < sel["key"])[0]
        eq = np.nonzero(s == sel["key"])[0]
        eq = eq if room >= len(eq) else eq[:max(room, 0)]  # the straddler keeps index order
        for slot, i in [*zip(sel["below_before"][c] + np.arange(len(lt)), lt),
                        *zip(sel["below"] + sel["equal_before"][c] + np.arange(len(eq)), eq)]:
            x = value_of(~s[i])
            v = -x if bottom else x
            vals[slot] = v if np.isfinite(v) else np.nan
            idx[slot] = i0 + i
            filled[slot] += 1
    assert (filled == 1).all(), "the compaction's slots collide or leave a hole"
    return vals, idx


def small_rank_twin(keys: np.ndarray, q: float) -> float:
    """The thread path: each member's position is the count of keys below
    it and of equal keys before it."""
    n = len(keys)
    count = int((keys != ABSENT).sum())
    lo, hi, rank = rank_for(q, count)
    pos = [int(((keys < keys[i]) | ((keys == keys[i]) & (np.arange(n) < i))).sum())
           for i in range(n)]
    k_lo = keys[pos.index(lo)] if lo in pos else ABSENT
    k_hi = keys[pos.index(hi)] if hi in pos else ABSENT
    return interpolate(count, rank, k_lo, k_hi)


def rank_for(q: float, count: int):
    qc = np.float32(min(max(q, 0.0), 1.0)) if not np.isnan(q) else np.float32(np.nan)
    rank = qc * max(np.float32(count) - np.float32(1), np.float32(0))
    if np.isnan(rank):
        return 0, 0, rank
    return int(np.floor(rank)), int(np.ceil(rank)), rank


def interpolate(count: int, rank, k_lo, k_hi) -> float:
    if count <= 0:
        return np.float32(np.nan)
    v_lo, v_hi = value_of(k_lo), value_of(k_hi)
    with np.errstate(invalid="ignore"):
        return np.float32(v_lo + (v_hi - v_lo) * (rank - np.floor(rank)))


def quantile_twin(grid: np.ndarray, members, q: float, C: int | None = None) -> np.ndarray:
    """``segment_quantile_kernel`` on a [J, S] grid: large groups by the
    cluster select over C slices (default the plan's) and next_above,
    small groups by the counting rank."""
    perm, starts = members.perm.numpy(), members.starts.numpy()
    G, J = members.num_groups, grid.shape[0]
    out = np.full((G, J), np.nan, np.float32)
    for g in range(G):
        mem = perm[starts[g]:starts[g + 1]]
        n = len(mem)
        for j in range(J):
            keys = quantile_key(grid[j, mem])
            if n <= OS.SMALL_SEGMENT:
                out[g, j] = small_rank_twin(keys, q)
                continue
            slices = cut(keys, C or OS.cluster_for(n))
            r = {}

            def rank_of(absent):
                r["count"] = n - absent
                r["lo"], r["hi"], r["rank"] = rank_for(q, r["count"])
                return r["lo"]

            sel = cluster_select(slices, rank_of)
            k_hi = sel["key"]
            if r["hi"] > r["lo"] and r["hi"] >= sel["below"] + sel["equal"]:
                above = keys[keys > sel["key"]]
                k_hi = above.min() if len(above) else ABSENT
            out[g, j] = interpolate(r["count"], r["rank"], sel["key"], k_hi)
    return out


KINDS = ("normal", "ties", "nan", "inf_zeros", "equal")


def column_grid(kind: str, S: int, J: int, n_real: int, seed: int) -> np.ndarray:
    """A seeded [S, J] f32 grid (rows past n_real hold values the n_real
    mask must hide): normal values; small integers (exact ties); NaN-heavy
    with an all-NaN step; +-inf and signed zeros mixed in; or one value
    everywhere (every key a tie)."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        v = rng.integers(0, 4, (S, J)).astype(np.float32)
    elif kind == "equal":
        v = np.full((S, J), 2.5, np.float32)
    else:
        v = (50 + 20 * rng.standard_normal((S, J))).astype(np.float32)
    if kind == "nan":
        v[rng.random((S, J)) < 0.4] = np.nan
        v[:, min(1, J - 1)] = np.nan  # an all-NaN step
    if kind == "inf_zeros":
        for x, p in ((np.inf, 0.15), (-np.inf, 0.15), (0.0, 0.1), (-0.0, 0.1), (np.nan, 0.1)):
            v[rng.random((S, J)) < p] = x
    v[n_real:] = 7.0
    return v


@pytest.mark.parametrize("C", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("kind", KINDS)
def test_cluster_select_is_the_rank_th_key(kind, C):
    """Per-slice histograms merged into one digit choice give the rank-th
    smallest key of the whole segment, with its counts below and equal, and
    each slice's share of them among the slices before it."""
    keys = topk_key(column_grid(kind, 203, 1, 203, seed=C)[:, 0], False)
    order = np.sort(keys)
    slices = cut(keys, C)
    for rank in (0, 1, 101, 201, 202):
        sel = cluster_select(slices, lambda absent: rank)
        assert sel["key"] == order[rank]
        assert sel["below"] == int((keys < sel["key"]).sum())
        assert sel["equal"] == int((keys == sel["key"]).sum())
        for c, s in enumerate(slices):
            lower = np.concatenate([np.zeros(0, np.uint32), *slices[:c]])
            assert sel["below_before"][c] == int((lower < sel["key"]).sum())
            assert sel["equal_before"][c] == int((lower == sel["key"]).sum())
            assert sel["equal_own"][c] == int((s == sel["key"]).sum())


N_REAL, S_PAD, J = 61, 72, 5


def port_store_grid(v: np.ndarray) -> torch.Tensor:
    gids = np.ones(S_PAD, np.int64)
    gids[:N_REAL] = 0
    return GA.series_grid(torch.from_numpy(v), torch.from_numpy(gids), 1, J)


def winners(vals: np.ndarray, idx: np.ndarray) -> list[dict]:
    return [{int(i): np.float32(x).view(np.int32).item() for i, x in zip(idx[:, j], vals[:, j])}
            for j in range(vals.shape[1])]


@pytest.mark.parametrize("C", [1, 3, 8])
@pytest.mark.parametrize("k", [1, 5, "n-1", "n", "past_n", "past_S"])
@pytest.mark.parametrize("kind", KINDS)
def test_topk_twin_matches_plain_and_jax(kind, k, C):
    """The kernel's select and compaction, restated, give the winner sets
    and the values (bit for bit) of ``topk_steps_plain`` and of the JAX
    topk arm (``lax.top_k``), top and bottom, k capped at S."""
    v = column_grid(kind, S_PAD, J, N_REAL, seed=len(kind) + C)
    k = {"n-1": N_REAL - 1, "n": N_REAL, "past_n": N_REAL + 4, "past_S": S_PAD + 5}.get(k, k)
    kc = min(k, S_PAD)
    for bottom in (False, True):
        grid = port_store_grid(v)
        twin = [topk_twin(grid[j, :N_REAL].numpy(), kc, bottom, C) for j in range(J)]
        tv = np.stack([t[0] for t in twin], axis=1)
        ti = np.stack([t[1] for t in twin], axis=1)
        pv, pi = OS.topk_steps_plain(grid, kc, bottom)
        jv, ji = JAGG._apply_epilogue(jnp.asarray(v), ("topk", k, bottom),
                                      jnp.zeros(S_PAD, jnp.int32), N_REAL, jnp.float32(0.0), 1)
        want = winners(pv.numpy(), pi.numpy())
        assert winners(tv, ti) == want, f"bottom={bottom}"
        assert winners(np.asarray(jv), np.asarray(ji)) == want, f"bottom={bottom}"


def jax_quantile(v: np.ndarray, g: np.ndarray, G: int, q: float) -> np.ndarray:
    return np.asarray(JAGG._apply_epilogue(jnp.asarray(v), ("quantile",), jnp.asarray(g),
                                           N_REAL, jnp.float32(q), G))


def assert_same_bits(got: np.ndarray, want: np.ndarray) -> None:
    """NaN masks equal and every other value bit-equal (signs of zeros too;
    a NaN's sign and payload are free)."""
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    m = ~np.isnan(want)
    np.testing.assert_array_equal(got[m].view(np.int32), want[m].view(np.int32))


QUANTILE_GROUPINGS = {  # name -> (gids over the N_REAL real rows, G)
    "one": (np.zeros(N_REAL, np.int32), 1),
    "pairs_and_one_large": (np.where(np.arange(N_REAL) < 40, 0, 1 + np.arange(N_REAL) % 7), 8),
    "singletons": (np.arange(N_REAL, dtype=np.int32), N_REAL),
    "with_empty": (np.where(np.arange(N_REAL) % 3 == 0, 0, 3).astype(np.int32), 5),
}


@pytest.mark.parametrize("C", [1, 4, 8])
@pytest.mark.parametrize("q", [0.0, 0.5, 0.99, 1.0, -1.0, 2.0, float("nan")])
@pytest.mark.parametrize("grouping", sorted(QUANTILE_GROUPINGS))
def test_quantile_twin_matches_plain_and_jax(grouping, q, C):
    """The kernel's select, next_above and counting rank, restated, give
    ``segment_quantile_plain``'s quantiles bit for bit, and the JAX
    ``segment_quantile``'s (selected ranks bit-equal, interpolated within
    2 ulp), over values with ties, +-inf, +-0 and NaN."""
    gid_real, G = QUANTILE_GROUPINGS[grouping]
    g = np.full(S_PAD, G, np.int32)
    g[:N_REAL] = gid_real
    v = column_grid("inf_zeros" if C != 4 else "ties", S_PAD, J, N_REAL, seed=G + C)
    gids = torch.from_numpy(g.astype(np.int64))
    grid = GA.series_grid(torch.from_numpy(v), gids, G, J)
    members = OS.segment_members(gids, G)
    twin = quantile_twin(grid.numpy(), members, q, C)
    plain = OS.segment_quantile_plain(grid, members, q).numpy()
    assert_same_bits(twin, plain)
    want = jax_quantile(v, g, G, q)
    np.testing.assert_array_equal(np.isnan(twin), np.isnan(want))
    fin = np.isfinite(want)
    np.testing.assert_array_max_ulp(twin[fin], want[fin], maxulp=2)
    np.testing.assert_array_equal(twin[~fin & ~np.isnan(want)], want[~fin & ~np.isnan(want)])


@pytest.mark.parametrize("value", [np.inf, -np.inf, 0.0, -0.0, 3.5, np.nan])
def test_a_group_of_one_is_interpolated_not_copied(value):
    """A lone member goes through v + (v - v) * 0: +-inf gives NaN, as the
    JAX formula does; a finite value and a zero come back (+0 for -0)."""
    v = np.full((S_PAD, J), np.float32(value), np.float32)
    g = np.full(S_PAD, N_REAL, np.int32)
    g[:N_REAL] = np.arange(N_REAL)
    gids = torch.from_numpy(g.astype(np.int64))
    grid = GA.series_grid(torch.from_numpy(v), gids, N_REAL, J)
    members = OS.segment_members(gids, N_REAL)
    twin = quantile_twin(grid.numpy(), members, 0.5)
    want = jax_quantile(v, g, N_REAL, 0.5)
    assert_same_bits(twin, want)
    assert_same_bits(twin, OS.segment_quantile_plain(grid, members, 0.5).numpy())
    assert np.isnan(twin).all() == (not np.isfinite(value))


# -- segment_topk's step route: its plan and a twin of its selection ---------------------

STEP_GROUP_SIZES = (*range(1, 18), 31, 32, 33, 34, 64, 100, 999, 1000, 1001, 1034, 5000)


def step_members(sizes, seed: int):
    """Members of groups of the given sizes, their series interleaved at
    random (zones interleave so), and the column count."""
    rng = np.random.default_rng(seed)
    gids = rng.permutation(np.repeat(np.arange(len(sizes)), sizes))
    return OS.segment_members(torch.from_numpy(gids.astype(np.int64)), len(sizes)), len(gids)


@pytest.mark.parametrize("J", [1, 111])
@pytest.mark.parametrize("n", [0, 1, 17, 12_500, 24_575, 24_576, 24_577, 100_000])
def test_segment_topk_takes_the_step_route_while_a_block_stages_the_column(n, J):
    """One block a step, cluster 1, the column's keys (in column and in
    group order) and its kept bitmap in whole 16-byte groups, while the
    column fits STEP_KEYS keys; past it the per-group route of a cluster
    per (large group, step)."""
    gids = torch.from_numpy(np.arange(n) % 8)
    members = OS.segment_members(gids, 8)
    plan = OS.order_plan("segment_topk", members, J)
    if n <= OS.STEP_KEYS:
        assert (plan.route, plan.cluster, plan.blocks, plan.slice) == ("step", 1, J, n)
        assert plan.threads == OS.STEP_THREADS
        assert plan.smem_bytes == 8 * ((n + 3) // 4 * 4) + 4 * ((-(-n // 32) + 3) // 4 * 4)
        assert plan.smem_bytes + STATIC_SMEM <= BLOCK_SMEM and plan.smem_bytes % 16 == 0
        assert (plan.block_segments, plan.thread_segments) == (
            members.large.numel(), members.small.numel())
    else:
        assert plan.route in ("staged", "stream") and plan.blocks >= 8 * J
    text = (cuda_build.CSRC / "order_stats.cu").read_text()
    assert f"constexpr int STEP_THREADS = {OS.STEP_THREADS};" in text
    assert f"constexpr int STEP_KEYS = {OS.STEP_KEYS};" in text


@pytest.mark.parametrize("by_step", [True, False])
def test_segment_topk_route_can_be_forced(by_step):
    """``by_step`` overrides the plan (the sweep times the per-group route
    beside the step route); the step route refuses a column past MAX_SLICE
    and blocks past STEP_THREADS threads."""
    members, _ = step_members((20, 30, 5), 0)
    plan = OS.order_plan("segment_topk", members, 7, by_step=by_step)
    assert (plan.route == "step") == by_step
    if not by_step:  # a cluster per (large group, step), a thread per (small group, step)
        assert plan.route == "staged" and plan.blocks == 2 * 7 + 1
    big = OS.segment_members(torch.zeros(OS.STEP_KEYS + 1, dtype=torch.int64), 1)
    with pytest.raises(ValueError, match="stages at most"):
        OS.order_plan("segment_topk", big, 3, by_step=True)
    with pytest.raises(ValueError, match="threads"):
        OS.order_plan("segment_topk", members, 3, threads=512, by_step=True)
    with pytest.raises(ValueError, match="takes k up to"):
        OS.order_plan("segment_topk", members, 3, by_step=True, k=OS.STEP_MAX_K + 1)


@pytest.mark.parametrize("k", [1, 3, 16, 32, 33, 1000])
def test_segment_topk_route_follows_k(k):
    """k up to STEP_MAX_K (a lane's sorted list of pairs in registers)
    takes the step route; past it the per-group route, whose selects
    measured faster than the block's one group after another."""
    members, _ = step_members((20, 30, 5), 0)
    plan = OS.order_plan("segment_topk", members, 7, k=k)
    assert (plan.route == "step") == (k <= OS.STEP_MAX_K)
    text = (cuda_build.CSRC / "order_stats.cu").read_text()
    assert f"constexpr int STEP_MAX_K = {OS.STEP_MAX_K};" in text


def kmax_of(k: int) -> int:
    """The kernel's template: the least power of two >= k (k <= STEP_MAX_K)."""
    m = 1
    while m < k:
        m *= 2
    return m


def topk_value_twin(key: np.ndarray, bottom: bool) -> np.ndarray:
    x = value_of(~np.asarray(key, np.uint32))
    v = -x if bottom else x
    return np.where(np.isfinite(v), v, np.float32(np.nan)).astype(np.float32)


def threshold_twin(key, bottom: bool) -> np.float32:
    x = value_of(~np.uint32(key))
    return np.float32(-x if bottom else x)


def step_twin(col: np.ndarray, members, k: int, bottom: bool):
    """``segment_topk_step_kernel`` on one step's column of n values (k <=
    STEP_MAX_K): ([n] kept values, [G] thresholds). Keys as ``topk_key``,
    gathered into group order; a group of at most SMALL members ranks each
    by counting (better keys, and equal keys earlier in member order); a
    larger one of at most k members keeps all (threshold its worst key);
    else each of 32 lanes keeps the KMAX least (key, position) pairs of
    the run's entries lane, lane + 32, ... and the warp pops the least
    head k times (the kernel's tau only drops pairs no better than a lane's
    KMAX-th best, which cannot be among the k popped)."""
    keys = topk_key(col, bottom)
    n = len(col)
    perm, starts = members.perm.numpy(), members.starts.numpy()
    kept = np.zeros(n, bool)
    thr = np.full(members.num_groups, np.nan, np.float32)
    kmax = kmax_of(k)
    for g in range(members.num_groups):
        mem = perm[starts[g]:starts[g + 1]]
        size = len(mem)
        kr = min(k, size)
        if size == 0:
            continue
        gk = keys[mem]
        if size <= OS.SMALL_SEGMENT:
            pos = np.array([int(((gk < gk[i]) | ((gk == gk[i]) & (np.arange(size) < i))).sum())
                            for i in range(size)])
            kept[mem[pos < kr]] = True
            thr[g] = threshold_twin(gk[pos == kr - 1][0], bottom)
        elif size <= k:
            kept[mem] = True
            thr[g] = threshold_twin(gk.max(), bottom)
        elif k <= kmax:
            pairs = (gk.astype(np.uint64) << np.uint64(32)) | np.arange(size, dtype=np.uint64)
            lanes = [np.sort(pairs[lane::32])[:kmax] for lane in range(32)]
            heads = [0] * 32
            last = None
            for _ in range(k):  # the warp's least head, popped
                cand = [(lanes[l][heads[l]], l) for l in range(32) if heads[l] < len(lanes[l])]
                last, lane = min(cand)
                heads[lane] += 1
                kept[mem[int(last & np.uint64(0xFFFFFFFF))]] = True
            thr[g] = threshold_twin(int(last >> np.uint64(32)), bottom)
        else:
            raise ValueError(f"the step route takes k up to {OS.STEP_MAX_K}, not {k}")
    out = np.where(kept, topk_value_twin(keys, bottom), np.float32(np.nan)).astype(np.float32)
    return out, thr


def step_grid(J: int, n: int, seed: int) -> np.ndarray:
    """[J, n] values with ties (one decimal), +-0, +-inf and NaN; step 0
    all equal, step 1 all NaN, step 2 only signed zeros."""
    rng = np.random.default_rng(seed)
    v = np.round(rng.uniform(-2, 2, (J, n)), 1).astype(np.float32)
    for x, p in ((np.nan, 0.05), (0.0, 0.05), (-0.0, 0.05), (np.inf, 0.01), (-np.inf, 0.01)):
        v[rng.random((J, n)) < p] = x
    v[0] = 1.5
    if J > 2:
        v[1] = np.nan
        v[2] = np.where(rng.random(n) < 0.5, 0.0, -0.0)
    return v


@pytest.mark.parametrize("bottom", [False, True], ids=["topk", "bottomk"])
@pytest.mark.parametrize("k", [1, 3, 5, 16, 32, 33, 1000])
def test_step_twin_matches_plain_and_jax(k, bottom):
    """The step route's selection (a thread or a warp merge a group, by
    size), restated in numpy, against ``segment_topk_plain`` and the JAX
    ``topk_mask`` of each group's rows, over groups of 1 to 5,000 members
    with ties, +-0, +-inf and NaN: kept values (and signs) and thresholds
    bit-equal; past STEP_MAX_K (32, 33, 1000) the plain version alone
    against JAX, as the per-group route's twin ``cluster_select`` holds
    it."""
    members, n = step_members(STEP_GROUP_SIZES, k)
    J = 5
    v = step_grid(J, n, k + 7)
    p_out, p_thr = OS.segment_topk_plain(torch.from_numpy(v), members, k, bottom)
    perm, starts = members.perm.numpy(), members.starts.numpy()
    for j in range(J if k <= OS.STEP_MAX_K else 0):
        out, thr = step_twin(v[j], members, k, bottom)
        assert_same_bits(out, p_out[j].numpy())
        assert_same_bits(thr, p_thr[:, j].numpy())
    for g in range(members.num_groups):
        mem = np.sort(perm[starts[g]:starts[g + 1]])
        want = np.asarray(JAGG.topk_mask(jnp.asarray(v[:, mem].T), min(k, len(mem)),
                                         bottom=bottom)).T
        assert_same_bits(p_out[:, mem].numpy(), want)


# -- tile_sweep.py --order's split builds ---------------------------------------------


@pytest.mark.parametrize("patch", [p for ps in (*tile_sweep.ORDER_PATCHES.values(),
                                                *tile_sweep.STEP_PATCHES.values()) for p in ps],
                         ids=lambda p: p[1].strip()[:40])
def test_order_patch_targets_are_in_the_sources(patch):
    """``tile_sweep.py --order --split`` and ``--segment-topk --split`` patch
    these lines of csrc/: each must appear there exactly once."""
    fname, old, _ = patch
    assert (cuda_build.CSRC / fname).read_text().count(old) == 1
