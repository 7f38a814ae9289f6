#!/usr/bin/env python3
"""Tile-layout sweep of the port's two fused kernels on one NVIDIA card, at
the main path's shape: a [131072, 768] superblock with 100k real series
(irregular 5-15 s rows for the fused window-stats kernel, a shared 10 s
grid for the regular kernel), 111 steps, 5 m windows, sum over 1 group.

    python3 tile_sweep.py [--split]
    python3 tile_sweep.py --hist [--package-root DIR]
    python3 tile_sweep.py --general [--package-root DIR]
    python3 tile_sweep.py --order [--split] [--package-root DIR]
    python3 tile_sweep.py --classic-gather

For each kernel and function it times the launch (the median of 20 calls
between CUDA events, after warm-up) at every rows-per-tile layout -- the
fused kernel staged in shared memory or read in place, the regular kernel
read in place -- and marks the layout that ``ops/group_acc.tile_plan``
picks. At that layout it also times 50 back-to-back launches between two
events and reads the kernel's device time from ``torch.profiler``, and it
lists the atomic instructions of the built kernels (``cuobjdump -sass``).
With ``--split`` it also builds patched copies of the sources into a
temporary directory -- without the group atomics, and (fused kernel) with
fixed window bounds instead of the binary searches -- to show what each
costs; the patched kernels compute wrong values and serve only as timings.
Every launch goes through the wrappers' own ``_launch_range`` / ``_launch``
with an explicit layout (``group_acc.layout``) and, for a patched copy, its
library. ``HIST_PATCHES`` are the histogram kernel's split, which
``chip_smoke.py`` builds with ``build_patched`` and times beside the kernel.

With ``--hist`` it times the histogram range kernel instead, on 100k
12-bucket histograms made on the card (``chip_smoke.hist_block_bulk_on_card``;
once on irregular scrapes with per-series bounds, once moved onto bench.py's
regular 10 s grid with shared bounds), ``rate`` over bench.py's 111 steps into
one group: back to back, alone and with ``histogram_quantile(0.99, .)``
(folded into the launch, or a second launch where the package has the
quantile kernel of its own), and at each rows-per-tile count and at 256
threads per block, and built with the register budgets of ``HIST_BUILDS``.
``--package-root`` imports ``filodb_tpu_torch`` from
another checkout (a parent commit unpacked into a gitignored directory), so
that one call can time parent, change, change, parent on one card.

With ``--general`` it times the general range kernel (``csrc/general_range.cu``,
or the package's own where ``--package-root`` names a parent checkout) back
to back for every function of ``general_range.GENERAL_FUNCS`` at phase 4's
shape (100k irregular counters, 720 samples 5-15 s apart, corrected or
diff-staged as phase 8's queries take them) and on the regular store's
(the same on one 10 s grid), with phase 8's grouping (``by (zone)`` for
changes and stddev_over_time, else one group). Where the package has
``general_plan`` it also sweeps the warps per block, and times patched
builds: teams of ``GENERAL_TEAMS`` lanes that stride each window and reduce
it by shuffles (``general_team_patches``, for the functions that walk their
windows), and the split of ``GENERAL_PATCHES`` (bounds only: no window
read; reduce only: fixed windows instead of the searches).

With ``--order`` it times the two order-statistics kernels
(``csrc/order_stats.cu``, or the package's own where ``--package-root``
names a parent checkout) at phase 9's cases (``ORDER_CASES``: topk and
bottomk at k = 5, 10, 1000; quantile over one group, 8 groups of every
8th series, 100,000 groups of one) on one grid drawn on the card
(``chip_smoke.order_grid_on_card``: 111 steps x 131,072 rows, 100,000
real), back to back and per call, beside ``torch.topk`` /
``torch.nanquantile``, each result first held against its plain version,
and the host time a call of the public wrapper takes to enqueue its
launch (``host_ms``).
Where the package plans its launches (``order_stats.order_plan``) it also
times every cluster size and block size of ``ORDER_LAYOUTS``; with
``--split`` the patched builds of ``ORDER_PATCHES`` (select only, stage
only, key by key), or on a one-block-per-segment package those of
``BLOCK_ORDER_PATCHES`` (select only, compaction / next_above only,
coalesced stores, no ``__match_any_sync``).

With ``--classic-gather`` it times the standalone quantile of classic
buckets (``filodb_hist_quantile_gather``) at phase 10b's shapes (the
partials of 120,000 ``le`` counters: G = 1 group by ``le``, G = 8 by ``(le,
zone)``; B = 12, J = 111) and at G = 32 to 3,000 drawn on the card, in the
kernel's design (one thread per group and step) and in the tiled design
that ``GATHER_PATCHES`` builds (blocks of groups x steps, the groups' row
indices staged in shared memory and every count read issued before use),
alternating kernel, tiled, tiled, kernel: the device time from
``torch.profiler`` and from 50 launches captured in a CUDA graph and
replayed (``chip_smoke.graph_ms``), 50 launches back to back, and the host
time a call of the wrapper takes to enqueue beside a bare ctypes call of
the entry, the wrapper's per-call checks (``part``, ``out``) and the
table's checks made once a pivot (``check_gather_table``); beside them an
empty kernel over the same blocks (``hist_kernels.empty_launch``), the
card's floor for any launch. Each design is first held bit-equal to
``histogram_quantile_gather_plain``.

Prints the card's name and power limit, and ends with one JSON object of
every time. Exits non-zero where no CUDA device is available.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

BASE = 1_600_000_000_000
S, T, N_REAL, J, J_PAD = 131072, 768, 100_000, 111, 128
START_OFF, STEP, WINDOW = 400_000, 60_000, 300_000
FUSED_LAYOUTS = ((1, True), (2, True), (3, True), (4, True), (6, True), (8, True), (8, False))
REGULAR_ROWS = (1, 2, 4, 8)
FUNCS = ("rate", "sum_over_time", "count_over_time")

# patches of the --split variants: (file in csrc/, old, new)
NO_ATOMICS = ("group_acc.cuh", "        fold(acc + i, cnt + i, acc_op, v, 1.0f);",
              "        if (v == 1234.5f) fold(acc + i, cnt + i, acc_op, v, 1.0f);")
NO_SEARCH = [("window_stats.cu", "    const int hi = count_le(rt, n, t_j);",
              "    const int hi = min(n, max(0, j * 6 + 30));"),
             ("window_stats.cu", "    const int lo = lower_edge(rt, hi, wrap_add(t_j, -a.window));",
              "    const int lo = max(0, hi - 30);")]
PATCHES = [NO_ATOMICS, *NO_SEARCH]
# patches of the histogram kernel's split (chip_smoke.py phases 7b, 7c and
# the card block): "search only" stages ts and searches the windows but
# fetches no bucket; "fetch only" copies no ts and takes fixed windows of
# 30 samples, 6 further per step (10 s samples, 60 s steps)
HIST_PATCHES = {
    "search only": [("hist_range.cu",
                     "            for (int cv = threadIdx.x; cv < cv_n; cv += blockDim.x) {",
                     "            for (int cv = threadIdx.x; cv < 0; cv += blockDim.x) {")],
    "fetch only": [("hist_range.cu",
                    "return gid_of(s0 + r) < 0 ? 0 : (len_of(s0 + r) + 3) / 4;", "return 0;"),
                   ("hist_range.cu", "hi = count_le<!STAGED>(rt, len_of(s), t_j);",
                    "hi = min(len_of(s), max(0, (j0 + jl) * 6 + 30));"),
                   ("hist_range.cu", "lo = lower_edge(rt, hi, wrap_add(t_j, -a.window));",
                    "lo = max(0, hi - 30);")],
}
# the store mode's split (``--hist-store --split`` and chip_smoke.py phase
# 12): "store: compute only" computes every value but stores none (a
# discarded comparison keeps the work); "store: store only" stores fixed
# values, copies no ts and takes fixed windows (no search, no bucket fetch)
HIST_PATCHES.update({
    "store: compute only": [("hist_range.cu",
                             "            for (int i = 0; i < V; ++i) o[(int64_t)i * a.ld_series] = v[u][i];",
                             "            for (int i = 0; i < V; ++i)\n"
                             "                if (v[u][i] == 1234.5f) o[(int64_t)i * a.ld_series] = v[u][i];")],
    "store: store only": [("hist_range.cu",
                           "            window_values<V>(a, tile_vals + (int64_t)r * a.T * B + b0, lo_s[k], hi_s[k],\n"
                           "                             fac_s[k], win_sum, w_s, v[u]);",
                           "            for (int i = 0; i < V; ++i) v[u][i] = fac_s[k] + (float)(lo_s[k] + i);"),
                          *HIST_PATCHES["fetch only"]],
})
# patches of the general kernel's split (``--general``): "bounds only"
# searches every window but reads none of it (no prefix, no gather, no
# scan); "reduce only" takes fixed windows of 30 samples, 6 further per
# step (10 s samples, 60 s steps from 400 s) instead of the searches
GENERAL_PATCHES = {
    "bounds only": [("general_range.cu", "v = pair_value<KIND>(rt, rvc, lo, hi, a);",
                     "v = (float)(hi - lo);"),
                    ("general_range.cu",
                     "v = window_value<KIND>(a, rt, rvc, rr, lo, hi, t_of(j0 + jl));",
                     "v = (float)(hi - lo);"),
                    ("general_range.cu", "            if (KIND == K_PAIRS && STAGED) {",
                     "            if (false) {")],
    "reduce only": [("general_range.cu", "search_bounds<!STAGED>(rt, n, t_j, a.window, lo, hi);",
                     "for (int q = 0; q < Q; ++q) { hi[q] = min(n, (j0 + jq + 32 * q) * 6 + 40);"
                     " lo[q] = max(0, hi[q] - 30); }")],
}
GENERAL_TEAMS = (2, 4, 8, 16, 32)  # lanes per window of the team builds (the kernel: 1)
GENERAL_WARPS = (2, 4, 6, 8)  # warps per block swept by --general
# phase 8's grouping: by (zone) for these, one group for the rest
GENERAL_BY_ZONE = ("changes", "stddev_over_time")


def general_team_patches(team: int):
    """Patches that make the general kernel reduce each window by a team of
    ``team`` lanes: the team takes one step of the warp's, its lanes stride
    the window over consecutive samples, a ``__shfl_xor_sync`` chain sums
    their partials, and the team's first lane keeps the value."""
    reduce = (
        "constexpr unsigned FULL = 0xffffffffu;\n"
        f"constexpr int TEAM = {team};\n"
        "template <typename X>\n"
        "__device__ __forceinline__ X team_reduce(X x) {\n"
        "    const unsigned lane = threadIdx.x & 31;\n"
        "    const unsigned mask = TEAM >= 32 ? FULL\n"
        "                                     : ((1u << (TEAM & 31)) - 1) << (lane & ~(TEAM - 1));\n"
        "    for (int o = TEAM >> 1; o > 0; o >>= 1) x += __shfl_xor_sync(mask, x, o, TEAM);\n"
        "    return x;\n"
        "}\n")
    walk = ("    int k = lo;\n    for (; k + 3 < hi; k += 4) {\n        f(k, 0);\n"
            "        f(k + 1, 1);\n        f(k + 2, 2);\n        f(k + 3, 3);\n    }\n"
            "    for (; k < hi; ++k) f(k, 0);\n")
    return [("general_range.cu", "constexpr unsigned FULL = 0xffffffffu;\n", reduce),
            ("general_range.cu", walk,
             "    for (int k = lo + (int)(threadIdx.x & (TEAM - 1)); k < hi; k += TEAM) f(k, 0);\n"),
            ("general_range.cu", "    return (x[0] + x[1]) + (x[2] + x[3]);",
             "    return team_reduce((x[0] + x[1]) + (x[2] + x[3]));"),
            ("general_range.cu", "    return x[0] + x[1];", "    return team_reduce(x[0] + x[1]);"),
            ("general_range.cu", "for (int jl = lane; jl < ns; jl += 32) {\n"
             "                const int lo = tb_lo[jl]",
             "for (int jl = lane / TEAM; jl < ns; jl += 32 / TEAM) {\n"
             "                const int lo = tb_lo[jl]"),
            ("general_range.cu", "                if (!isnan(v)) {",
             "                if ((lane & (TEAM - 1)) == 0 && !isnan(v)) {")]


# register budgets of the histogram kernel (``--hist``): rows whose loads a
# thread has in flight, and blocks per SM its registers are cut for
HIST_BUILDS = {
    f"unroll {u}, {b} blocks per SM": [
        (f, old, new) for f, old, new in (
            ("hist_range.cu", "constexpr int UNROLL = 2;", f"constexpr int UNROLL = {u};"),
            ("hist_range.cu", "constexpr int MIN_BLOCKS = 3;", f"constexpr int MIN_BLOCKS = {b};"))
        if old != new]
    for u, b in ((4, 2), (2, 2), (2, 4), (4, 3))
}


# ``--order``: phase 9's cases of the two order-statistics kernels: (name,
# kernel, k or q, bottom, groups); groups 8 are every 8th series (by zone),
# N_REAL groups one series each (by instance)
ORDER_CASES = (
    ("topk(5)", "topk", 5, False, 1), ("topk(10)", "topk", 10, False, 1),
    ("topk(1000)", "topk", 1000, False, 1), ("bottomk(5)", "topk", 5, True, 1),
    ("bottomk(10)", "topk", 10, True, 1), ("bottomk(1000)", "topk", 1000, True, 1),
    ("quantile(0.99), G=1", "quantile", 0.99, False, 1),
    ("quantile(0.5) by zone, G=8", "quantile", 0.5, False, 8),
    ("quantile(0.5) by instance, G=100000", "quantile", 0.5, False, N_REAL),
)
# patches of ``--order --split`` for the one-block-per-segment kernels
# (order_stats.cu before the cluster design; run with --package-root on
# such a checkout): "select only" skips topk's compaction and the
# quantile's next_above; "compaction / next_above only" replaces the select
# by a fixed threshold (topk: nothing better, so the compaction walks the
# whole column; quantile: next_above on every large segment); "coalesced
# stores" writes the thread path's results at the thread's own index; "no
# match" gives each key its own shared atomic instead of __match_any_sync
BLOCK_ORDER_PATCHES = {
    "select only": [
        ("order_stats.cu", "    for (int i0 = 0; i0 < n; i0 += blockDim.x) {",
         "    if (threadIdx.x == 0) idx[j] = (int)sel.key;\n"
         "    for (int i0 = 0; i0 < 0; i0 += blockDim.x) {"),
        ("order_stats.cu", "if (r.hi > r.lo && r.hi >= sel.below + sel.equal)", "if (false)")],
    "compaction / next_above only": [
        ("order_stats.cu", "    const order_select::Selection sel =\n"
         "        order_select::select(n, key, [&](int) { return kr - 1; }, sel_sh);",
         "    const order_select::Selection sel = {0u, 0, 0, 0};"),
        ("order_stats.cu", "        const order_select::Selection sel = order_select::select(\n"
         "            n, key,\n            [&](int absent) {\n                count = n - absent;\n"
         "                r = rank_for(q, count);\n                return r.lo;\n"
         "            },\n            sel_sh);",
         "        count = n;\n        r = rank_for(q, count);\n"
         "        const order_select::Selection sel = {0x80000000u, 0, 0, 0};"),
        ("order_stats.cu", "if (r.hi > r.lo && r.hi >= sel.below + sel.equal)", "if (true)")],
    "coalesced stores": [
        ("order_stats.cu", "    out[(int64_t)g * J + j] = interpolate(count, r, k_lo, k_hi);",
         "    out[t] = interpolate(count, r, k_lo, k_hi);")],
    "no match": [
        ("order_select.cuh", "const unsigned peers = __match_any_sync(FULL, digit);",
         "const unsigned peers = 1u << lane;")],
}


# patches of ``--order --split`` for this package's kernels: "select only"
# skips topk's compaction and the quantile's next_above; "stage only" also
# stops the select after the first pass (one read of the segment into
# shared memory, its first histogram and one merge); "key by key" stages a
# topk column (and a quantile group of consecutive series) by the threads'
# loads, 8 keys a thread in flight, instead of one bulk copy by the TMA
# engine
_SKIP_COMPACTION = ("order_stats.cu", "    const bool all_eq = room >= sel.equal_own;\n",
                    "    const bool all_eq = room >= sel.equal_own;\n"
                    "    if (threadIdx.x == 0) idx[j] = (int)sel.key;\n"
                    "    if (m >= 0) {\n        order_select::cluster_wait();\n        return;\n"
                    "    }\n")
_SKIP_NEXT_ABOVE = ("order_stats.cu", "if (r.hi > r.lo && r.hi >= sel.below + sel.equal)",
                    "if (false)")
ORDER_PATCHES = {
    "select only": [_SKIP_COMPACTION, _SKIP_NEXT_ABOVE],
    "stage only": [_SKIP_COMPACTION, _SKIP_NEXT_ABOVE,
                   ("order_select.cuh", "for (int pass = 0; pass < 4; ++pass) {",
                    "for (int pass = 0; pass < 1; ++pass) {")],
    "key by key": [("order_stats.cu", "if (STAGED && ((uintptr_t)(col + i0) & 15) == 0)",
                    "if (false)"),
                   ("order_stats.cu", "    if (STAGED && m > 0 && __ldg(mem + i0 + m - 1) - first == m - 1 &&",
                    "    if (false &&")],
}
# (cluster, threads) layouts ``--order`` times beside the plan's choice
ORDER_LAYOUTS = ((1, 256), (2, 256), (4, 256), (8, 256), (8, 128), (8, 512))
ORDER_TILE_THREADS = (128, 256, 512)  # block sizes timed on the thread route


def median_ms(fn, reps: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def blocks(device):
    """The irregular and the regular superblock, seeded, built in bulk."""
    import torch

    from filodb_tpu_torch.ops.staging import TS_PAD, block_from_arrays

    rng = np.random.default_rng(0)
    lens = np.zeros(S, np.int32)
    lens[:N_REAL] = rng.integers(650, 720, N_REAL)
    mask = np.arange(T)[None, :] < lens[:, None]
    ts = np.where(mask, np.cumsum(rng.integers(5_000, 15_001, (S, T)), axis=1),
                  int(TS_PAD)).astype(np.int32)
    vals = np.where(mask, np.cumsum(rng.uniform(0, 10, (S, T)), axis=1), 0).astype(np.float32)
    irregular = block_from_arrays(ts, vals, lens, BASE, np.zeros(S, np.float32), N_REAL,
                                  raw=vals + np.float32(1e3), device=device)
    lens[:N_REAL] = 720
    mask = np.arange(T)[None, :] < lens[:, None]
    grid = np.where(np.arange(T) < 720, np.arange(T) * 10_000, int(TS_PAD)).astype(np.int32)
    ts = np.where(mask, grid[None, :], int(TS_PAD)).astype(np.int32)
    regular = block_from_arrays(ts, vals, lens, BASE, np.zeros(S, np.float32), N_REAL,
                                raw=vals + np.float32(1e3), device=device)
    assert irregular.regular_ts is None and regular.regular_ts is not None
    gids = torch.full((S,), 1, dtype=torch.int64, device=device)
    gids[:N_REAL] = 0
    return irregular, regular, gids


def build_patched(name: str, patches, bind) -> ctypes.CDLL:
    """A patched copy of csrc/, built apart with the port's nvcc flags and
    bound by the wrapper's ``bind``."""
    from filodb_tpu_torch.ops import cuda_build

    d = Path(tempfile.mkdtemp(prefix="tile_sweep_"))
    for f in cuda_build.CSRC.iterdir():
        shutil.copy(f, d)
    for fname, old, new in patches:
        text = (d / fname).read_text()
        if old not in text:
            raise RuntimeError(f"patch target not found in {fname}: {old.strip()}")
        (d / fname).write_text(text.replace(old, new))
    out = d / f"{name}.so"
    proc = subprocess.run([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(out),
                           str(d / f"{name}.cu")], capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the patched {name}.cu:\n{proc.stderr}")
    return bind(ctypes.CDLL(str(out)))


def host_ms(fn, reps: int = 200) -> float:
    """Host ms per call of ``fn`` (what it takes to enqueue a launch: the
    wrapper's Python, ctypes and the CUDA runtime), over ``reps`` calls
    after warm-up, the device drained before and after."""
    import time

    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e3


def device_ms(fn, match: str, reps: int = 20) -> float:
    """Device ms per call of ``fn`` spent in the kernels whose name holds
    ``match``, from ``torch.profiler``'s CUDA activity over ``reps`` calls
    after warm-up: the kernels alone, where back to back launches would
    time the host's enqueue instead."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
                for e in prof.key_averages() if match in e.key)
    return total / reps / 1e3


def back_to_back_ms(fn, reps: int = 50) -> float:
    """Device ms per call of ``fn`` launched ``reps`` times between two events."""
    import torch

    for _ in range(3):
        fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def hist_main(package_root: str | None, card: str, device=None, n_series: int | None = None,
              timer=back_to_back_ms) -> int:
    """``--hist``: the histogram range kernel of the package at
    ``package_root`` (default this checkout's), alone and with the quantile,
    and (where the package has the redesigned plan) at other layouts, on
    ``n_series`` (default chip_smoke's 100k) series on ``device`` (default
    the card)."""
    if package_root:
        sys.path.insert(0, str(Path(package_root).resolve()))
    import dataclasses
    import importlib.util

    import torch

    import filodb_tpu_torch
    # this checkout's chip_smoke.py (its block generator), whatever the package
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  Path(__file__).resolve().parent / "chip_smoke.py")
    CS = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(CS)
    from filodb_tpu_torch.ops import aggregations as AGG
    from filodb_tpu_torch.ops import group_acc as GA
    from filodb_tpu_torch.ops import hist_kernels as HK
    from filodb_tpu_torch.ops.kernels import RangeParams, pad_steps

    device = device or torch.device("cuda")
    print(f"package {Path(filodb_tpu_torch.__file__).resolve().parent}")
    HK._load()
    builds = {}
    if hasattr(HK, "hist_smem_bytes") and device.type == "cuda":
        with ThreadPoolExecutor(len(HIST_BUILDS)) as pool:
            libs = pool.map(lambda k: build_patched("hist_range", HIST_BUILDS[k], HK.bind),
                            HIST_BUILDS)
        builds = dict(zip(HIST_BUILDS, libs))
    n, B = n_series or CS.N_SERIES, CS.N_BUCKETS
    J = int((CS.END_S - CS.START_S) // CS.STEP_S) + 1
    params = RangeParams(int(CS.START_S * 1000), int(CS.STEP_S * 1000), J, CS.WINDOW_MS)
    les = torch.tensor(CS.HIST_LES, dtype=torch.float32, device=device)
    irregular = CS.hist_block_bulk_on_card(n, CS.N_SAMPLES, CS.HIST_SEED, device)
    regular = CS.hist_block_bulk_on_card(n, CS.N_SAMPLES, CS.HIST_SEED + 1, device)
    regular.lens[:n] = CS.N_SAMPLES
    lane = torch.arange(regular.ts.shape[1], device=device)
    grid = torch.where(lane < CS.N_SAMPLES, lane * 10_000, 2**31 - 1).to(torch.int32)
    regular.ts[:n] = grid
    regular.vals[n // 2] = regular.vals[0]  # the generator's empty series gets samples
    regular.regular_ts = grid.cpu().numpy()
    gids = torch.ones(regular.vals.shape[0], dtype=torch.int64, device=device)
    gids[:n] = 0
    times = {}
    for name, block in (("shared bounds", regular), ("per-series bounds", irregular)):
        windows = (AGG._hist_shared_windows(block, params, pad_steps(J))
                   if block.regular_ts is not None else None)
        acc, cnt = GA.accumulators("sum", 1, pad_steps(J) * B, device)
        out = torch.full((1, pad_steps(J)), float("nan"), device=device)

        def launch(quantile=False, plan=None, lib=None):
            kw = {"plan": plan, "lib": lib} if plan or lib else {}
            if quantile and hasattr(HK, "hist_range_quantile"):  # folded into the launch
                arrivals = torch.zeros(8, dtype=torch.int32, device=device)
                kw["quantile"] = (0.99, les, out, arrivals)
            return lambda: (HK._launch_range("rate", block, gids, 1, params, windows, False,
                                             acc, cnt, **kw),
                            quantile and not hasattr(HK, "hist_range_quantile")
                            and HK._launch_quantile(0.99, acc, cnt, 1, les, J, out))

        times[f"{name}: hist_range"] = timer(launch())
        times[f"{name}: hist_range with the quantile"] = timer(launch(True))
        if hasattr(HK, "hist_smem_bytes"):
            plan = HK.hist_plan(block.vals.shape[1], J, B, 1, windows is not None)
            layouts = [dataclasses.replace(plan, rows=r, smem_bytes=HK.hist_smem_bytes(
                1, B, plan.steps, r, block.vals.shape[1], windows is not None, plan.shared,
                plan.staged)) for r in (2, 4, 8, 16) if r != plan.rows]
            layouts.append(dataclasses.replace(plan, threads=256))
            for layout in layouts:
                key = f"{name}: rows={layout.rows} threads={layout.threads}"
                times[key] = timer(launch(plan=layout))
            for build, lib in builds.items():
                times[f"{name}: {build}"] = timer(launch(lib=lib))
            times[f"{name}: the plan's layout"] = f"rows={plan.rows} threads={plan.threads}"
        for k, v in times.items():
            if k.startswith(name):
                print(f"{k}: {v if isinstance(v, str) else f'{v:.4f} ms'}", flush=True)
    print(card)
    print(json.dumps({"card": card, "package": str(package_root or "."), "ms": times}))
    return 0


CS_SEED = 42  # chip_smoke.HIST_SEED: bench.py's histogram seed
STORE_LEAVES = 8  # phase 12's leaves: 8 shards of 7b's 100k (shared bounds) and 7c's 50k


def store_leaves(device, n_series: int, regular: bool, seed: int):
    """One leaf's block of ``n_series`` card-made histograms (phase 12's
    shard shape: a twelfth of 7b's 100k on bench.py's 10 s grid, or of 7c's
    50k on irregular scrapes)."""
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  Path(__file__).resolve().parent / "chip_smoke.py")
    CS = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(CS)
    block = CS.hist_block_bulk_on_card(n_series, CS.N_SAMPLES, seed, device)
    if regular:
        block.lens[:n_series] = CS.N_SAMPLES
        lane = torch.arange(block.ts.shape[1], device=device)
        grid = torch.where(lane < CS.N_SAMPLES, lane * 10_000, 2**31 - 1).to(torch.int32)
        block.ts[:n_series] = grid
        block.vals[n_series // 2] = block.vals[0]  # the generator's empty series gets samples
        block.regular_ts = grid.cpu().numpy()
    return CS, block


def store_main(package_root: str | None, card: str, split: bool, device=None,
               sizes=(12_500, 6_250), timer=back_to_back_ms) -> int:
    """``--hist-store``: the histogram range kernel's store mode (K1 of the
    tree over histograms, ``filodb_hist_range_series``) of the package at
    ``package_root`` (default this checkout's) at phase 12's shapes: 8 leaf
    launches of ``rate`` over a leaf of 12,500 histograms on bench.py's
    regular grid (shared bounds, 7b's 100k over 8 shards) and over 6,250
    on irregular scrapes (per-series bounds, 7c's 50k), each launch into a
    grid of its own, back to back and on the device (``torch.profiler``);
    beside them the fused aggregate over the same reads (``hist_range``
    into one group), ``fill_`` of the 8 grids (the writes alone) and, with
    ``split``, the patched builds of the ``store:`` entries of
    ``HIST_PATCHES`` ("compute only": no store; "store only": fixed
    values, no fetch, no search). Each launch is first held bit-equal to
    ``hist_series_plain`` on one leaf."""
    if package_root:
        sys.path.insert(0, str(Path(package_root).resolve()))
    import torch

    import filodb_tpu_torch
    from filodb_tpu_torch.ops import aggregations as AGG
    from filodb_tpu_torch.ops import hist_kernels as HK
    from filodb_tpu_torch.ops.kernels import RangeParams, pad_steps

    device = device or torch.device("cuda")
    print(f"package {Path(filodb_tpu_torch.__file__).resolve().parent}")
    HK._load()
    libs = {}
    if split and device.type == "cuda":
        patches = {k: v for k, v in HIST_PATCHES.items() if k.startswith("store:")}
        with ThreadPoolExecutor(len(patches)) as pool:
            libs = dict(zip(patches, pool.map(
                lambda k: build_patched("hist_range", patches[k], HK.bind), patches)))
    times = {}
    for name, n, regular in (("shared bounds", sizes[0], True),
                             ("per-series bounds", sizes[1], False)):
        CS, block = store_leaves(device, n, regular, CS_SEED if regular else CS_SEED + 1)
        J = int((CS.END_S - CS.START_S) // CS.STEP_S) + 1
        params = RangeParams(int(CS.START_S * 1000), int(CS.STEP_S * 1000), J, CS.WINDOW_MS)
        windows = (AGG._hist_shared_windows(block, params, pad_steps(J)) if regular else None)
        gids = AGG.zero_gids(block)
        S, T, B = block.vals.shape
        outs = [torch.empty((J, B, S), dtype=torch.float32, device=device)
                for _ in range(STORE_LEAVES)]
        want = HK.hist_series_plain("rate", block, gids, params, windows)

        def leaves(lib=None):
            kw = {"lib": lib} if lib else {}
            return lambda: [HK._launch_series("rate", block, gids, params, windows, False,
                                              o, **kw) for o in outs]

        leaves()()
        torch.cuda.synchronize()
        if not torch.equal(outs[0].view(torch.int32), want.view(torch.int32)):
            raise RuntimeError(f"{name}: K1 differs from hist_series_plain")
        times[f"{name}: K1 x {STORE_LEAVES} leaves"] = timer(leaves(), reps=20)
        times[f"{name}: K1 device"] = device_ms(leaves(), "hist_range", reps=10)
        times[f"{name}: the plan"] = str(HK.LAST_SERIES_PLAN)
        for variant, lib in libs.items():
            times[f"{name}: {variant}"] = timer(leaves(lib=lib), reps=20)
        acc = torch.zeros((2, pad_steps(J) * B), device=device)
        cnt = torch.zeros_like(acc)
        times[f"{name}: fused aggregate x {STORE_LEAVES} (the reads alone)"] = timer(
            lambda: [HK._launch_range("rate", block, gids, 1, params, windows, False, acc, cnt)
                     for _ in outs], reps=20)
        times[f"{name}: fill_ of the {STORE_LEAVES} grids (the writes alone)"] = timer(
            lambda: [o.fill_(1.0) for o in outs], reps=20)
        times[f"{name}: grid bytes written"] = STORE_LEAVES * J * B * S * 4
        for k, v in times.items():
            if k.startswith(name):
                print(f"{k}: {v if isinstance(v, (str, int)) else f'{v:.4f} ms'}", flush=True)
        del outs, block, want
        torch.cuda.empty_cache()
    print(card)
    print(json.dumps({"card": card, "package": str(package_root or "."), "ms": times}))
    return 0


TOPK_KS = (1, 3, 8, 16, 32, 33, 1000)  # --segment-topk: k of each case (3: phase 11's)
# patches of ``--segment-topk --split`` for the step route: "step: launch
# only" returns at once (the launch and its 100 KB blocks); "step: stage
# only" returns once the column and its group-ordered copy are in shared
# memory; "step: no output" selects but writes no column
STEP_PATCHES = {
    "step: launch only": [("order_stats.cu", "    const int j = blockIdx.x, J = gridDim.x;",
                           "    const int j = blockIdx.x, J = gridDim.x;\n    if (k > 0) return;")],
    "step: stage only": [("order_stats.cu",
                          "    stage_column(grid + (size_t)j * ld, perm, n, bottom, keys, sorted);",
                          "    stage_column(grid + (size_t)j * ld, perm, n, bottom, keys, sorted);\n"
                          "    if (k > 0) return;")],
    "step: no output": [("order_stats.cu", "    __syncthreads();  // every kept bit is set",
                         "    if (k > 0) return;")],
}


def topk_leaf(device, n: int, seed: int):
    """One leaf's ``rate``-like [J, n] step-major grid drawn on the card
    (``chip_smoke.order_grid_on_card``'s values) and its members by zone:
    every 8th series a group, as bench.py's tags interleave them."""
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  Path(__file__).resolve().parent / "chip_smoke.py")
    CS = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(CS)
    from filodb_tpu_torch.ops import order_stats as OS

    grid = CS.order_grid_on_card(n, n, J, seed, device)[:, :n].contiguous()
    gids = torch.arange(n, device=device) % 8
    return grid, OS.segment_members(gids, 8)


def topk_main(package_root: str | None, card: str, split: bool = False, device=None,
              n: int = 12_500, timer=back_to_back_ms) -> int:
    """``--segment-topk``: the grouped top-k (K2 of the tree's map phase,
    ``filodb_segment_topk``) of the package at ``package_root`` (default
    this checkout's) at phase 11's shape: ``topk by (zone) (k, rate)`` over
    8 leaf grids of ``n`` series x 111 steps in 8 interleaved groups, all
    8 launches back to back, for each k of ``TOPK_KS``, topk and bottomk;
    where the package has the step route, also the per-group route of the
    same build (the design the step route replaced), alternating: group,
    step, step, group, and with ``split`` (at k = 3 and 16) the step route's
    patched builds of ``STEP_PATCHES`` on the device. Every launch is first
    held bit-equal to ``segment_topk_plain``."""
    if package_root:
        sys.path.insert(0, str(Path(package_root).resolve()))
    import torch

    import filodb_tpu_torch
    from filodb_tpu_torch.ops import order_stats as OS

    device = device or torch.device("cuda")
    print(f"package {Path(filodb_tpu_torch.__file__).resolve().parent}")
    OS._load()
    leaves = [topk_leaf(device, n, seed) for seed in range(8)]
    stepped = "by_step" in OS.order_plan.__code__.co_varnames
    routes = ("group", "step", "step", "group") if stepped else ("plan",)
    libs = {}
    if split and stepped and device.type == "cuda":
        with ThreadPoolExecutor(len(STEP_PATCHES)) as pool:
            libs = dict(zip(STEP_PATCHES, pool.map(
                lambda k: build_patched("order_stats", STEP_PATCHES[k], OS.bind), STEP_PATCHES)))
    times = {}
    for k in TOPK_KS:
        for bottom in (False, True):
            name = f"{'bottomk' if bottom else 'topk'} by (zone) ({k})"
            plans = {}
            for route in set(routes):
                if route == "step" and k > OS.STEP_MAX_K:
                    continue  # the step route takes k up to STEP_MAX_K
                plan = (OS.order_plan("segment_topk", leaves[0][1], J, by_step=route == "step",
                                      k=k) if stepped else None)
                plans[route] = plan
                grid, members = leaves[0]
                out, thr = OS.segment_topk(grid, members, k, bottom, plan=plan)
                w_out, w_thr = OS.segment_topk_plain(grid, members, k, bottom)
                if not (torch.equal(out.view(torch.int32), w_out.view(torch.int32))
                        and torch.equal(thr.view(torch.int32), w_thr.view(torch.int32))):
                    raise RuntimeError(f"{name} ({route}): differs from segment_topk_plain")
            for i, route in enumerate(routes):
                if route not in plans:
                    continue
                plan = plans[route]

                def call(plan=plan):
                    return [OS.segment_topk(g, m, k, bottom, plan=plan) for g, m in leaves]

                times.setdefault(f"{name}: {route}", []).append(timer(call, reps=20))
                times.setdefault(f"{name}: {route} device", []).append(
                    device_ms(call, "segment_topk"))
                times.setdefault(f"{name}: {route} host per call", []).append(
                    host_ms(lambda: call(), reps=20) / len(leaves))
            for variant, lib in libs.items() if "step" in plans and k in (3, 16) else ():
                plan = plans["step"]
                times[f"{name}: {variant} device"] = device_ms(
                    lambda: [OS.segment_topk(g, m, k, bottom, plan=plan, lib=lib)
                             for g, m in leaves], "segment_topk")
            if k == 3 and not bottom:
                times[f"{name}: torch.topk at G = 1"] = timer(
                    lambda: [torch.topk(g, 3, dim=1) for g, _ in leaves], reps=20)
            for key, v in times.items():
                if key.startswith(name):
                    print(f"{key}: {v}", flush=True)
    print(card)
    print(json.dumps({"card": card, "package": str(package_root or "."), "ms": times}))
    return 0


def general_blocks(device, n_real: int = N_REAL, seed: int = 0):
    """Phase 4's and the regular store's superblocks, made on the card from
    a seed: ``n_real`` counters of 720 samples (5-15 s apart, or every
    10 s), [S, 768] with the padded rows past them; each twice, corrected
    (cumulative values) and diff-staged (the adjacent increments, one in
    five zero), as phase 8's queries stage them."""
    import torch

    from filodb_tpu_torch.ops.staging import TS_PAD, StagedBlock

    g = torch.Generator(device=device).manual_seed(seed)
    m = 720
    S_pad = -(-n_real // 128) * 128 if n_real < N_REAL else S
    lens = torch.zeros(S_pad, dtype=torch.int32, device=device)
    lens[:n_real] = m
    inc = torch.rand((n_real, m), generator=g, device=device) * 10
    inc = torch.where(torch.rand((n_real, m), generator=g, device=device) < 0.2, 0.0, inc)
    inc[:, 0] = 0.0
    irregular = torch.cumsum(torch.randint(5_000, 15_001, (n_real, m), generator=g,
                                           device=device, dtype=torch.int32), dim=1,
                             dtype=torch.int32)
    grid = torch.arange(m, dtype=torch.int32, device=device) * 10_000
    out = {}
    for store, rows in (("irregular", irregular), ("regular", grid.expand(n_real, m))):
        ts = torch.full((S_pad, T), int(TS_PAD), dtype=torch.int32, device=device)
        ts[:n_real, :m] = rows
        for mode, v in (("corrected", torch.cumsum(inc, dim=1)), ("diff", inc)):
            vals = torch.zeros((S_pad, T), dtype=torch.float32, device=device)
            vals[:n_real, :m] = v
            regular = grid.cpu().numpy() if store == "regular" else None
            out[store, mode] = StagedBlock(ts, vals, lens, BASE, torch.zeros(S_pad, device=device),
                                           n_real, [], regular_ts=regular)
    return out


def general_main(package_root: str | None, card: str, device=None, n_real: int = N_REAL,
                 timer=back_to_back_ms) -> int:
    """``--general``: the general range kernel of the package at
    ``package_root`` (default this checkout's) for every function on both
    stores, and (where the package has ``general_plan``) its warps-per-block
    sweep, team builds and split builds."""
    if package_root:
        sys.path.insert(0, str(Path(package_root).resolve()))
    import dataclasses

    import torch

    import filodb_tpu_torch
    from filodb_tpu_torch.ops import general_range as GR
    from filodb_tpu_torch.ops import group_acc as GA
    from filodb_tpu_torch.ops.kernels import RangeParams, pad_steps

    device = device or torch.device("cuda")
    print(f"package {Path(filodb_tpu_torch.__file__).resolve().parent}")
    redesigned = hasattr(GR, "general_plan")
    splits, teams = {}, {}
    if redesigned and device.type == "cuda":
        builds = {**GENERAL_PATCHES, **{f"team={t}": general_team_patches(t) for t in GENERAL_TEAMS}}
        with ThreadPoolExecutor(len(builds)) as pool:
            libs = dict(zip(builds, pool.map(
                lambda k: build_patched("general_range", builds[k], GR.bind), builds)))
        splits = {k: libs[k] for k in GENERAL_PATCHES}
        teams = {k: v for k, v in libs.items() if k not in GENERAL_PATCHES}
    stores = general_blocks(device, n_real)
    params = RangeParams(BASE + START_OFF, STEP, J, WINDOW)
    times = {}
    for (store, mode), block in stores.items():
        S_pad = block.ts.shape[0]
        for func in sorted(GR.GENERAL_FUNCS):
            if (mode == "diff") != (func in ("changes", "resets", "idelta")):
                continue
            G = 8 if func in GENERAL_BY_ZONE else 1
            gids = torch.full((S_pad,), G, dtype=torch.int64, device=device)
            gids[:n_real] = torch.arange(n_real, device=device) % G
            acc, cnt = GA.accumulators("sum", G, pad_steps(J), device)

            def launch(plan=None, lib=None):
                kw = {k: v for k, v in (("plan", plan), ("lib", lib)) if v is not None}
                return lambda: GR._launch(func, "sum", block, gids, G, params, True, False,
                                          acc, cnt, **kw)

            key = f"{store} {func}"
            times[key] = timer(launch())
            plan = GR.LAST_PLAN
            if redesigned:
                times[f"{key}: the plan"] = (f"warps={plan.warps} n_arrays={plan.n_arrays} "
                                             f"{plan.partials} "
                                             f"shared_bounds={plan.shared_bounds}")
                if GR.KINDS[func] in ("moment2", "lsq"):  # the kinds that walk their windows
                    for name, lib in teams.items():
                        times[f"{key}: {name}"] = timer(launch(lib=lib))
                for warps in GENERAL_WARPS:
                    if warps != plan.warps:
                        smem = GR.general_smem_bytes(G, plan.steps, warps, T, plan.n_arrays,
                                                     plan.shared, plan.shared_bounds)
                        times[f"{key}: warps={warps}"] = timer(
                            launch(dataclasses.replace(plan, warps=warps, smem_bytes=smem)))
                for name, lib in splits.items():
                    times[f"{key}: {name}"] = timer(launch(lib=lib))
            for k, v in times.items():
                if k == key or k.startswith(key + ":"):
                    print(f"{k}: {v if isinstance(v, str) else f'{v:.4f} ms'}", flush=True)
    print(card)
    print(json.dumps({"card": card, "package": str(package_root or "."), "ms": times}))
    return 0


def order_launchers(OS, grid, n_real: int, kernel: str, arg, bottom: bool, members, lib=None,
                    plan=None):
    """A call of the package's order-statistics kernel on the grid: through
    the wrapper where the package plans its launches (``order_plan``, with
    an optional library and plan), else through the one-block C entry."""
    import torch

    J_, S_ = grid.shape
    if hasattr(OS, "order_plan"):
        if kernel == "topk":
            return lambda: OS.topk_steps(grid, arg, bottom, n_real=n_real, plan=plan, lib=lib)
        return lambda: OS.segment_quantile(grid, members, arg, plan=plan, lib=lib)
    lib = lib or OS._load()
    stream = torch.cuda.current_stream().cuda_stream
    if kernel == "topk":
        vals = torch.empty((arg, J_), dtype=torch.float32, device=grid.device)
        idx = torch.empty((arg, J_), dtype=torch.int32, device=grid.device)
        return lambda: lib.filodb_topk_steps(grid.data_ptr(), S_, n_real, J_, arg, int(bottom),
                                             OS.THREADS, vals.data_ptr(), idx.data_ptr(), stream)
    out = torch.empty((members.num_groups, J_), dtype=torch.float32, device=grid.device)
    return lambda: lib.filodb_segment_quantile(
        grid.data_ptr(), S_, J_, members.perm.data_ptr(), members.starts.data_ptr(),
        members.large.data_ptr(), members.large.numel(), members.small.data_ptr(),
        members.small.numel(), members.small_max, float(np.float32(arg)), OS.THREADS,
        out.data_ptr(), stream)


def order_main(package_root: str | None, card: str, split: bool, device=None,
               n_real: int = N_REAL, timer=back_to_back_ms) -> int:
    """``--order``: both order-statistics kernels of the package at
    ``package_root`` (default this checkout's) at phase 9's cases
    (``ORDER_CASES``) on one card-drawn grid, back to back and per call,
    beside ``torch.topk`` / ``torch.nanquantile``; each result checked
    against the plain version once. Where the package plans its launches,
    also every cluster size and block size; with ``split``, the patched
    builds of ``ORDER_PATCHES`` (or ``BLOCK_ORDER_PATCHES`` on a
    one-block package)."""
    if package_root:
        sys.path.insert(0, str(Path(package_root).resolve()))
    import dataclasses
    import importlib.util

    import torch

    import filodb_tpu_torch
    from filodb_tpu_torch.ops import order_stats as OS

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  Path(__file__).resolve().parent / "chip_smoke.py")
    CS = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(CS)
    device = device or torch.device("cuda")
    planned = hasattr(OS, "order_plan")
    print(f"package {Path(filodb_tpu_torch.__file__).resolve().parent} "
          f"({'cluster plan' if planned else 'one block per segment'})")
    OS._load()
    libs = {}
    if split and device.type == "cuda":
        patches = ORDER_PATCHES if planned else BLOCK_ORDER_PATCHES
        with ThreadPoolExecutor(len(patches)) as pool:
            libs = dict(zip(patches, pool.map(
                lambda k: build_patched("order_stats", patches[k], OS.bind), patches)))
    grid = CS.order_grid_on_card(n_real, S, J, 0, device)
    J_, S_ = grid.shape
    times = {}
    for name, kernel, arg, bottom, G in ORDER_CASES:
        members = None
        if kernel == "quantile":
            gids = torch.full((S_,), G, dtype=torch.int64, device=device)
            gids[:n_real] = torch.arange(n_real, device=device) % G
            members = OS.segment_members(gids, G)
        call = order_launchers(OS, grid, n_real, kernel, arg, bottom, members)
        if kernel == "topk":
            CS.topk_sets_equal(OS.topk_steps(grid, arg, bottom, n_real=n_real),
                               OS.topk_steps_plain(grid, arg, bottom), name)
        else:
            CS.quantiles_equal(OS.segment_quantile(grid, members, arg),
                               OS.segment_quantile_plain(grid, members, arg), grid, members, arg,
                               name)
        times[name] = timer(call)
        times[f"{name}: per call"] = median_ms(call)
        wrapper = ((lambda: OS.topk_steps(grid, arg, bottom, n_real=n_real)) if kernel == "topk"
                   else (lambda: OS.segment_quantile(grid, members, arg)))
        times[f"{name}: wrapper host"] = host_ms(wrapper)
        if planned:
            plan = OS.LAST_PLAN
            times[f"{name}: the plan"] = (f"route={plan.route} cluster={plan.cluster} "
                                          f"threads={plan.threads} blocks={plan.blocks} "
                                          f"smem={plan.smem_bytes}")
            layouts = (ORDER_LAYOUTS if plan.route != "thread"
                       else [(1, threads) for threads in ORDER_TILE_THREADS])
            for cluster, threads in layouts:
                alt = OS.order_plan(plan.kernel, n_real if kernel == "topk" else members, J_,
                                    cluster=cluster, threads=threads)
                if (alt.cluster, alt.threads) != (plan.cluster, plan.threads):
                    times[f"{name}: cluster={alt.cluster} threads={alt.threads}"] = timer(
                        order_launchers(OS, grid, n_real, kernel, arg, bottom, members, plan=alt))
        for variant, lib in libs.items():
            times[f"{name}: {variant}"] = timer(
                order_launchers(OS, grid, n_real, kernel, arg, bottom, members, lib=lib))
        if kernel == "topk":
            times[f"{name}: torch.topk"] = timer(
                lambda: torch.topk(grid[:, :n_real], arg, dim=1, largest=not bottom))
        elif G == 1:
            times[f"{name}: torch.nanquantile"] = timer(
                lambda: torch.nanquantile(grid[:, :n_real], arg, dim=1))
        for k, v in times.items():
            if k == name or k.startswith(name + ":"):
                print(f"{k}: {v if isinstance(v, str) else f'{v:.4f} ms'}", flush=True)
    print(card)
    print(json.dumps({"card": card, "package": str(package_root or "."), "ms": times}))
    return 0


GATHER_CASES = ((1, "phase 10b by le"), (8, "phase 10b by (le, zone)"), (32, "drawn"),
                (128, "drawn"), (512, "drawn"), (1_000, "drawn"), (3_000, "drawn"))
GATHER_B, GATHER_J, GATHER_LD = 12, 111, 128
# the tiled design of the classic quantile gather, built apart: a block of
# groups x steps (the steps of the query up to 128, rounded up to a warp,
# and as many groups as fill 256 threads, halved where shared memory would
# not hold them) stages its groups' row indices in shared memory; each
# thread issues the count reads of a chunk of B rounded up to 16, 32 or 64,
# unrolled, before it uses any, parks them in its column of a [B][steps]
# tile, and reads them back through the shared quantile_of
GATHER_TILED = r"""template <int CH>
__global__ void hist_quantile_gather_tiled_kernel(const float* part, int ld,
                                                  const int32_t* table, const int32_t* rows,
                                                  const float* les, int G, int B, int J,
                                                  float q, float* out, int ld_out) {
    extern __shared__ __align__(16) float smem[];
    const int TS = blockDim.x, t = threadIdx.x, y = threadIdx.y;
    const int g = blockIdx.x * blockDim.y + y;
    int32_t* s_row = reinterpret_cast<int32_t*>(smem) + y * B;
    float* s_cnt = smem + blockDim.y * B + (int64_t)y * B * TS;
    if (g < G) {
        const int32_t* tg = table + (int64_t)g * B;
        for (int b = t; b < B; b += TS) s_row[b] = __ldg(tg + b);
    }
    __syncthreads();
    const int j = blockIdx.y * TS + t;
    if (g >= G || j >= J) return;
    const float* pj = part + j;
    for (int b0 = 0; b0 < B; b0 += CH) {
        float c[CH];
#pragma unroll
        for (int u = 0; u < CH; ++u) {
            const int32_t r = b0 + u < B ? s_row[b0 + u] : -1;
            c[u] = r >= 0 ? __ldg(pj + (int64_t)r * ld) : group_acc::nan_f();
        }
#pragma unroll
        for (int u = 0; u < CH; ++u)
            if (b0 + u < B) s_cnt[(b0 + u) * TS + t] = c[u];
    }
    const float* mine = s_cnt + t;
    out[(int64_t)__ldg(rows + g) * ld_out + j] =
        quantile_of([&](int i) { return mine[i * TS]; }, les, B, q);
}

void tiled_gather_launch(cudaStream_t st, const float* part, int ld, const int32_t* table,
                         const int32_t* rows, const float* les, int G, int B, int J, float q,
                         float* out, int ld_out) {
    int steps = min(128, (J + 31) / 32 * 32), groups = max(1, 256 / steps);
    auto smem = [&] { return 4 * (int64_t)groups * B * (steps + 1); };
    while (smem() > 232448 && groups > 1) groups /= 2;
    while (smem() > 232448 && steps > 1) steps /= 2;
    auto kern = B <= 16 ? hist_quantile_gather_tiled_kernel<16>
              : B <= 32 ? hist_quantile_gather_tiled_kernel<32>
                        : hist_quantile_gather_tiled_kernel<64>;
    if (smem() > 48 * 1024)
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem());
    const dim3 grid((G + groups - 1) / groups, (J + steps - 1) / steps);
    kern<<<grid, dim3(steps, groups), (size_t)smem(), st>>>(part, ld, table, rows, les, G, B,
                                                           J, q, out, ld_out);
}

"""
GATHER_PATCHES = {
    "tiled": [("hist_range.cu", "// An empty kernel: the card's floor for a launch through ctypes",
               GATHER_TILED + "// An empty kernel: the card's floor for a launch through ctypes"),
              ("hist_range.cu", "    hist_quantile_gather_kernel<<<(int)blocks, GATHER_THREADS, 0, "
                                "(cudaStream_t)stream>>>(",
               "    tiled_gather_launch((cudaStream_t)stream,")],
}


def gather_case(G: int, seed: int, device):
    """(part, table, rows, les, out) of G classic groups of 12 buckets on
    the card: cumulative counts as a by-(le, ...) aggregate leaves them
    ([G * B, 128], 111 real steps, a few absent), each group's rows in a
    drawn order, as the pivot's index table sees the aggregate's groups."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    B, J = GATHER_B, GATHER_J
    counts = torch.poisson(torch.full((G, B, GATHER_LD), 3.0, device=device), generator=g)
    part = counts.cumsum(1).reshape(G * B, GATHER_LD).contiguous()
    part[torch.rand(part.shape, device=device, generator=g) < 0.01] = float("nan")
    part[:, J:] = float("nan")
    table = torch.randperm(G * B, device=device, generator=g).to(torch.int32).reshape(G, B)
    table = table.sort(dim=1).values.contiguous()  # any rows: the pivot sorts by le only
    rows = torch.randperm(G, device=device, generator=g).to(torch.int32)
    les = torch.tensor([0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, float("inf")],
                       device=device)
    out = torch.full((G, GATHER_LD), float("nan"), device=device)
    return part, table, rows, les, out


def gather_main(card: str, device=None) -> int:
    """``--classic-gather``: the classic-bucket quantile gather and its
    tiled design at ``GATHER_CASES``, alternating, beside an empty launch."""
    import torch

    from filodb_tpu_torch.ops import hist_kernels as HK

    device = device or torch.device("cuda")
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  Path(__file__).resolve().parent / "chip_smoke.py")
    CS = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(CS)
    libs = {"kernel": HK._load(),
            "tiled": build_patched("hist_range", GATHER_PATCHES["tiled"], HK.bind)}
    times = {}
    for G, what in GATHER_CASES:
        part, table, rows, les, out = gather_case(G, G, device)
        HK.check_gather_table(table, rows, les)
        B, J = GATHER_B, GATHER_J
        want = torch.full_like(out, float("nan"))
        want[rows.long(), :J] = HK.histogram_quantile_gather_plain(0.99, part, table, les, J)
        args = (part.data_ptr(), part.shape[1], table.data_ptr(), rows.data_ptr(),
                les.data_ptr(), G, B, J, 0.99, out.data_ptr(), out.shape[1])

        def launch(lib):  # on the stream current at the call (a graph captures a side one)
            return lib.filodb_hist_quantile_gather(
                *args, torch.cuda.current_stream(device).cuda_stream)

        for d, lib in libs.items():
            out.fill_(float("nan"))
            if launch(lib) != 0:
                raise RuntimeError(f"G = {G}, {d}: launch failed")
            torch.cuda.synchronize()
            if not (torch.equal(torch.isnan(out), torch.isnan(want))
                    and torch.equal(out[~torch.isnan(want)], want[~torch.isnan(want)])):
                raise RuntimeError(f"G = {G}, {d}: differs from histogram_quantile_gather_plain")
        name = f"G = {G} ({what})"
        for d in ("kernel", "tiled", "tiled", "kernel"):
            def bare(lib=libs[d]):
                launch(lib)

            for key, fn in ((f"{name}: {d} device", lambda: device_ms(bare, "gather")),
                            (f"{name}: {d} graph replay", lambda: CS.graph_ms(bare)),
                            (f"{name}: {d} back to back", lambda: back_to_back_ms(bare)),
                            (f"{name}: {d} bare ctypes host per call", lambda: host_ms(bare))):
                times.setdefault(key, []).append(fn())

        def call():
            HK.histogram_quantile_gather(0.99, part, table, rows, les, J, out)

        def empty():
            HK.empty_launch(G, J, device)

        for key, fn in ((f"{name}: wrapper host per call", lambda: host_ms(call)),
                        (f"{name}: empty launch device", lambda: device_ms(empty, "empty_kernel")),
                        (f"{name}: empty launch graph replay", lambda: CS.graph_ms(empty)),
                        (f"{name}: empty launch back to back", lambda: back_to_back_ms(empty))):
            times[key] = fn()
        times[f"{name}: the wrapper's per-call checks host per call"] = host_ms(lambda: [
            HK._check(n, t, t.dtype, tuple(t.shape), part.device)
            for n, t in (("part", part), ("out", out))])
        times[f"{name}: check_gather_table host per call"] = host_ms(
            lambda: HK.check_gather_table(table, rows, les))
        need = G * B * J * 4 + G * J * 4 + G * B * 4 + G * 4 + B * 4
        times[f"{name}: bound bytes"] = need
        times[f"{name}: bound ms"] = need / 3.35e12 * 1e3
        for key, v in times.items():
            if key.startswith(name):
                print(f"{key}: {v}", flush=True)
    print(card)
    print(json.dumps({"card": card, "ms": times}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--split", action="store_true", help="also time patched copies")
    ap.add_argument("--hist", action="store_true", help="time the histogram kernel instead")
    ap.add_argument("--general", action="store_true",
                    help="time the general range kernel instead")
    ap.add_argument("--segment-topk", action="store_true",
                    help="time the grouped top-k (the tree's K2) instead")
    ap.add_argument("--hist-store", action="store_true",
                    help="time the histogram kernel's store mode (the tree's K1) instead")
    ap.add_argument("--order", action="store_true",
                    help="time the two order-statistics kernels instead")
    ap.add_argument("--classic-gather", action="store_true",
                    help="time the classic-bucket quantile gather and its tiled design instead")
    ap.add_argument("--package-root", default=None,
                    help="with --hist, --general or --order: import filodb_tpu_torch from this "
                         "checkout")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("tile_sweep: no CUDA device is available", file=sys.stderr)
        return 2
    if (args.hist or args.general or args.order or args.hist_store or args.segment_topk
            or args.classic_gather):
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True, timeout=60).stdout.strip()
        if args.classic_gather:
            return gather_main(card)
        if args.order:
            return order_main(args.package_root, card, args.split)
        if args.hist_store:
            return store_main(args.package_root, card, args.split)
        if args.segment_topk:
            return topk_main(args.package_root, card, args.split)
        return (hist_main if args.hist else general_main)(args.package_root, card)
    from filodb_tpu_torch.ops import cuda_build
    from filodb_tpu_torch.ops import group_acc as GA
    from filodb_tpu_torch.ops import mxu_kernels as MK
    from filodb_tpu_torch.ops import window_stats as WS
    from filodb_tpu_torch.ops.kernels import RangeParams

    device = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    irregular, regular, gids = blocks(device)
    acc, cnt = GA.accumulators("sum", 1, J_PAD, device)
    params = RangeParams(BASE + START_OFF, STEP, J, WINDOW)
    wm = MK.window_matrices(regular, START_OFF, STEP, J_PAD, WINDOW)
    libs = {"": (WS._load(), MK._load())}
    if args.split:
        libs["no atomics"] = (build_patched("window_stats", [NO_ATOMICS], WS.bind),
                              build_patched("regular_range", [NO_ATOMICS], MK.bind))
        libs["no search"] = (build_patched("window_stats", NO_SEARCH, WS.bind), None)
        libs["no search, no atomics"] = (
            build_patched("window_stats", NO_SEARCH + [NO_ATOMICS], WS.bind), None)

    def fused(lib, func, plan):
        return lambda: WS._launch_range(func, "sum", irregular, gids, 1, params, True, False,
                                        acc, cnt, plan=plan, lib=lib)

    def reg(lib, func, plan):
        return lambda: MK._launch(func, "sum", regular.vals, regular.raw, gids, 1, wm, J, True,
                                  False, acc, cnt, plan=plan, lib=lib)

    def plans(kernel, func):
        """(the layouts to time, tile_plan's choice) of a kernel and function."""
        if kernel == "window_range":
            narr = WS.staged_arrays(func, True, False)
            return ([GA.layout(1, J, T, narr if staged else 0, rows)
                     for rows, staged in FUSED_LAYOUTS], GA.tile_plan(1, J, T, narr))
        return [GA.layout(1, J, 0, 0, rows) for rows in REGULAR_ROWS], GA.tile_plan(1, J, 0, 0)

    times = {}
    for variant, (fused_lib, reg_lib) in libs.items():
        for kernel, lib, make in (("window_range", fused_lib, fused),
                                  ("regular_range", reg_lib, reg)):
            if lib is None:
                continue
            for func in FUNCS:
                layouts, picked = plans(kernel, func)
                for plan in layouts if not variant else [picked]:
                    call = make(lib, func, plan)
                    t = median_ms(call)
                    mark = " (tile_plan's choice)" if plan == picked else ""
                    key = (f"{kernel} {func} rows={plan.rows} "
                           f"{'staged' if plan.staged else 'in place'}")
                    if variant:
                        key += f" [{variant}]"
                    times[key] = t
                    print(f"{key}: {t:.4f} ms{mark}", flush=True)
    # the chosen layouts: per call, back to back, and the profiler's device time
    from torch.profiler import ProfilerActivity, profile

    for kernel, lib, make in (("window_range", libs[""][0], fused),
                              ("regular_range", libs[""][1], reg)):
        for func in ("rate", "sum_over_time"):
            plan = plans(kernel, func)[1]
            call = make(lib, func, plan)
            for _ in range(3):
                call()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(50):
                call()
            b.record()
            b.synchronize()
            b2b = a.elapsed_time(b) / 50
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    call()
                torch.cuda.synchronize()
            device_us = [getattr(e, "device_time", None) or getattr(e, "cuda_time", 0)
                         for e in prof.key_averages() if f"{kernel}_kernel" in e.key]
            key = f"{kernel} {func} rows={plan.rows}"
            times[f"{key} back to back"] = b2b
            times[f"{key} profiler"] = device_us[0] / 1e3 if device_us else None
            print(f"{key}: back to back {b2b:.4f} ms; torch.profiler device time "
                  f"{device_us[0] / 1e3 if device_us else float('nan'):.4f} ms", flush=True)
    cuobjdump = Path(cuda_build.nvcc()).with_name("cuobjdump")
    for name in ("window_stats", "regular_range"):
        sass = subprocess.run([str(cuobjdump), "-sass", str(cuda_build.build(name))],
                              capture_output=True, text=True, check=True, timeout=300).stdout
        ops = {}
        for word in sass.split():
            if word.startswith(("ATOMS", "ATOMG", "RED")):
                ops[word.rstrip(";")] = ops.get(word.rstrip(";"), 0) + 1
        print(f"sass {name}: atomic instructions {dict(sorted(ops.items()))}")
    torch.cuda.synchronize()
    print(card)
    print(json.dumps({"card": card, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
