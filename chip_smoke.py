#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``filodb_tpu_torch``) on one NVIDIA
card: build its kernels, hold each kernel against its plain PyTorch
version, drive both rungs of the main path at full size, and check what
comes out.

    python3 chip_smoke.py [--seed N]

Phases (any failure raises and exits non-zero):

1. Build ``filodb_tpu_torch/csrc/window_stats.cu`` and ``regular_range.cu``
   with nvcc (both at once); print their ptxas lines and the card's name
   and power limit.
2. Window stats, kernel vs plain on seeded irregular blocks, S in {1, 65,
   4096} and T in {128, 768}, gauge and counter data: count exact,
   first/last timestamps bit-equal, the other planes within rtol 2e-4 /
   atol 1e-4, NaN masks equal; and one block with tied timestamps, where
   the kernel sums the tied first/last values as the plain version does.
3. Regular range kernel vs plain on seeded blocks on one shared 10 s grid,
   same S and T: every function of ``FUSED_MXU_FUNCS`` over gauge,
   corrected-counter and diff-counter blocks with each row its own group
   (G = S, so no atomic reorders a sum; rtol 2e-4 / atol 1e-4, NaN masks
   equal), and each op sum/count/avg/min/max with G in {1, 8} (rtol 1e-3:
   atomics reorder the f32 sums of a group).
4. Irregular main path: 100k ``http_requests_total`` counter series on 8
   shards, 720 samples each at irregular 5-15 s intervals, ingested through
   ``TimeSeriesShard.ingest_series``; ``sum(rate(...[5m]))`` and
   ``sum by (zone) (rate(...[5m]))`` through ``QueryEngine`` on the card.
   Each query must launch the window-stats kernel exactly once, and its
   [G, J] result must match the same superblock run through the plain
   window stats, finish and segment aggregate (rtol 1e-3: index_add_
   atomics reorder the f32 sums; NaN masks equal). Prints the window-stats
   kernel's time (median of 20 after warm-up) beside its bound: the bytes
   the query needs (each real sample's ts, value and raw value read once,
   the nine planes written once at [series, steps]), with the padded bound
   beside it.
5. Regular main path: bench.py's own store, as its ``build_memstore``
   builds it with jitter 0: the same 100k counters with 720 samples each at exactly 10 s
   from ``BASE``, values ``cumsum(uniform(0, 10)) + 1e9``. Each of the two
   queries must be classed ``regular``, take the ``mxu`` rung, launch the
   regular kernel exactly once and window stats never, and match both the
   plain path on the card and the window-stats rung on the same superblock
   (rtol 1e-3). Prints staging seconds, device-path ms, the kernel's ms
   (median of 20) on ``sum(rate)`` and on ``sum(sum_over_time)``, the plain
   path's ms, ``torch.matmul(vals, W)`` (cuBLAS f32, TF32 off: the JAX
   package's window sums) and the bounds: the 32-byte sectors of vals (and
   raw) the function reads over the real rows, gids and the outputs, from
   the query's window bounds.

Prints, in order at the end: one JSON object with the kernels' numbers, the
card's name and power limit as nvidia-smi gives them, and the result line
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result, where
no CUDA device is available.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

BASE = 1_600_000_000_000
N_SHARDS = 8
SPREAD = 3
STEP_S = 60.0
WINDOW_MS = 300_000
N_SERIES = 100_000
N_SAMPLES = 720
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
QUERIES = (
    "sum(rate(http_requests_total[5m]))",
    "sum by (zone) (rate(http_requests_total[5m]))",
)
KERNELS = ("window_stats", "regular_range")
START_S = (BASE + 400_000) / 1000  # bench.py's range
END_S = (BASE + N_SAMPLES * 10_000 - 200_000) / 1000


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median device time of ``fn`` in ms, from CUDA events around each call."""
    import torch

    for _ in range(warmup):
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


def compare(got, want, what: str, rtol: float, atol: float = 0.0) -> float:
    """NaN masks equal and values within rtol/atol; returns the largest
    absolute difference."""
    import torch

    require(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    require(torch.equal(torch.isnan(got), torch.isnan(want)), f"{what}: NaN masks differ")
    m = ~torch.isnan(want)
    gm, wm = got[m], want[m]
    bad = (gm - wm).abs() > atol + rtol * wm.abs()
    require(not bool(bad.any()), f"{what}: {int(bad.sum())} values outside tolerance")
    return float((gm.double() - wm.double()).abs().max()) if gm.numel() else 0.0


def compare_stats(got: dict, want: dict, rtol: float = 2e-4, atol: float = 1e-4) -> float:
    """Hold the kernel's nine planes against the plain version's; returns
    the largest absolute difference over the planes."""
    import torch

    worst = 0.0
    for name, w in want.items():
        g = got[name]
        if name in ("count", "t_first", "t_last"):
            m = ~torch.isnan(w)
            require(torch.equal(g[m], w[m]), f"{name}: kernel differs from plain")
        worst = max(worst, compare(g, w, name, rtol, atol))
    return worst


def build_kernels() -> None:
    """Build every kernel at once (one nvcc each) and print ptxas's lines."""
    from filodb_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        libs = list(pool.map(cuda_build.build, KERNELS))
    print(f"phase1 built {', '.join(l.name for l in libs)} in {time.perf_counter() - t0:.1f} s")
    for name in KERNELS:
        for line in cuda_build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"phase1 ptxas {name}: {line.strip()}")


def random_block(S: int, T: int, counter: bool, rng, device):
    """Seeded irregular rows: strictly increasing timestamps 5-15 s apart,
    ragged lengths, TS_PAD past each row's length."""
    import torch

    from filodb_tpu_torch.ops.staging import TS_PAD

    lens = rng.integers(T // 2, T + 1, S).astype(np.int32)
    ts = np.full((S, T), TS_PAD, np.int32)
    steps = rng.integers(5_000, 15_001, (S, T))
    start = rng.integers(0, 20_000, (S, 1))
    real = (start + np.cumsum(steps, axis=1)).astype(np.int32)
    mask = np.arange(T)[None, :] < lens[:, None]
    ts[mask] = real[mask]
    if counter:
        vals = np.cumsum(rng.uniform(0, 10, (S, T)), axis=1).astype(np.float32)
        raw = (vals + 1e3).astype(np.float32)
    else:
        vals = (50 + 20 * rng.standard_normal((S, T))).astype(np.float32)
        raw = vals
    vals = np.where(mask, vals, 0).astype(np.float32)
    raw = np.where(mask, raw, 0).astype(np.float32)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (ts, vals, raw, lens)]


def phase_window_stats_vs_plain(seed: int, device) -> None:
    import torch

    from filodb_tpu_torch.ops import window_stats as WS
    from filodb_tpu_torch.ops.staging import TS_PAD

    rng = np.random.default_rng(seed)
    for S in (1, 65, 4096):
        for T in (128, 768):
            for counter in (False, True):
                ts, vals, raw, lens = random_block(S, T, counter, rng, device)
                J = T * 10_000 // 60_000 - 2
                args = (ts, vals, raw, lens, 100_000, 60_000, WINDOW_MS, J)
                got = WS.window_stats(*args)
                want = WS.window_stats_plain(*args)
                err = compare_stats(got, want)
                k_ms = cuda_ms(lambda: WS.window_stats(*args), reps=10)
                p_ms = cuda_ms(lambda: WS.window_stats_plain(*args), reps=3, warmup=1)
                kind = "counter" if counter else "gauge"
                print(f"phase2 S={S} T={T} J={J} {kind}: match, max_abs_err={err:.3g} "
                      f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.3f}")
    # tied timestamps: first/last values sum over the tie, as on the TPU
    ts = np.full((8, 128), TS_PAD, np.int32)
    ts[0, :4] = [1000, 1000, 2000, 2000]
    vals = np.zeros((8, 128), np.float32)
    vals[0, :4] = [1.0, 10.0, 3.0, 4.0]
    raw = np.zeros((8, 128), np.float32)
    raw[0, :4] = [100.0, 200.0, 300.0, 400.0]
    lens = np.zeros(8, np.int32)
    lens[0] = 4
    args = [torch.from_numpy(a).to(device) for a in (ts, vals, raw, lens)] + [2000, 1000, 5000, 64]
    got = WS.window_stats(*args)
    compare_stats(got, WS.window_stats_plain(*args), rtol=0.0, atol=0.0)
    first = (float(got["v_first"][0, 0]), float(got["raw_first"][0, 0]), float(got["v_last"][0, 0]))
    require(first == (11.0, 300.0, 7.0), f"tied timestamps: v_first/raw_first/v_last {first}")
    print(f"phase2 tied timestamps: kernel equals plain, v_first/raw_first/v_last = {first}")


def regular_block(S: int, T: int, kind: str, rng, device):
    """``S`` seeded series on one shared 10 s grid, staged by the port so
    the block pads to width ``T``: gauges, or counters staged corrected or
    diff-encoded."""
    from filodb_tpu_torch.ops.staging import stage_series

    n = T - 5
    ts = BASE + 3_000 + np.arange(n, dtype=np.int64) * 10_000
    if kind == "gauge":
        vals = 50 + 20 * rng.standard_normal((S, n))
    else:
        vals = np.cumsum(rng.uniform(0, 10, (S, n)), axis=1) + 1e3
    block = stage_series([(ts, v) for v in vals], BASE,
                         counter_corrected=kind == "corrected", diff_encode=kind == "diff")
    require(block.regular_ts is not None and block.shape[1] == T, "regular block expected")
    return block.to_device(device)


def regular_plain(func, op, block, gids, G, params, is_counter):
    """The regular rung's plain version: mxu_range_plain -> segment aggregate."""
    from filodb_tpu_torch.ops import aggregations as AGG
    from filodb_tpu_torch.ops import mxu_kernels as MK
    from filodb_tpu_torch.ops.kernels import pad_steps

    wm = MK.window_matrices(block, params.start_ms - block.base_ms, params.step_ms,
                            pad_steps(params.num_steps), params.window_ms)
    raw = block.raw if block.raw is not None else block.vals
    sj = MK.mxu_range_plain(func, block.vals, raw, wm, params.window_ms, is_counter=is_counter)
    return AGG.apply_epilogue(sj, ("agg", op), gids, G)


def phase_regular_vs_plain(seed: int, device) -> None:
    import torch

    from filodb_tpu_torch.ops import mxu_kernels as MK
    from filodb_tpu_torch.ops.kernels import RangeParams

    rng = np.random.default_rng(seed + 1)
    group_func = {"gauge": "avg_over_time", "corrected": "rate", "diff": "idelta"}
    for S in (1, 65, 4096):
        for T in (128, 768):
            for kind in ("gauge", "corrected", "diff"):
                block = regular_block(S, T, kind, rng, device)
                counter = kind != "gauge"
                n_steps = ((T - 5) * 10_000 - 600_000) // 60_000 + 1
                params = RangeParams(BASE + 400_000, 60_000, n_steps, WINDOW_MS)
                s_pad = block.vals.shape[0]
                own = torch.full((s_pad,), S, dtype=torch.int64, device=device)
                own[:S] = torch.arange(S, device=device)
                err = 0.0
                for func in sorted(MK.FUSED_MXU_FUNCS):
                    got = MK.regular_range_aggregate(func, "sum", block, own, S, params,
                                                     is_counter=counter)
                    want = regular_plain(func, "sum", block, own, S, params, counter)
                    err = max(err, compare(got, want, f"{func} S={S} T={T} {kind}",
                                           rtol=2e-4, atol=1e-4))
                func = group_func[kind]
                for G in (1, 8):
                    gids = torch.full((s_pad,), G, dtype=torch.int64, device=device)
                    gids[:S] = torch.arange(S, device=device) % G
                    for op in ("sum", "count", "avg", "min", "max"):
                        got = MK.regular_range_aggregate(func, op, block, gids, G, params,
                                                         is_counter=counter)
                        want = regular_plain(func, op, block, gids, G, params, counter)
                        compare(got, want, f"{op}({func}) G={G} S={S} T={T}", rtol=1e-3)
                gids1 = torch.where(own < S, 0, 1)
                k_ms = cuda_ms(lambda: MK.regular_range_aggregate(
                    func, "sum", block, gids1, 1, params, is_counter=counter), reps=10)
                print(f"phase3 S={S} T={T} J={params.num_steps} {kind}: "
                      f"{len(MK.FUSED_MXU_FUNCS)} functions match plain at G=S "
                      f"(max_abs_err={err:.3g}); sum/count/avg/min/max of {func} match at "
                      f"G=1, 8; sum({func}) kernel_ms={k_ms:.4f}")


def build_memstore(n_series: int, n_samples: int, seed: int, regular: bool):
    """``n_series`` counters on 8 shards, ingested through the port's shard
    API: with ``regular``, bench.py's store (every series at exactly 10 s
    from BASE, values cumsum(uniform(0, 10)) + 1e9, drawn per block of 10k
    series as bench.py draws them); else strictly increasing irregular
    intervals, uniform 5-15 s."""
    from filodb_tpu_torch.core.records import SeriesBatch
    from filodb_tpu_torch.core.schemas import METRIC_TAG, PROM_COUNTER, Dataset, shard_for
    from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore
    from filodb_tpu_torch.memstore.shard import StoreConfig

    rng = np.random.default_rng(seed)
    ms = TimeSeriesMemStore(StoreConfig(max_chunk_size=n_samples))
    ms.setup(Dataset("prometheus"), range(N_SHARDS))
    grid = BASE + np.arange(n_samples, dtype=np.int64) * 10_000
    blk = 10_000
    for b0 in range(0, n_series, blk):
        n = min(blk, n_series - b0)
        if regular:
            ts = np.broadcast_to(grid, (n, n_samples))
        else:
            ts = BASE + np.cumsum(rng.integers(5_000, 15_001, (n, n_samples)), axis=1)
        vals = np.cumsum(rng.uniform(0, 10, (n, n_samples)), axis=1) + 1e9
        for i in range(n):
            tags = {
                METRIC_TAG: "http_requests_total", "_ws_": "demo", "_ns_": "App-2",
                "instance": f"host-{b0 + i}", "zone": f"z{(b0 + i) % 8}",
            }
            shard = ms.shard("prometheus", shard_for(tags, spread=SPREAD, num_shards=N_SHARDS))
            shard.ingest_series(SeriesBatch(
                schema=PROM_COUNTER, tags=tags, timestamps=ts[i].astype(np.int64),
                values={"count": vals[i]},
            ))
    return ms


def device_path(entry, exec_plan):
    """The exec node's device work on a staged superblock."""
    from filodb_tpu_torch.ops import aggregations as AGG
    from filodb_tpu_torch.ops.kernels import RangeParams

    gids, G, _ = AGG.group_ids_memo(entry.block, entry.labels, exec_plan.by,
                                    exec_plan.without, strip_metric=True)
    params = RangeParams(exec_plan.start_ms, exec_plan.step_ms, exec_plan.num_steps(),
                         exec_plan.window_ms)
    return AGG.fused_range_aggregate(exec_plan.function, exec_plan.op, entry.block, gids, G,
                                     params, is_counter=entry.is_counter)


def window_stats_path(entry, exec_plan, plain: bool):
    """The exec node's work on the window-stats rung: stats (the kernel, or
    its plain version) -> finish -> slice -> segment aggregate."""
    from filodb_tpu_torch.ops import aggregations as AGG
    from filodb_tpu_torch.ops import window_stats as WS
    from filodb_tpu_torch.ops.kernels import pad_steps

    block = entry.block
    j_pad = pad_steps(exec_plan.num_steps())
    start_off = exec_plan.start_ms - block.base_ms
    stats = (WS.window_stats_plain if plain else WS.window_stats)(
        block.ts, block.vals, block.raw, block.lens, start_off, exec_plan.step_ms,
        exec_plan.window_ms, j_pad)
    sj = WS.finish(exec_plan.function or "last", stats, start_off, exec_plan.step_ms, exec_plan.window_ms,
                   is_counter=entry.is_counter)[: block.vals.shape[0], :j_pad]
    gids, G, _ = AGG.group_ids_memo(block, entry.labels, exec_plan.by, exec_plan.without,
                                    strip_metric=True)
    return AGG.apply_epilogue(sj, ("agg", exec_plan.op), gids, G)[:, : exec_plan.num_steps()]


def run_queries(engine, phase: str, rung: str) -> dict:
    """The main path: each query through the user's entry point, with every
    launch count set to 0 just before and read just after; the port's
    ladder is watched for the grid class and the rung it picks."""
    from filodb_tpu_torch.ops import aggregations as AGG
    from filodb_tpu_torch.ops import mxu_kernels as MK
    from filodb_tpu_torch.ops import window_stats as WS
    from filodb_tpu_torch.ops.staging import grid_class

    counters = {"window_stats": WS, "regular_range": MK}
    kernel = "regular_range" if rung == "mxu" else "window_stats"
    want_class = "regular" if rung == "mxu" else "irregular"
    seen = []
    ladder = AGG.grid_variant

    def watched(block, func, is_delta=False):
        variant = ladder(block, func, is_delta)
        seen.append((grid_class(block), variant))
        return variant

    AGG.grid_variant = watched
    results, launches = {}, 0
    try:
        for q in QUERIES:
            seen.clear()
            for mod in counters.values():
                mod.LAUNCHES = 0
            t0 = time.perf_counter()
            res = engine.query_range(q, START_S, END_S, STEP_S)
            vals = res.grids[0].values_np()
            wall = time.perf_counter() - t0
            counts = {name: mod.LAUNCHES for name, mod in counters.items()}
            require(seen == [(want_class, rung)],
                    f"{q}: grid class and rung {seen}, expected {[(want_class, rung)]}")
            require(counts == {k: int(k == kernel) for k in counters},
                    f"{q}: launches {counts}, expected one {kernel} launch and no other")
            launches += counts[kernel]
            results[q] = res
            print(f"{phase} query {q!r}: grid {want_class}, rung {rung}, "
                  f"{len(res.grids[0].labels)} groups x {res.grids[0].num_steps} steps, "
                  f"{res.stats.series_scanned} series, {res.stats.samples_scanned} samples, "
                  f"{wall * 1e3:.1f} ms end to end, launches {counts}")
            require(np.isfinite(vals).all(), f"{q}: non-finite values in the result")
            require((vals > 0).all(), f"{q}: a counter rate must be positive")
    finally:
        AGG.grid_variant = ladder
    by_zone = results[QUERIES[1]].grids[0]
    require(sorted(l["zone"] for l in by_zone.labels) == [f"z{i}" for i in range(8)],
            "sum by (zone) must return the 8 zones")
    total = results[QUERIES[0]].grids[0].values_np()
    require(np.allclose(by_zone.values_np().sum(axis=0), total[0], rtol=1e-4),
            "the zones' rates must add up to the global rate")
    print(f"{phase}: the 8 zones' rates add up to the global rate (rtol 1e-4)")
    return {"results": results, "launches": launches}


def stage_again(engine, q: str):
    """The query's exec node and its superblock, staged again (timed)."""
    import torch

    from filodb_tpu_torch.query.promql import query_range_to_logical_plan

    plan = query_range_to_logical_plan(q, START_S, END_S, STEP_S)
    ex = engine.planner.materialize(plan)
    t0 = time.perf_counter()
    entry = ex.superblock(engine.context())
    torch.cuda.synchronize(engine.device)
    return ex, entry, time.perf_counter() - t0


def phase_irregular_path(seed: int, device) -> dict:
    import torch

    from filodb_tpu_torch.coordinator.planner import QueryEngine
    from filodb_tpu_torch.ops.kernels import pad_steps

    t0 = time.perf_counter()
    ms = build_memstore(N_SERIES, N_SAMPLES, seed, regular=False)
    print(f"phase4 ingest: {N_SERIES} irregular series x {N_SAMPLES} samples on {N_SHARDS} "
          f"shards in {time.perf_counter() - t0:.1f} s")
    engine = QueryEngine(ms, "prometheus")
    require(engine.device == device, f"the engine runs on {engine.device}, not {device}")
    run = run_queries(engine, "phase4", "window_stats")

    # the same superblock through the plain window stats on the card
    kernel_row = None
    for q in QUERIES:
        ex, entry, stage_s = stage_again(engine, q)
        dev_ms = cuda_ms(lambda: device_path(entry, ex), reps=5)
        print(f"phase4 {q!r}: superblock staged in {stage_s:.2f} s (host gather, "
              f"stage, copy); device path (window stats + finish + aggregate) {dev_ms:.3f} ms")
        want = window_stats_path(entry, ex, plain=True)
        got = torch.as_tensor(run["results"][q].grids[0].values_np(), device=device)
        compare(got, want, q, rtol=1e-3)
        print(f"phase4 {q!r}: [G, J] matches the plain path (rtol 1e-3)")
        if kernel_row is None:
            kernel_row = time_window_stats(entry.block, len(entry.labels), ex,
                                           j_pad=pad_steps(ex.num_steps()))
    kernel_row["launches"] = run["launches"]
    return kernel_row


def time_window_stats(block, n_series: int, ex, j_pad: int) -> dict:
    """Kernel vs plain at the main path's shape, with the kernel's time and
    its bound: the bytes the query needs, each real sample's ts, value and
    raw value and each series' length read once, and the nine planes
    written once at [n_series, num_steps]. The padded rows and steps the
    kernel also writes (sliced off or sent to the trash group after) are
    printed as a second, padded bound."""
    from filodb_tpu_torch.ops import window_stats as WS

    S, T = block.ts.shape
    start_off = ex.start_ms - block.base_ms
    args = (block.ts, block.vals, block.raw, block.lens, start_off, ex.step_ms,
            ex.window_ms, j_pad)
    err = compare_stats(WS.window_stats(*args), WS.window_stats_plain(*args))
    k_ms = cuda_ms(lambda: WS.window_stats(*args), reps=20)
    p_ms = cuda_ms(lambda: WS.window_stats_plain(*args), reps=3, warmup=1)
    J = ex.num_steps()
    real = int(block.lens.sum())
    in_bytes = real * 12 + n_series * 4  # ts+vals+raw per real sample, lens per series
    need_bytes = in_bytes + 9 * n_series * J * 4
    padded_bytes = in_bytes + 9 * S * j_pad * 4
    block_bytes = 3 * S * T * 4 + S * 4
    bound_ms = need_bytes / HBM_BYTES_PER_S * 1e3
    padded_ms = padded_bytes / HBM_BYTES_PER_S * 1e3
    print(f"phase4 superblock [{S}, {T}] for {n_series} series ({real} real samples), "
          f"{block_bytes} bytes staged (ts+vals+raw+lens); stats planes 9 x [{S}, {j_pad}] f32 "
          f"= {9 * S * j_pad * 4} bytes written, of which 9 x [{n_series}, {J}] needed")
    print(f"phase4 window_stats kernel: {k_ms:.4f} ms (median of 20), plain {p_ms:.2f} ms, "
          f"bound {bound_ms:.4f} ms ({need_bytes} bytes at 3.35 TB/s; padded bound "
          f"{padded_ms:.4f} ms, {padded_bytes} bytes, padding "
          f"{(padded_bytes - need_bytes) / padded_bytes:.1%} of them), "
          f"max_abs_err vs plain {err:.3g}")
    return {
        "name": "window_stats",
        "route": "cuda",
        "source": "filodb_tpu_torch/csrc/window_stats.cu",
        "replaces": "filodb_tpu/ops/pallas_kernels.py:33",
        "launches": 0,
        "max_abs_err": err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
    }


def regular_bound_bytes(wm, n_series: int, num_steps: int, G: int, func: str) -> int:
    """Bytes the function must move over the real rows and steps, from the
    query's window bounds: the 32-byte sectors of a row's vals (and raw,
    for the counter zero-crossing cap) that it reads, times the rows (rows
    are 32-byte aligned, so each reads the same sectors); each real row's
    gid; the seven per-step arrays; acc and cnt at [G, num_steps]."""
    lo = wm.lo.cpu().numpy()[:num_steps].astype(np.int64)
    hi = wm.hi.cpu().numpy()[:num_steps].astype(np.int64)
    count = hi - lo
    if func == "rate":
        ok = count >= 2
        vals_pos = np.concatenate([lo[ok], hi[ok] - 1])
        raw_pos = lo[ok]
    else:  # sum_over_time: every sample of every window
        vals_pos = np.concatenate([np.arange(a, b) for a, b in zip(lo, hi)] + [np.empty(0, np.int64)])
        raw_pos = np.empty(0, np.int64)
    sectors = len(np.unique(vals_pos * 4 // 32)) + len(np.unique(raw_pos * 4 // 32))
    return sectors * 32 * n_series + n_series * 8 + 7 * num_steps * 4 + 2 * G * num_steps * 4


def phase_regular_path(seed: int, device) -> dict:
    import torch

    from filodb_tpu_torch.coordinator.planner import QueryEngine
    from filodb_tpu_torch.ops import aggregations as AGG
    from filodb_tpu_torch.ops import mxu_kernels as MK
    from filodb_tpu_torch.ops.kernels import RangeParams, pad_steps

    t0 = time.perf_counter()
    ms = build_memstore(N_SERIES, N_SAMPLES, seed, regular=True)
    print(f"phase5 ingest: {N_SERIES} series x {N_SAMPLES} samples at exactly 10 s "
          f"(bench.py's store) on {N_SHARDS} shards in {time.perf_counter() - t0:.1f} s")
    engine = QueryEngine(ms, "prometheus")
    run = run_queries(engine, "phase5", "mxu")

    row = None
    for q in QUERIES:
        ex, entry, stage_s = stage_again(engine, q)
        block = entry.block
        dev_ms = cuda_ms(lambda: device_path(entry, ex), reps=20)
        print(f"phase5 {q!r}: superblock {list(block.shape)} staged in {stage_s:.2f} s "
              f"(host gather, stage, copy); device path (regular kernel + [G, J] finish) "
              f"{dev_ms:.4f} ms")
        gids, G, _ = AGG.group_ids_memo(block, entry.labels, ex.by, ex.without, strip_metric=True)
        params = RangeParams(ex.start_ms, ex.step_ms, ex.num_steps(), ex.window_ms)
        J = ex.num_steps()
        got = torch.as_tensor(run["results"][q].grids[0].values_np(), device=device)
        want = regular_plain(ex.function, ex.op, block, gids, G, params, entry.is_counter)[:, :J]
        err = compare(got, want, f"{q} vs plain", rtol=1e-3)
        compare(got, window_stats_path(entry, ex, plain=False), f"{q} vs window stats",
                rtol=1e-3)
        print(f"phase5 {q!r}: [G, J] matches the plain path (max_abs_err {err:.3g}) and the "
              f"window-stats rung on the same superblock (rtol 1e-3)")
        wm = MK.window_matrices(block, ex.start_ms - block.base_ms, ex.step_ms,
                                pad_steps(J), ex.window_ms)
        raw = block.raw if block.raw is not None else block.vals

        def kernel(func):
            return lambda: MK._launch(func, ex.op, block.vals, raw, gids, G, wm,
                                      entry.is_counter, False)

        k_ms = cuda_ms(kernel("rate"), reps=20)
        print(f"phase5 {q!r}: regular_range kernel {k_ms:.4f} ms (median of 20, {G} groups)")
        if row is not None:
            continue
        s_ms = cuda_ms(kernel("sum_over_time"), reps=20)
        p_ms = cuda_ms(lambda: regular_plain("rate", ex.op, block, gids, G, params,
                                             entry.is_counter), reps=3, warmup=1)
        lib_ms = cuda_ms(lambda: torch.matmul(block.vals, wm.W), reps=20)
        n = len(entry.labels)
        rate_bytes = regular_bound_bytes(wm, n, J, G, "rate")
        sum_bytes = regular_bound_bytes(wm, n, J, G, "sum_over_time")
        bound_ms = rate_bytes / HBM_BYTES_PER_S * 1e3
        sum_bound_ms = sum_bytes / HBM_BYTES_PER_S * 1e3
        print(f"phase5 regular_range on sum(rate): plain {p_ms:.3f} ms, bound {bound_ms:.4f} ms "
              f"({rate_bytes} bytes at 3.35 TB/s)")
        print(f"phase5 regular_range kernel on sum(sum_over_time): {s_ms:.4f} ms (median of 20), "
              f"bound {sum_bound_ms:.4f} ms ({sum_bytes} bytes); torch.matmul(vals, W) "
              f"[{block.shape[0]}, {block.shape[1]}] x [{block.shape[1]}, {pad_steps(J)}] "
              f"(cuBLAS f32, TF32 off) {lib_ms:.4f} ms")
        row = {
            "name": "regular_range",
            "route": "cuda",
            "source": "filodb_tpu_torch/csrc/regular_range.cu",
            "replaces": "filodb_tpu/ops/mxu_kernels.py:250",
            "launches": 0,
            "max_abs_err": err,
            "ms": k_ms,
            "plain_ms": p_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes",
            "library_ms": lib_ms,
            "library_call": "torch.matmul(vals, W): the window sums of sum_over_time",
            "sum_over_time_ms": s_ms,
            "sum_over_time_bound_ms": sum_bound_ms,
        }
    row["launches"] = run["launches"]
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 matmuls in full f32
    device = torch.device("cuda")
    build_kernels()
    card = card_line()
    print(f"phase1 card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    phase_window_stats_vs_plain(args.seed, device)
    phase_regular_vs_plain(args.seed, device)
    ws_row = phase_irregular_path(args.seed, device)
    gc.collect()  # the irregular store goes before the regular one is built
    torch.cuda.empty_cache()
    reg_row = phase_regular_path(args.seed, device)

    print(json.dumps({"kernels": [ws_row, reg_row]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
