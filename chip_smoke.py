#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``filodb_tpu_torch``) on one NVIDIA
card: build its kernel, hold the kernel against its plain PyTorch version,
drive the main path at full size, and check what comes out.

    python3 chip_smoke.py [--seed N]

Phases (any failure raises and exits non-zero):

1. Build ``filodb_tpu_torch/csrc/window_stats.cu`` with nvcc; print the
   card's name and power limit.
2. Kernel vs plain on seeded irregular blocks, S in {1, 65, 4096} and T in
   {128, 768}, gauge and counter data: count exact, first/last timestamps
   bit-equal, the other planes within rtol 2e-4 / atol 1e-4, NaN masks equal.
3. Main path: 100k ``http_requests_total`` counter series on 8 shards, 720
   samples each at irregular 5-15 s intervals, ingested through
   ``TimeSeriesShard.ingest_series``; ``sum(rate(...[5m]))`` and
   ``sum by (zone) (rate(...[5m]))`` through ``QueryEngine`` on the card.
   Each query must launch the kernel exactly once, and its [G, J] result
   must match the same superblock run through the plain window stats,
   finish and segment aggregate (rtol 1e-3: index_add_ atomics reorder the
   f32 sums; NaN masks equal). Prints the superblock's shape and bytes and
   the kernel's time (median of 20 after warm-up) beside its bound: the
   bytes the query needs (each real sample's ts, value and raw value read
   once, the nine planes written once at [series, steps]), with the padded
   bound (the nine planes at the kernel's padded [S, J]) beside it.

Prints, in order at the end: one JSON object with the kernel's numbers, the
card's name and power limit as nvidia-smi gives them, and the result line
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result, where
no CUDA device is available.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

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


def compare_stats(got: dict, want: dict, rtol: float = 2e-4, atol: float = 1e-4) -> float:
    """Hold the kernel's nine planes against the plain version's; returns
    the largest absolute difference over the planes."""
    import torch

    worst = 0.0
    for name, w in want.items():
        g = got[name]
        require(torch.equal(torch.isnan(g), torch.isnan(w)), f"{name}: NaN masks differ")
        m = ~torch.isnan(w)
        gm, wm = g[m], w[m]
        if name in ("count", "t_first", "t_last"):
            require(torch.equal(gm, wm), f"{name}: kernel differs from plain")
        else:
            bad = (gm - wm).abs() > atol + rtol * wm.abs()
            require(not bool(bad.any()), f"{name}: {int(bad.sum())} values outside tolerance")
        if gm.numel():
            worst = max(worst, float((gm.double() - wm.double()).abs().max()))
    return worst


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


def phase_kernel_vs_plain(seed: int, device) -> None:
    from filodb_tpu_torch.ops import window_stats as WS

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


def build_memstore(n_series: int, n_samples: int, seed: int):
    """``n_series`` counters on 8 shards at strictly increasing irregular
    intervals, uniform 5-15 s, ingested through the port's shard API."""
    from filodb_tpu_torch.core.records import SeriesBatch
    from filodb_tpu_torch.core.schemas import METRIC_TAG, PROM_COUNTER, Dataset, shard_for
    from filodb_tpu_torch.memstore.memstore import TimeSeriesMemStore
    from filodb_tpu_torch.memstore.shard import StoreConfig

    rng = np.random.default_rng(seed)
    ms = TimeSeriesMemStore(StoreConfig(max_chunk_size=n_samples))
    ms.setup(Dataset("prometheus"), range(N_SHARDS))
    blk = 10_000
    for b0 in range(0, n_series, blk):
        n = min(blk, n_series - b0)
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


def plain_path(entry, exec_plan, ctx):
    """The exec node's work with the plain window stats in place of the
    kernel: plain stats -> finish -> slice -> segment aggregate."""
    from filodb_tpu_torch.ops import aggregations as AGG
    from filodb_tpu_torch.ops import window_stats as WS
    from filodb_tpu_torch.ops.kernels import pad_steps

    block = entry.block
    j_pad = pad_steps(exec_plan.num_steps())
    start_off = exec_plan.start_ms - block.base_ms
    stats = WS.window_stats_plain(block.ts, block.vals, block.raw, block.lens, start_off,
                                  exec_plan.step_ms, exec_plan.window_ms, j_pad)
    sj = WS.finish(exec_plan.function or "last", stats, start_off, exec_plan.step_ms, exec_plan.window_ms,
                   is_counter=entry.is_counter)[: block.vals.shape[0], :j_pad]
    gids, G, _ = AGG.group_ids_memo(block, entry.labels, exec_plan.by, exec_plan.without,
                                    strip_metric=True)
    return AGG.apply_epilogue(sj, ("agg", exec_plan.op), gids, G)[:, : exec_plan.num_steps()]


def phase_main_path(seed: int, device) -> dict:
    import torch

    from filodb_tpu_torch.coordinator.planner import QueryEngine
    from filodb_tpu_torch.ops import window_stats as WS
    from filodb_tpu_torch.ops.kernels import pad_steps
    from filodb_tpu_torch.query.promql import query_range_to_logical_plan

    t0 = time.perf_counter()
    ms = build_memstore(N_SERIES, N_SAMPLES, seed)
    print(f"phase3 ingest: {N_SERIES} series x {N_SAMPLES} samples on {N_SHARDS} shards "
          f"in {time.perf_counter() - t0:.1f} s")
    start_s = (BASE + 400_000) / 1000
    end_s = (BASE + N_SAMPLES * 10_000 - 200_000) / 1000
    engine = QueryEngine(ms, "prometheus")
    require(engine.device == device, f"the engine runs on {engine.device}, not {device}")

    # the main path: each query through the user's entry point, with the
    # launch count set to 0 just before and read just after
    results, launches = {}, 0
    for q in QUERIES:
        WS.LAUNCHES = 0
        t0 = time.perf_counter()
        res = engine.query_range(q, start_s, end_s, STEP_S)
        vals = res.grids[0].values_np()
        wall = time.perf_counter() - t0
        n = WS.LAUNCHES
        require(n == 1, f"{q}: kernel launched {n} times, expected 1")
        launches += n
        results[q] = res
        print(f"phase3 query {q!r}: {len(res.grids[0].labels)} groups x "
              f"{res.grids[0].num_steps} steps, {res.stats.series_scanned} series, "
              f"{res.stats.samples_scanned} samples, {wall * 1e3:.1f} ms end to end, "
              f"kernel launches {n}")
        require(np.isfinite(vals).all(), f"{q}: non-finite values in the result")
        require((vals > 0).all(), f"{q}: a counter rate must be positive")

    by_zone = results[QUERIES[1]].grids[0]
    require(sorted(l["zone"] for l in by_zone.labels) == [f"z{i}" for i in range(8)],
            "sum by (zone) must return the 8 zones")
    total = results[QUERIES[0]].grids[0].values_np()
    require(np.allclose(by_zone.values_np().sum(axis=0), total[0], rtol=1e-4),
            "the zones' rates must add up to the global rate")

    # the same superblock through the plain window stats on the card
    kernel_row = None
    for q in QUERIES:
        plan = query_range_to_logical_plan(q, start_s, end_s, STEP_S)
        ex = engine.planner.materialize(plan)
        ctx = engine.context()
        t0 = time.perf_counter()
        entry = ex.superblock(ctx)
        torch.cuda.synchronize(device)
        stage_s = time.perf_counter() - t0
        dev_ms = cuda_ms(lambda: device_path(entry, ex), reps=5)
        print(f"phase3 {q!r}: superblock staged in {stage_s:.2f} s (host gather, "
              f"stage, copy); device path (window stats + finish + aggregate) {dev_ms:.3f} ms")
        want = plain_path(entry, ex, ctx)
        got = torch.as_tensor(results[q].grids[0].values_np(), device=device)
        require(torch.equal(torch.isnan(got), torch.isnan(want)), f"{q}: NaN masks differ")
        bad = (got - want).abs() > 1e-3 * want.abs()
        require(not bool(bad.any()), f"{q}: {int(bad.sum())} of [G, J] differ from plain by > 1e-3")
        print(f"phase3 {q!r}: [G, J] matches the plain path (rtol 1e-3)")
        if kernel_row is None:
            kernel_row = time_kernel(entry.block, len(entry.labels), ex,
                                     j_pad=pad_steps(ex.num_steps()))
    kernel_row["launches"] = launches
    return kernel_row


def time_kernel(block, n_series: int, ex, j_pad: int) -> dict:
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
    print(f"phase3 superblock [{S}, {T}] for {n_series} series ({real} real samples), "
          f"{block_bytes} bytes staged (ts+vals+raw+lens); stats planes 9 x [{S}, {j_pad}] f32 "
          f"= {9 * S * j_pad * 4} bytes written, of which 9 x [{n_series}, {J}] needed")
    print(f"phase3 window_stats kernel: {k_ms:.4f} ms (median of 20), plain {p_ms:.2f} ms, "
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from filodb_tpu_torch.ops import window_stats as WS

    device = torch.device("cuda")
    t0 = time.perf_counter()
    lib = WS.build()
    print(f"phase1 built {lib.name} in {time.perf_counter() - t0:.1f} s")
    for line in WS.build_log().splitlines():
        if "registers" in line or "spill" in line:
            print(f"phase1 ptxas: {line.strip()}")
    card = card_line()
    print(f"phase1 card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    phase_kernel_vs_plain(args.seed, device)
    row = phase_main_path(args.seed, device)

    print(json.dumps({"kernels": [row]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
