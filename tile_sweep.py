#!/usr/bin/env python3
"""Tile-layout sweep of the port's two fused kernels on one NVIDIA card, at
the main path's shape: a [131072, 768] superblock with 100k real series
(irregular 5-15 s rows for the fused window-stats kernel, a shared 10 s
grid for the regular kernel), 111 steps, 5 m windows, sum over 1 group.

    python3 tile_sweep.py [--split]

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
library.

Prints the card's name and power limit, and ends with one JSON object of
every time. Exits non-zero where no CUDA device is available.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--split", action="store_true", help="also time patched copies")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("tile_sweep: no CUDA device is available", file=sys.stderr)
        return 2
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
