"""Window statistics for irregular series (counterpart of
``filodb_tpu/ops/pallas_kernels.py``).

``window_stats`` computes, for every series row and output step
``t_j = start + j * step``, nine statistics over the window
``(t_j - window, t_j]``: count, sum, min, max, first/last timestamp,
first/last value and first raw value. On a CUDA tensor it launches the
hand-written kernel ``csrc/window_stats.cu``; on a CPU tensor it runs
``window_stats_plain``, the same function in plain torch. ``finish`` derives
any of ``PALLAS_FUNCS`` from the statistics, with Prometheus extrapolation
for rate/increase/delta.

The kernel is built with ``nvcc`` at first use into ``_build/`` beside the
package and bound through ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

NEG = -3.0e38
POS = 3.0e38
IMAX = 2**31 - 1
IMIN = -(2**31) + 1
STAT_NAMES = ("count", "sum", "min", "max", "t_first", "t_last", "v_first", "v_last", "raw_first")

PALLAS_FUNCS = {
    "sum_over_time", "count_over_time", "avg_over_time", "min_over_time",
    "max_over_time", "last", "last_over_time", "first_over_time",
    "present_over_time", "absent_over_time", "rate", "increase", "delta",
}

# kernel launches since the last reset (the wrapper's only state)
LAUNCHES = 0

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "window_stats.cu"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the window-stats kernel cannot be built")


def build() -> Path:
    """Compile ``csrc/window_stats.cu`` for sm_90a into a shared library
    named by the source's hash (rebuilt only when the source changes).
    Returns its path; nvcc's ptxas report is kept beside it, in the ``.log``
    of the same name, which ``build_log()`` reads."""
    src = _SOURCE.read_bytes()
    out = _BUILD_DIR / f"window_stats-{hashlib.sha256(src).hexdigest()[:12]}.so"
    if out.exists() and out.with_suffix(".log").exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC", "-o", tmp, str(_SOURCE)],
            capture_output=True, text=True, check=False,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build_log() -> str:
    """nvcc's output (the ptxas report) from the build of the current source."""
    return build().with_suffix(".log").read_text()


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.filodb_window_stats
        fn.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 10
        )
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_inputs(ts, vals, raw, lens) -> None:
    S, T = ts.shape if ts.dim() == 2 else (None, None)
    if S is None:
        raise ValueError(f"ts must be [S, T], got {tuple(ts.shape)}")
    for name, t, dtype, shape in (
        ("ts", ts, torch.int32, (S, T)), ("vals", vals, torch.float32, (S, T)),
        ("raw", raw, torch.float32, (S, T)), ("lens", lens, torch.int32, (S,)),
    ):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if t.device != ts.device:
            raise ValueError(f"{name} is on {t.device}, ts on {ts.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def window_stats(ts, vals, raw, lens, start_off: int, step_ms: int, window_ms: int,
                 num_steps: int) -> dict[str, torch.Tensor]:
    """[S, T] staged block -> dict of nine [S, num_steps] f32 statistics.

    A CUDA block launches the kernel (and raises if the launch fails); a
    CPU block runs ``window_stats_plain``."""
    _check_inputs(ts, vals, raw, lens)
    if ts.device.type == "cpu":
        return window_stats_plain(ts, vals, raw, lens, start_off, step_ms, window_ms, num_steps)
    if ts.device.type != "cuda":
        raise ValueError(f"window_stats runs on cuda or cpu tensors, not {ts.device}")
    global LAUNCHES
    lib = _load()
    S, T = ts.shape
    outs = [torch.empty((S, num_steps), dtype=torch.float32, device=ts.device)
            for _ in STAT_NAMES]
    with torch.cuda.device(ts.device):
        stream = torch.cuda.current_stream(ts.device).cuda_stream
        err = lib.filodb_window_stats(
            ts.data_ptr(), vals.data_ptr(), raw.data_ptr(), lens.data_ptr(),
            S, T, num_steps, int(start_off), int(step_ms), int(window_ms),
            *[o.data_ptr() for o in outs], stream,
        )
    if err != 0:
        raise RuntimeError(f"window_stats kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return dict(zip(STAT_NAMES, outs))


def window_stats_plain(ts, vals, raw, lens, start_off: int, step_ms: int,
                       window_ms: int, num_steps: int) -> dict[str, torch.Tensor]:
    """The window statistics in plain torch, written from the TPU kernel's
    definition: a [rows, J, T] window mask per chunk of rows, first/last
    selected by int32 timestamp equality (ties summed, as on the TPU).
    Chunks keep the mask near 2^24 elements, so it runs at the main path's
    size on the card."""
    dev = ts.device
    S, T = ts.shape
    J = num_steps
    i32 = torch.int32
    start = torch.tensor(start_off, dtype=i32, device=dev)
    step = torch.tensor(step_ms, dtype=i32, device=dev)
    window = torch.tensor(window_ms, dtype=i32, device=dev)
    t_j = start + torch.arange(J, dtype=i32, device=dev) * step  # [J]
    t_lo = t_j - window
    lane = torch.arange(T, dtype=i32, device=dev)
    outs = {k: torch.empty((S, J), dtype=torch.float32, device=dev) for k in STAT_NAMES}
    rows = max(1, (1 << 24) // max(1, T * J))
    for r0 in range(0, S, rows):
        r1 = min(S, r0 + rows)
        t = ts[r0:r1, None, :]  # [R, 1, T]
        v = vals[r0:r1, None, :]
        rw = raw[r0:r1, None, :]
        valid = (lane[None, :] < lens[r0:r1, None])[:, None, :]
        m = (t <= t_j[None, :, None]) & (t > t_lo[None, :, None]) & valid  # [R, J, T]
        tmin = torch.where(m, t, IMAX).amin(dim=2)
        tmax = torch.where(m, t, IMIN).amax(dim=2)
        first_m = m & (t == tmin[:, :, None])
        last_m = m & (t == tmax[:, :, None])
        o = outs
        o["count"][r0:r1] = m.sum(dim=2, dtype=torch.float32)
        o["sum"][r0:r1] = torch.where(m, v, 0.0).sum(dim=2)
        o["min"][r0:r1] = torch.where(m, v, POS).amin(dim=2)
        o["max"][r0:r1] = torch.where(m, v, NEG).amax(dim=2)
        o["t_first"][r0:r1] = tmin.to(torch.float32)
        o["t_last"][r0:r1] = tmax.to(torch.float32)
        o["v_first"][r0:r1] = torch.where(first_m, v, 0.0).sum(dim=2)
        o["v_last"][r0:r1] = torch.where(last_m, v, 0.0).sum(dim=2)
        o["raw_first"][r0:r1] = torch.where(first_m, rw, 0.0).sum(dim=2)
    return outs


def finish(func: str, agg: dict, start_off: int, step_ms: int, window_ms: int,
           is_counter: bool = False, is_delta: bool = False) -> torch.Tensor:
    """Derive a range function from the window statistics (line for line
    ``pallas_kernels.finish``)."""
    cnt = agg["count"]
    dev = cnt.device
    f32 = torch.float32
    window_ms = torch.tensor(window_ms, dtype=torch.int32, device=dev)
    has = cnt > 0
    nan = float("nan")
    if func == "sum_over_time" or (is_delta and func in ("rate", "increase")):
        r = agg["sum"]
        if func == "rate":
            r = r / (window_ms.to(f32) * 1e-3)
        return torch.where(has, r, nan)
    if func == "count_over_time":
        return torch.where(has, cnt, nan)
    if func == "avg_over_time":
        return torch.where(has, agg["sum"] / torch.clamp(cnt, min=1.0), nan)
    if func == "min_over_time":
        return torch.where(has, agg["min"], nan)
    if func == "max_over_time":
        return torch.where(has, agg["max"], nan)
    if func in ("last", "last_over_time"):
        return torch.where(has, agg["v_last"], nan)
    if func == "first_over_time":
        return torch.where(has, agg["v_first"], nan)
    if func == "present_over_time":
        return torch.where(has, torch.ones_like(cnt), nan)
    if func == "absent_over_time":
        return torch.where(has, nan, torch.ones_like(cnt))
    if func in ("rate", "increase", "delta"):
        J = cnt.shape[1]
        start = torch.tensor(start_off, dtype=torch.int32, device=dev)
        step = torch.tensor(step_ms, dtype=torch.int32, device=dev)
        out_t = (start + torch.arange(J, dtype=torch.int32, device=dev) * step).to(f32)
        w_s = window_ms.to(f32) * 1e-3
        tf = agg["t_first"] * 1e-3
        tl = agg["t_last"] * 1e-3
        dlt = agg["v_last"] - agg["v_first"]
        sampled = tl - tf
        dur_start = tf - (out_t - window_ms.to(f32))[None, :] * 1e-3
        dur_end = out_t[None, :] * 1e-3 - tl
        avg_dur = sampled / torch.clamp(cnt - 1.0, min=1.0)
        thresh = avg_dur * 1.1
        inf = float("inf")
        if is_counter and func != "delta":
            dur_zero = torch.where(
                dlt > 0, sampled * (agg["raw_first"] / torch.clamp(dlt, min=1e-30)), inf
            )
            dur_start = torch.minimum(dur_start, torch.where(agg["raw_first"] >= 0, dur_zero, inf))
        dur_start = torch.where(dur_start >= thresh, avg_dur / 2.0, dur_start)
        dur_end = torch.where(dur_end >= thresh, avg_dur / 2.0, dur_end)
        factor = (sampled + dur_start + dur_end) / torch.clamp(sampled, min=1e-30)
        res = dlt * factor
        if func == "rate":
            res = res / w_s
        return torch.where(cnt >= 2, res, nan)
    raise ValueError(f"window-stats path does not support {func}")
