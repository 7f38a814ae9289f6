"""The sorted-window range functions (counterpart of
``filodb_tpu/ops/kernels.py``'s ``sorted_window_kernel``, B8):
``quantile_over_time(q)``, ``median_absolute_deviation_over_time`` and
``last_over_time_is_mad_outlier(tolerance, bounds)`` of every (series,
step) over the window ``(t_j - w, t_j]``.

On a CUDA block ``sorted_window`` makes one launch of
``csrc/sorted_window.cu`` (``filodb_sorted_window``): a warp per row, the
row staged in shared memory (``sorted_plan``), each lane selecting its own
step's order statistics by counting for windows of up to ``LANE_CAP``
samples, the warp a radix select for longer ones; it writes the ``[S,
J_pad]`` grid. On a CPU block it runs ``sorted_window_plain``, the JAX
algorithm in torch (a ``[rows, steps, T]`` masked sort per chunk). Its
launches are counted in ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from . import cuda_build
from .kernels import _window_mask, pad_steps

SORTED_FUNCS = frozenset({
    "quantile_over_time", "median_absolute_deviation_over_time",
    "last_over_time_is_mad_outlier",
})
# the kernel's function codes (csrc/sorted_window.cu, enum SFunc)
SORTED_FUNC_CODES = {"quantile_over_time": 0, "median_absolute_deviation_over_time": 1,
                     "last_over_time_is_mad_outlier": 2}
WARPS = 4  # warps per block (csrc/sorted_window.cu WARPS)
LANE_CAP = 64  # windows a lane orders alone by counting; longer ones the warp (radix select)
BINS = 256  # the warp route's histogram, in the warp's buffer
BLOCK_SMEM = 227 * 1024  # the most dynamic shared memory a block may use
CHUNK_ELEMENTS = 1 << 24  # [rows, steps, T] elements per chunk of the plain version

# launches since the last reset, and the last launch's layout (SortedPlan)
LAUNCHES = 0
LAST_PLAN = None

_lib = None


@dataclass(frozen=True)
class SortedPlan:
    """One launch's layout: each warp's row ``staged`` in its shared buffer
    of ``words`` 32-bit words ([T] timestamps, [T] keys and the warp
    route's [BINS] histogram) or read in place (the histogram alone), and
    the dynamic shared memory of a block of ``WARPS`` warps."""

    staged: bool
    words: int
    smem_bytes: int


@functools.lru_cache(maxsize=64)
def sorted_plan(T: int) -> SortedPlan:
    """The layout of a launch over a block ``T`` samples wide, from the
    width alone: its rows staged while ``WARPS`` of them fit a block's
    shared memory, else read in place. The route of a window (a lane's
    count up to ``LANE_CAP`` samples, the warp's radix select above) is
    the kernel's, from the window's length."""
    staged_words = 2 * int(T) + BINS
    staged = 4 * WARPS * staged_words <= BLOCK_SMEM
    words = staged_words if staged else BINS
    return SortedPlan(staged, words, 4 * WARPS * words)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the entry point's argument types on a built library."""
    fn = lib.filodb_sorted_window
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_float] * 2
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    return lib


def _load():
    global _lib
    if _lib is None:
        _lib = bind(ctypes.CDLL(str(cuda_build.build("sorted_window"))))
    return _lib


def func_args(args) -> tuple[float, float]:
    """(q, arg1) as the JAX dispatch passes them: f32, q 0.5 and arg1 0
    when absent."""
    q = float(torch.tensor(args[0], dtype=torch.float32)) if len(args) > 0 else 0.5
    a1 = float(torch.tensor(args[1], dtype=torch.float32)) if len(args) > 1 else 0.0
    return q, a1


def sorted_window(func: str, block, params, args=()) -> torch.Tensor:
    """``func`` of every series of a staged block -> [S_padded, J_pad] f32
    on the block's device, NaN in the padded rows and past
    ``params.num_steps``. ``args`` are the function's arguments (q; the
    outlier's tolerance and bounds mode). A CUDA block makes one launch of
    the kernel (and raises if the launch fails); a CPU block runs
    ``sorted_window_plain``."""
    if func not in SORTED_FUNCS:
        raise NotImplementedError(f"range function {func!r} is not a sorted-window function")
    ts, vals, lens = block.ts, block.vals, block.lens
    if ts.dtype != torch.int32 or vals.dtype != torch.float32 or lens.dtype != torch.int32:
        raise TypeError("sorted_window takes int32 ts/lens and f32 vals")
    if vals.shape != ts.shape or lens.shape != ts.shape[:1] or vals.device != ts.device:
        raise ValueError(f"block shapes disagree: ts {tuple(ts.shape)}, vals {tuple(vals.shape)}")
    q, a1 = func_args(args)
    S = ts.shape[0]
    j_pad = pad_steps(params.num_steps)
    start_off = int(params.start_ms - block.base_ms)
    if ts.device.type == "cpu":
        out = torch.full((S, j_pad), float("nan"), dtype=torch.float32)
        out[:, : params.num_steps] = sorted_window_plain(
            func, ts, vals, lens, start_off, params.step_ms, params.window_ms, params.num_steps,
            q, a1)
        out[block.n_series:] = float("nan")
        return out
    if ts.device.type != "cuda":
        raise ValueError(f"sorted_window runs on cuda or cpu tensors, not {ts.device}")
    out = torch.full((S, j_pad), float("nan"), dtype=torch.float32, device=ts.device)
    _launch(func, block, params, q, a1, out)
    return out


def _launch(func: str, block, params, q: float, a1: float, out: torch.Tensor, plan=None,
            lib=None) -> None:
    """One launch over the real rows of ``block`` into ``out`` ([S, ld],
    steps [0, num_steps) written); raises if the launch fails. ``plan``
    defaults to ``sorted_plan``'s, ``lib`` to the package's build (a timing
    script may pass its own)."""
    global LAUNCHES, LAST_PLAN
    for name, t in (("ts", block.ts), ("vals", block.vals), ("lens", block.lens), ("out", out)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lib = lib or _load()
    T = block.ts.shape[1]
    plan = plan or sorted_plan(T)
    with torch.cuda.device(block.ts.device):
        stream = torch.cuda.current_stream(block.ts.device).cuda_stream
        err = lib.filodb_sorted_window(
            block.ts.data_ptr(), block.vals.data_ptr(), block.lens.data_ptr(),
            int(block.n_series), T, int(params.num_steps), out.shape[1],
            int(params.start_ms - block.base_ms), int(params.step_ms), int(params.window_ms),
            SORTED_FUNC_CODES[func], q, a1, int(plan.staged), plan.words, plan.smem_bytes,
            out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"{func} sorted-window kernel launch failed: cudaError {err}")
    LAST_PLAN = plan
    LAUNCHES += 1


def sorted_window_plain(func: str, ts, vals, lens, start_off: int, step_ms: int, window: int,
                        num_steps: int, q: float = 0.5, arg1: float = 0.0) -> torch.Tensor:
    """[S, num_steps] f32: ``sorted_window_kernel`` in plain torch, over
    chunks of rows and steps: the window mask, out-of-window slots +inf,
    -0 made +0 (jnp.sort's canonical zero), a sort along the row (NaN
    last), and the interpolation at rank q (n - 1) of the sorted values;
    MAD sorts |v - median| again; the outlier compares the sum of the
    values at the window's last timestamp with median +- tolerance MAD."""
    dev = ts.device
    f32, i32 = torch.float32, torch.int32
    S, T = ts.shape
    win = torch.tensor(window, dtype=i32, device=dev)
    out_t = (torch.tensor(start_off, dtype=i32, device=dev)
             + torch.arange(num_steps, dtype=i32, device=dev)
             * torch.tensor(step_ms, dtype=i32, device=dev))
    qv = torch.tensor(q, dtype=f32, device=dev)
    a1 = torch.tensor(arg1, dtype=f32, device=dev)
    inf = float("inf")
    out = torch.empty((S, num_steps), dtype=f32, device=dev)
    jc = max(1, min(num_steps, 16))
    rows = max(1, CHUNK_ELEMENTS // max(1, jc * T))

    def interp_at(sw, rank):
        lo_i = torch.floor(rank).to(torch.int64)
        hi_i = torch.ceil(rank).to(torch.int64)
        frac = rank - lo_i.to(f32)
        v_lo = torch.gather(sw, -1, lo_i[..., None])[..., 0]
        v_hi = torch.gather(sw, -1, hi_i[..., None])[..., 0]
        return v_lo + (v_hi - v_lo) * frac

    def ordered(x):
        return torch.sort(torch.where(x == 0, 0.0, x), dim=-1, stable=True).values

    for r0 in range(0, S, rows):
        r1 = min(S, r0 + rows)
        t, v = ts[r0:r1], vals[r0:r1]
        for j0 in range(0, num_steps, jc):
            j1 = min(num_steps, j0 + jc)
            m = _window_mask(t, lens[r0:r1], out_t[j0:j1], win)  # [R, Jc, T]
            count = m.sum(-1).to(f32)
            sw = ordered(torch.where(m, v[:, None, :], inf))
            if func == "quantile_over_time":
                rank = torch.clamp(qv, 0.0, 1.0) * torch.clamp(count - 1.0, min=0.0)
                r = interp_at(sw, rank)
            else:
                med_rank = 0.5 * torch.clamp(count - 1.0, min=0.0)
                med = interp_at(sw, med_rank)
                sd = ordered(torch.where(m, torch.abs(v[:, None, :] - med[:, :, None]), inf))
                mad = interp_at(sd, med_rank)
                if func == "median_absolute_deviation_over_time":
                    r = mad
                elif func == "last_over_time_is_mad_outlier":
                    tmax = torch.where(m, t[:, None, :], -(2**31) + 1).amax(-1)
                    last = m & (t[:, None, :] == tmax[:, :, None])
                    lastv = torch.where(last, v[:, None, :], 0.0).sum(-1)
                    lower = med - qv * mad
                    upper = med + qv * mad
                    is_out = ((lastv < lower) & (a1 <= 1)) | ((lastv > upper) & (a1 >= 1))
                    r = torch.where(is_out, lastv, float("nan"))
                else:
                    raise ValueError(func)
            out[r0:r1, j0:j1] = torch.where(count > 0, r, float("nan"))
    return out
