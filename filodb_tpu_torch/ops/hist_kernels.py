"""Native-histogram range functions fused with the per-bucket group sum,
and the ``histogram_quantile`` epilogue (counterpart of
``filodb_tpu/ops/hist_kernels.py``; reference format/vectors/Histogram.scala
quantile math :64-130, HistogramQuantileMapper, RateFunctions hist rate
:367).

Native histograms stage as ``[S, T, B]`` blocks of raw cumulative bucket
counts. ``sum by (...) (func(m[w]))`` over them is a per-bucket range
function followed by a per-bucket group sum to ``[G, J, B]``;
``histogram_quantile(q, ...)`` then interpolates over the bucket axis to
``[G, J]``. Two kernels of ``csrc/hist_range.cu`` carry it on the card:

- ``hist_range_partials`` launches ``filodb_hist_range_aggregate`` once:
  the range function of every (row, step, bucket) reduced straight into
  ``[G+1, J_pad * B]`` accumulators (``group_acc``), over the shared
  ``[J]`` window bounds of a regular grid (``windows``) or bounds searched
  per series;
- ``hist_quantile`` launches ``filodb_hist_quantile`` once on those
  accumulators: the group finish and the interpolation, ``[G, J_pad]``.

On a CPU tensor each runs its plain torch version (``hist_partials_plain``,
``hist_quantile_plain``), which the tests hold against the JAX package;
on a CUDA tensor it launches its kernel or raises. Steps past the query's
``num_steps`` are not computed: their group sums and quantiles are NaN.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from . import group_acc as GA
from .kernels import pad_steps

# histogram range functions of the fused path ("last" is the plain
# selector's read)
FUSED_HIST_FUNCS = frozenset({
    "rate", "increase", "delta", "sum_over_time", "last", "last_over_time",
})

# the kernel's function codes (csrc/hist_range.cu, enum HFunc)
HIST_FUNC_CODES = {"rate": 0, "increase": 1, "delta": 2, "sum_over_time": 3, "last": 4,
                   "last_over_time": 4}

HIST_THREADS = 256  # columns per block of the range kernel (csrc/hist_range.cu THREADS)
# blocks a range launch aims at (a few waves of an H100's 132 SMs); the
# rows per block follow from the shape
TARGET_BLOCKS = 4096

# launches since the last reset: RANGE_LAUNCHES of filodb_hist_range_aggregate,
# QUANTILE_LAUNCHES of filodb_hist_quantile; LAST_PLAN is the range
# kernel's last layout (group_acc.TilePlan: rows per block, partials)
RANGE_LAUNCHES = 0
QUANTILE_LAUNCHES = 0
LAST_PLAN = None

_lib = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the entry points' argument types on a built library."""
    fn = lib.filodb_hist_range_aggregate
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 15 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    fn = lib.filodb_hist_quantile
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_float]
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    return lib


def _load():
    global _lib
    if _lib is None:
        _lib = bind(ctypes.CDLL(str(cuda_build.build("hist_range"))))
    return _lib


# -- plain versions ------------------------------------------------------------


def _extrap_factor(cnt, tf, tl, out_t, window_ms: int):
    """Prometheus' extrapolation factor (hist_kernels.py:59-77) of windows
    of ``cnt`` samples with first/last timestamps ``tf``/``tl`` (int32 ms)
    ending at ``out_t``; f32, in the kernel's order of operations."""
    f32 = torch.float32
    cnt = cnt.to(f32)
    tf = tf.to(f32) * 1e-3
    tl = tl.to(f32) * 1e-3
    sampled = tl - tf
    range_start = (out_t - window_ms).to(f32) * 1e-3
    range_end = out_t.to(f32) * 1e-3
    dur_start = tf - range_start
    dur_end = range_end - tl
    avg_dur = sampled / torch.clamp(cnt - 1.0, min=1.0)
    thresh = avg_dur * 1.1
    dur_start = torch.where(dur_start >= thresh, avg_dur / 2.0, dur_start)
    dur_end = torch.where(dur_end >= thresh, avg_dur / 2.0, dur_end)
    return (sampled + dur_start + dur_end) / torch.clamp(sampled, min=1e-30)


def hist_range_plain(func: str, block, params, windows=None, is_delta: bool = False):
    """[S, T, B] histogram block -> [S, J_pad, B] per-bucket range function
    in plain torch: the JAX package's ``_hist_range_shared`` with the
    shared [J] ``windows`` (lo, hi, t_first, t_last) of a regular grid, else
    its ``hist_range_kernel`` with bounds searched per series. Window sums
    are taken in index order inside the window, as the kernel takes them."""
    if func not in FUSED_HIST_FUNCS:
        raise NotImplementedError(f"histogram range function {func!r} is not ported")
    vals = block.vals
    S, T, B = vals.shape
    dev = vals.device
    J = pad_steps(params.num_steps)
    i32, f32 = torch.int32, torch.float32
    start_off = int(params.start_ms - block.base_ms)
    window = int(params.window_ms)
    out_t = (start_off + torch.arange(J, dtype=torch.int64, device=dev)
             * int(params.step_ms)).to(i32)
    if windows is not None:
        lo, hi, tf, tl = (w[:J].to(dev) for w in windows)
        factor = _extrap_factor(hi - lo, tf, tl, out_t, window)[None, :]
        lo, hi = lo.long()[None, :].expand(S, J), hi.long()[None, :].expand(S, J)
    else:
        lane = torch.arange(T, device=dev)
        ts = torch.where(lane[None, :] < block.lens[:, None].long(), block.ts, 2**31 - 1)
        q_hi = out_t[None, :].expand(S, J).contiguous()
        hi = torch.searchsorted(ts, q_hi, right=True)
        lo = torch.searchsorted(ts, (q_hi - window).to(i32), right=True)
        tf = torch.gather(ts, 1, lo.clamp(0, T - 1))
        tl = torch.gather(ts, 1, (hi - 1).clamp(0, T - 1))
        factor = _extrap_factor(hi - lo, tf, tl, out_t[None, :], window)
    cnt = hi - lo

    def take(idx):  # [S, J] sample positions -> [S, J, B]
        return torch.gather(vals, 1, idx.clamp(0, T - 1)[:, :, None].expand(S, J, B))

    nan = float("nan")
    w_s = torch.tensor(window, dtype=f32, device=dev) * 1e-3
    if func in ("last", "last_over_time"):
        return torch.where((cnt > 0)[:, :, None], take(hi - 1), nan)
    if func == "sum_over_time" or (is_delta and func in ("rate", "increase")):
        sm = torch.zeros((S, J, B), dtype=f32, device=dev)
        for i in range(int(cnt.max()) if cnt.numel() else 0):
            k = lo + i
            sm = sm + torch.where((k < hi)[:, :, None], take(k), 0.0)
        if func == "rate":
            sm = sm / w_s
        return torch.where((cnt > 0)[:, :, None], sm, nan)
    res = (take(hi - 1) - take(lo)) * factor[:, :, None]
    if func == "rate":
        res = res / w_s
    return torch.where((cnt >= 2)[:, :, None], res, nan)


def hist_partials_plain(func: str, block, gids: torch.Tensor, num_groups: int, params,
                        windows=None, is_delta: bool = False):
    """The range kernel's function in plain torch: ``hist_range_plain`` ->
    the per-bucket sum over the flattened [S, J_pad * B] grid into
    ``(acc, cnt)`` [G+1, J_pad * B] (NaN is absence; padded rows go to the
    trash group G), with the steps past ``params.num_steps`` empty."""
    sjb = hist_range_plain(func, block, params, windows, is_delta)
    S, J, B = sjb.shape
    flat = sjb.reshape(S, J * B)
    valid = ~torch.isnan(flat)
    zeros = torch.zeros((num_groups + 1, J * B), dtype=flat.dtype, device=flat.device)
    acc = zeros.index_add(0, gids, torch.where(valid, flat, 0.0))
    cnt = zeros.index_add(0, gids, valid.to(flat.dtype))
    acc[:, params.num_steps * B:] = 0.0
    cnt[:, params.num_steps * B:] = 0.0
    return acc, cnt


def histogram_quantile_plain(q: float, buckets: torch.Tensor, les: torch.Tensor) -> torch.Tensor:
    """Prometheus histogram_quantile over cumulative bucket counts [..., B]
    with bounds ``les`` [B] (les[-1] = +inf), line for line the JAX
    package's ``histogram_quantile``: linear interpolation in the first
    bucket whose count reaches ``q`` x the total; the +Inf bucket returns
    the highest finite bound; a first bound <= 0 has no lower bound (-inf:
    the bucket's upper bound is returned); a total that is not positive and
    finite gives NaN; q < 0 gives -inf and q > 1 +inf."""
    f32 = torch.float32
    B = buckets.shape[-1]
    les = les.to(device=buckets.device, dtype=f32)
    total = buckets[..., -1]
    ok = (total > 0) & torch.isfinite(total)
    qv = torch.tensor(q, dtype=f32, device=buckets.device)
    rank = torch.clamp(qv, 0.0, 1.0) * total
    meets = buckets >= rank[..., None]
    idx = torch.argmax(meets.to(torch.int8), dim=-1)
    idx = torch.where(meets.any(-1), idx, B - 1)
    below = torch.clamp(idx - 1, min=0)
    c_hi = torch.gather(buckets, -1, idx[..., None])[..., 0]
    c_lo = torch.where(idx > 0, torch.gather(buckets, -1, below[..., None])[..., 0], 0.0)
    le_hi = les[idx]
    first_lo = torch.where(les[0] > 0, 0.0, float("-inf"))
    le_lo = torch.where(idx > 0, les[below], first_lo)
    highest_finite = les[B - 2] if B >= 2 else les[0]
    frac = (rank - c_lo) / torch.clamp(c_hi - c_lo, min=1e-30)
    val = le_lo + (le_hi - le_lo) * frac
    val = torch.where(idx == B - 1, highest_finite, val)
    val = torch.where(torch.isneginf(le_lo), le_hi, val)
    out = torch.where(ok, val, float("nan"))
    if q < 0:
        out = torch.full_like(out, float("-inf"))
    if q > 1:
        out = torch.full_like(out, float("inf"))
    return out


def hist_quantile_plain(q: float, acc: torch.Tensor, cnt: torch.Tensor, num_groups: int,
                        les: torch.Tensor, num_steps: int) -> torch.Tensor:
    """The quantile kernel's function in plain torch: the group finish of
    ``(acc, cnt)`` to [G, J_pad, B] (NaN without a member), then
    ``histogram_quantile_plain``; NaN past ``num_steps``."""
    B = les.shape[0]
    buckets = GA.finish_groups("sum", acc, cnt, num_groups).reshape(num_groups, -1, B)
    return GA.mask_steps(histogram_quantile_plain(q, buckets, les), num_steps)


# -- wrappers ------------------------------------------------------------------


def _check(name: str, t, dtype, shape, device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, not {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def hist_plan(S: int, num_steps: int, B: int, num_groups: int) -> GA.TilePlan:
    """The range kernel's layout: rows per block, so that a launch makes
    about ``TARGET_BLOCKS`` blocks (each owns 256 columns of the flattened
    (step, bucket) axis and a chunk of rows; at most 65535 chunks), and
    group partials ``[G, 256]`` in shared memory while they fit."""
    col_blocks = -(-num_steps * B // HIST_THREADS)
    rows = max(1, -(-S * col_blocks // TARGET_BLOCKS), -(-S // 65535))
    return GA.layout(num_groups, HIST_THREADS, 0, 0, rows)


def hist_range_partials(func: str, block, gids: torch.Tensor, num_groups: int, params,
                        windows=None, is_delta: bool = False):
    """``sum by (...) (func(m[w]))`` over a [S, T, B] histogram block ->
    ``(acc, cnt)`` [G+1, J_pad * B] group partials on the block's device
    (bucket b of step j at column j * B + b; group G is the trash group of
    padded rows). ``windows`` are the shared [J_pad] bounds (lo, hi,
    t_first, t_last) of a regular grid, else bounds are searched per
    series. A CUDA block makes one launch of the range kernel (and raises
    if the launch fails); a CPU block runs ``hist_partials_plain``."""
    if func not in FUSED_HIST_FUNCS:
        raise NotImplementedError(f"histogram range function {func!r} is not ported")
    vals = block.vals
    if vals.dim() != 3:
        raise ValueError(f"vals must be [S, T, B], got {tuple(vals.shape)}")
    S, T, B = vals.shape
    dev = vals.device
    _check("vals", vals, torch.float32, (S, T, B), dev)
    _check("gids", gids, torch.int64, (S,), dev)
    j_pad = pad_steps(params.num_steps)
    if windows is not None:
        for name, w in zip(("lo", "hi", "t_first", "t_last"), windows):
            _check(name, w, torch.int32, (j_pad,), dev)
    else:
        _check("ts", block.ts, torch.int32, (S, T), dev)
        _check("lens", block.lens, torch.int32, (S,), dev)
    if dev.type == "cpu":
        return hist_partials_plain(func, block, gids, num_groups, params, windows, is_delta)
    if dev.type != "cuda":
        raise ValueError(f"hist_range_partials runs on cuda or cpu tensors, not {dev}")
    acc, cnt = GA.accumulators("sum", num_groups, j_pad * B, dev)
    _launch_range(func, block, gids, num_groups, params, windows, is_delta, acc, cnt)
    return acc, cnt


def _launch_range(func: str, block, gids, num_groups: int, params, windows, is_delta: bool,
                  acc: torch.Tensor, cnt: torch.Tensor) -> None:
    """One launch of the range kernel into ``acc``/``cnt`` ([G+1, J_pad * B],
    zeros); raises if the launch fails."""
    global RANGE_LAUNCHES, LAST_PLAN
    S, T, B = block.vals.shape
    dev = block.vals.device
    plan = hist_plan(S, params.num_steps, B, num_groups)
    lib = _load()
    # the bounds' source: the shared [J] windows, or each row's ts and lens
    if windows is not None:
        lo, hi, tf, tl = (w.data_ptr() for w in windows)
        ts = lens = None
    else:
        lo = hi = tf = tl = None
        ts, lens = block.ts.data_ptr(), block.lens.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.filodb_hist_range_aggregate(
            ts, block.vals.data_ptr(), lens, gids.data_ptr(), lo, hi, tf, tl,
            S, T, B, params.num_steps, acc.shape[1], num_groups,
            int(params.start_ms - block.base_ms), int(params.step_ms), int(params.window_ms),
            HIST_FUNC_CODES[func], int(is_delta), int(windows is not None), plan.rows,
            int(plan.shared), plan.smem_bytes, acc.data_ptr(), cnt.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"hist_range_aggregate kernel launch failed: cudaError {err}")
    RANGE_LAUNCHES += 1
    LAST_PLAN = plan


def hist_quantile(q: float, acc: torch.Tensor, cnt: torch.Tensor, num_groups: int,
                  les: torch.Tensor, num_steps: int) -> torch.Tensor:
    """``histogram_quantile(q, ...)`` of the group partials from
    ``hist_range_partials`` over the bounds ``les`` (f32 [B]) -> [G, J_pad]
    on their device, NaN past ``num_steps``. A CUDA tensor makes one launch
    of the quantile kernel (and raises if the launch fails); a CPU tensor
    runs ``hist_quantile_plain``."""
    dev = acc.device
    B = les.shape[0] if les.dim() == 1 else -1
    if B < 1 or acc.dim() != 2 or acc.shape[1] % B:
        raise ValueError(f"acc {tuple(acc.shape)} does not hold buckets of les {tuple(les.shape)}")
    _check("acc", acc, torch.float32, (num_groups + 1, acc.shape[1]), dev)
    _check("cnt", cnt, torch.float32, tuple(acc.shape), dev)
    _check("les", les, torch.float32, (B,), dev)
    if dev.type == "cpu":
        return hist_quantile_plain(q, acc, cnt, num_groups, les, num_steps)
    if dev.type != "cuda":
        raise ValueError(f"hist_quantile runs on cuda or cpu tensors, not {dev}")
    out = torch.full((num_groups, acc.shape[1] // B), float("nan"), dtype=torch.float32,
                     device=dev)
    _launch_quantile(q, acc, cnt, num_groups, les, num_steps, out)
    return out


def _launch_quantile(q: float, acc, cnt, num_groups: int, les, num_steps: int, out) -> None:
    """One launch of the quantile kernel into ``out`` [G, J_pad] (steps
    [0, num_steps) written); raises if the launch fails."""
    global QUANTILE_LAUNCHES
    dev = acc.device
    B = les.shape[0]
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.filodb_hist_quantile(
            acc.data_ptr(), cnt.data_ptr(), les.data_ptr(), num_groups, num_steps, B,
            acc.shape[1], out.shape[1], float(q), out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"hist_quantile kernel launch failed: cudaError {err}")
    QUANTILE_LAUNCHES += 1
