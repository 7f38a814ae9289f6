"""Regular-grid range functions fused with the group aggregate
(counterpart of ``filodb_tpu/ops/mxu_kernels.py`` and of the regular
variant of ``filodb_tpu/ops/aggregations._fused_mxu_jit``).

When every staged series shares one timestamp vector, the window of each
output step is the same index range ``[lo[j], hi[j])`` in every row, so the
window bounds are built once on the host (``WindowMatrices``). The JAX
package then evaluates the range function with ``[S, T] x [T, J]``
matmuls on the TPU's matrix unit and segment-reduces the ``[S, J]`` grid.
On a CUDA tensor ``regular_range_aggregate`` launches the hand-written
kernel ``csrc/regular_range.cu``, which gathers at the window bounds, sums
the windows and reduces into ``[G+1, J]`` accumulators in one pass; on a CPU
tensor it runs ``mxu_range_plain`` followed by the segment aggregate, the
same function in plain torch. Steps past the query's ``num_steps`` are NaN
in both. ``regular_range_series`` is the same kernel in its store mode
(the fused epilogues and the reference tree): the per-series
``[J_pad, S_pad]`` grid.

Beyond ``FUSED_MXU_FUNCS`` the kernel computes the rest of the JAX
package's ``MXU_FUNCS`` (``mxu_pair_count``, ``mxu_minmax``,
``mxu_regression`` and ``absent_over_time``), which the tree takes on a
regular grid: changes/resets count flagged pairs inside the window,
min/max scan it, deriv/predict_linear sum ``v`` and ``v * tc`` in f32
against the host's time moments (``WindowMatrices.ensure_regression``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import cuda_build
from . import group_acc as GA
from .group_acc import ACC_CODES  # noqa: F401 (re-exported: the ops the kernel takes)
from .kernels import pad_steps

# range functions the regular rung computes (aggregations.FUSED_MXU_FUNCS
# of the JAX package)
FUSED_MXU_FUNCS = {
    "sum_over_time", "count_over_time", "avg_over_time", "last",
    "last_over_time", "first_over_time", "present_over_time",
    "stddev_over_time", "stdvar_over_time", "z_score",
    "rate", "increase", "delta", "idelta", "irate",
}

# every range function of the regular rung (the JAX package's MXU_FUNCS);
# the fused ladder takes only FUSED_MXU_FUNCS here, the tree all of them
# (timestamp is the host's)
MXU_FUNCS = FUSED_MXU_FUNCS | {
    "absent_over_time", "timestamp", "changes", "resets", "deriv", "predict_linear",
    "min_over_time", "max_over_time",
}

# the kernel's codes (csrc/regular_range.cu, enums Func and Acc)
FUNC_CODES = {
    "sum_over_time": 0, "count_over_time": 1, "avg_over_time": 2, "last": 3,
    "last_over_time": 3, "first_over_time": 4, "present_over_time": 5,
    "stddev_over_time": 6, "stdvar_over_time": 7, "z_score": 8, "rate": 9,
    "increase": 10, "delta": 11, "irate": 12, "idelta": 13, "changes": 14,
    "resets": 15, "min_over_time": 16, "max_over_time": 17, "deriv": 18,
    "predict_linear": 19, "absent_over_time": 20,
}
MINMAX_SENTINEL = 3e38  # mxu_minmax's sentinel for samples outside a window
# kernel launches since the last reset, and the last launch's layout
# (group_acc.TilePlan); the lane mode's launches are counted apart
LAUNCHES = 0
LAST_PLAN = None
LANE_LAUNCHES = 0
LAST_LANE_PLAN = None

_lib = None


class WindowMatrices:
    """Window structure of one shared timestamp vector for one query grid,
    built on the host exactly as the JAX package builds it (f32 casts
    included) and moved to ``device``:

    - ``lo``/``hi`` int32 [J]: each step's window is samples [lo, hi);
    - ``count``, ``t_first``, ``t_last``, ``t_last2``, ``out_t`` f32 [J]
      (timestamps of absent samples as 0, as the JAX device copies);
    - ``idx`` int32 [3, J]: first / last / second-to-last positions,
      clipped to the row (the kernel's gathers);
    - ``W``, ``F``, ``L``, ``L2`` f32 [T, J]: window membership and the
      one-hot selections, which only the plain version reads;
    - built at first use, as the JAX package's lazy builders: the pair
      membership ``P`` (``ensure_pairs``) and deriv's time moments
      (``ensure_regression``)."""

    def __init__(self, ts1: np.ndarray, n_valid: int, start_off: int, step_ms: int,
                 num_steps: int, window_ms: int, device):
        ts = ts1[:n_valid].astype(np.int64)
        T = len(ts1)
        J = num_steps
        out_t = start_off + np.arange(J, dtype=np.int64) * step_ms
        hi = np.searchsorted(ts, out_t, side="right")
        lo = np.searchsorted(ts, out_t - window_ms, side="right")
        cnt = (hi - lo).astype(np.float32)
        tidx = np.arange(T)[:, None]
        W = ((tidx >= lo[None, :]) & (tidx < hi[None, :])).astype(np.float32)
        F = np.zeros((T, J), dtype=np.float32)
        L = np.zeros((T, J), dtype=np.float32)
        L2 = np.zeros((T, J), dtype=np.float32)
        has = cnt > 0
        has2 = cnt >= 2
        F[lo[has], np.nonzero(has)[0]] = 1.0
        L[hi[has] - 1, np.nonzero(has)[0]] = 1.0
        L2[hi[has2] - 2, np.nonzero(has2)[0]] = 1.0
        t_first = np.where(has, ts[np.minimum(lo, len(ts) - 1)], np.nan)
        t_last = np.where(has, ts[np.minimum(hi - 1, len(ts) - 1)], np.nan)
        t_last2 = np.where(has2, ts[np.clip(hi - 2, 0, len(ts) - 1)], np.nan)
        idx = np.stack([
            np.clip(lo, 0, T - 1), np.clip(hi - 1, 0, T - 1), np.clip(hi - 2, 0, T - 1),
        ]).astype(np.int32)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        self.window_ms = window_ms
        self.lo = put(lo.astype(np.int32))
        self.hi = put(hi.astype(np.int32))
        self.count = put(cnt)
        self.t_first = put(np.nan_to_num(t_first, nan=0.0).astype(np.float32))
        self.t_last = put(np.nan_to_num(t_last, nan=0.0).astype(np.float32))
        self.t_last2 = put(np.nan_to_num(t_last2, nan=0.0).astype(np.float32))
        self.out_t = put(out_t.astype(np.float64).astype(np.float32))
        self.idx = put(idx)
        self.W, self.F, self.L, self.L2 = map(put, (W, F, L, L2))
        self._put, self._ts1, self._W = put, ts1, W
        self._lo, self._hi, self._T, self._out_t = lo, hi, T, out_t.astype(np.float64)

    def ensure_pairs(self) -> None:
        """``P`` f32 [T, J]: pair (t-1, t) lies in window j when lo < t < hi
        (changes, resets; the plain version's matmul)."""
        if "P" not in self.__dict__:
            tidx = np.arange(self._T)[:, None]
            self.P = self._put(((tidx > self._lo[None, :]) & (tidx < self._hi[None, :]))
                               .astype(np.float32))

    def ensure_regression(self) -> None:
        """deriv/predict_linear's time moments, built as the JAX package
        builds them: ``tc`` = (ts - out_t) / 1000 in f64, ``Wt`` = W * tc
        rounded to f32 once, ``st`` its f32 column sums, ``stt`` the f64
        sums of W * tc^2 rounded to f32; and ``rts`` (the shared ts, int32)
        and ``out_t64`` (f64) from which the kernel takes each ``tc``."""
        if "st" not in self.__dict__:
            tc = (self._ts1.astype(np.float64)[:, None] - self._out_t[None, :]) * 1e-3
            Wt = (self._W * tc).astype(np.float32)
            self.Wt = self._put(Wt)
            self.st = self._put(Wt.sum(0))
            self.stt = self._put((self._W * tc * tc).sum(0).astype(np.float64)
                                 .astype(np.float32))
            self.rts = self._put(np.asarray(self._ts1, np.int32))
            self.out_t64 = self._put(self._out_t)


def window_matrices(block, start_off: int, step_ms: int, num_steps: int,
                    window_ms: int) -> WindowMatrices:
    """``WindowMatrices`` of a regular block, memoized in a plain dict on
    the block, keyed by the query grid, on the block's device."""
    key = (int(start_off), int(step_ms), int(num_steps), int(window_ms))
    memo = block.__dict__.setdefault("window_matrices_memo", {})
    if key not in memo:
        memo[key] = WindowMatrices(block.regular_ts, int(block.lens[0]), *key,
                                   device=block.vals.device)
    return memo[key]


def _window_sum(x: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """``x @ W`` summed in index order over t, each product rounded first:
    the kernel's order, so the f32 rounding of the two agrees (W a 0/1
    window matrix, or deriv's ``Wt``)."""
    out = torch.zeros((x.shape[0], W.shape[1]), dtype=x.dtype, device=x.device)
    for t in range(W.shape[0]):
        out = out + x[:, t : t + 1] * W[t]
    return out


def window_scan_min(v: torch.Tensor, lo, hi) -> torch.Tensor:
    """[S, J] minimum of ``v`` over each step's shared index range [lo[j],
    hi[j]) (host ints), ``MINMAX_SENTINEL`` for an empty range: the scan the
    kernels make, which equals the JAX package's tile hierarchy (a minimum
    is exact)."""
    out = torch.full((v.shape[0], len(lo)), MINMAX_SENTINEL, dtype=v.dtype, device=v.device)
    for j, (a, b) in enumerate(zip(lo, hi)):
        if b > a:
            out[:, j] = torch.clamp(v[:, a:b].amin(1), max=MINMAX_SENTINEL)
    return out


def mxu_range_plain(func: str, vals: torch.Tensor, raw: torch.Tensor, wm: WindowMatrices,
                    window_ms, is_counter: bool = False, is_delta: bool = False,
                    args: tuple = ()) -> torch.Tensor:
    """[S, T] values of a regular block -> [S, J] range function, every
    branch of the JAX package's ``mxu_range_kernel``, ``mxu_pair_count``,
    ``mxu_minmax`` and ``mxu_regression`` in plain torch. The selections
    and pair counts are f32 matmuls (TF32 off); window sums are
    ``_window_sum``; min/max scan each window (``window_scan_min``)."""
    if vals.is_cuda and torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError("mxu_range_plain needs f32 matmuls: TF32 must stay off")
    f32 = torch.float32
    count = wm.count
    has = count > 0
    nan = float("nan")
    w_ms = torch.tensor(window_ms, dtype=f32, device=vals.device)
    w_s = w_ms * 1e-3
    ones = torch.ones_like(vals[:, :1])

    def gF(x):
        return x @ wm.F

    def gL(x):
        return x @ wm.L

    def gL2(x):
        return x @ wm.L2

    if func == "sum_over_time" or (is_delta and func in ("rate", "increase")):
        s = _window_sum(vals, wm.W)
        if func == "rate":
            s = s / w_s
        return torch.where(has, s, nan)
    if func == "count_over_time":
        return torch.where(has, count, nan)[None, :] * ones
    if func == "avg_over_time":
        return torch.where(has, _window_sum(vals, wm.W) / torch.clamp(count, min=1.0), nan)
    if func in ("last", "last_over_time"):
        return torch.where(has, gL(vals), nan)
    if func == "first_over_time":
        return torch.where(has, gF(vals), nan)
    if func == "present_over_time":
        return torch.where(has, 1.0, nan)[None, :] * ones
    if func == "absent_over_time":
        return torch.where(has, nan, 1.0)[None, :] * ones
    if func in ("changes", "resets"):
        # raw value movement; diff-staged counters carry the differences
        wm.ensure_pairs()
        if is_counter and not is_delta:
            flag = (raw != 0) if func == "changes" else (raw < 0)
        else:
            prev = torch.cat([raw[:, :1], raw[:, :-1]], dim=1)
            flag = (raw != prev) if func == "changes" else (raw < prev)
        return torch.where(has, flag.to(f32) @ wm.P, nan)
    if func in ("min_over_time", "max_over_time"):
        v = vals if func == "min_over_time" else -vals
        r = window_scan_min(v, wm._lo.tolist(), wm._hi.tolist())
        r = r if func == "min_over_time" else -r
        return torch.where(has[None, :], r, nan)
    if func in ("deriv", "predict_linear"):
        wm.ensure_regression()
        sv = _window_sum(vals, wm.W)
        stv = _window_sum(vals, wm.Wt)  # each v * tc rounded, then summed in order
        n = count[None, :]
        denom = n * wm.stt[None, :] - (wm.st * wm.st)[None, :]
        small = torch.abs(denom) < 1e-30
        slope = (n * stv - wm.st[None, :] * sv) / torch.where(small, 1.0, denom)
        ok = (count >= 2)[None, :] & ~small
        if func == "deriv":
            return torch.where(ok, slope, nan)
        lead = torch.tensor(np.float32(args[0]) if args else 0.0, dtype=f32, device=vals.device)
        intercept = (sv - slope * wm.st[None, :]) / torch.clamp(n, min=1.0)
        return torch.where(ok, intercept + slope * lead, nan)
    if func in ("stddev_over_time", "stdvar_over_time", "z_score"):
        s = _window_sum(vals, wm.W)
        s2 = _window_sum(vals * vals, wm.W)
        c = torch.clamp(count, min=1.0)
        mean = s / c
        var = torch.clamp(s2 / c - mean * mean, min=0.0)
        if func == "stdvar_over_time":
            return torch.where(has, var, nan)
        sd = torch.sqrt(var)
        if func == "stddev_over_time":
            return torch.where(has, sd, nan)
        return torch.where(has, (gL(vals) - mean) / torch.clamp(sd, min=1e-30), nan)
    if func in ("rate", "increase", "delta"):
        vf = gF(vals)
        dlt = gL(vals) - vf
        tf = wm.t_first * 1e-3
        tl = wm.t_last * 1e-3
        sampled = tl - tf
        range_start = (wm.out_t - w_ms) * 1e-3
        range_end = wm.out_t * 1e-3
        dur_start = tf - range_start
        dur_end = range_end - tl
        avg_dur = sampled / torch.clamp(count - 1.0, min=1.0)
        thresh = avg_dur * 1.1
        inf = float("inf")
        if is_counter and func != "delta":
            v_first_raw = gF(raw)
            dur_zero = torch.where(
                dlt > 0, sampled[None, :] * (v_first_raw / torch.clamp(dlt, min=1e-30)), inf
            )
            ds = torch.minimum(dur_start[None, :], torch.where(v_first_raw >= 0, dur_zero, inf))
        else:
            ds = dur_start[None, :].expand_as(dlt)
        ds = torch.where(ds >= thresh[None, :], (avg_dur / 2.0)[None, :], ds)
        de = torch.where(dur_end >= thresh, avg_dur / 2.0, dur_end)[None, :]
        factor = (sampled[None, :] + ds + de) / torch.clamp(sampled, min=1e-30)[None, :]
        res = dlt * factor
        if func == "rate":
            res = res / w_s
        return torch.where((count >= 2)[None, :], res, nan)
    if func in ("irate", "idelta"):
        ok = (count >= 2)[None, :]
        if func == "idelta" and is_counter and not is_delta:
            # counter blocks arrive diff-encoded: the last pair's difference
            return torch.where(ok, gL(vals), nan)
        dt_s = (wm.t_last - wm.t_last2) * 1e-3
        dv = gL(vals) - gL2(vals)
        r = dv / torch.clamp(dt_s, min=1e-30)[None, :] if func == "irate" else dv
        return torch.where(ok, r, nan)
    raise ValueError(f"regular rung does not support {func}")


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the entry point's argument types on a built library."""
    fn = lib.filodb_regular_range
    fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
                   + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    fn = lib.filodb_regular_range_lanes
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 10 + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    return lib


def _load():
    global _lib
    if _lib is None:
        _lib = bind(ctypes.CDLL(str(cuda_build.build("regular_range"))))
    return _lib


def _check_inputs(vals, raw, gids) -> None:
    if vals.dim() != 2:
        raise ValueError(f"vals must be [S, T], got {tuple(vals.shape)}")
    S = vals.shape[0]
    for name, t, dtype, shape in (
        ("vals", vals, torch.float32, tuple(vals.shape)), ("raw", raw, torch.float32, tuple(vals.shape)),
        ("gids", gids, torch.int64, (S,)),
    ):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if t.device != vals.device:
            raise ValueError(f"{name} is on {t.device}, vals on {vals.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(func: str, op: str, vals, raw, gids, num_groups: int, wm: WindowMatrices,
            num_steps: int, is_counter: bool, is_delta: bool, acc: torch.Tensor,
            cnt: torch.Tensor, plan=None, lib=None, args: tuple = ()) -> None:
    """One launch of the regular kernel over the first ``num_steps`` steps
    into ``acc``/``cnt`` ([G+1, J_pad], from ``group_acc.accumulators``),
    or with ``op`` ``group_acc.STORE`` into the grid ``acc`` ([J_pad, S],
    from ``group_acc.series_buffer``; ``cnt`` is not read); raises if the
    launch fails. Rows are read in place; ``plan`` (a
    ``group_acc.TilePlan``) defaults to ``tile_plan``'s, ``lib`` to the
    package's build (a timing script may pass its own)."""
    global LAUNCHES, LAST_PLAN
    GA.check_aligned(vals=vals, raw=raw)
    lib = lib or _load()
    S, T = vals.shape
    if plan is None:
        plan = GA.tile_plan(num_groups, num_steps, 0, 0, store=op == GA.STORE)
    regression = func in ("deriv", "predict_linear")
    if regression:
        wm.ensure_regression()
    moments = [wm.rts, wm.out_t64, wm.st, wm.stt] if regression else [None] * 4
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        err = lib.filodb_regular_range(
            vals.data_ptr(), raw.data_ptr(), gids.data_ptr(), wm.lo.data_ptr(),
            wm.hi.data_ptr(), wm.idx.data_ptr(), wm.count.data_ptr(), wm.t_first.data_ptr(),
            wm.t_last.data_ptr(), wm.t_last2.data_ptr(), wm.out_t.data_ptr(),
            *[0 if m is None else m.data_ptr() for m in moments],
            S, T, num_steps, wm.lo.shape[0], num_groups,
            float(np.float32(wm.window_ms)), float(np.float32(args[0]) if args else 0.0),
            FUNC_CODES[func], GA.acc_code(op), int(is_counter),
            int(is_delta), plan.rows, int(plan.shared), plan.smem_bytes,
            acc.data_ptr(), cnt.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"regular_range kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    LAST_PLAN = plan


def _check_func(func: str) -> None:
    if func not in FUNC_CODES:
        raise NotImplementedError(f"range function {func!r} is not on the regular rung")


def regular_range_aggregate(func: str, op: str, block, gids: torch.Tensor, num_groups: int,
                            params, is_counter: bool = False,
                            is_delta: bool = False, args: tuple = ()) -> torch.Tensor:
    """``op by (...) (func(selector[w]))`` over a block with a shared
    regular grid -> [G, J_pad] group values on the block's device; steps
    past ``params.num_steps`` are NaN. ``gids`` is int64 [S_padded],
    padded rows in the trash group ``num_groups``. A CUDA block launches
    the kernel (and raises if the launch fails); a CPU block runs
    ``mxu_range_plain`` and the segment aggregate."""
    from .aggregations import SIMPLE_AGG_OPS, apply_epilogue

    _check_func(func)
    if op not in SIMPLE_AGG_OPS:
        raise NotImplementedError(f"aggregation {op!r} is not ported (ported: {SIMPLE_AGG_OPS})")
    if block.regular_ts is None:
        raise ValueError("regular_range_aggregate needs a block with a shared regular grid")
    raw = block.raw if block.raw is not None else block.vals
    _check_inputs(block.vals, raw, gids)
    start_off = int(params.start_ms - block.base_ms)
    wm = window_matrices(block, start_off, params.step_ms, pad_steps(params.num_steps),
                         params.window_ms)
    device = block.vals.device.type
    if device == "cpu":
        sj = mxu_range_plain(func, block.vals, raw, wm, params.window_ms,
                             is_counter=is_counter, is_delta=is_delta, args=args)
        return GA.mask_steps(apply_epilogue(sj, ("agg", op), gids, num_groups),
                             params.num_steps)
    if device != "cuda":
        raise ValueError(f"regular_range_aggregate runs on cuda or cpu tensors, not {device}")
    acc, cnt = GA.accumulators(op, num_groups, wm.lo.shape[0], block.vals.device)
    _launch(func, op, block.vals, raw, gids, num_groups, wm, params.num_steps, is_counter,
            is_delta, acc, cnt, args=args)
    return GA.finish_groups(op, acc, cnt, num_groups)


def regular_range_series(func: str, block, gids: torch.Tensor, num_groups: int, params,
                         is_counter: bool = False, is_delta: bool = False,
                         args: tuple = ()) -> torch.Tensor:
    """``func(selector[w])`` of every series of a block with a shared
    regular grid -> the step-major [J_pad, S_padded] grid on the block's
    device (the store mode, for the fused epilogues): rows whose gid lies
    outside ``[0, num_groups)`` (the trash group of padded rows) and steps
    past ``params.num_steps`` are NaN. A CUDA block makes one launch of the
    kernel's store variant; a CPU block runs ``mxu_range_plain`` through
    ``group_acc.series_grid``. ``args`` is predict_linear's horizon."""
    _check_func(func)
    if block.regular_ts is None:
        raise ValueError("regular_range_series needs a block with a shared regular grid")
    raw = block.raw if block.raw is not None else block.vals
    _check_inputs(block.vals, raw, gids)
    start_off = int(params.start_ms - block.base_ms)
    j_pad = pad_steps(params.num_steps)
    wm = window_matrices(block, start_off, params.step_ms, j_pad, params.window_ms)
    return GA.run_series(
        block.vals.device, block.vals.shape[0], gids, num_groups, params.num_steps,
        lambda: mxu_range_plain(func, block.vals, raw, wm, params.window_ms,
                                is_counter=is_counter, is_delta=is_delta, args=args),
        lambda out: _launch(func, GA.STORE, block.vals, raw, gids, num_groups, wm,
                            params.num_steps, is_counter, is_delta, out, out, args=args))


# -- lane mode (cross-query batching, B12) -------------------------------------


def lane_windows(block, ukeys, j_pad: int) -> dict:
    """The stacked window tables of a lane-mode launch: each unique window
    ``(start_off, step, window)`` of ``ukeys`` its ``WindowMatrices``
    (``wms``, the solo launches' memo), their [U, j_pad] tables ([U, 3,
    j_pad] idx) and window_ms [U] f32."""
    wms = [window_matrices(block, so, sm, j_pad, w) for so, sm, w in ukeys]

    def stk(attr):
        return torch.stack([getattr(w, attr) for w in wms]).contiguous()

    out = {"wms": wms, "window_ms": torch.tensor([float(np.float32(w)) for *_, w in ukeys],
                                                 dtype=torch.float32, device=block.vals.device)}
    for attr in ("lo", "hi", "idx", "count", "t_first", "t_last", "t_last2", "out_t"):
        out[attr] = stk(attr)
    return out


def _launch_lanes(func: str, op: str, vals, raw, batch, is_counter: bool, is_delta: bool,
                  acc: torch.Tensor, cnt: torch.Tensor, plan=None, lib=None) -> None:
    """One launch of the regular kernel's lane mode over ``batch`` (an
    ``aggregations.LaneBatch``) into the lanes' ``acc``/``cnt`` ([L, G+1,
    J_pad], from ``group_acc.lane_accumulators``), or with ``op``
    ``group_acc.STORE`` into the [U, J_pad, S] grids ``acc``; raises if the
    launch fails. ``plan`` defaults to ``tile_plan``'s for the most lanes
    of one window."""
    global LANE_LAUNCHES, LAST_LANE_PLAN
    GA.check_aligned(vals=vals, raw=raw)
    lib = lib or _load()
    store = op == GA.STORE
    S, T = vals.shape
    gids = batch.store_gids if store else batch.gids
    L, G = (1, 1) if store else (gids.shape[0], batch.G)
    lanes_max = 1 if store else batch.lanes_max
    if plan is None:
        plan = GA.tile_plan(G, batch.num_steps, 0, 0, store=store, lanes=lanes_max)
    w = batch.windows
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        err = lib.filodb_regular_range_lanes(
            vals.data_ptr(), raw.data_ptr(), w["lo"].data_ptr(), w["hi"].data_ptr(),
            w["idx"].data_ptr(), w["count"].data_ptr(), w["t_first"].data_ptr(),
            w["t_last"].data_ptr(), w["t_last2"].data_ptr(), w["out_t"].data_ptr(),
            w["window_ms"].data_ptr(), S, T, batch.num_steps, batch.j_pad, len(batch.ukeys),
            gids.data_ptr(), batch.u_dev.data_ptr(), L, G, FUNC_CODES[func], GA.acc_code(op),
            int(is_counter), int(is_delta), plan.rows, int(plan.shared), lanes_max,
            plan.smem_bytes, acc.data_ptr(), cnt.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"regular_range lane-mode launch failed: cudaError {err}")
    LANE_LAUNCHES += 1
    LAST_LANE_PLAN = plan


def _lane_series_plain(func: str, block, batch, u: int, is_counter: bool, is_delta: bool):
    raw = block.raw if block.raw is not None else block.vals
    return mxu_range_plain(func, block.vals, raw, batch.windows["wms"][u], batch.ukeys[u][2],
                           is_counter=is_counter, is_delta=is_delta)


def regular_range_lanes_plain(func: str, op: str, block, lanes, batch, is_counter: bool = False,
                              is_delta: bool = False) -> list:
    """The lane mode in plain torch: ``mxu_range_plain`` once per unique
    window, each lane's segment aggregate (``group_acc.lanes_plain``)."""
    return GA.lanes_plain(
        lambda u: _lane_series_plain(func, block, batch, u, is_counter, is_delta), op, lanes,
        batch.u_of_lane)


def regular_range_lanes_series_plain(func: str, block, batch, is_counter: bool = False,
                                     is_delta: bool = False) -> torch.Tensor:
    """The lane store mode in plain torch: each unique window's
    ``mxu_range_plain`` through ``group_acc.series_grid``."""
    return torch.stack([
        GA.series_grid(_lane_series_plain(func, block, batch, u, is_counter, is_delta),
                       batch.store_gids[0], 1, batch.num_steps) for u in range(len(batch.ukeys))])


def regular_range_lanes(func: str, op: str, block, lanes, batch, is_counter: bool = False,
                        is_delta: bool = False) -> list:
    """``op by (...) (func(selector[w]))`` of every lane of ``batch`` over a
    block with a shared regular grid -> each lane's [G_l, J_pad] group
    values, NaN past its own ``num_steps``. ``lanes`` are ``(gids, G, q,
    params)``. A CUDA block makes ONE launch of the lane mode (and raises
    if it fails); a CPU block runs ``regular_range_lanes_plain``."""
    from .aggregations import SIMPLE_AGG_OPS

    _check_func(func)
    if op not in SIMPLE_AGG_OPS:
        raise NotImplementedError(f"aggregation {op!r} is not ported (ported: {SIMPLE_AGG_OPS})")
    raw = block.raw if block.raw is not None else block.vals
    device = block.vals.device
    if device.type == "cpu":
        return regular_range_lanes_plain(func, op, block, lanes, batch, is_counter, is_delta)
    if device.type != "cuda":
        raise ValueError(f"regular_range_lanes runs on cuda or cpu tensors, not {device}")
    acc, cnt = GA.lane_accumulators(op, len(lanes), batch.G, batch.j_pad, device)
    _launch_lanes(func, op, block.vals, raw, batch, is_counter, is_delta, acc, cnt)
    return GA.finish_lanes(op, acc, cnt, lanes)


def regular_range_lanes_series(func: str, block, batch, is_counter: bool = False,
                               is_delta: bool = False) -> torch.Tensor:
    """The store grids of every unique window of ``batch`` -> [U, J_pad,
    S_pad], each ``regular_range_series``'s grid of its window (padded rows
    and steps past the batch's ``num_steps`` NaN): ONE launch of the lane
    store mode on a CUDA block, the plain version on a CPU block."""
    _check_func(func)
    raw = block.raw if block.raw is not None else block.vals
    device = block.vals.device
    U, S = len(batch.ukeys), block.vals.shape[0]
    if device.type == "cpu":
        return regular_range_lanes_series_plain(func, block, batch, is_counter, is_delta)
    if device.type != "cuda":
        raise ValueError(f"regular_range_lanes_series runs on cuda or cpu tensors, not {device}")
    out = GA.lane_series_buffer(U, S, batch.j_pad, batch.num_steps, device)
    _launch_lanes(func, GA.STORE, block.vals, raw, batch, is_counter, is_delta, out, out)
    return out
