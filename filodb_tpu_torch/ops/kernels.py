"""Range-query grid parameters, the general range kernel's plain version
and the reference tree's range-function ladder (counterpart of
``filodb_tpu/ops/kernels.py``).

``run_range_function`` / ``_dispatch_range_function`` evaluate one range
function over a staged block for the tree's leaves, as the JAX package's
ladder does, mapped onto the port's rungs (each one launch, in its store
mode, the ``[J_pad, S_pad]`` grid transposed to ``[S, J]``): ``timestamp``
on the host in f64 (``_host_timestamp``), the sorted-window functions on
``sorted_window`` (B8), and the rest on the rung
``aggregations.grid_variant`` picks (regular, window stats or general),
with the functions that take arguments on the general kernel.

``range_kernel_plain`` is ``range_kernel`` (B4) in plain torch, line for
line: for every (series, step) the window ``(t_j - w, t_j]`` is the samples
``[lo, hi)``, boundary samples are gathered at ``lo``, ``hi - 1`` and
``hi - 2``, and the in-window reduces run over ``[rows, J, T]`` masks one
chunk of rows at a time, so the function runs at the main path's size on
the card (no ``[S, J, T]`` tensor). The bounds come from
``torch.searchsorted`` clamped by ``lens``, which counts what the JAX
package's compare-and-reduce counts on a staged row (sorted samples,
``TS_PAD`` past ``lens``). changes/resets count their flags with an exact
integer prefix difference instead of a mask. Two sums differ from
range_kernel's on purpose (ROADMAP C): the stddev family's mean is the
window's own sum (range_kernel differences whole-row f32 prefix sums), and
deriv/predict_linear sum in float64. On the card the Hopper kernel
of ``csrc/general_range.cu`` computes the same functions
(``general_range.general_range_aggregate``); this version is what the CPU
tests hold against the JAX package and what the card's kernel is held
against.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

NAN = float("nan")
CHUNK_ELEMENTS = 1 << 25  # [rows, J, T] mask elements per chunk of rows


@dataclass(frozen=True)
class RangeParams:
    """Output grid + window spec."""

    start_ms: int  # absolute ms of first output step
    step_ms: int
    num_steps: int
    window_ms: int


def pad_steps(j: int) -> int:
    return max(64, ((j + 63) // 64) * 64)


def _bounds(ts, lens, out_t, window):
    """(lo, hi) int64 [S, J]: sample i is in window j iff lo <= i < hi.
    Rows are sorted with ``TS_PAD`` past ``lens``, so the count of a row's
    valid samples <= x is the row's ``searchsorted`` clamped by ``lens``."""
    S, T = ts.shape
    J = out_t.shape[0]
    n = lens.to(torch.int64).clamp(0, T)[:, None]
    hi = torch.searchsorted(ts, out_t.expand(S, J).contiguous(), right=True)
    lo = torch.searchsorted(ts, (out_t - window).expand(S, J).contiguous(), right=True)
    return torch.minimum(lo, n), torch.minimum(hi, n)


def _gather(arr, idx):
    """arr [S, T], idx [S, J] -> [S, J] (idx clipped; caller masks validity)."""
    return torch.gather(arr, 1, idx.clamp(0, arr.shape[1] - 1))


def _prefix(vals):
    """[S, T] -> [S, T+1] exclusive prefix sum."""
    cs = torch.cumsum(vals, dim=1)
    return torch.cat([torch.zeros_like(cs[:, :1]), cs], dim=1)


def _window_mask(ts, lens, out_t, window):
    """[rows, J, T] in-window mask of a chunk of rows."""
    T = ts.shape[1]
    valid = torch.arange(T, dtype=torch.int32, device=ts.device)[None, :] < lens[:, None]
    t = ts[:, None, :]
    return (t <= out_t[None, :, None]) & (t > (out_t - window)[None, :, None]) & valid[:, None, :]


def _masked_reduce(reduce, ts, lens, out_t, window, *arrays):
    """``reduce(mask, *row_chunks)`` -> a tuple of [rows, J] results, run
    over chunks of rows and concatenated to [S, J] each."""
    S, T = ts.shape
    rows = max(1, CHUNK_ELEMENTS // max(1, out_t.shape[0] * T))
    parts = []
    for r0 in range(0, S, rows):
        r1 = min(S, r0 + rows)
        m = _window_mask(ts[r0:r1], lens[r0:r1], out_t, window)
        parts.append(reduce(m, *(a[r0:r1] for a in arrays)))
    return tuple(torch.cat(p, dim=0) for p in zip(*parts))


def _extrapolated(delta, t_first, t_last, count, v_first_raw, out_t, window, is_counter,
                  as_rate):
    """Prometheus extrapolatedRate: extrapolate the in-window delta to the
    window edges, capped at 1.1x the average sample spacing (and at the
    zero-crossing for counters)."""
    f32 = torch.float32
    w_s = window.to(f32) * 1e-3
    range_start = (out_t - window)[None, :].to(f32) * 1e-3
    range_end = out_t[None, :].to(f32) * 1e-3
    tf = t_first.to(f32) * 1e-3
    tl = t_last.to(f32) * 1e-3
    sampled = tl - tf
    cnt = count.to(f32)
    dur_start = tf - range_start
    dur_end = range_end - tl
    avg_dur = sampled / torch.clamp(cnt - 1.0, min=1.0)
    inf = float("inf")
    if is_counter:
        dur_zero = torch.where(delta > 0, sampled * (v_first_raw / torch.clamp(delta, min=1e-30)),
                               inf)
        dur_start = torch.minimum(dur_start, torch.where(v_first_raw >= 0, dur_zero, inf))
    thresh = avg_dur * 1.1
    dur_start = torch.where(dur_start >= thresh, avg_dur / 2.0, dur_start)
    dur_end = torch.where(dur_end >= thresh, avg_dur / 2.0, dur_end)
    factor = (sampled + dur_start + dur_end) / torch.clamp(sampled, min=1e-30)
    result = delta * factor
    if as_rate:
        result = result / w_s
    return torch.where(count >= 2, result, NAN)


def range_kernel_plain(func: str, ts, vals, lens, baseline, raw, start_off: int, step_ms: int,
                       window: int, num_steps: int, is_counter: bool = False,
                       is_delta: bool = False, arg0: float = 0.0,
                       arg1: float = 0.0) -> torch.Tensor:
    """[S, num_steps] f32 results of one range function over a staged
    block (ts int32 [S, T], vals/raw f32 [S, T], lens int32 [S]), as
    ``filodb_tpu.ops.kernels.range_kernel`` computes them; ``arg0`` is
    predict_linear's horizon in seconds, ``arg0``/``arg1`` Holt-Winters'
    smoothing and trend factors (f32, as the JAX dispatch casts them).
    ``baseline`` is unused, as there."""
    dev = ts.device
    f32, i32 = torch.float32, torch.int32
    window = torch.tensor(window, dtype=i32, device=dev)
    out_t = (torch.tensor(start_off, dtype=i32, device=dev)
             + torch.arange(num_steps, dtype=i32, device=dev)
             * torch.tensor(step_ms, dtype=i32, device=dev))
    lo, hi = _bounds(ts, lens, out_t, window)
    count = (hi - lo).to(f32)
    has = count > 0

    def prefix_sum_of(x):
        p = _prefix(x)  # [S, T+1] exclusive; sum over [lo, hi) = p[hi]-p[lo]
        return _gather(p, hi) - _gather(p, lo)

    def masked(reduce, *arrays):
        return _masked_reduce(reduce, ts, lens, out_t, window, *arrays)

    if func in ("sum_over_time", "avg_over_time"):
        # masked in-window reduce: a prefix difference cancels in f32
        (s,) = masked(lambda m, v: (torch.where(m, v[:, None, :], 0.0).sum(-1),), vals)
        if func == "avg_over_time":
            s = s / count
        return torch.where(has, s, NAN)
    if func == "count_over_time":
        return torch.where(has, count, NAN)
    if func in ("last", "last_over_time"):
        return torch.where(has, _gather(vals, hi - 1), NAN)
    if func == "first_over_time":
        return torch.where(has, _gather(vals, lo), NAN)
    if func == "timestamp":
        return torch.where(has, _gather(ts, hi - 1).to(f32), NAN)
    if func == "present_over_time":
        return torch.where(has, 1.0, NAN)
    if func == "absent_over_time":
        return torch.where(has, NAN, 1.0)
    if func in ("min_over_time", "max_over_time"):
        big = float("inf") if func == "min_over_time" else float("-inf")
        if func == "min_over_time":
            (r,) = masked(lambda m, v: (torch.where(m, v[:, None, :], big).amin(-1),), vals)
        else:
            (r,) = masked(lambda m, v: (torch.where(m, v[:, None, :], big).amax(-1),), vals)
        return torch.where(has, r, NAN)
    if func in ("stddev_over_time", "stdvar_over_time", "z_score"):
        # the mean from the masked window sum, where range_kernel differences
        # f32 prefix sums of the whole row: that difference's rounding is
        # all a one-sample window holds (z_score +-1 for 0; ROADMAP C)
        def moments(m, v):
            s = torch.where(m, v[:, None, :], 0.0).sum(-1)
            mu = s / torch.clamp(m.sum(-1, dtype=torch.float32), min=1.0)
            dev2 = torch.where(m, (v[:, None, :] - mu[:, :, None]) ** 2, 0.0).sum(-1)
            return mu, dev2

        mean, dev2 = masked(moments, vals)
        var = dev2 / torch.clamp(count, min=1.0)
        if func == "stdvar_over_time":
            return torch.where(has, var, NAN)
        sd = torch.sqrt(var)
        if func == "z_score":
            return torch.where(has, (_gather(vals, hi - 1) - mean) / torch.clamp(sd, min=1e-30),
                               NAN)
        return torch.where(has, sd, NAN)
    if func in ("changes", "resets"):
        # counters stage f64-exact adjacent diffs ("diff" mode); gauges and
        # delta counters compare raw neighbours
        if is_counter and not is_delta:
            flag = (vals != 0) if func == "changes" else (vals < 0)
        else:
            prev = torch.cat([raw[:, :1], raw[:, :-1]], dim=1)
            flag = (raw != prev) if func == "changes" else (raw < prev)
        # flagged i with lo < i < hi: an exact integer prefix difference
        p = _prefix(flag.to(i32))
        n = (_gather(p, hi) - _gather(p, lo + 1)).clamp(min=0)
        return torch.where(has, n.to(f32), NAN)
    if func in ("deriv", "predict_linear"):
        # least-squares slope over (t - out_t) seconds, per window, in
        # range_kernel's order of operations; the four sums (and what is
        # made of them) in float64, where range_kernel's f32 sums cancel:
        # ~5e-4 of the slope on a window of a few samples far from t_j
        def moments(m, t, v):
            tc = (t[:, None, :] - out_t[None, :, None]).to(f32) * 1e-3
            tc = torch.where(m, tc, 0.0).double()
            vm = torch.where(m, v[:, None, :], 0.0).double()
            return tc.sum(-1), vm.sum(-1), (tc * tc).sum(-1), (tc * vm).sum(-1)

        st, sv, stt, stv = masked(moments, ts, vals)
        n = count.double()
        denom = n * stt - st * st
        slope = (n * stv - st * sv) / torch.where(denom.abs() < 1e-30, 1.0, denom)
        intercept = (sv - slope * st) / torch.clamp(n, min=1.0)
        ok = (count >= 2) & (denom.abs() >= 1e-30)
        if func == "deriv":
            return torch.where(ok, slope.to(f32), NAN)
        horizon = float(torch.tensor(arg0, dtype=f32))
        return torch.where(ok, (intercept + slope * horizon).to(f32), NAN)
    if func in ("rate", "increase", "delta"):
        if is_delta:
            # delta-temporality counters: each sample is the increase
            s = prefix_sum_of(vals)
            r = s / (window.to(f32) * 1e-3) if func == "rate" else s
            return torch.where(has, r, NAN)
        dlt = _gather(vals, hi - 1) - _gather(vals, lo)
        return _extrapolated(dlt, _gather(ts, lo), _gather(ts, hi - 1), count, _gather(raw, lo),
                             out_t, window, is_counter=is_counter and func != "delta",
                             as_rate=func == "rate")
    if func in ("irate", "idelta"):
        ok = (hi - lo) >= 2
        v_last = _gather(vals, hi - 1)
        if func == "idelta" and is_counter and not is_delta:
            # counter idelta reads the staged f64-exact diff of the last pair
            return torch.where(ok, v_last, NAN)
        dt_s = (_gather(ts, hi - 1) - _gather(ts, hi - 2)).to(f32) * 1e-3
        dv = v_last - _gather(vals, hi - 2)
        r = dv / torch.clamp(dt_s, min=1e-30) if func == "irate" else dv
        return torch.where(ok, r, NAN)
    if func == "double_exponential_smoothing":
        return _holt_winters(vals, lo, hi, arg0, arg1)
    raise ValueError(f"unknown range function {func}")


def _holt_winters(vals, lo, hi, sf: float, tf: float) -> torch.Tensor:
    """Holt's double exponential smoothing per window, as the JAX
    package's ``_holt_winters`` scans it: the first sample is the level,
    the second sets the trend to x1 - x0 and the level to x1, then
    level' = sf x + (1 - sf)(level + trend), trend' = tf (level' - level)
    + (1 - tf) trend; NaN below two samples. The scan runs over the k-th
    sample of every window at once, k < the longest window."""
    f32 = torch.float32
    sf = torch.tensor(sf, dtype=f32, device=vals.device)
    tf = torch.tensor(tf, dtype=f32, device=vals.device)
    n = hi - lo
    level = torch.zeros(n.shape, dtype=f32, device=vals.device)
    trend = torch.zeros_like(level)
    for k in range(int(n.max()) if n.numel() else 0):
        x = _gather(vals, lo + k)
        live = k < n
        if k == 0:
            level = torch.where(live, x, level)
        elif k == 1:
            trend = torch.where(live, x - level, trend)
            level = torch.where(live, x, level)
        else:
            nxt = sf * x + (1 - sf) * (level + trend)
            trend = torch.where(live, tf * (nxt - level) + (1 - tf) * trend, trend)
            level = torch.where(live, nxt, level)
    return torch.where(n >= 2, level, NAN)


# -- the reference tree's ladder ---------------------------------------------


def _host_arrays(block):
    """(ts, lens) of a block as host numpy: the host-staged block a device
    copy was made from (a tree leaf's), else fetched."""
    if block.host_block is not None:
        return np.asarray(block.host_block.ts), np.asarray(block.host_block.lens)
    return block.ts.cpu().numpy(), block.lens.cpu().numpy()


def _host_timestamp(block, params: RangeParams) -> np.ndarray:
    """timestamp() computed on the host from the int32 ts array in f64.

    The device grid is f32, which represents integer ms offsets exactly only
    up to 2^24 (~4.6h); Prometheus returns exact sample timestamps, so this
    function never goes through an f32 kernel. Returns absolute seconds
    [S, J_pad] f64 (NaN = no sample in window)."""
    j_pad = pad_steps(params.num_steps)
    out_t = (np.int64(params.start_ms - block.base_ms)
             + np.arange(j_pad, dtype=np.int64) * params.step_ms)
    ts_host, lens_np = _host_arrays(block)
    S = ts_host.shape[0]
    out = np.full((S, j_pad), np.nan)

    def row_for(ts1: np.ndarray) -> np.ndarray:
        hi = np.searchsorted(ts1, out_t, side="right")
        lo = np.searchsorted(ts1, out_t - params.window_ms, side="right")
        has = hi > lo
        t_last = ts1[np.minimum(hi - 1, len(ts1) - 1)]
        return np.where(has, (t_last + block.base_ms) / 1e3, np.nan)

    if block.regular_ts is not None and block.n_series > 0:
        ts1 = np.asarray(block.regular_ts)[: int(lens_np[0])].astype(np.int64)
        out[: block.n_series] = row_for(ts1)[None, :]
        return out
    # irregular grids: one batched searchsorted over all series via per-row
    # offsets (rows are sorted and TS_PAD sorts after every real offset)
    n = block.n_series
    if n == 0:
        return out
    ts_np = ts_host[:n].astype(np.int64)
    T = ts_np.shape[1]
    lens_n = lens_np[:n].astype(np.int64)
    stride = np.int64(1) << 33  # > any int32 ms offset incl. TS_PAD
    row_off = (np.arange(n, dtype=np.int64) * stride)[:, None]
    flat = (ts_np + row_off).ravel()
    hi = np.searchsorted(flat, (out_t[None, :] + row_off).ravel(), side="right")
    lo = np.searchsorted(
        flat, ((out_t - params.window_ms)[None, :] + row_off).ravel(), side="right")
    hi = np.minimum(hi.reshape(n, -1) - np.arange(n)[:, None] * T, lens_n[:, None])
    lo = np.minimum(lo.reshape(n, -1) - np.arange(n)[:, None] * T, lens_n[:, None])
    has = hi > lo
    t_last = np.take_along_axis(ts_np, np.maximum(hi - 1, 0), axis=1)
    out[:n] = np.where(has, (t_last + block.base_ms) / 1e3, np.nan)
    return out


def run_range_function(func: str, block, params: RangeParams, is_counter: bool = False,
                       is_delta: bool = False, args: tuple = ()):
    """One range function over a staged block for a tree leaf: [S_padded,
    J_pad] values (a tensor on the block's device; f64 numpy for
    ``timestamp``); the caller slices [:n_series, :num_steps]."""
    return _dispatch_range_function(func, block, params, is_counter=is_counter,
                                    is_delta=is_delta, args=args)[0]


def tree_rung(func: str, block, params: RangeParams, is_delta: bool = False,
              args: tuple = ()) -> str:
    """The rung of the JAX package's tree ladder that serves ``func`` over
    ``block``: ``host`` (timestamp); ``mxu`` (the regular kernel's store
    mode) for ``MXU_FUNCS`` on a regular grid, predict_linear's horizon
    included; ``jitter``, then ``masked``, for ``JITTER_FUNCS`` without
    arguments, each of which declines a window not wider than twice its
    grid's deviation bound; none of these for irate/idelta of a delta
    counter; then ``sorted`` (B8), ``general`` for the functions with
    arguments (predict_linear, double_exponential_smoothing) and
    ``aggregations.general_rung`` (window stats or general) in place of the
    JAX ``pallas`` and ``general``."""
    from . import aggregations as AGG
    from . import general_range as GR
    from . import mxu_jitter as JR
    from . import mxu_kernels as MK
    from . import sorted_window as SW
    from . import staging as ST

    if func == "timestamp":
        return "host"
    delta_i = is_delta and func in ("irate", "idelta")
    if block.regular_ts is not None and func in MK.MXU_FUNCS and not delta_i:
        return "mxu"
    if not delta_i and not args and func in JR.JITTER_FUNCS:
        if block.nominal_ts is not None and JR.window_ok(params.window_ms, block.maxdev_ms):
            return "jitter"
        if (block.regular_ts is None and block.nominal_ts is None
                and ST.sidecar(block) is not None
                and JR.window_ok(params.window_ms, block.mgrid.maxdev_ms)):
            return "masked"
    if func in SW.SORTED_FUNCS:
        return "sorted"
    if func in GR.ARG_FUNCS:
        return "general"
    return AGG.general_rung(func, block)


def _dispatch_range_function(func: str, block, params: RangeParams, is_counter: bool = False,
                             is_delta: bool = False, args: tuple = ()):
    """Returns ``(grid, variant)``: the [S_pad, J_pad] values of the rung
    ``tree_rung`` picks (its store mode transposed, the sorted-window
    kernel, or the host's timestamp) and that rung's name."""
    from . import aggregations as AGG
    from . import sorted_window as SW

    variant = tree_rung(func, block, params, is_delta, args)
    if variant == "host":
        return _host_timestamp(block, params), "host"
    if variant not in ("mxu", "jitter", "masked"):
        # the window rungs take the start as an int32 offset from the block's
        # base: one past it (a subquery window over ~24.8 days) raises the
        # JAX ladder's OverflowError (NumPy's, word for word), on the CPU and
        # the card alike
        start_off = int(params.start_ms) - int(block.base_ms)
        if not -2**31 <= start_off < 2**31:
            raise OverflowError(f"Python integer {start_off} out of bounds for int32")
    if variant == "sorted":
        return SW.sorted_window(func, block, params, args), "sorted"
    grid = AGG.rung_series(variant)(func, block, AGG.zero_gids(block), 1, params,
                                    is_counter=is_counter, is_delta=is_delta,
                                    **({"args": args} if args else {}))
    return grid.T, variant
