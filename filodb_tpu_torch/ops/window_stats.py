"""Window statistics for irregular series (counterpart of
``filodb_tpu/ops/pallas_kernels.py`` and of the Pallas variant of
``filodb_tpu/ops/aggregations._fused_pallas_jit``).

``window_range_aggregate`` is the main path's window-stats rung:
``op by (...) (func(m[w]))`` over a staged block, for every output step
``t_j = start + j * step`` over the window ``(t_j - window, t_j]``. On a
CUDA block it makes one launch of the fused kernel in
``csrc/window_stats.cu`` (window stats, ``finish`` and the group aggregate;
no ``[S, J]`` plane in device memory); on a CPU block it runs
``window_range_aggregate_plain``: ``window_stats_plain`` -> ``finish`` ->
the segment aggregate, the same function in plain torch.
``window_range_series`` is the same kernel in its store mode (the fused
epilogues): the per-series ``[J_pad, S_pad]`` grid (``run_series``).

``window_range_lanes`` is the fused kernel's lane mode (cross-query
batching): one launch serves L queries over one superblock, each staged
row tile read once for all U unique windows, each lane folded at its own
groups (``window_range_lanes_series``: the store mode's [U, J_pad, S_pad]
grids, for topk and quantile lanes); ``window_range_lanes_plain`` is its
plain version.

``window_stats`` computes the nine per-series statistics planes (count,
sum, min, max, first/last timestamp, first/last value and first raw
value), on a CUDA tensor with the nine-plane kernel of the same source, on
a CPU tensor with ``window_stats_plain``. ``finish`` derives any of
``PALLAS_FUNCS`` from the statistics, with Prometheus extrapolation for
rate/increase/delta.

The kernels are built with ``nvcc`` at first use (``cuda_build``) and bound
through ctypes.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from . import group_acc as GA
from .kernels import pad_steps

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

# the fused kernel's function codes (csrc/window_stats.cu, enum WFunc)
WINDOW_FUNC_CODES = {
    "sum_over_time": 0, "count_over_time": 1, "avg_over_time": 2, "min_over_time": 3,
    "max_over_time": 4, "last": 5, "last_over_time": 5, "first_over_time": 6,
    "present_over_time": 7, "absent_over_time": 8, "rate": 9, "increase": 10, "delta": 11,
}

# launches since the last reset: LAUNCHES of the nine-plane kernel,
# RANGE_LAUNCHES of the fused kernel; LAST_PLAN is the fused kernel's last
# layout (group_acc.TilePlan)
LAUNCHES = 0
RANGE_LAUNCHES = 0
LAST_PLAN = None

_lib = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the entry points' argument types on a built library."""
    fn = lib.filodb_window_stats
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 10
    fn.restype = ctypes.c_int
    fn = lib.filodb_window_range_aggregate
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 16 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    fn = lib.filodb_window_range_lanes
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 10 + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    return lib


def _load():
    global _lib
    if _lib is None:
        _lib = bind(ctypes.CDLL(str(cuda_build.build("window_stats"))))
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


def staged_arrays(func: str, is_counter: bool, is_delta: bool) -> int:
    """How many [S, T] arrays the fused kernel stages for ``func``: ts;
    vals unless it only counts; raw for the counter zero-crossing cap. The
    kernel lays out its buffers by this number (the plan's ``n_arrays``)
    and refuses one too small for the function."""
    if func in ("count_over_time", "present_over_time", "absent_over_time"):
        return 1
    return 3 if is_counter and not is_delta and func in ("rate", "increase") else 2


def _check_gids(gids, S: int, device) -> None:
    if gids.dtype != torch.int64:
        raise TypeError(f"gids must be torch.int64, got {gids.dtype}")
    if tuple(gids.shape) != (S,) or gids.device != device or not gids.is_contiguous():
        raise ValueError(f"gids must be a contiguous [{S}] tensor on {device}, "
                         f"got {tuple(gids.shape)} on {gids.device}")


def window_range_aggregate(func: str, op: str, block, gids: torch.Tensor, num_groups: int,
                           params, is_counter: bool = False,
                           is_delta: bool = False) -> torch.Tensor:
    """``op by (...) (func(selector[w]))`` over a staged block ->
    [G, J_pad] group values on the block's device; steps past
    ``params.num_steps`` are NaN. ``gids`` is int64 [S_padded], padded rows
    in the trash group ``num_groups``. A CUDA block makes one launch of the
    fused kernel (and raises if the launch fails); a CPU block runs
    ``window_range_aggregate_plain``."""
    if func not in PALLAS_FUNCS:
        raise NotImplementedError(f"range function {func!r} is not on the window-stats rung")
    return run_fused(_launch_range, window_range_aggregate_plain, func, op, block, gids,
                     num_groups, params, is_counter, is_delta)


def run_fused(launch, plain, func: str, op: str, block, gids: torch.Tensor, num_groups: int,
              params, is_counter: bool, is_delta: bool) -> torch.Tensor:
    """The body of the window-stats and general rungs' wrappers:
    check the op and the inputs, run ``plain`` on a CPU block, else
    ``launch`` once into fresh accumulators and finish them to [G, J_pad]."""
    from .aggregations import SIMPLE_AGG_OPS

    if op not in SIMPLE_AGG_OPS:
        raise NotImplementedError(f"aggregation {op!r} is not ported (ported: {SIMPLE_AGG_OPS})")
    raw = block.raw if block.raw is not None else block.vals
    _check_inputs(block.ts, block.vals, raw, block.lens)
    _check_gids(gids, block.ts.shape[0], block.ts.device)
    device = block.ts.device.type
    if device == "cpu":
        return plain(func, op, block, gids, num_groups, params, is_counter=is_counter,
                     is_delta=is_delta)
    if device != "cuda":
        raise ValueError(f"the fused range kernel runs on cuda or cpu tensors, not {device}")
    acc, cnt = GA.accumulators(op, num_groups, pad_steps(params.num_steps), block.ts.device)
    launch(func, op, block, gids, num_groups, params, is_counter, is_delta, acc, cnt)
    return GA.finish_groups(op, acc, cnt, num_groups)


def window_range_series(func: str, block, gids: torch.Tensor, num_groups: int, params,
                        is_counter: bool = False, is_delta: bool = False) -> torch.Tensor:
    """``func(selector[w])`` of every series of a staged block -> the
    step-major [J_pad, S_padded] grid on the block's device (the store
    mode, for the fused epilogues): rows whose gid lies outside
    ``[0, num_groups)`` (the trash group of padded rows) and steps past
    ``params.num_steps`` are NaN. A CUDA block makes one launch of the
    fused kernel's store variant; a CPU block runs
    ``window_range_series_plain``."""
    if func not in PALLAS_FUNCS:
        raise NotImplementedError(f"range function {func!r} is not on the window-stats rung")
    return run_series(_launch_range, window_range_series_plain, func, block, gids, num_groups,
                      params, is_counter, is_delta)


def run_series(launch, plain, func: str, block, gids: torch.Tensor, num_groups: int, params,
               is_counter: bool, is_delta: bool) -> torch.Tensor:
    """The window-stats and general rungs' store-mode wrappers: check the
    inputs, then ``group_acc.run_series`` with ``plain`` (the per-series
    [S, J_pad] values) and one store-mode ``launch``."""
    raw = block.raw if block.raw is not None else block.vals
    _check_inputs(block.ts, block.vals, raw, block.lens)
    _check_gids(gids, block.ts.shape[0], block.ts.device)
    return GA.run_series(
        block.ts.device, block.ts.shape[0], gids, num_groups, params.num_steps,
        lambda: plain(func, block, params, is_counter=is_counter, is_delta=is_delta),
        lambda out: launch(func, GA.STORE, block, gids, num_groups, params, is_counter,
                           is_delta, out, out))


def _launch_range(func: str, op: str, block, gids, num_groups: int, params, is_counter: bool,
                  is_delta: bool, acc: torch.Tensor, cnt: torch.Tensor, plan=None,
                  lib=None) -> None:
    """One launch of the fused kernel into ``acc``/``cnt`` ([G+1, J_pad],
    from ``group_acc.accumulators``), or with ``op`` ``group_acc.STORE``
    into the grid ``acc`` ([J_pad, S], from ``group_acc.series_buffer``;
    ``cnt`` is not read); raises if the launch fails. ``plan`` (a
    ``group_acc.TilePlan``) defaults to ``tile_plan``'s, ``lib`` to the
    package's build (a timing script may pass its own)."""
    global RANGE_LAUNCHES, LAST_PLAN
    raw = block.raw if block.raw is not None else block.vals
    GA.check_aligned(ts=block.ts, vals=block.vals, raw=raw)
    lib = lib or _load()
    S, T = block.ts.shape
    J = params.num_steps
    store = op == GA.STORE
    if plan is None:
        plan = GA.tile_plan(num_groups, J, T, staged_arrays(func, is_counter, is_delta), store)
    with torch.cuda.device(block.ts.device):
        stream = torch.cuda.current_stream(block.ts.device).cuda_stream
        err = lib.filodb_window_range_aggregate(
            block.ts.data_ptr(), block.vals.data_ptr(), raw.data_ptr(), block.lens.data_ptr(),
            gids.data_ptr(), S, T, J, acc.shape[0 if store else 1], num_groups,
            int(params.start_ms - block.base_ms), int(params.step_ms), int(params.window_ms),
            WINDOW_FUNC_CODES[func], GA.acc_code(op), int(is_counter), int(is_delta),
            plan.rows, plan.n_arrays, int(plan.shared), plan.smem_bytes, acc.data_ptr(),
            cnt.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"{func} range kernel launch failed: cudaError {err}")
    LAST_PLAN = plan
    RANGE_LAUNCHES += 1


def window_range_aggregate_plain(func: str, op: str, block, gids: torch.Tensor,
                                 num_groups: int, params, is_counter: bool = False,
                                 is_delta: bool = False) -> torch.Tensor:
    """The fused kernel's function in plain torch, as the JAX package's
    ``_fused_pallas_jit`` composes it: window stats -> finish -> slice to
    the block's padding -> the ("agg", op) epilogue; then NaN past
    ``params.num_steps``."""
    from .aggregations import apply_epilogue

    sj = window_range_series_plain(func, block, params, is_counter=is_counter,
                                   is_delta=is_delta)
    out = apply_epilogue(sj, ("agg", op), gids, num_groups)
    return GA.mask_steps(out, params.num_steps)


def window_range_series_plain(func: str, block, params, is_counter: bool = False,
                              is_delta: bool = False) -> torch.Tensor:
    """The [S_padded, J_pad] per-series values of the window-stats rung in
    plain torch: window stats -> finish, sliced to the block's padding."""
    raw = block.raw if block.raw is not None else block.vals
    j_pad = pad_steps(params.num_steps)
    start_off = int(params.start_ms - block.base_ms)
    stats = window_stats_plain(block.ts, block.vals, raw, block.lens, start_off,
                               params.step_ms, params.window_ms, j_pad)
    sj = finish(func, stats, start_off, params.step_ms, params.window_ms,
                is_counter=is_counter, is_delta=is_delta)
    return sj[: block.vals.shape[0], :j_pad]


# -- lane mode (cross-query batching, B12) -------------------------------------

# the lane mode's launches and the last one's layout (group_acc.TilePlan:
# rows per tile, arrays staged, shared or global lane partials)
LANE_LAUNCHES = 0
LAST_LANE_PLAN = None


def _launch_lanes(func: str, op: str, block, batch, is_counter: bool, is_delta: bool,
                  acc: torch.Tensor, cnt: torch.Tensor, plan=None, lib=None) -> None:
    """One launch of the fused kernel's lane mode over ``batch`` (an
    ``aggregations.LaneBatch``) into the lanes' ``acc``/``cnt`` ([L, G+1,
    J_pad]), or with ``op`` ``group_acc.STORE`` into the [U, J_pad, S]
    grids ``acc``; raises if the launch fails. ``plan`` defaults to
    ``tile_plan``'s with every lane's partials counted."""
    global LANE_LAUNCHES, LAST_LANE_PLAN
    raw = block.raw if block.raw is not None else block.vals
    _check_inputs(block.ts, block.vals, raw, block.lens)
    GA.check_aligned(ts=block.ts, vals=block.vals, raw=raw)
    lib = lib or _load()
    S, T = block.ts.shape
    store = op == GA.STORE
    gids = batch.store_gids if store else batch.gids
    L, G = (1, 1) if store else (gids.shape[0], batch.G)
    if plan is None:
        plan = GA.tile_plan(G, batch.num_steps, T, staged_arrays(func, is_counter, is_delta),
                            store, lanes=L)
    w = batch.windows
    with torch.cuda.device(block.ts.device):
        stream = torch.cuda.current_stream(block.ts.device).cuda_stream
        err = lib.filodb_window_range_lanes(
            block.ts.data_ptr(), block.vals.data_ptr(), raw.data_ptr(), block.lens.data_ptr(),
            w["start"].data_ptr(), w["step"].data_ptr(), w["window"].data_ptr(), S, T,
            batch.num_steps, batch.j_pad, len(batch.ukeys), gids.data_ptr(),
            batch.u_dev.data_ptr(), L, G, WINDOW_FUNC_CODES[func], GA.acc_code(op),
            int(is_counter), int(is_delta), plan.rows, plan.n_arrays, int(plan.shared),
            plan.smem_bytes, acc.data_ptr(), cnt.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"{func} window-stats lane-mode launch failed: cudaError {err}")
    LANE_LAUNCHES += 1
    LAST_LANE_PLAN = plan


def _lane_series_plain(func: str, block, batch, u: int, is_counter: bool, is_delta: bool):
    from .kernels import RangeParams

    so, sm, w = batch.ukeys[u]
    return window_range_series_plain(func, block, RangeParams(so + block.base_ms, sm,
                                                              batch.num_steps, w),
                                     is_counter=is_counter, is_delta=is_delta)


def window_range_lanes_plain(func: str, op: str, block, lanes, batch, is_counter: bool = False,
                             is_delta: bool = False) -> list:
    """The lane mode in plain torch: ``window_range_series_plain`` once per
    unique window, each lane's segment aggregate
    (``group_acc.lanes_plain``)."""
    return GA.lanes_plain(
        lambda u: _lane_series_plain(func, block, batch, u, is_counter, is_delta), op, lanes,
        batch.u_of_lane)


def window_range_lanes_series_plain(func: str, block, batch, is_counter: bool = False,
                                    is_delta: bool = False) -> torch.Tensor:
    """The lane store mode in plain torch: each unique window's
    ``window_range_series_plain`` through ``group_acc.series_grid``."""
    return torch.stack([
        GA.series_grid(_lane_series_plain(func, block, batch, u, is_counter, is_delta),
                       batch.store_gids[0], 1, batch.num_steps) for u in range(len(batch.ukeys))])


def window_range_lanes(func: str, op: str, block, lanes, batch, is_counter: bool = False,
                       is_delta: bool = False) -> list:
    """``op by (...) (func(selector[w]))`` of every lane of ``batch`` over a
    staged block -> each lane's [G_l, J_pad] values, NaN past its own
    ``num_steps``: ONE launch of the lane mode on a CUDA block (raises if it
    fails), ``window_range_lanes_plain`` on a CPU block."""
    from .aggregations import SIMPLE_AGG_OPS

    if func not in PALLAS_FUNCS:
        raise NotImplementedError(f"range function {func!r} is not on the window-stats rung")
    if op not in SIMPLE_AGG_OPS:
        raise NotImplementedError(f"aggregation {op!r} is not ported (ported: {SIMPLE_AGG_OPS})")
    device = block.ts.device
    if device.type == "cpu":
        return window_range_lanes_plain(func, op, block, lanes, batch, is_counter, is_delta)
    if device.type != "cuda":
        raise ValueError(f"window_range_lanes runs on cuda or cpu tensors, not {device}")
    acc, cnt = GA.lane_accumulators(op, len(lanes), batch.G, batch.j_pad, device)
    _launch_lanes(func, op, block, batch, is_counter, is_delta, acc, cnt)
    return GA.finish_lanes(op, acc, cnt, lanes)


def window_range_lanes_series(func: str, block, batch, is_counter: bool = False,
                              is_delta: bool = False) -> torch.Tensor:
    """Every unique window's store grid of ``batch`` -> [U, J_pad, S_pad]
    (ONE launch of the lane store mode on a CUDA block, the plain version on
    a CPU block)."""
    if func not in PALLAS_FUNCS:
        raise NotImplementedError(f"range function {func!r} is not on the window-stats rung")
    device = block.ts.device
    if device.type == "cpu":
        return window_range_lanes_series_plain(func, block, batch, is_counter, is_delta)
    if device.type != "cuda":
        raise ValueError(f"window_range_lanes_series runs on cuda or cpu tensors, not {device}")
    out = GA.lane_series_buffer(len(batch.ukeys), block.ts.shape[0], batch.j_pad,
                                batch.num_steps, device)
    _launch_lanes(func, GA.STORE, block, batch, is_counter, is_delta, out, out)
    return out
