"""The general range rung (counterpart of the JAX package's
``aggregations._fused_general_jit``: ``range_kernel`` (B4,
``filodb_tpu/ops/kernels.py:141``) and the ``("agg", op)`` epilogue as one
program).

``general_range_aggregate`` computes ``op by (...) (func(m[w]))`` on any
grid for the functions of ``GENERAL_FUNCS``, those range_kernel computes
and the window-stats finisher cannot: irate/idelta from the last two
samples, stddev/stdvar_over_time and z_score from a second moment,
changes/resets from pair flags and deriv by least squares. On a CUDA
block it makes one launch of ``csrc/general_range.cu``
(``filodb_general_range_aggregate``), which reduces straight into the
``[G, J]`` group partials; on a CPU block it runs
``general_range_aggregate_plain``: ``kernels.range_kernel_plain`` and the
segment aggregate. Its launches are counted in ``LAUNCHES``.
``general_range_series`` is the same kernel in its store mode (the fused
epilogues, and the reference tree's leaves): the per-series ``[J_pad,
S_pad]`` grid; there it also takes the functions with arguments
(``ARG_FUNCS``: ``predict_linear(t)`` and ``double_exponential_smoothing(sf,
tf)``), which the fused planner refuses as the JAX package's does.

``general_plan`` lays a launch out: warps per block (each on its own
row, staged in a buffer of its own or read in place), steps per slice,
the group partials, and a block's shared ``[steps]`` bounds on an exact
shared grid.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from . import cuda_build
from . import group_acc as GA
from . import window_stats as WS
from .kernels import pad_steps, range_kernel_plain

GENERAL_FUNCS = frozenset({
    "irate", "idelta", "stddev_over_time", "stdvar_over_time", "z_score",
    "changes", "resets", "deriv",
})

# the functions with arguments the kernel also computes, in its store mode
# only (the reference tree): predict_linear's horizon, Holt-Winters' factors
ARG_FUNCS = frozenset({"predict_linear", "double_exponential_smoothing"})
TREE_FUNCS = GENERAL_FUNCS | ARG_FUNCS

# the kernel's function codes (csrc/general_range.cu, enum GFunc)
GENERAL_FUNC_CODES = {
    "irate": 0, "idelta": 1, "stddev_over_time": 2, "stdvar_over_time": 3,
    "z_score": 4, "changes": 5, "resets": 6, "deriv": 7, "predict_linear": 8,
    "double_exponential_smoothing": 9,
}
# what each function reads of its window (the kernel's enum Kind)
KINDS = {"irate": "last2", "idelta": "last2", "stddev_over_time": "moment2",
         "stdvar_over_time": "moment2", "z_score": "moment2", "changes": "pairs",
         "resets": "pairs", "deriv": "lsq", "predict_linear": "lsq",
         "double_exponential_smoothing": "hw"}
MAX_SLICE_STEPS = 512  # steps per slice: each warp's [steps] run stays small
# warps per block, each on its own row with one staging buffer: on an H100
# 6 beat 2, 4 and 8 or tied them, and a second buffer per warp beat none
# (tile_sweep.py --general)
WARPS = 6
MAX_WARPS = 8

# launches of the kernel since the last reset, and the last launch's
# layout (GeneralPlan)
LAUNCHES = 0
LAST_PLAN = None

_lib = None


@dataclass(frozen=True)
class GeneralPlan:
    """One launch's layout: ``warps`` per block, each on its own row with a
    staging buffer of ``n_arrays`` arrays in shared memory (0 arrays: rows
    read in place), ``steps`` per slice, group partials in shared memory or
    not (none in the store mode, ``store``), one ``[steps]`` bounds table
    per block on an exact shared grid, and the dynamic shared memory that
    takes."""

    warps: int
    steps: int
    n_arrays: int
    shared: bool
    shared_bounds: bool
    smem_bytes: int
    store: bool = False

    @property
    def staged(self) -> bool:
        return self.n_arrays > 0

    @property
    def partials(self) -> str:
        return "store" if self.store else ("shared" if self.shared else "global")


def _round4(x: int) -> int:
    return -(-x // 4) * 4


def general_smem_bytes(num_groups: int, steps: int, warps: int, row_words: int, n_arrays: int,
                       shared: bool, shared_bounds: bool, store: bool = False) -> int:
    """Dynamic shared memory of a launch (``smem_words`` in the source,
    which the C entry checks): the block's ``[G, steps]`` partials
    (shared) and ``[steps]`` lo/hi (shared bounds), and per warp its row's
    ``[steps]`` lo/hi, its ``[steps]`` acc/cnt run (not in the store mode)
    and its staging buffer."""
    part = _round4(2 * num_groups * steps) if shared else 0
    sb = 2 * _round4(steps) if shared_bounds else 0
    per_warp = (2 if store else 4) * _round4(steps) + n_arrays * row_words
    return 4 * (part + sb + warps * per_warp)


@functools.lru_cache(maxsize=256)
def general_plan(num_groups: int, num_steps: int, row_words: int, n_arrays: int,
                 shared_bounds: bool = False, store: bool = False) -> GeneralPlan:
    """The layout of a launch over ``num_steps`` steps into
    ``num_groups`` groups (or, with ``store``, to the per-series grid, with
    no partials) that stages ``n_arrays`` arrays of ``row_words`` words per
    row: steps per slice up to ``MAX_SLICE_STEPS``; partials in shared
    memory while ``2 * G * steps * 4`` bytes fit
    ``group_acc.PARTIALS_BUDGET``; ``WARPS`` warps staging their rows
    within ``group_acc.BLOCK_SMEM``, else fewer, and where one warp's row
    does not fit, ``WARPS`` warps reading rows in place."""
    steps = min(num_steps, MAX_SLICE_STEPS)
    shared = not store and 2 * num_groups * steps * 4 <= GA.PARTIALS_BUDGET

    def plan(warps: int, narr: int) -> GeneralPlan:
        return GeneralPlan(warps, steps, narr, shared, shared_bounds,
                           general_smem_bytes(num_groups, steps, warps, row_words, narr, shared,
                                              shared_bounds, store), store)

    for warps in (WARPS, WARPS // 2, 1):
        staged = plan(warps, n_arrays)
        if n_arrays and staged.smem_bytes <= GA.BLOCK_SMEM:
            return staged
    return plan(WARPS, 0)


def staged_arrays(func: str, is_counter: bool, is_delta: bool,
                  distinct_raw: bool = False) -> int:
    """How many [S, T] arrays the kernel stages for ``func``: ts and vals,
    and raw for changes/resets of a gauge or delta counter that compare
    raw neighbours, where the block's raw is a row of its own
    (``distinct_raw``; staging gives those columns none: raw is vals). The
    kernel lays out its buffers by this number (the plan's ``n_arrays``)
    and refuses one too small for the function."""
    diff_flags = is_counter and not is_delta
    return 3 if func in ("changes", "resets") and distinct_raw and not diff_flags else 2


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the entry point's argument types on a built library."""
    fn = lib.filodb_general_range_aggregate
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_float] * 2
                   + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    fn = lib.filodb_general_range_lanes
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 4 + [ctypes.c_float] * 2 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    return lib


def _load():
    global _lib
    if _lib is None:
        _lib = bind(ctypes.CDLL(str(cuda_build.build("general_range"))))
    return _lib


def general_range_aggregate(func: str, op: str, block, gids: torch.Tensor, num_groups: int,
                            params, is_counter: bool = False,
                            is_delta: bool = False) -> torch.Tensor:
    """``op by (...) (func(selector[w]))`` over a staged block ->
    [G, J_pad] group values on the block's device; steps past
    ``params.num_steps`` are NaN. ``gids`` is int64 [S_padded], padded rows
    in the trash group ``num_groups``. A CUDA block makes one launch of the
    kernel (and raises if the launch fails); a CPU block runs
    ``general_range_aggregate_plain``."""
    if func not in GENERAL_FUNCS:
        raise NotImplementedError(f"range function {func!r} is not on the general rung")
    return WS.run_fused(_launch, general_range_aggregate_plain, func, op, block, gids,
                        num_groups, params, is_counter, is_delta)


def general_range_series(func: str, block, gids: torch.Tensor, num_groups: int, params,
                         is_counter: bool = False, is_delta: bool = False,
                         args=()) -> torch.Tensor:
    """``func(selector[w])`` of every series of a staged block -> the
    step-major [J_pad, S_padded] grid on the block's device (the store
    mode, for the fused epilogues and the reference tree): rows whose gid
    lies outside ``[0, num_groups)`` (the trash group of padded rows) and
    steps past ``params.num_steps`` are NaN. ``args`` are an ``ARG_FUNCS``
    function's arguments. A CUDA block makes one launch of the kernel's
    store variant; a CPU block runs ``general_range_series_plain``."""
    if func not in TREE_FUNCS:
        raise NotImplementedError(f"range function {func!r} is not on the general rung")
    return WS.run_series(functools.partial(_launch, args=args),
                         functools.partial(general_range_series_plain, args=args), func, block,
                         gids, num_groups, params, is_counter, is_delta)


def func_args(args) -> tuple[float, float]:
    """(arg0, arg1) as f32 values, 0 where absent (the JAX dispatch's
    ``np.float32`` casts)."""
    a = [float(torch.tensor(x, dtype=torch.float32)) for x in tuple(args)[:2]]
    return tuple(a + [0.0] * (2 - len(a)))


def _launch(func: str, op: str, block, gids, num_groups: int, params, is_counter: bool,
            is_delta: bool, acc: torch.Tensor, cnt: torch.Tensor, plan=None,
            lib=None, args=()) -> None:
    """One launch of the kernel into ``acc``/``cnt`` ([G+1, J_pad], from
    ``group_acc.accumulators``), or with ``op`` ``group_acc.STORE`` into
    the grid ``acc`` ([J_pad, S], from ``group_acc.series_buffer``; ``cnt``
    is not read); raises if the launch fails. ``plan`` (a
    ``GeneralPlan``) defaults to ``general_plan``'s, ``lib`` to the
    package's build (a timing script may pass its own). A block on an
    exact shared grid (``regular_ts``) takes its bounds from one table per
    block. ``args`` are an ``ARG_FUNCS`` function's arguments."""
    global LAUNCHES, LAST_PLAN
    raw = block.raw if block.raw is not None else block.vals
    GA.check_aligned(ts=block.ts, vals=block.vals, raw=raw)
    lib = lib or _load()
    S, T = block.ts.shape
    J = params.num_steps
    store = op == GA.STORE
    arg0, arg1 = func_args(args)
    if plan is None:
        n_arrays = staged_arrays(func, is_counter, is_delta,
                                 distinct_raw=raw.data_ptr() != block.vals.data_ptr())
        plan = general_plan(num_groups, J, T, n_arrays, block.regular_ts is not None, store)
    with torch.cuda.device(block.ts.device):
        stream = torch.cuda.current_stream(block.ts.device).cuda_stream
        err = lib.filodb_general_range_aggregate(
            block.ts.data_ptr(), block.vals.data_ptr(), raw.data_ptr(), block.lens.data_ptr(),
            gids.data_ptr(), S, T, J, acc.shape[0 if store else 1], num_groups,
            int(params.start_ms - block.base_ms), int(params.step_ms), int(params.window_ms),
            GENERAL_FUNC_CODES[func], GA.acc_code(op), arg0, arg1, int(is_counter), int(is_delta),
            plan.warps, plan.steps, plan.n_arrays, int(plan.shared), int(plan.shared_bounds),
            plan.smem_bytes, acc.data_ptr(), cnt.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"{func} general range kernel launch failed: cudaError {err}")
    LAST_PLAN = plan
    LAUNCHES += 1


def general_range_aggregate_plain(func: str, op: str, block, gids: torch.Tensor,
                                  num_groups: int, params, is_counter: bool = False,
                                  is_delta: bool = False) -> torch.Tensor:
    """The general rung in plain torch, as ``_fused_general_jit`` composes
    it: ``range_kernel_plain`` over the padded steps -> the ("agg", op)
    epilogue; then NaN past ``params.num_steps``."""
    from .aggregations import apply_epilogue

    sj = general_range_series_plain(func, block, params, is_counter=is_counter,
                                    is_delta=is_delta)
    out = apply_epilogue(sj, ("agg", op), gids, num_groups)
    return GA.mask_steps(out, params.num_steps)


def general_range_series_plain(func: str, block, params, is_counter: bool = False,
                               is_delta: bool = False, args=()) -> torch.Tensor:
    """The [S_padded, J_pad] per-series values of the general rung in plain
    torch: ``range_kernel_plain`` over the padded steps."""
    raw = block.raw if block.raw is not None else block.vals
    arg0, arg1 = func_args(args)
    return range_kernel_plain(func, block.ts, block.vals, block.lens, block.baseline, raw,
                              int(params.start_ms - block.base_ms), params.step_ms,
                              params.window_ms, pad_steps(params.num_steps),
                              is_counter=is_counter, is_delta=is_delta, arg0=arg0, arg1=arg1)


# -- lane mode (cross-query batching, B12) -------------------------------------

# the lane mode's launches and the last one's layout (group_acc.TilePlan:
# rows per tile, shared or global lane partials)
LANE_LAUNCHES = 0
LAST_LANE_PLAN = None


def _launch_lanes(func: str, op: str, block, batch, is_counter: bool, is_delta: bool,
                  acc: torch.Tensor, cnt: torch.Tensor, plan=None, lib=None) -> None:
    """One launch of the general kernel's lane mode over ``batch`` (an
    ``aggregations.LaneBatch``) into the lanes' ``acc``/``cnt`` ([L, G+1,
    J_pad]), or with ``op`` ``group_acc.STORE`` into the [U, J_pad, S]
    grids ``acc``; raises if the launch fails. Rows are read in place."""
    global LANE_LAUNCHES, LAST_LANE_PLAN
    raw = block.raw if block.raw is not None else block.vals
    WS._check_inputs(block.ts, block.vals, raw, block.lens)
    lib = lib or _load()
    S, T = block.ts.shape
    store = op == GA.STORE
    gids = batch.store_gids if store else batch.gids
    L, G = (1, 1) if store else (gids.shape[0], batch.G)
    lanes_max = 1 if store else batch.lanes_max
    if plan is None:
        plan = GA.tile_plan(G, batch.num_steps, 0, 0, store=store, lanes=lanes_max)
    w = batch.windows
    with torch.cuda.device(block.ts.device):
        stream = torch.cuda.current_stream(block.ts.device).cuda_stream
        err = lib.filodb_general_range_lanes(
            block.ts.data_ptr(), block.vals.data_ptr(), raw.data_ptr(), block.lens.data_ptr(),
            w["start"].data_ptr(), w["step"].data_ptr(), w["window"].data_ptr(), S, T,
            batch.num_steps, batch.j_pad, len(batch.ukeys), gids.data_ptr(),
            batch.u_dev.data_ptr(), L, G, GENERAL_FUNC_CODES[func], GA.acc_code(op), 0.0, 0.0,
            int(is_counter), int(is_delta), plan.rows, int(plan.shared), lanes_max,
            plan.smem_bytes, acc.data_ptr(), cnt.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"{func} general range lane-mode launch failed: cudaError {err}")
    LANE_LAUNCHES += 1
    LAST_LANE_PLAN = plan


def _lane_series_plain(func: str, block, batch, u: int, is_counter: bool, is_delta: bool):
    from .kernels import RangeParams

    so, sm, w = batch.ukeys[u]
    return general_range_series_plain(func, block, RangeParams(so + block.base_ms, sm,
                                                               batch.num_steps, w),
                                      is_counter=is_counter, is_delta=is_delta)


def general_range_lanes_plain(func: str, op: str, block, lanes, batch, is_counter: bool = False,
                              is_delta: bool = False) -> list:
    """The lane mode in plain torch: ``general_range_series_plain`` once per
    unique window, each lane's segment aggregate
    (``group_acc.lanes_plain``)."""
    return GA.lanes_plain(
        lambda u: _lane_series_plain(func, block, batch, u, is_counter, is_delta), op, lanes,
        batch.u_of_lane)


def general_range_lanes_series_plain(func: str, block, batch, is_counter: bool = False,
                                     is_delta: bool = False) -> torch.Tensor:
    """The lane store mode in plain torch: each unique window's
    ``general_range_series_plain`` through ``group_acc.series_grid``."""
    return torch.stack([
        GA.series_grid(_lane_series_plain(func, block, batch, u, is_counter, is_delta),
                       batch.store_gids[0], 1, batch.num_steps) for u in range(len(batch.ukeys))])


def general_range_lanes(func: str, op: str, block, lanes, batch, is_counter: bool = False,
                        is_delta: bool = False) -> list:
    """``op by (...) (func(selector[w]))`` of every lane of ``batch`` over a
    staged block -> each lane's [G_l, J_pad] values, NaN past its own
    ``num_steps``: ONE launch of the lane mode on a CUDA block (raises if it
    fails), ``general_range_lanes_plain`` on a CPU block."""
    from .aggregations import SIMPLE_AGG_OPS

    if func not in GENERAL_FUNCS:
        raise NotImplementedError(f"range function {func!r} is not on the general rung")
    if op not in SIMPLE_AGG_OPS:
        raise NotImplementedError(f"aggregation {op!r} is not ported (ported: {SIMPLE_AGG_OPS})")
    device = block.ts.device
    if device.type == "cpu":
        return general_range_lanes_plain(func, op, block, lanes, batch, is_counter, is_delta)
    if device.type != "cuda":
        raise ValueError(f"general_range_lanes runs on cuda or cpu tensors, not {device}")
    acc, cnt = GA.lane_accumulators(op, len(lanes), batch.G, batch.j_pad, device)
    _launch_lanes(func, op, block, batch, is_counter, is_delta, acc, cnt)
    return GA.finish_lanes(op, acc, cnt, lanes)


def general_range_lanes_series(func: str, block, batch, is_counter: bool = False,
                               is_delta: bool = False) -> torch.Tensor:
    """Every unique window's store grid of ``batch`` -> [U, J_pad, S_pad]
    (ONE launch of the lane store mode on a CUDA block, the plain version on
    a CPU block)."""
    if func not in GENERAL_FUNCS:
        raise NotImplementedError(f"range function {func!r} is not on the general rung")
    device = block.ts.device
    U, S = len(batch.ukeys), block.ts.shape[0]
    if device.type == "cpu":
        return general_range_lanes_series_plain(func, block, batch, is_counter, is_delta)
    if device.type != "cuda":
        raise ValueError(f"general_range_lanes_series runs on cuda or cpu tensors, not {device}")
    out = GA.lane_series_buffer(U, S, batch.j_pad, batch.num_steps, device)
    _launch_lanes(func, GA.STORE, block, batch, is_counter, is_delta, out, out)
    return out
