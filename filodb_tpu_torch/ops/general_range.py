"""The general range rung (counterpart of the JAX package's
``aggregations._fused_general_jit``: ``range_kernel`` (B4,
``filodb_tpu/ops/kernels.py:141``) and the ``("agg", op)`` epilogue as one
program).

``general_range_aggregate`` computes ``op by (...) (func(m[w]))`` on any
grid for the functions of ``GENERAL_FUNCS``, those range_kernel computes
and the window-stats finisher cannot: irate/idelta from the last two
samples, stddev/stdvar_over_time and z_score from a second moment,
changes/resets from pair flags and deriv by least squares. On a CUDA
block it makes one launch of the fused kernel of ``csrc/window_stats.cu``
on the general function codes (their template kinds ``K_LAST2``,
``K_MOMENT2``, ``K_PAIRS``, ``K_LSQ``), which reduces straight into the
``[G, J]`` group partials; on a CPU block it runs
``general_range_aggregate_plain``: ``kernels.range_kernel_plain`` and the
segment aggregate. Its launches are counted in ``LAUNCHES``, apart from
the window-stats rung's.
"""

from __future__ import annotations

import torch

from . import group_acc as GA
from . import window_stats as WS
from .kernels import pad_steps, range_kernel_plain

GENERAL_FUNCS = frozenset({
    "irate", "idelta", "stddev_over_time", "stdvar_over_time", "z_score",
    "changes", "resets", "deriv",
})

# the fused kernel's function codes (csrc/window_stats.cu, enum WFunc)
GENERAL_FUNC_CODES = {
    "irate": 12, "idelta": 13, "stddev_over_time": 14, "stdvar_over_time": 15,
    "z_score": 16, "changes": 17, "resets": 18, "deriv": 19,
}

# launches of the kernel on the general codes since the last reset, and
# the last launch's layout (group_acc.TilePlan)
LAUNCHES = 0
LAST_PLAN = None


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


def _launch(func: str, op: str, block, gids, num_groups: int, params, is_counter: bool,
            is_delta: bool, acc: torch.Tensor, cnt: torch.Tensor, plan=None) -> None:
    """One launch of the kernel on ``func``'s general code into
    ``acc``/``cnt`` ([G+1, J_pad], from ``group_acc.accumulators``);
    raises if the launch fails."""
    global LAUNCHES, LAST_PLAN
    LAST_PLAN = WS.launch_fused(GENERAL_FUNC_CODES[func], func, op, block, gids, num_groups,
                                params, is_counter, is_delta, acc, cnt, plan)
    LAUNCHES += 1


def general_range_aggregate_plain(func: str, op: str, block, gids: torch.Tensor,
                                  num_groups: int, params, is_counter: bool = False,
                                  is_delta: bool = False) -> torch.Tensor:
    """The general rung in plain torch, as ``_fused_general_jit`` composes
    it: ``range_kernel_plain`` over the padded steps -> the ("agg", op)
    epilogue; then NaN past ``params.num_steps``."""
    from .aggregations import apply_epilogue

    raw = block.raw if block.raw is not None else block.vals
    sj = range_kernel_plain(func, block.ts, block.vals, block.lens, block.baseline, raw,
                            int(params.start_ms - block.base_ms), params.step_ms,
                            params.window_ms, pad_steps(params.num_steps),
                            is_counter=is_counter, is_delta=is_delta)
    out = apply_epilogue(sj, ("agg", op), gids, num_groups)
    return GA.mask_steps(out, params.num_steps)
