"""Cross-series aggregation (counterpart of ``filodb_tpu/ops/aggregations.py``;
reference query/exec/aggregator/ RowAggregators).

``sum by (labels)`` is a segment reduce over the ``[S, J]`` range grid: one
``index_add_`` / ``scatter_reduce_`` for all steps and all groups. NaN means
absence: a NaN sample does not contribute, and a group with no members at a
step yields NaN. Padded rows go to the trash group ``num_groups``, which is
sliced off.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.schemas import METRIC_TAG
from . import window_stats as WS
from .kernels import pad_steps

SIMPLE_AGG_OPS = ("sum", "count", "avg", "min", "max")

# the one kernel variant of the fused path: every grid class takes it
FUSED_VARIANT = "window_stats"


def segment_aggregate(op: str, values: torch.Tensor, group_ids: torch.Tensor,
                      num_groups: int) -> torch.Tensor:
    """values [S, J] (NaN = absent), group_ids [S] int64 -> [num_groups, J]."""
    S, J = values.shape
    valid = ~torch.isnan(values)
    zeros = torch.zeros((num_groups, J), dtype=values.dtype, device=values.device)
    count = zeros.index_add(0, group_ids, valid.to(values.dtype))
    has = count > 0
    nan = float("nan")
    if op == "count":
        return torch.where(has, count, nan)
    if op in ("sum", "avg"):
        s = zeros.index_add(0, group_ids, torch.where(valid, values, 0.0))
        if op == "sum":
            return torch.where(has, s, nan)
        return torch.where(has, s / torch.clamp(count, min=1.0), nan)
    if op in ("min", "max"):
        big = float("inf") if op == "min" else float("-inf")
        vm = torch.where(valid, values, big)
        init = torch.full((num_groups, J), big, dtype=values.dtype, device=values.device)
        r = init.scatter_reduce(0, group_ids[:, None].expand(S, J), vm,
                                "amin" if op == "min" else "amax", include_self=True)
        return torch.where(has, r, nan)
    raise NotImplementedError(f"aggregation {op!r} is not ported (ported: {SIMPLE_AGG_OPS})")


def apply_epilogue(sj: torch.Tensor, epilogue: tuple, gids: torch.Tensor,
                   num_groups: int) -> torch.Tensor:
    """The ``("agg", op)`` epilogue: [S, J] -> [G, J] under the trash-group
    contract (padded rows carry group ``num_groups``)."""
    if epilogue[0] != "agg":
        raise NotImplementedError(f"fused epilogue {epilogue!r} is not ported")
    return segment_aggregate(epilogue[1], sj, gids, num_groups + 1)[:num_groups]


def fused_range_aggregate(func: str, op: str, block, gids_padded: torch.Tensor,
                          num_groups: int, params, is_counter: bool = False,
                          is_delta: bool = False) -> torch.Tensor:
    """``op by (...) (func(selector[w]))`` over a staged (super)block on
    the device: window stats -> finish -> slice to the block's padding ->
    segment aggregate. Returns the [G, J_pad] group partials on the device
    (variant ``FUSED_VARIANT``)."""
    if func not in WS.PALLAS_FUNCS:
        raise NotImplementedError(f"range function {func!r} is not ported")
    j_pad = pad_steps(params.num_steps)
    raw = block.raw if block.raw is not None else block.vals
    start_off = int(params.start_ms - block.base_ms)
    agg = WS.window_stats(block.ts, block.vals, raw, block.lens, start_off,
                          params.step_ms, params.window_ms, j_pad)
    sj = WS.finish(func, agg, start_off, params.step_ms, params.window_ms,
                   is_counter=is_counter, is_delta=is_delta)
    sj = sj[: block.vals.shape[0], :j_pad]
    return apply_epilogue(sj, ("agg", op), gids_padded, num_groups)


def group_ids_for(series_labels: list[dict], by: list[str] | None, without: list[str] | None):
    """Host-side grouping: label subset -> contiguous group ids + group labels.
    by=None, without=None -> one global group."""
    keys = []
    for lbls in series_labels:
        if by is not None:
            key = tuple((k, lbls.get(k, "")) for k in sorted(by))
        elif without:
            drop = set(without) | {"_metric_", "__name__"}
            key = tuple(sorted((k, v) for k, v in lbls.items() if k not in drop))
        else:
            key = ()
        keys.append(key)
    uniq: dict[tuple, int] = {}
    gids = np.empty(len(keys), dtype=np.int32)
    group_labels: list[dict] = []
    for i, k in enumerate(keys):
        if k not in uniq:
            uniq[k] = len(uniq)
            group_labels.append(dict(k))
        gids[i] = uniq[k]
    return gids, group_labels


def group_ids_memo(block, series_labels, by, without, strip_metric: bool = False):
    """``group_ids_for`` memoized in a plain dict on the block, keyed by
    (by, without, strip). Returns ``(gids_padded, num_groups, group_labels)``
    with gids_padded an int64 [S_padded] tensor on the block's device whose
    padded rows carry the trash group ``num_groups``."""
    key = (tuple(by) if by else None, tuple(without) if without else None, bool(strip_metric))
    memo = block.__dict__.setdefault("group_ids_memo", {})
    if key not in memo:
        labels = series_labels
        if strip_metric:
            labels = [{k: v for k, v in l.items() if k not in (METRIC_TAG, "__name__")}
                      for l in labels]
        gids, group_labels = group_ids_for(
            labels, list(by) if by else None, list(without) if without else None
        )
        G = len(group_labels)
        s_pad = block.lens.shape[0]
        gids_padded = np.full(s_pad, G, dtype=np.int64)
        gids_padded[: len(gids)] = gids
        memo[key] = (torch.from_numpy(gids_padded).to(block.lens.device), G, group_labels)
    return memo[key]
