"""Cross-series aggregation (counterpart of ``filodb_tpu/ops/aggregations.py``;
reference query/exec/aggregator/ RowAggregators).

``sum by (labels)`` is a segment reduce over the ``[S, J]`` range grid: one
``index_add_`` / ``scatter_reduce_`` for all steps and all groups. NaN means
absence: a NaN sample does not contribute, and a group with no members at a
step yields NaN. Padded rows go to the trash group ``num_groups``, which is
sliced off. On the card every rung of ``fused_range_aggregate`` reduces
inside its kernel; the segment reduce here is the plain versions'
epilogue. ``fused_hist_range_aggregate`` is the histogram counterpart: a
per-bucket sum to ``[G, J, B]``, or the ``[G, J]`` quantile.

The fused epilogues (B9) ``topk``/``bottomk`` (global) and ``quantile by
(...)`` need every series' value: ``fused_range_series`` runs the rung in
its store mode to the step-major ``[J_pad, S_pad]`` grid, and
``fused_topk`` / ``fused_quantile`` reduce it with one order-statistics
launch (``order_stats``): two launches a query.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.schemas import METRIC_TAG
from ..singleflight import memo_on
from . import general_range as GR
from . import group_acc as GA
from . import hist_kernels as HK
from . import mxu_jitter as JR
from . import mxu_kernels as MK
from . import order_stats as OS
from . import window_stats as WS
from .kernels import pad_steps
from .staging import grid_class, sidecar

SIMPLE_AGG_OPS = ("sum", "count", "avg", "min", "max")

# the jitter and masked rungs' fused functions (the JAX package's
# FUSED_JITTER_FUNCS): the regular rung's set and min/max_over_time
FUSED_JITTER_FUNCS = MK.FUSED_MXU_FUNCS | {"min_over_time", "max_over_time"}


def general_rung(func: str, block=None) -> str:
    """The port's rung where the JAX ladder takes ``general`` or ``pallas``:
    ``general`` (B4) for ``GENERAL_FUNCS``, ``window_stats`` for the
    functions the general kernel does not compute (``PALLAS_FUNCS``; both
    kernels' windows are exact, so the answers agree)."""
    if func in GR.GENERAL_FUNCS:
        return "general"
    if func in WS.PALLAS_FUNCS:
        return "window_stats"
    where = f" on a {grid_class(block, build=False)} grid" if block is not None else ""
    raise NotImplementedError(f"range function {func!r}{where} is not ported")


def grid_variant(block, func: str, is_delta: bool = False, window_ms=None) -> str:
    """Kernel-variant ladder for one fused dispatch, from the block's grid
    class and the function: the JAX package's ``_grid_variant`` -- ``mxu``
    (exact shared grid: the regular kernel) for ``FUSED_MXU_FUNCS`` >
    ``jitter`` (near-regular) > ``masked`` (missed scrapes) for
    ``FUSED_JITTER_FUNCS``, none of them for irate/idelta of a delta
    counter -- with ``_fused_dispatch``'s decline where ``window_ms`` is
    given (a window not wider than twice the grid's deviation bound), then
    ``general_rung`` in place of the JAX ``general`` and ``pallas``."""
    if not (is_delta and func in ("irate", "idelta")):
        if block.regular_ts is not None:
            if func in MK.FUSED_MXU_FUNCS:
                return "mxu"
        elif block.nominal_ts is not None:
            if func in FUSED_JITTER_FUNCS and (
                    window_ms is None or JR.window_ok(window_ms, block.maxdev_ms)):
                return "jitter"
        elif func in FUSED_JITTER_FUNCS and sidecar(block) is not None:
            if window_ms is None or JR.window_ok(window_ms, block.mgrid.maxdev_ms):
                return "masked"
    return general_rung(func, block)


# each rung's module and the prefix of its aggregate and store-mode entry
# points (looked up at each call: ``<prefix>_aggregate``, ``<prefix>_series``)
_RUNGS = {"mxu": (MK, "regular_range"), "jitter": (JR, "jitter_range"),
          "masked": (JR, "masked_range"), "window_stats": (WS, "window_range"),
          "general": (GR, "general_range")}


def rung_aggregate(variant: str):
    """The rung's aggregate entry point (``regular_range_aggregate``, ...)."""
    mod, prefix = _RUNGS[variant]
    return getattr(mod, f"{prefix}_aggregate")


def rung_series(variant: str):
    """The rung's store-mode entry point (``regular_range_series``, ...)."""
    mod, prefix = _RUNGS[variant]
    return getattr(mod, f"{prefix}_series")


def rung_series_plain(variant: str, func: str, block, params, is_counter: bool = False,
                      is_delta: bool = False, args: tuple = ()) -> torch.Tensor:
    """The [S_pad, J_pad] per-series values of a rung through its plain
    version, on the block's device (what a rung's store mode computes)."""
    kw = {"is_counter": is_counter, "is_delta": is_delta}
    if variant == "general":
        return GR.general_range_series_plain(func, block, params, args=args, **kw)
    if variant == "window_stats":
        return WS.window_range_series_plain(func, block, params, **kw)
    start_off = int(params.start_ms - block.base_ms)
    j_pad = pad_steps(params.num_steps)
    if variant == "mxu":
        raw = block.raw if block.raw is not None else block.vals
        wm = MK.window_matrices(block, start_off, params.step_ms, j_pad, params.window_ms)
        return MK.mxu_range_plain(func, block.vals, raw, wm, params.window_ms, args=args, **kw)
    masked = variant == "masked"
    wm = (JR.masked_window_matrices if masked else JR.jitter_window_matrices)(
        block, start_off, params.step_ms, j_pad, params.window_ms)
    return JR._plain(masked, func, block, wm, params, is_counter, is_delta)


def segment_aggregate(op: str, values: torch.Tensor, group_ids: torch.Tensor,
                      num_groups: int) -> torch.Tensor:
    """values [S, J] (NaN = absent), group_ids [S] int64 -> [num_groups, J].
    Besides the simple ops, the tree's components: ``sumsq`` (the sum of
    the f32 squares) and ``group`` (1.0 where the group has a value). min
    and max order the floats totally (-0 below +0), as the kernels'
    ordered-int atomics do."""
    S, J = values.shape
    valid = ~torch.isnan(values)
    zeros = torch.zeros((num_groups, J), dtype=values.dtype, device=values.device)
    count = zeros.index_add(0, group_ids, valid.to(values.dtype))
    has = count > 0
    nan = float("nan")
    if op == "count":
        return torch.where(has, count, nan)
    if op == "group":
        return torch.where(has, 1.0, nan)
    if op in ("sum", "avg", "sumsq"):
        x = values * values if op == "sumsq" else values
        s = zeros.index_add(0, group_ids, torch.where(valid, x, 0.0))
        if op == "avg":
            return torch.where(has, s / torch.clamp(count, min=1.0), nan)
        return torch.where(has, s, nan)
    if op in ("min", "max"):
        big = float("inf") if op == "min" else float("-inf")
        keys = OS.order_keys(torch.where(valid, values, big))
        init = OS.order_keys(torch.full((num_groups, J), big, dtype=values.dtype,
                                        device=values.device))
        r = init.scatter_reduce(0, group_ids[:, None].expand(S, J), keys,
                                "amin" if op == "min" else "amax", include_self=True)
        return torch.where(has, OS.order_keys(r.view(torch.float32)).view(torch.float32), nan)
    raise NotImplementedError(
        f"aggregation {op!r} is not ported (ported: {SIMPLE_AGG_OPS}, sumsq, group)")


def apply_epilogue(sj: torch.Tensor, epilogue: tuple, gids: torch.Tensor,
                   num_groups: int) -> torch.Tensor:
    """The ``("agg", op)`` epilogue: [S, J] -> [G, J] under the trash-group
    contract (padded rows carry group ``num_groups``)."""
    if epilogue[0] != "agg":
        raise NotImplementedError(f"fused epilogue {epilogue!r} is not ported")
    return segment_aggregate(epilogue[1], sj, gids, num_groups + 1)[:num_groups]


def fused_range_aggregate(func: str, op: str, block, gids_padded: torch.Tensor,
                          num_groups: int, params, is_counter: bool = False,
                          is_delta: bool = False, obs: dict | None = None) -> torch.Tensor:
    """``op by (...) (func(selector[w]))`` over a staged (super)block on
    the device, on the rung ``grid_variant`` picks for the query's window
    (written to ``obs["variant"]`` when ``obs`` is given): one launch of
    the regular kernel (``mxu``), the jitter kernel (``jitter``, or its
    ``masked`` variant), the fused window-stats kernel (``window_stats``)
    or the general kernel (``general``). Returns the [G, J_pad] group
    values on the device (NaN past ``params.num_steps``); no [S, J] grid
    is allocated."""
    variant = grid_variant(block, func, is_delta, params.window_ms)
    if obs is not None:
        obs["variant"] = variant
    return rung_aggregate(variant)(func, op, block, gids_padded, num_groups, params,
                                   is_counter=is_counter, is_delta=is_delta)


def fused_range_series(func: str, block, params, is_counter: bool = False,
                       is_delta: bool = False, obs: dict | None = None) -> torch.Tensor:
    """``func(selector[w])`` of every series of a staged (super)block on
    the rung ``grid_variant`` picks for the query's window (written to
    ``obs["variant"]``), in its store mode: one launch that writes the
    step-major [J_pad, S_pad] grid on the device, the padded rows
    (``zero_gids``) and the steps past ``params.num_steps`` NaN."""
    variant = grid_variant(block, func, is_delta, params.window_ms)
    if obs is not None:
        obs["variant"] = variant
    return rung_series(variant)(func, block, zero_gids(block), 1, params,
                                is_counter=is_counter, is_delta=is_delta)


def zero_gids(block) -> torch.Tensor:
    """The global grouping of a block under the trash-group contract: int64
    [S_padded] on the block's device, 0 for the real rows and 1 (the trash
    group of one group) for the padded ones, which the store mode writes
    as NaN (the JAX package's zero gids with its ``n_real`` mask).
    Memoized on the block."""
    s_pad = block.lens.shape[0]

    def build():
        gids = np.ones(s_pad, dtype=np.int64)
        gids[: block.n_series] = 0
        return torch.from_numpy(gids).to(block.lens.device)

    return memo_on(block, "zero_gids_memo", s_pad, build)


def fused_topk(func: str, block, k: int, bottom: bool, params, is_counter: bool = False,
               is_delta: bool = False, obs: dict | None = None):
    """Global ``topk(k, func(selector[w]))`` (``bottomk`` with
    ``bottom``): the rung's store mode, then one ``order_stats.topk_steps``
    launch over the real steps and series. Returns ([k, J] values, [k, J]
    int32 series indices) on the device, J = ``params.num_steps``, k
    capped at S_pad; only O(k J) reaches the host."""
    grid = fused_range_series(func, block, params, is_counter=is_counter, is_delta=is_delta,
                              obs=obs)
    return OS.topk_steps(grid[: params.num_steps], k, bottom, n_real=block.n_series)


def fused_quantile(func: str, block, members, q: float, params, is_counter: bool = False,
                   is_delta: bool = False, obs: dict | None = None) -> torch.Tensor:
    """``quantile(q, func(selector[w])) by (...)`` over the grouping whose
    member lists are ``members`` (``order_stats.Members``, e.g.
    ``group_members_memo``'s): the rung's store mode, then one
    ``order_stats.segment_quantile`` launch over the real steps. Returns
    [G, J] on the device, J = ``params.num_steps``."""
    grid = fused_range_series(func, block, params, is_counter=is_counter, is_delta=is_delta,
                              obs=obs)
    return OS.segment_quantile(grid[: params.num_steps], members, q)


def hist_variant(block, params=None) -> str:
    """The histogram rung of a block, the JAX ladder's
    (``fused_hist_range_aggregate``): ``hist_shared`` (shared [J] window
    bounds) on a regular grid; with the query's ``params``, ``hist_jitter``
    (the jitter mode, B1) on a near-regular grid whose window structure
    (``mxu_jitter.jitter_window_matrices``) is ``ok``, where a decline
    counts ``grid_jitter`` in ``metrics.record_fused_fallback``; else
    ``hist_general`` (bounds searched per series). The tree's leaves ask
    without ``params`` and keep the general kernel, as the JAX tree does."""
    if block.regular_ts is not None:
        return "hist_shared"
    if params is not None and block.nominal_ts is not None:
        if _hist_jitter_windows(block, params).ok:
            return "hist_jitter"
        from ..metrics import record_fused_fallback

        record_fused_fallback("grid_jitter")
    return "hist_general"


def _hist_jitter_windows(block, params):
    """The jitter window structure of a near-regular histogram block for one
    query grid (memoized on the block)."""
    return JR.jitter_window_matrices(block, int(params.start_ms - block.base_ms),
                                     params.step_ms, pad_steps(params.num_steps),
                                     params.window_ms)


def _hist_shared_windows(block, params, j_pad: int):
    """The [j_pad] window bounds of a regular-grid (super)block for one query
    grid, built on the host with ``np.searchsorted`` and memoized on the
    block's device: ``(lo, hi, t_first, t_last)`` int32, the window of step
    j being samples [lo[j], hi[j]) of every row (the JAX package's
    ``_hist_shared_windows``)."""
    start_off = int(params.start_ms - block.base_ms)
    key = (start_off, int(params.step_ms), j_pad, int(params.window_ms))

    def build():
        m = int(block.lens[0])
        tsv = np.asarray(block.regular_ts)[:m].astype(np.int64)
        out_t = start_off + np.arange(j_pad, dtype=np.int64) * int(params.step_ms)
        hi = np.searchsorted(tsv, out_t, side="right")
        lo = np.searchsorted(tsv, out_t - int(params.window_ms), side="right")
        t_first = tsv[np.minimum(lo, m - 1)]
        t_last = tsv[np.minimum(hi - 1, m - 1)]
        return tuple(torch.from_numpy(a.astype(np.int32)).to(block.vals.device)
                     for a in (lo, hi, t_first, t_last))

    return memo_on(block, "hist_windows_memo", key, build)


def fused_hist_range_aggregate(func: str, block, gids_padded: torch.Tensor, num_groups: int,
                               params, les: torch.Tensor, q: float | None = None,
                               is_delta: bool = False, obs: dict | None = None) -> torch.Tensor:
    """``sum by (...) (func(m[w]))`` over a [S, T, B] histogram
    (super)block on the rung ``hist_variant`` picks (written to
    ``obs["variant"]``): one launch of the range kernel, returning the
    [G, J_pad, B] group bucket sums, or with ``q`` the same one launch with
    the quantile folded in, returning [G, J_pad] ``histogram_quantile(q,
    ...)`` over the bounds ``les`` (f32 [B] on the block's device). Steps
    past ``params.num_steps`` are NaN."""
    variant = hist_variant(block, params)
    if obs is not None:
        obs["variant"] = variant
    j_pad = pad_steps(params.num_steps)
    windows = _hist_shared_windows(block, params, j_pad) if variant == "hist_shared" else None
    jitter = _hist_jitter_windows(block, params) if variant == "hist_jitter" else None
    if q is not None:
        return HK.hist_range_quantile(q, func, block, gids_padded, num_groups, params, les,
                                      windows=windows, is_delta=is_delta, jitter=jitter)[0]
    acc, cnt = HK.hist_range_partials(func, block, gids_padded, num_groups, params,
                                      windows=windows, is_delta=is_delta, jitter=jitter)
    return GA.finish_groups("sum", acc, cnt, num_groups).reshape(num_groups, j_pad, -1)


def count_values_key(x: float, decimals: int = 10) -> str:
    """The JAX package's count_values label of a value: ``{x:.10g}``, its
    trailing zeros and point stripped where it has a point."""
    s = f"{x:.{decimals}g}"
    return s.rstrip("0").rstrip(".") if "." in s else s


def count_values(values: np.ndarray, decimals: int = 10) -> dict:
    """Host count_values (reference CountValuesRowAggregator): value
    string -> [J] f64 counts, NaN where the string has no value at the
    step; strings in the order their first value appears step by step, as
    the JAX package's loop inserts them. Each distinct f32 value is
    formatted once."""
    vals = np.asarray(values, dtype=np.float32)
    J = vals.shape[1]
    jj, ii = np.nonzero(~np.isnan(vals.T))  # step-major, series order within a step
    if not len(jj):
        return {}
    bits = vals.T[jj, ii].view(np.uint32)
    ubits, first, inv = np.unique(bits, return_index=True, return_inverse=True)
    strings = [count_values_key(float(x), decimals) for x in ubits.view(np.float32)]
    key_first: dict = {}
    for s, f in zip(strings, first):
        key_first[s] = min(key_first.get(s, f), f)
    keys = sorted(key_first, key=key_first.__getitem__)
    kid = {s: i for i, s in enumerate(keys)}
    of_unique = np.array([kid[s] for s in strings], dtype=np.int64)
    counts = np.bincount(of_unique[inv.ravel()] * J + jj, minlength=len(keys) * J)
    counts = counts.reshape(len(keys), J).astype(np.float64)
    rows = np.where(counts > 0, counts, np.nan)
    return {s: rows[i] for i, s in enumerate(keys)}


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
    """``group_ids_for`` memoized on the block (``singleflight.memo_on``:
    one build under concurrency), keyed by (by, without, strip). Returns
    ``(gids_padded, num_groups, group_labels)``
    with gids_padded an int64 [S_padded] tensor on the block's device whose
    padded rows carry the trash group ``num_groups``."""
    key = (tuple(by) if by else None, tuple(without) if without else None, bool(strip_metric))

    def build():
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
        return torch.from_numpy(gids_padded).to(block.lens.device), G, group_labels

    return memo_on(block, "group_ids_memo", key, build)


def group_members_memo(block, series_labels, by, without, strip_metric: bool = False):
    """The ``order_stats.Members`` of ``group_ids_memo``'s grouping (the
    quantile kernel's member lists), memoized on the block under the same
    key. Returns ``(members, num_groups, group_labels)``."""
    gids, G, group_labels = group_ids_memo(block, series_labels, by, without, strip_metric)
    key = (tuple(by) if by else None, tuple(without) if without else None, bool(strip_metric))
    members = memo_on(block, "group_members_memo", key, lambda: OS.segment_members(gids, G))
    return members, G, group_labels
