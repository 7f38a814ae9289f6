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


# -- cross-query batching (B12) ------------------------------------------------
#
# One launch of a rung's lane mode serves L concurrent queries over one
# superblock (query/scheduler.DispatchScheduler): U unique (start, step,
# window) triples each get one range grid, and every lane folds its
# window's values by its own group ids. A lane is ``(grouping, G, q,
# params)``: the int64 [S_pad] group ids of an aggregate or histogram lane
# (``zero_gids`` for topk, the ``order_stats.Members`` for quantile), its
# group count, its q and its ``RangeParams``. The JAX package pads lanes
# and windows to powers of two so that XLA compiles few shapes; the port
# has no compile cache, so a launch computes and writes its real lanes
# only, each at its own position.

# the rungs with a lane mode, and their modules' entry-point prefixes
# (``<prefix>_lanes``, ``<prefix>_lanes_series``)
_LANE_RUNGS = {"mxu": (MK, "regular_range"), "jitter": (JR, "jitter_range"),
               "masked": (JR, "masked_range"), "general": (GR, "general_range"),
               "window_stats": (WS, "window_range")}
_BATCH_STACK_MEMO_MAX = 64


def _pow2(n: int, lo: int = 1) -> int:
    q = max(lo, 1)
    while q < n:
        q *= 2
    return q


def _unique_windows(params_list, base_ms: int):
    """(the unique window of each lane, the unique (start offset, step,
    window) triples in order of first appearance)."""
    uniq: dict[tuple, int] = {}
    u_idx = []
    for p in params_list:
        k = (int(p.start_ms - base_ms), int(p.step_ms), int(p.window_ms))
        u_idx.append(uniq.setdefault(k, len(uniq)))
    return u_idx, list(uniq)


def batch_variant_supported(block, func: str, kind: str, is_delta: bool) -> bool:
    """Whether a fused dispatch's rung has a lane mode, decided before the
    scheduler groups it (the JAX package's ``batch_variant_supported``): a
    jittered histogram grid and min/max_over_time on the jitter and masked
    rungs run solo; every other rung batches, window stats included (the
    JAX package's general program, ``_batched_general_jit``, where the
    port serves the function on window stats, ``general_rung``). The JAX
    predicate also declines an irregular grid its Pallas policy promotes
    (``pallas_enabled``, on for a TPU); the port has no separate Pallas
    rung, and its window-stats kernel has a lane mode."""
    if kind == "hist":
        return block.regular_ts is not None or block.nominal_ts is None
    variant = grid_variant(block, func, is_delta)
    if variant in ("jitter", "masked") and func in ("min_over_time", "max_over_time"):
        return False
    return variant in _LANE_RUNGS


def lanes_variant(block, func: str, kind: str, is_delta: bool, params_list) -> str | None:
    """The rung every lane's solo run takes, where they all take the same
    one and it has a lane mode; else None (the group runs solo: a merged
    window that the jitter bound declines, or more lanes than one launch
    takes, ``group_acc.MAX_LANES``)."""
    if len(params_list) > GA.MAX_LANES or not batch_variant_supported(block, func, kind,
                                                                      is_delta):
        return None
    if kind == "hist":
        variants = {hist_variant(block, p) for p in params_list}
        ok = ("hist_shared", "hist_general")
    else:
        variants = {grid_variant(block, func, is_delta, p.window_ms) for p in params_list}
        ok = _LANE_RUNGS
    return variants.pop() if len(variants) == 1 and next(iter(variants)) in ok else None


class LaneBatch:
    """The stacked inputs of one lane-mode launch, memoized on the block
    per lane composition (``_batched_stacks``): ``u_of_lane`` (host list and
    int32 [L] on the device), the unique windows ``ukeys`` and the rung's
    stacked window structure ``windows``, the int32 [L, S_pad] lane group
    ids ``gids`` (a lane's padded rows -1; None for topk and quantile
    lanes, whose store launch reads ``store_gids``, the zero gids as
    int32 [1, S_pad]), the largest group count ``G``, the largest
    ``num_steps`` and the shared ``j_pad``."""

    def __init__(self, block, lanes, variant: str, kind: str, j_pad: int):
        dev = block.vals.device
        self.u_of_lane, self.ukeys = _unique_windows([l[3] for l in lanes], block.base_ms)
        self.u_dev = torch.tensor(self.u_of_lane, dtype=torch.int32, device=dev)
        self.j_pad = j_pad
        self.num_steps = max(l[3].num_steps for l in lanes)
        self.G = max(l[1] for l in lanes)
        self.lanes_max = max(self.u_of_lane.count(u) for u in range(len(self.ukeys)))
        self.gids = self.store_gids = None
        if kind in ("agg", "hist"):
            self.gids = torch.stack([torch.where(g < G, g, -1).to(torch.int32)
                                     for g, G, _q, _p in lanes]).contiguous()
        else:
            self.store_gids = zero_gids(block).to(torch.int32)[None, :].contiguous()
        self.windows = self._windows(block, variant)

    def _windows(self, block, variant: str):
        dev = block.vals.device
        i32 = torch.int32
        if variant == "mxu":
            return MK.lane_windows(block, self.ukeys, self.j_pad)
        if variant in ("jitter", "masked"):
            return JR.lane_windows(variant == "masked", block, self.ukeys, self.j_pad)
        grid = {name: torch.tensor([k[i] for k in self.ukeys], dtype=i32, device=dev)
                for i, name in enumerate(("start", "step", "window"))}
        if variant == "hist_shared":
            from .kernels import RangeParams

            wins = [_hist_shared_windows(block, RangeParams(so + block.base_ms, sm,
                                                            self.num_steps, w), self.j_pad)
                    for so, sm, w in self.ukeys]
            grid["bounds"] = tuple(torch.stack([w[i] for w in wins]).contiguous()
                                   for i in range(4))
        return grid


def _batched_stacks(block, lanes, variant: str, kind: str, j_pad: int) -> LaneBatch:
    """The ``LaneBatch`` of a lane composition, memoized on the block
    (``singleflight.memo_on``: one build under concurrency) by the variant,
    kind, ``j_pad`` and each lane's window and grouping identity (the
    groupings are themselves memoized on the block, so their ids are stable
    for its life). A recurring dashboard round pays no host-to-device copy
    after its first occurrence."""
    sig = tuple((int(p.start_ms - block.base_ms), int(p.step_ms), int(p.window_ms),
                 int(p.num_steps), id(g), G) for g, G, _q, p in lanes)
    key = (variant, kind, j_pad, sig)
    cache = block.__dict__.get("_batch_stacks")
    if cache is not None and len(cache) > _BATCH_STACK_MEMO_MAX:
        cache.clear()  # bounded: stacks rebuild in one call
    return memo_on(block, "_batch_stacks", key,
                   lambda: LaneBatch(block, lanes, variant, kind, j_pad))


def fused_batched_scalar(func: str, epilogue: tuple, block, lanes, is_counter: bool,
                         is_delta: bool) -> list:
    """One lane-mode dispatch serving the scalar fused queries ``lanes``
    over one superblock, each output in its solo dispatch's shape and on
    the rung its solo run takes (``lanes_variant``): ``("agg", op)`` lanes
    one launch of the rung's lane mode ([G_l, J_pad] each); topk/bottomk
    and quantile lanes one launch of its lane store mode (every unique
    window's [J_pad, S_pad] grid once) and then each lane's
    order-statistics launch over its window's grid (1 + L launches)."""
    kind = "agg" if epilogue[0] == "agg" else epilogue[0]
    variant = lanes_variant(block, func, kind, is_delta, [l[3] for l in lanes])
    if variant is None:
        raise ValueError(f"the lanes of {func!r} do not share a rung with a lane mode")
    j_pad = pad_steps(max(l[3].num_steps for l in lanes))
    batch = _batched_stacks(block, lanes, variant, kind, j_pad)
    mod, prefix = _LANE_RUNGS[variant]
    if kind == "agg":
        return getattr(mod, f"{prefix}_lanes")(func, epilogue[1], block, lanes, batch,
                                               is_counter=is_counter, is_delta=is_delta)
    grids = getattr(mod, f"{prefix}_lanes_series")(func, block, batch, is_counter=is_counter,
                                                   is_delta=is_delta)
    out = []
    for (grouping, _G, q, params), u in zip(lanes, batch.u_of_lane):
        grid = grids[u][: params.num_steps]
        if kind == "topk":
            out.append(OS.topk_steps(grid, max(int(epilogue[1]), 1), bool(epilogue[2]),
                                     n_real=block.n_series))
        else:
            out.append(OS.segment_quantile(grid, grouping, q))
    return out


def fused_batched_hist(func: str, block, lanes, les: torch.Tensor, quantile: bool,
                       is_delta: bool) -> list:
    """One launch of the histogram range kernel's lane mode serving the
    histogram queries ``lanes`` over one [S, T, B] superblock: each lane's
    [G_l, J_pad, B] bucket sums, or with ``quantile`` its [G_l, J_pad]
    ``histogram_quantile`` at its own q folded into the same launch."""
    variant = lanes_variant(block, func, "hist", is_delta, [l[3] for l in lanes])
    if variant is None:
        raise ValueError(f"the lanes of {func!r} do not share a histogram rung with a lane mode")
    j_pad = pad_steps(max(l[3].num_steps for l in lanes))
    batch = _batched_stacks(block, lanes, variant, "hist", j_pad)
    return HK.hist_range_lanes(func, block, lanes, batch, les, quantile, is_delta=is_delta)


# -- standing delta maintenance (standing/maintainer.py) -----------------------
#
# A standing query keeps its [G, J] partials and, after a live-edge append,
# re-dispatches only the step suffix whose windows reach the appended
# interval, through the same fused launch over the same superblock, and
# splices it in. Each step's value reduces over the same rows of the same
# block whatever the grid's start and length, so the spliced partials equal
# a full re-evaluation; steps whose windows closed before an in-place
# extension are stable across it (appended columns fall outside them).
# Sums of old and appended partials were not used: float addition does not
# re-associate, so they could not equal a full re-evaluation.

# epilogues whose [G, J] output splices per step: the segment reduces (the
# JAX package's SIMPLE_AGG_OPS, which holds the tree's stddev, stdvar and
# group beside the fused ops). topk, quantile and the fused
# histogram_quantile re-dispatch the whole grid (counted
# standing_nondecomposable).
STANDING_DELTA_OPS = frozenset(SIMPLE_AGG_OPS) | {"stddev", "stdvar", "group"}


def standing_delta_eligible(op: str, params=(), hist_quantile=None) -> bool:
    """Whether a fused aggregate's epilogue supports standing delta
    maintenance (per-step splicing of retained partials)."""
    return op in STANDING_DELTA_OPS and not params and hist_quantile is None


def shift_partials(retained: np.ndarray, shift: int, num_steps: int) -> np.ndarray:
    """Slide retained [G, J] partials left by ``shift`` whole steps onto a
    ``num_steps``-wide grid (the dashboard's window advancing): steps off
    the front drop, steps not computed yet arrive as NaN for the delta
    dispatch to fill."""
    out = np.full((retained.shape[0], num_steps), np.nan, dtype=retained.dtype)
    if shift < retained.shape[1]:
        keep = retained[:, shift:]
        n = min(keep.shape[1], num_steps)
        out[:, :n] = keep[:, :n]
    return out


def splice_partials(retained: np.ndarray, fresh: np.ndarray, k0: int) -> np.ndarray:
    """Write a delta dispatch's [G, J - k0] suffix into the retained [G, J]
    grid at step ``k0``, in place. The caller has checked that the group
    axes match (the same ``group_ids_memo`` labels); a mismatch raises."""
    if fresh.shape[0] != retained.shape[0]:
        raise ValueError(f"standing splice group mismatch: retained G={retained.shape[0]} "
                         f"vs fresh G={fresh.shape[0]}")
    retained[:, k0:] = fresh[:, : retained.shape[1] - k0]
    return retained
