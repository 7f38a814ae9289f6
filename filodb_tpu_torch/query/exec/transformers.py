"""Range-vector transformers (counterpart of
``filodb_tpu/query/exec/transformers.py``; reference
query/exec/RangeVectorTransformer.scala + PeriodicSamplesMapper.scala:61):
the operator stages folded onto a leaf exec's output.

``PeriodicSamplesMapper`` turns a tree leaf's staged selection
(``RawGrid``) into the ``[S, J]`` grid of one range function through the
range-function ladder (``ops.kernels.run_range_function``: one launch per
leaf), with ``offset``, ``@`` (one evaluation step broadcast across the
grid), the metric strip and ``absent_over_time``'s host reduction. A
native-histogram leaf takes one launch of the histogram range kernel's
store mode (``hist_kernels.run_hist_range_function``): its ``[S, J, B]``
buckets beside NaN placeholder values, as in the JAX package (whose
``@`` broadcast drops the buckets; the port answers the same).
``classic_histogram_quantile`` is ``histogram_quantile`` over classic
``le``-labelled bucket rows: the pivot of the rows into per-group
cumulative counts on the host (an index table per bucket scheme), then one
launch of the standalone quantile per scheme
(``hist_kernels.histogram_quantile_gather``).

The reference tree's second part: instant functions
(``InstantVectorFunctionMapper``), scalar operators (``apply_binop``,
``ScalarOperationMapper``), the label, sort, limit and absent mappers, and
the map phases of the non-mergeable aggregates pushed onto shard leaves
(``TopkCandidateFilter``, whose per-(group, step) thresholds come from one
``order_stats.segment_topk`` launch, and ``CountValuesMapReduce``, on the
host). Values stay on the device they were computed on (a tensor; a host
grid as a CPU tensor); ``timestamp()`` and the time components are f64 on
the host, as in the JAX package. Over native histogram grids the
quantiles and histogram_fraction take one launch of the instant kernel
(``hist_kernels.hist_instant``) for a node's grids, histogram_bucket and
hist_to_prom_vectors slice and gather where the grid lies, sort orders
the buckets with their rows and the candidate filter passes them
through.
"""

from __future__ import annotations

import calendar
import datetime as _dt
import re
from dataclasses import dataclass

import numpy as np
import torch

from ...core.schemas import METRIC_TAG
from ...ops import aggregations as AGG
from ...ops import hist_kernels as HK
from ...ops import kernels as K
from ...ops import order_stats as OS
from ...ops import segment_agg as SA
from ...singleflight import memo_on
from ..rangevector import Grid, RawGrid, ScalarResult

_DROP_NAME_KEEP = {"last_over_time", "timestamp"}  # functions that keep _metric_


class QueryError(ValueError):
    pass


class QueryDeadlineExceeded(QueryError):
    """A query that ran past its deadline (the caller stopped waiting); the
    HTTP edge answers 503, as Prometheus does for timeouts."""


def _strip_metric(labels: dict) -> dict:
    return {k: v for k, v in labels.items() if k not in (METRIC_TAG, "__name__")}


@dataclass
class PeriodicSamplesMapper:
    """Regular-step samples from staged raw windows: one range-function
    launch per leaf (the JAX package's one jit call)."""

    start_ms: int
    end_ms: int
    step_ms: int
    function: str | None = None  # None => instant lookback (the selector's last)
    window_ms: int | None = None
    lookback_ms: int = 300_000
    offset_ms: int = 0
    at_ms: int | None = None
    args: tuple = ()

    def num_steps(self) -> int:
        return int((self.end_ms - self.start_ms) // self.step_ms) + 1

    def range_params(self) -> K.RangeParams:
        """The evaluation grid of the range function: shifted back by
        ``offset``; with ``@``, one step at that time."""
        window = self.window_ms if self.window_ms is not None else self.lookback_ms
        eval_start = (self.at_ms if self.at_ms is not None else self.start_ms) - self.offset_ms
        eval_steps = 1 if self.at_ms is not None else self.num_steps()
        return K.RangeParams(eval_start, self.step_ms, eval_steps, window)

    def apply_raw(self, raws: list[RawGrid], stats=None) -> list[Grid]:
        """One range-function launch per leaf grid; ``stats`` (a
        ``QueryStats``) counts the rung that served each."""
        out: list[Grid] = []
        nsteps = self.num_steps()
        for rg in raws:
            func = self.function or "last"
            params = self.range_params()
            hist = None
            if rg.is_histogram:
                if func not in HK.FUSED_HIST_FUNCS:
                    raise QueryError(
                        f"function {self.function} is not supported on native histograms")
                hist = HK.run_hist_range_function(func, rg.block, params, is_delta=rg.is_delta)
                if stats is not None:
                    stats.note_rung(AGG.hist_variant(rg.block))
                # the scalar rows beside the buckets are a NaN placeholder, as in JAX
                vals = torch.full((hist.shape[0], max(nsteps, 1) if self.at_ms is not None
                                   else hist.shape[1]), float("nan"), dtype=torch.float32,
                                  device=hist.device)
                if self.at_ms is not None:
                    # the JAX package's @ broadcast replaces the grid's values and
                    # drops its buckets (Grid.with_values): the port answers the same
                    hist = None
            else:
                vals, variant = K._dispatch_range_function(
                    func, rg.block, params, is_counter=rg.is_counter, is_delta=rg.is_delta,
                    args=self.args)
                if stats is not None:
                    stats.note_rung(variant)
                if self.at_ms is not None:
                    # @ fixes the evaluation time: the one step broadcast across the grid
                    vals = _broadcast_first_step(vals, max(nsteps, 1))
            labels = rg.labels
            if self.function and self.function not in _DROP_NAME_KEEP:
                # memoized on the block, as its labels are (a warm leaf strips nothing)
                labels = memo_on(rg.block, "stripped_labels_memo", id(rg.labels),
                                 lambda: [_strip_metric(l) for l in rg.labels])
            # the source lets the map phases memoize groupings on the block
            g = Grid(list(labels), self.start_ms, self.step_ms, nsteps, vals, hist=hist,
                     les=rg.les if hist is not None else None, source=(rg.block, id(labels)))
            if self.function == "absent_over_time":
                g = self._absent_reduce(g)
            out.append(g)
        return out

    def _absent_reduce(self, g: Grid) -> Grid:
        # absent iff no series is present at the step (a host reduction, as in JAX)
        v = g.values_np()
        if v.shape[0] == 0:
            vals = np.ones((1, g.num_steps), dtype=np.float32)
        else:
            present = (~np.isnan(v)).any(axis=0)
            vals = np.where(present, np.nan, 1.0)[None, :].astype(np.float32)
        return Grid([{}], g.start_ms, g.step_ms, g.num_steps, vals)


def _broadcast_first_step(vals, nsteps: int):
    """[S, 1+] -> [S, nsteps]: every step holds step 0's value."""
    if isinstance(vals, torch.Tensor):
        return vals[:, :1].expand(-1, nsteps).contiguous()
    return np.repeat(np.asarray(vals)[:, :1], nsteps, axis=1)


@dataclass(frozen=True)
class ClassicPivot:
    """The host plan of a classic-bucket quantile over a list of ``le``
    rows: the output labels (each group's labels without ``le``, in the
    order groups first appear) and per bucket scheme the ``(table, rows,
    les)`` of one launch, tensors on one device -- ``table`` int32 [G_s,
    B_s], each group's rows in ascending ``le``; ``rows`` int32 [G_s], its
    output rows; ``les`` f32 [B_s]."""

    labels: list
    schemes: list


def classic_pivot(labels, device) -> ClassicPivot:
    """Group ``le``-labelled rows by their other labels and stack the
    groups of one bucket scheme (their sorted bounds) into one index table
    on ``device`` (``classic_histogram_quantile``'s pivot in the JAX
    package), checked once for the gather (``check_gather_table``); raises
    QueryError when a row carries no ``le``."""
    groups: dict = {}
    order: list = []
    for i, l in enumerate(labels):
        le_s = l.get("le")
        if le_s is None:
            raise QueryError(
                "histogram_quantile needs native-histogram input or "
                "le-labeled classic bucket series"
            )
        le = float("inf") if str(le_s) in ("+Inf", "Inf", "inf") else float(le_s)
        key = tuple(sorted((k, v) for k, v in l.items() if k != "le"))
        if key not in groups:
            groups[key] = []
            order.append(key)
        groups[key].append((le, i))
    position = {key: g for g, key in enumerate(order)}
    by_scheme: dict = {}
    for key in order:
        members = sorted(groups[key], key=lambda m: m[0])
        scheme = tuple(m[0] for m in members)
        by_scheme.setdefault(scheme, []).append((position[key], [m[1] for m in members]))
    schemes = []
    for scheme, entries in by_scheme.items():
        table = np.array([idx for _, idx in entries], dtype=np.int32).reshape(len(entries), -1)
        rows = np.array([g for g, _ in entries], dtype=np.int32)
        gather = tuple(torch.from_numpy(a).to(device) for a in (
            table, rows, np.array(scheme, dtype=np.float32)))
        HK.check_gather_table(*gather)  # once: the launches trust the memoized table
        schemes.append(gather)
    return ClassicPivot([dict(key) for key in order], schemes)


def classic_histogram_quantile(q: float, labels, values, num_steps: int, pivot=None):
    """``histogram_quantile`` over classic bucket rows (scalar rows with
    ``le`` labels, e.g. a ``sum by (le, ...)`` of ``m_bucket`` series):
    ``values`` [rows, J*] (a tensor, NaN = absent) pivots through
    ``classic_pivot`` (or the memoized ``pivot`` of the same labels) into
    per-group cumulative counts and interpolates them, one launch per
    bucket scheme. Returns ``(labels without le, [G, J*] values)`` on the
    values' device, NaN past ``num_steps``."""
    values = torch.as_tensor(values, dtype=torch.float32).contiguous()
    dev = values.device
    pivot = pivot if pivot is not None else classic_pivot(labels, dev)
    out = torch.full((len(pivot.labels), values.shape[1]), float("nan"), dtype=torch.float32,
                     device=dev)
    for table, rows, les in pivot.schemes:
        HK.histogram_quantile_gather(q, values, table, rows, les, num_steps, out)
    return pivot.labels, out


# -- the reference tree's second part -------------------------------------------


def grid_values(g: Grid) -> torch.Tensor:
    """A grid's real rows and steps as a [n, J] f32 tensor on the device
    its values live on (a host array as a CPU tensor)."""
    v = g.values
    if not isinstance(v, torch.Tensor):
        v = torch.as_tensor(np.asarray(v), dtype=torch.float32)
    elif v.dtype != torch.float32:
        v = v.float()
    return v[: g.n_series, : g.num_steps]


def grid_hist(g: Grid, device=None) -> torch.Tensor:
    """A histogram grid's real rows and steps as a [n, J, B] f32 tensor:
    the tensor it holds (a leaf's store-mode view on the card), or its host
    array (the host merge phase's answer) uploaded to ``device`` (the CPU
    without one)."""
    h = g.hist
    if not isinstance(h, torch.Tensor):
        h = torch.as_tensor(np.asarray(h, dtype=np.float32)).to(device or "cpu")
    return h[: g.n_series, : g.num_steps]


def grid_grouping(g: Grid, by, without, device):
    """``(gids, G, group_labels)`` of a grid's rows (``group_ids_for``),
    gids int64 [n] on ``device``; memoized on a leaf grid's staged block
    (keyed by its label list, which the block memoizes)."""
    def build():
        gids, labels = AGG.group_ids_for(g.labels, list(by) if by else None,
                                         list(without) if without else None)
        return torch.from_numpy(gids.astype(np.int64)).to(device), len(labels), labels

    if g.source is None:
        return build()
    return memo_on(g.source[0], "tree_groups_memo", _grouping_key(g, by, without, device), build)


def grid_members(g: Grid, by, without, device):
    """``(members, G, group_labels, gids)``: ``grid_grouping`` and its
    ``order_stats.Members``, memoized beside it."""
    gids, G, labels = grid_grouping(g, by, without, device)
    if g.source is None:
        return OS.segment_members(gids, G), G, labels, gids
    members = memo_on(g.source[0], "tree_members_memo", _grouping_key(g, by, without, device),
                      lambda: OS.segment_members(gids, G))
    return members, G, labels, gids


def _grouping_key(g: Grid, by, without, device) -> tuple:
    return (g.source[1], tuple(by) if by else None, tuple(without) if without else None,
            str(device))


_ELEMENTWISE = {
    "abs": torch.abs, "ceil": torch.ceil, "floor": torch.floor, "exp": torch.exp,
    "ln": torch.log, "log2": torch.log2, "log10": torch.log10, "sqrt": torch.sqrt,
    # jnp.sign: NaN (absence) and signed zeros stay as they are
    "sgn": lambda v: torch.where((v == 0) | torch.isnan(v), v, torch.sign(v)),
    "acos": torch.acos, "acosh": torch.acosh,
    "asin": torch.asin, "asinh": torch.asinh, "atan": torch.atan,
    "atanh": torch.atanh, "cos": torch.cos, "cosh": torch.cosh, "sin": torch.sin,
    "sinh": torch.sinh, "tan": torch.tan, "tanh": torch.tanh,
    "deg": torch.rad2deg, "rad": torch.deg2rad,
}

_TIME_COMPONENT = {
    "minute": lambda d: d.minute, "hour": lambda d: d.hour,
    "month": lambda d: d.month, "year": lambda d: d.year,
    "day_of_month": lambda d: d.day, "day_of_week": lambda d: (d.weekday() + 1) % 7,
    "day_of_year": lambda d: d.timetuple().tm_yday,
    "days_in_month": lambda d: calendar.monthrange(d.year, d.month)[1],
}

# the functions of native histogram grids the instant kernel computes: its op
# for each
_HIST_INSTANT_OPS = {"histogram_quantile": "quantile", "histogram_max_quantile": "quantile",
                     "histogram_max_quantile_even": "quantile_even",
                     "histogram_fraction": "fraction"}


def time_components(f: str, times_ms) -> np.ndarray:
    """``f`` (a ``_TIME_COMPONENT``) of each UTC time, f64."""
    return np.array([_TIME_COMPONENT[f](_dt.datetime.fromtimestamp(t / 1e3, _dt.timezone.utc))
                     for t in times_ms], dtype=np.float64)


@dataclass
class InstantVectorFunctionMapper:
    """Instant functions over each grid (reference InstantVectorFunctionMapper
    + InstantFunction.scala): elementwise math and clamp/round/or_vector on
    the values' device, ``timestamp()`` and the time components f64 on the
    host, ``histogram_quantile`` over classic ``le`` rows through the
    standalone quantile. Over native histogram grids: the quantiles and
    ``histogram_fraction`` take one launch of the instant kernel for all
    of the node's grids (``hist_kernels.hist_instant``; a host grid, the
    merge phase's answer, is uploaded to ``device`` first),
    ``histogram_bucket`` a slice of one bucket, ``hist_to_prom_vectors``
    the buckets as ``le`` rows gathered where they lie; any other function
    reads the grid's NaN placeholder values, as in JAX."""

    function: str
    args: tuple = ()

    def apply(self, grids: list[Grid], device=None) -> list[Grid]:
        f = self.function
        # grids without buckets first, grid by grid (a classic quantile, or
        # the JAX package's error), then the native ones in one launch
        out = [self._one(g) if g.hist is None or f not in _HIST_INSTANT_OPS else None
               for g in grids]
        native = [i for i, g in enumerate(grids) if g.hist is not None
                  and f in _HIST_INSTANT_OPS]
        if native:
            hists = [grid_hist(grids[i], device) for i in native]
            les = [_les_on(grids[i], h.device) for i, h in zip(native, hists)]
            kw = ({"lower": float(np.float32(self.args[0])),
                   "upper": float(np.float32(self.args[1]))} if f == "histogram_fraction"
                  else {"q": float(np.float32(self.args[0]))})
            for i, vals in zip(native, HK.hist_instant(_HIST_INSTANT_OPS[f], hists, les, **kw)):
                g = grids[i]
                out[i] = Grid([_strip_metric(l) for l in g.labels], g.start_ms, g.step_ms,
                              g.num_steps, vals)
        return out

    def _one(self, g: Grid) -> Grid:
        f = self.function
        labels = [_strip_metric(l) for l in g.labels]
        if f in ("histogram_max_quantile", "histogram_max_quantile_even"):
            # a grid without buckets: the JAX package's own error
            raise ValueError("None is not a valid value for jnp.array")
        if f == "histogram_fraction":
            raise QueryError("histogram_fraction needs native-histogram input")
        if f == "histogram_bucket":
            return _histogram_bucket(g, float(self.args[0]), labels)
        if f == "hist_to_prom_vectors":
            return _hist_to_prom(g)
        if f == "histogram_quantile":
            out_labels, vals = classic_histogram_quantile(float(np.float32(self.args[0])),
                                                          g.labels, grid_values(g), g.num_steps)
            return Grid([_strip_metric(l) for l in out_labels], g.start_ms, g.step_ms,
                        g.num_steps, vals)
        if f == "timestamp" or f in _TIME_COMPONENT:
            times = g.step_times_ms()
            t = times.astype(np.float64) / 1e3 if f == "timestamp" else time_components(f, times)
            return Grid(labels, g.start_ms, g.step_ms, g.num_steps,
                        np.where(np.isnan(g.values_np()), np.nan, t[None, :]))
        v = grid_values(g)
        if f == "clamp":
            v = torch.clamp(v, float(np.float32(self.args[0])), float(np.float32(self.args[1])))
        elif f == "clamp_min":
            v = torch.maximum(v, _scalar(self.args[0], v))
        elif f == "clamp_max":
            v = torch.minimum(v, _scalar(self.args[0], v))
        elif f == "round":
            to = _scalar(self.args[0] if self.args else 1.0, v)
            v = torch.round(v / to) * to
        elif f == "or_vector":
            v = torch.where(torch.isnan(v), _scalar(self.args[0], v), v)
        elif f in _ELEMENTWISE:
            v = _ELEMENTWISE[f](v)
        else:
            raise QueryError(f"unknown instant function {f}")
        return Grid(labels, g.start_ms, g.step_ms, g.num_steps, v)


def _les_on(g: Grid, device) -> torch.Tensor:
    """A histogram grid's bucket bounds as f32 [B] on ``device``."""
    return torch.as_tensor(np.asarray(g.les, dtype=np.float32)).to(device)


def _histogram_bucket(g: Grid, le: float, labels) -> Grid:
    """histogram_bucket(le, h): one bucket's values where the grid lies
    (reference HistogramBucketImpl: a bound within 1e-10, +Inf the top
    bucket, NaN rows where none matches), labels stripped with ``le`` set."""
    if g.hist is None:
        raise QueryError("histogram_bucket needs native-histogram input")
    les = np.asarray(g.les, dtype=np.float64)
    if np.isinf(le):
        idx = len(les) - 1
    else:
        matches = np.nonzero(np.abs(les - le) < 1e-10)[0]
        idx = int(matches[0]) if len(matches) else -1
    if idx < 0:
        vals = np.full((g.n_series, g.num_steps), np.nan, np.float32)
    else:
        vals = g.hist[: g.n_series, : g.num_steps, idx]
    le_str = "+Inf" if idx >= 0 and np.isinf(les[idx]) else f"{le:g}"
    return Grid([dict(l, le=le_str) for l in labels], g.start_ms, g.step_ms, g.num_steps, vals)


def _hist_to_prom(g: Grid) -> Grid:
    """A native histogram grid exploded into classic bucket rows (reference
    HistToPromSeriesMapper): each series' buckets in order, labelled with
    their ``le`` on the host, the rows gathered where the grid lies; a grid
    without buckets passes through."""
    if g.hist is None:
        return g
    h = g.hist[: g.n_series, : g.num_steps]
    if not isinstance(h, torch.Tensor):
        h = torch.as_tensor(np.asarray(h, dtype=np.float32))
    S, J, B = h.shape
    labels = []
    for l in g.labels:
        for b in range(B):
            le = g.les[b]
            labels.append(dict(l, le="+Inf" if np.isinf(le) else f"{le:g}"))
    return Grid(labels, g.start_ms, g.step_ms, g.num_steps, h.permute(0, 2, 1).reshape(S * B, J))


def _scalar(x, like: torch.Tensor) -> torch.Tensor:
    """A number as a 0-d f32 tensor beside ``like``."""
    return torch.tensor(float(x), dtype=torch.float32, device=like.device)


_BINOPS = {
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "/": lambda a, b: a / b,
    "%": lambda a, b: torch.where(b != 0, a - torch.floor(a / b) * b, float("nan")),
    "^": lambda a, b: torch.pow(a, b),
    "atan2": lambda a, b: torch.atan2(a, b),
}
_CMPOPS = {
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    ">": lambda a, b: a > b,
    "<": lambda a, b: a < b,
    ">=": lambda a, b: a >= b,
    "<=": lambda a, b: a <= b,
}


def apply_binop(op: str, lhs: torch.Tensor, rhs: torch.Tensor, return_bool: bool) -> torch.Tensor:
    """Elementwise arithmetic or comparison of f32 tensors with PromQL's
    filter semantics: a comparison keeps the left value where it holds
    (NaN elsewhere), or with ``bool`` gives 1/0 where both sides have a
    value; ``%`` is a floored modulo, NaN at 0."""
    if op in _BINOPS:
        return _BINOPS[op](lhs, rhs)
    cmp = _CMPOPS[op](lhs, rhs)
    if return_bool:
        both = ~(torch.isnan(lhs) | torch.isnan(rhs))
        return torch.where(both, cmp.to(torch.float32), float("nan"))
    return torch.where(cmp, lhs, float("nan"))


@dataclass
class ScalarOperationMapper:
    """vector op scalar (reference ScalarOperationMapper): the scalar a
    number or a ``ScalarResult`` (one value a step, NaN past its steps);
    the metric name kept only by a comparison without ``bool``."""

    op: str
    scalar: ScalarResult | float
    scalar_is_lhs: bool
    return_bool: bool = False

    def apply(self, grids: list[Grid]) -> list[Grid]:
        out = []
        for g in grids:
            v = grid_values(g)
            s = self.scalar
            if isinstance(s, ScalarResult):
                sv = np.full(v.shape[1], np.nan)
                n = min(len(s.values), v.shape[1])
                sv[:n] = np.asarray(s.values)[:n]
                sv = torch.as_tensor(sv, dtype=torch.float32, device=v.device)[None, :]
            else:
                sv = _scalar(s, v)
            a, b = (sv, v) if self.scalar_is_lhs else (v, sv)
            res = apply_binop(self.op, a, b, self.return_bool).expand(v.shape)
            keep_name = self.op in _CMPOPS and not self.return_bool
            labels = g.labels if keep_name else [_strip_metric(l) for l in g.labels]
            out.append(Grid(labels, g.start_ms, g.step_ms, g.num_steps, res))
        return out


@dataclass
class MiscellaneousFunctionMapper:
    """label_replace / label_join, and the planner's no-op markers."""

    function: str
    str_args: tuple = ()

    def apply(self, grids: list[Grid]) -> list[Grid]:
        if self.function in ("optimize_with_agg", "no_optimize"):
            return grids  # planner-level markers; no-op at execution
        if self.function == "label_replace":
            dst, repl, src, regex_s = self.str_args
            pat = re.compile(regex_s)
            for g in grids:
                new_labels = []
                for l in g.labels:
                    m = pat.fullmatch(l.get(src, ""))
                    l2 = dict(l)
                    if m:
                        val = m.expand(repl.replace("$", "\\"))
                        if val:
                            l2[dst] = val
                        else:
                            l2.pop(dst, None)
                    new_labels.append(l2)
                g.labels = new_labels
                g.source = None  # groupings memoized on the block hold the old labels
            return grids
        if self.function == "label_join":
            dst, sep, *srcs = self.str_args
            for g in grids:
                g.labels = [{**l, dst: sep.join(l.get(s, "") for s in srcs)} for l in g.labels]
                g.source = None
            return grids
        raise QueryError(f"unknown misc function {self.function}")


@dataclass
class SortFunctionMapper:
    """sort()/sort_desc(): series ordered by their last step's value (on
    the host; a NaN sorts last)."""

    descending: bool = False

    def apply(self, grids: list[Grid]) -> list[Grid]:
        out = []
        for g in grids:
            v = g.values_np()
            key = np.where(np.isnan(v[:, -1]), -np.inf if not self.descending else np.inf,
                           v[:, -1])
            order = np.argsort(-key if self.descending else key, kind="stable")
            hist = None
            if g.hist is not None:  # the buckets follow their rows, where they lie
                hist = g.hist[: g.n_series, : g.num_steps]
                hist = hist[torch.as_tensor(order, device=hist.device)] if isinstance(
                    hist, torch.Tensor) else np.asarray(hist)[order]
            out.append(Grid([g.labels[i] for i in order], g.start_ms, g.step_ms, g.num_steps,
                            v[order], hist, g.les))
        return out


@dataclass
class LimitFunctionMapper:
    """limit(n): the first n series, grid by grid."""

    limit: int

    def apply(self, grids: list[Grid]) -> list[Grid]:
        out = []
        budget = self.limit
        for g in grids:
            if budget <= 0:
                break
            take = min(budget, g.n_series)
            out.append(Grid(g.labels[:take], g.start_ms, g.step_ms, g.num_steps,
                            grid_values(g)[:take]))
            budget -= take
        return out


@dataclass
class AbsentFunctionMapper:
    """absent(v): 1 where no series has a value at the step (reference
    AbsentFunctionMapper); the labels of the selector's equality matchers."""

    filters: tuple = ()
    start_ms: int = 0
    step_ms: int = 1
    num_steps: int = 1

    def apply(self, grids: list[Grid]) -> list[Grid]:
        start_ms, step_ms, num_steps = self.start_ms, self.step_ms, self.num_steps
        if grids:
            start_ms, step_ms, num_steps = grids[0].start_ms, grids[0].step_ms, grids[0].num_steps
        present = np.zeros(num_steps, dtype=bool)
        for g in grids:
            v = grid_values(g)
            if v.numel():
                present[: v.shape[1]] |= (~torch.isnan(v)).any(dim=0).cpu().numpy()
        vals = np.where(present, np.nan, 1.0)[None, :].astype(np.float32)
        labels = {f.column: f.value for f in self.filters
                  if getattr(f, "op", "") == "=" and f.column not in (METRIC_TAG, "__name__")}
        return [Grid([labels], start_ms, step_ms, num_steps, vals)]


@dataclass
class TopkCandidateFilter:
    """The per-shard map phase of a root topk/bottomk by (...): keep only
    the series in this shard's per-(group, step) top k at some step
    (reference TopBottomKRowAggregator's per-node heaps). Ties at the k-th
    value are kept, a superset, so the root's answer is exact. The
    thresholds come from one ``order_stats.segment_topk`` launch on the
    grid's device; a group of at most k series keeps every row."""

    k: int
    bottom: bool = False
    by: tuple | None = None
    without: tuple | None = None

    def apply(self, grids: list[Grid]) -> list[Grid]:
        out = []
        for g in grids:
            if g.hist is not None or g.n_series <= self.k:
                out.append(g)  # a histogram grid passes through, as in JAX
                continue
            v = grid_values(g)
            members, G, _, gids = grid_members(g, self.by, self.without, v.device)
            _, thr = OS.segment_topk(SA.step_major(v), members, self.k, self.bottom)
            t = thr[gids]  # [n, J]: each row's group threshold
            fill = float("inf") if self.bottom else float("-inf")
            vv = torch.where(torch.isnan(v), fill, v)
            cand = (vv <= t) if self.bottom else (vv >= t)
            keep = (cand & torch.isfinite(v)).any(dim=1)
            sizes = members.starts[1:] - members.starts[:-1]
            keep |= (sizes <= self.k)[gids]
            rows = torch.nonzero(keep).flatten()
            rows_h = rows.cpu().numpy()
            out.append(Grid([g.labels[i] for i in rows_h], g.start_ms, g.step_ms, g.num_steps,
                            v[rows]))
        return out


@dataclass
class CountValuesMapReduce:
    """The per-shard map phase of a root count_values: one row per (group,
    value string) with this shard's per-step counts, on the host (shards
    own disjoint series, so the root sums rows of equal labels)."""

    label: str
    by: tuple | None = None
    without: tuple | None = None

    def apply(self, grids: list[Grid]) -> list[Grid]:
        if not grids:
            return grids
        all_labels = [l for g in grids for l in g.labels]
        if not all_labels:
            return [grids[0]]
        vals = stack_values_np(grids)
        gids, group_labels = AGG.group_ids_for(
            all_labels, list(self.by) if self.by else None,
            list(self.without) if self.without else None)
        meta = grids[0]
        out_labels, out_rows = [], []
        for gi, gl in enumerate(group_labels):
            for valstr, row in AGG.count_values(vals[gids == gi]).items():
                out_labels.append(dict(gl, **{self.label: valstr}))
                out_rows.append(row[: meta.num_steps])
        v = (np.stack(out_rows).astype(np.float32) if out_rows
             else np.zeros((0, meta.num_steps), np.float32))
        return [Grid(out_labels, meta.start_ms, meta.step_ms, meta.num_steps, v)]


def stack_values_np(grids: list[Grid]) -> np.ndarray:
    """The grids' rows stacked on the host as one f32 [N, J] array (J the
    widest grid's steps, NaN-padded)."""
    mats = [g.values_np() for g in grids]
    J = max(m.shape[1] for m in mats)
    vals = np.full((sum(m.shape[0] for m in mats), J), np.nan, np.float32)
    r = 0
    for m in mats:
        vals[r: r + m.shape[0], : m.shape[1]] = m
        r += m.shape[0]
    return vals
