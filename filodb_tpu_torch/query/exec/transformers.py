"""Range-vector transformers (counterpart of
``filodb_tpu/query/exec/transformers.py``; reference
query/exec/RangeVectorTransformer.scala + PeriodicSamplesMapper.scala:61):
the operator stages folded onto a leaf exec's output.

``PeriodicSamplesMapper`` turns a tree leaf's staged selection
(``RawGrid``) into the ``[S, J]`` grid of one range function through the
range-function ladder (``ops.kernels.run_range_function``: one launch per
leaf), with ``offset``, ``@`` (one evaluation step broadcast across the
grid), the metric strip and ``absent_over_time``'s host reduction.
``classic_histogram_quantile`` is ``histogram_quantile`` over classic
``le``-labelled bucket rows: the pivot of the rows into per-group
cumulative counts on the host (an index table per bucket scheme), then one
launch of the standalone quantile per scheme
(``hist_kernels.histogram_quantile_gather``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ...core.schemas import METRIC_TAG
from ...ops import hist_kernels as HK
from ...ops import kernels as K
from ...singleflight import memo_on
from ..rangevector import Grid, RawGrid

_DROP_NAME_KEEP = {"last_over_time", "timestamp"}  # functions that keep _metric_


class QueryError(ValueError):
    pass


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

    def apply_raw(self, raws: list[RawGrid]) -> list[Grid]:
        out: list[Grid] = []
        nsteps = self.num_steps()
        for rg in raws:
            func = self.function or "last"
            params = self.range_params()
            if rg.is_histogram:
                raise NotImplementedError(
                    "range functions over native histograms on the reference tree "
                    "(run_hist_range_function, [S, J, B] grids) are not ported: ROADMAP A2b")
            vals = K.run_range_function(func, rg.block, params, is_counter=rg.is_counter,
                                        is_delta=rg.is_delta, args=self.args)
            if self.at_ms is not None:
                # @ fixes the evaluation time: the one step broadcast across the grid
                vals = _broadcast_first_step(vals, max(nsteps, 1))
            labels = rg.labels
            if self.function and self.function not in _DROP_NAME_KEEP:
                # memoized on the block, as its labels are (a warm leaf strips nothing)
                labels = memo_on(rg.block, "stripped_labels_memo", id(rg.labels),
                                 lambda: [_strip_metric(l) for l in rg.labels])
            g = Grid(list(labels), self.start_ms, self.step_ms, nsteps, vals)
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


def classic_pivot(labels, device="cpu") -> ClassicPivot:
    """Group ``le``-labelled rows by their other labels and stack the
    groups of one bucket scheme (their sorted bounds) into one index table
    on ``device`` (``classic_histogram_quantile``'s pivot in the JAX
    package); raises QueryError when a row carries no ``le``."""
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
        schemes.append(tuple(torch.from_numpy(a).to(device) for a in (
            table, rows, np.array(scheme, dtype=np.float32))))
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
