"""Binary joins, set operators, scalar plans and subqueries (counterpart of
``filodb_tpu/query/exec/joins.py``; reference query/exec/BinaryJoinExec.scala,
SetOperatorExec.scala, the scalar execs, subquery materialization).

Label matching runs on the host over the series' label keys; the matched
rows are gathered with index tensors and combined on the device the
children's values live on (``transformers.apply_binop``). Scalar plans
evaluate on the host, one value a step. A subquery's inner grids come to
the host, are re-staged as series without a loop per row
(``staging.stage_step_rows``), go back to the query's device in one upload
and take the range function's rung (``kernels.run_range_function``): one
launch per inner grid.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ...core.schemas import METRIC_TAG
from ...ops import kernels as K
from ...ops import staging as ST
from .. import logical as L
from ..rangevector import Grid, QueryResult, ScalarResult
from .plans import ExecPlan, NonLeafExecPlan, QueryContext, stack_step_major
from .transformers import (_CMPOPS, _TIME_COMPONENT, QueryError, ScalarOperationMapper,
                           _strip_metric, apply_binop, time_components)


def _match_key(labels: dict, on, ignoring) -> tuple:
    if on is not None:
        return tuple((k, labels.get(k, "")) for k in sorted(on))
    drop = set(ignoring or ()) | {METRIC_TAG, "__name__"}
    return tuple(sorted((k, v) for k, v in labels.items() if k not in drop))


def _flatten(grids: list[Grid]):
    """(labels, [N, J] f32 values on their device, meta grid) of a child's
    grids side by side; ([], None, None) for none."""
    if not grids:
        return [], None, None
    labels = [l for g in grids for l in g.labels]
    return labels, stack_step_major(grids).T, grids[0]


def _rows(idx: list[int], device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(idx, dtype=np.int64), device=device)


class BinaryJoinExec(NonLeafExecPlan):
    """Arithmetic and comparison joins, one-to-one or group_left /
    group_right (reference BinaryJoinExec)."""

    def __init__(self, lhs: ExecPlan, rhs: ExecPlan, op: str, cardinality: str,
                 on=None, ignoring=(), include=(), return_bool=False):
        super().__init__([lhs, rhs])
        self.op = op
        self.cardinality = cardinality
        self.on = on
        self.ignoring = ignoring
        self.include = include
        self.return_bool = return_bool

    def args_str(self):
        return f"op={self.op} card={self.cardinality} on={self.on} ignoring={self.ignoring}"

    def do_execute(self, ctx: QueryContext) -> QueryResult:
        lres, rres = self.execute_children(ctx)
        llabels, lvals, lmeta = _flatten(lres.grids)
        rlabels, rvals, rmeta = _flatten(rres.grids)
        meta = lmeta or rmeta
        if meta is None:
            return QueryResult()
        out_labels: list[dict] = []
        lhs_rows: list[int] = []
        rhs_rows: list[int] = []
        many_side_left = self.cardinality == "many-to-one"
        if self.cardinality == "one-to-one":
            rindex: dict[tuple, list[int]] = {}
            for j, rl in enumerate(rlabels):
                rindex.setdefault(_match_key(rl, self.on, self.ignoring), []).append(j)
            seen: set = set()
            for i, ll in enumerate(llabels):
                key = _match_key(ll, self.on, self.ignoring)
                js = rindex.get(key, [])
                if not js:
                    continue
                if len(js) > 1:
                    raise QueryError(
                        "many-to-many matching not allowed: use group_left/group_right")
                if key in seen:
                    raise QueryError("multiple matches for labels on left side")
                seen.add(key)
                out_labels.append(self._result_labels(ll, rlabels[js[0]]))
                lhs_rows.append(i)
                rhs_rows.append(js[0])
        else:
            # group_left: many on the left; group_right: many on the right
            many_labels = llabels if many_side_left else rlabels
            one_labels = rlabels if many_side_left else llabels
            one_index: dict[tuple, list[int]] = {}
            for j, ol in enumerate(one_labels):
                one_index.setdefault(_match_key(ol, self.on, self.ignoring), []).append(j)
            for i, ml in enumerate(many_labels):
                js = one_index.get(_match_key(ml, self.on, self.ignoring), [])
                if not js:
                    continue
                if len(js) > 1:
                    raise QueryError("multiple matches on the 'one' side of a grouped join")
                j = js[0]
                lbl = dict(_strip_metric(ml))
                for inc in self.include:
                    v = one_labels[j].get(inc)
                    if v is not None:
                        lbl[inc] = v
                    else:
                        lbl.pop(inc, None)
                out_labels.append(lbl)
                lhs_rows.append(i if many_side_left else j)
                rhs_rows.append(j if many_side_left else i)
        if not out_labels:
            return QueryResult()
        dev = lvals.device
        a = lvals[_rows(lhs_rows, dev)]
        b = rvals.to(dev)[_rows(rhs_rows, dev)]
        v = apply_binop(self.op, a, b, self.return_bool)
        return QueryResult(grids=[Grid(out_labels, meta.start_ms, meta.step_ms, meta.num_steps,
                                       v)])

    def _result_labels(self, ll: dict, rl: dict) -> dict:
        keep_name = self.op in _CMPOPS and not self.return_bool
        if self.on is not None:
            # one-to-one with on(): the result's labels are the on() labels
            out = {k: ll.get(k, "") for k in self.on if k in ll}
            if keep_name and METRIC_TAG in ll:
                out[METRIC_TAG] = ll[METRIC_TAG]
            return out
        out = dict(ll) if keep_name else _strip_metric(ll)
        for k in self.ignoring:
            out.pop(k, None)
        return out


class SetOperatorExec(NonLeafExecPlan):
    """and / or / unless, sample by sample (reference SetOperatorExec): the
    presence of each match key at each step summed on the device."""

    def __init__(self, lhs: ExecPlan, rhs: ExecPlan, op: str, on=None, ignoring=()):
        super().__init__([lhs, rhs])
        self.op = op
        self.on = on
        self.ignoring = ignoring

    def args_str(self):
        return f"op={self.op} on={self.on} ignoring={self.ignoring}"

    def do_execute(self, ctx: QueryContext) -> QueryResult:
        lres, rres = self.execute_children(ctx)
        llabels, lvals, lmeta = _flatten(lres.grids)
        rlabels, rvals, rmeta = _flatten(rres.grids)
        meta = lmeta or rmeta
        if meta is None:
            return QueryResult()
        keys: dict[tuple, int] = {}
        lk = [keys.setdefault(_match_key(l, self.on, self.ignoring), len(keys)) for l in llabels]
        rk = [keys.setdefault(_match_key(l, self.on, self.ignoring), len(keys)) for l in rlabels]
        dev = (lvals if lvals is not None else rvals).device
        J = (lvals if lvals is not None else rvals).shape[1]

        def presence(vals, kids):  # [K, J]: some row of the key has a value
            out = torch.zeros((len(keys), J), dtype=torch.float32, device=dev)
            if vals is not None and kids:
                out.index_add_(0, _rows(kids, dev), (~torch.isnan(vals.to(dev))).float())
            return out > 0

        if self.op in ("and", "unless"):
            if lvals is None:
                return QueryResult(grids=[Grid([], meta.start_ms, meta.step_ms, meta.num_steps,
                                               np.zeros((0, J), np.float32))])
            present = presence(rvals, rk)[_rows(lk, dev)]
            keep = present if self.op == "and" else ~present
            rows = torch.where(keep, lvals, float("nan"))
            live = (~torch.isnan(rows)).any(dim=1)
            idx = torch.nonzero(live).flatten()
            labels = [llabels[i] for i in idx.cpu().numpy()]
            return QueryResult(grids=[Grid(labels, meta.start_ms, meta.step_ms, meta.num_steps,
                                           rows[idx])])
        # or: every left row, then the right rows where no left row of their
        # key has a value
        parts, labels = [], []
        if lvals is not None:
            parts.append(lvals)
            labels.extend(llabels)
        if rvals is not None:
            lpresent = presence(lvals, lk)[_rows(rk, dev)]
            rows = torch.where(lpresent, float("nan"), rvals.to(dev))
            idx = torch.nonzero((~torch.isnan(rows)).any(dim=1)).flatten()
            parts.append(rows[idx])
            labels.extend(rlabels[i] for i in idx.cpu().numpy())
        return QueryResult(grids=[Grid(labels, meta.start_ms, meta.step_ms, meta.num_steps,
                                       torch.cat(parts))])


class ScalarPlanExec(ExecPlan):
    """A number, ``time()``, a time component or a scalar expression of
    them, per step."""

    def __init__(self, logical, start_ms: int, step_ms: int, num_steps: int):
        super().__init__()
        self.logical = logical
        self.start_ms = start_ms
        self.step_ms = step_ms
        self.num_steps = num_steps

    def do_execute(self, ctx: QueryContext) -> QueryResult:
        vals = eval_scalar(self.logical, self.start_ms, self.step_ms, self.num_steps)
        return QueryResult(scalar=ScalarResult(self.start_ms, self.step_ms, self.num_steps, vals),
                           result_type="scalar")


def eval_scalar(plan, start_ms: int, step_ms: int, num_steps: int) -> np.ndarray:
    """A scalar plan's [J] values on the host (f64; a binary operation of
    scalars f32, as the JAX package computes it)."""
    times_ms = start_ms + np.arange(num_steps, dtype=np.int64) * step_ms
    if isinstance(plan, (int, float)):
        return np.full(num_steps, float(plan))
    if isinstance(plan, L.ScalarFixedDoublePlan):
        return np.full(num_steps, plan.value)
    if isinstance(plan, L.ScalarTimeBasedPlan):
        if plan.function == "time":
            return (times_ms / 1e3).astype(np.float64)
        if plan.function not in _TIME_COMPONENT:
            raise QueryError(f"cannot evaluate scalar plan {plan}")
        return time_components(plan.function, times_ms)
    if isinstance(plan, L.ScalarBinaryOperation):
        a = eval_scalar(plan.lhs, start_ms, step_ms, num_steps)
        b = eval_scalar(plan.rhs, start_ms, step_ms, num_steps)
        out = apply_binop(plan.op, torch.as_tensor(a, dtype=torch.float32),
                          torch.as_tensor(b, dtype=torch.float32), False)
        return out.numpy()
    if isinstance(plan, L.ScalarVaryingDoublePlan):
        raise QueryError("scalar(vector) must be materialized via planner")
    raise QueryError(f"cannot evaluate scalar plan {plan}")


class ScalarVaryingExec(NonLeafExecPlan):
    """``scalar(v)`` (the one series' values, else NaN) and ``vector(s)``."""

    def __init__(self, child: ExecPlan, function: str):
        super().__init__([child])
        self.function = function

    def do_execute(self, ctx: QueryContext) -> QueryResult:
        (r,) = self.execute_children(ctx)
        if self.function == "scalar":
            labels, vals, meta = _flatten(r.grids)
            if meta is None:
                return QueryResult(result_type="scalar")
            if len(labels) == 1:
                out = vals[0].cpu().numpy().astype(np.float64)
            else:
                out = np.full(vals.shape[1] if vals.numel() else meta.num_steps, np.nan)
            return QueryResult(scalar=ScalarResult(meta.start_ms, meta.step_ms, meta.num_steps,
                                                   out), result_type="scalar")
        s = r.scalar
        if s is None:
            return QueryResult()
        vals = np.asarray(s.values, dtype=np.float32)[None, :]
        return QueryResult(grids=[Grid([{}], s.start_ms, s.step_ms, s.num_steps, vals)],
                           result_type="vector")


class ScalarVectorOpExec(NonLeafExecPlan):
    """vector op scalar, the scalar an exec of its own (a scalar plan or
    ``scalar(v)``)."""

    def __init__(self, vector: ExecPlan, scalar: ExecPlan, op: str,
                 scalar_is_lhs: bool, return_bool: bool = False):
        super().__init__([vector, scalar])
        self.op = op
        self.scalar_is_lhs = scalar_is_lhs
        self.return_bool = return_bool

    def args_str(self):
        return f"op={self.op} scalar_is_lhs={self.scalar_is_lhs}"

    def do_execute(self, ctx: QueryContext) -> QueryResult:
        vres, sres = self.execute_children(ctx)
        scalar = sres.scalar if sres.scalar is not None else ScalarResult(0, 1, 1,
                                                                          np.array([np.nan]))
        mapper = ScalarOperationMapper(self.op, scalar, self.scalar_is_lhs, self.return_bool)
        return QueryResult(grids=mapper.apply(vres.grids), stats=vres.stats)


# subquery range functions whose inner rows re-stage reset-corrected
_COUNTERISH = frozenset({"rate", "increase", "irate"})


class SubqueryWindowExec(NonLeafExecPlan):
    """``func(<expr>[window:step])`` (reference subquery materialization in
    DefaultPlanner): the range function over the inner expression's step
    grid, each inner grid's rows re-staged as series from
    ``start - window - offset`` and windowed at the outer steps. The host
    split of each grid (ms: fetch, re-stage, upload, launch) and the
    inner execution's go to ``ctx.obs["subquery"]``."""

    def __init__(self, child: ExecPlan, function: str, window_ms: int, sub_step_ms: int,
                 start_ms: int, end_ms: int, step_ms: int, offset_ms: int = 0, args=()):
        super().__init__([child])
        self.function = function
        self.window_ms = window_ms
        self.sub_step_ms = sub_step_ms
        self.start_ms = start_ms
        self.end_ms = end_ms
        self.step_ms = step_ms
        self.offset_ms = offset_ms
        self.args = args

    def args_str(self):
        return f"fn={self.function} window={self.window_ms} substep={self.sub_step_ms}"

    def do_execute(self, ctx: QueryContext) -> QueryResult:
        t0 = time.perf_counter()
        (r,) = self.execute_children(ctx)
        split = {"inner_ms": (time.perf_counter() - t0) * 1e3, "fetch_ms": 0.0,
                 "restage_ms": 0.0, "upload_ms": 0.0, "launch_ms": 0.0, "rows": 0}
        nsteps = int((self.end_ms - self.start_ms) // self.step_ms) + 1
        counterish = self.function in _COUNTERISH
        params = K.RangeParams(self.start_ms - self.offset_ms, self.step_ms, nsteps,
                               self.window_ms)
        base_ms = self.start_ms - self.window_ms - self.offset_ms
        out = []
        for g in r.grids:
            t1 = time.perf_counter()
            v = g.values_np()
            t2 = time.perf_counter()
            host = ST.stage_step_rows(v, g.step_times_ms(), base_ms, counter_corrected=counterish)
            t3 = time.perf_counter()
            block = ST.device_copy(host, ctx.device)
            t4 = time.perf_counter()
            vals = K.run_range_function(self.function, block, params, is_counter=counterish,
                                        args=self.args)
            t5 = time.perf_counter()
            for key, a, b in (("fetch_ms", t1, t2), ("restage_ms", t2, t3),
                              ("upload_ms", t3, t4), ("launch_ms", t4, t5)):
                split[key] += (b - a) * 1e3
            split["rows"] += v.shape[0]
            out.append(Grid(list(g.labels), self.start_ms, self.step_ms, nsteps, vals))
        ctx.obs.setdefault("subquery", []).append(split)
        return QueryResult(grids=out)
