"""Query planning and the engine facade (counterpart of
``filodb_tpu/coordinator/planner.py``; reference SingleClusterPlanner.scala).

The port plans:

- the reference tree: an unaggregated range function
  ``func(selector[w] [offset d] [@ t])`` (every function of the JAX
  ladder, arguments included) or a bare selector becomes one
  ``SelectRawPartitionsExec`` per shard with a ``PeriodicSamplesMapper``
  under a ``DistConcatExec`` (``_fanout``); aggregates over any subtree
  (``_materialize_aggregate_tree``: the map phase pushed onto each shard,
  a ``ReduceAggregateExec`` or, for the non-mergeable ops, an
  ``AggregatePresentExec``), instant functions, binary operators (vector
  joins, set operators, scalar operands), sort, limit, absent, label
  functions and scalar plans;
- the fused aggregate: ``op by (...) (func(selector[w] [offset d]))`` (or
  over a bare selector) with ``op`` in sum/count/avg/min/max and ``func``
  in the JAX package's fused set ``FUSED_FUNCS`` becomes a
  ``FusedAggregateExec``; ``histogram_quantile(q, sum ... (...))`` of it
  folds the interpolation in (native histograms, or classic ``le`` series
  grouped by ``le``); and the fused epilogues (``FUSED_EPI_OPS``): global
  ``topk``/``bottomk(k, ...)`` and ``quantile [by (...)] (q, ...)``. Every
  other aggregate shape (``_try_fused_aggregate`` returns None where the
  JAX package's does) takes the tree; a fused exec falls back to it at run
  time for a selection of several schemas and for a histogram shape the
  fused kernels do not model (any op but ``sum``, a function outside the
  fused set, one shard's partitions on different bucket schemes).

A range whose selection spans more than the int32 ms offsets of a staged
block is cut into time slices planned one by one under a ``StitchRvsExec``
(``materialize``). Subqueries nest at any depth: ``func(<expr>[w:s])``
becomes a ``SubqueryWindowExec`` over the inner expression's plan, a
top-level ``<expr>[w:s]`` the inner plan itself. A top-level range
selector ``m[w]`` exports its raw samples (one ``RawChunkExportExec`` per
shard), and ``_filodb_chunkmeta_all`` its chunks (``ChunkMetaExec``). The
metadata plans (label values and names, series, cardinalities) run on the
local shards (``MetadataExec``, ``TsCardinalitiesExec``); the JAX
package's scatter to peer processes needs the server's transport
(ROADMAP A6), so a planner given peers raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from dataclasses import dataclass
from typing import Sequence

import torch

from ..core.schemas import DatasetOptions, METRIC_TAG, PROM_METRIC_TAG, shard_group, shardkey_hash
from ..memstore.index import _LITERAL_ALT
from ..ops import staging as ST
from ..query import logical as L
from ..query.exec.joins import (BinaryJoinExec, ScalarPlanExec, ScalarVaryingExec,
                                ScalarVectorOpExec, SetOperatorExec, SubqueryWindowExec)
from ..query.exec.plans import (_PARTIAL_COMPONENTS, FUSED_AGG_OPS, FUSED_EPI_OPS,
                                AggregateMapReduce, AggregatePresentExec, ChunkMetaExec,
                                CountValuesMergeExec, DistConcatExec, EmptyResultExec, ExecPlan,
                                FusedAggregateExec, QueryContext, RawChunkExportExec,
                                ReduceAggregateExec, SelectRawPartitionsExec, StitchRvsExec)
from ..query.exec.transformers import (AbsentFunctionMapper, CountValuesMapReduce,
                                       InstantVectorFunctionMapper, LimitFunctionMapper,
                                       MiscellaneousFunctionMapper, PeriodicSamplesMapper,
                                       QueryError, SortFunctionMapper, TopkCandidateFilter)
from ..query.promql import query_range_to_logical_plan, query_to_logical_plan
from ..query.rangevector import QueryResult

# the range functions of the fused path, the JAX package's set
# (filodb_tpu/query/exec/plans.py FUSED_FUNCS): every one runs on some rung
# of aggregations.grid_variant on every grid
FUSED_FUNCS = frozenset({
    "rate", "increase", "delta", "irate", "idelta",
    "sum_over_time", "avg_over_time", "count_over_time", "min_over_time",
    "max_over_time", "last", "last_over_time", "first_over_time",
    "present_over_time", "stddev_over_time", "stdvar_over_time", "z_score",
    "changes", "resets", "deriv",
})


@dataclass
class PlannerParams:
    """Per-planner config (reference PlannerParams / QueryConfig)."""

    spread: int = 3
    lookback_ms: int = 300_000
    max_series: int = 1_000_000
    deadline_s: float = 60.0
    # total shards in the cluster (the ingest-routing modulus); None = the
    # memstore owns the whole cluster
    num_shards: int | None = None
    # single-dispatch cross-shard aggregates; off, every aggregate takes the
    # reference tree
    fused_aggregate: bool = True
    # base URLs of peer processes owning the cluster's other shards: the
    # JAX package scatters to them; the port has no transport to do so
    # until its server lands (ROADMAP A6), so a planner given any raises
    peer_endpoints: tuple = ()
    # the default of the partial-results stance (a request's own choice
    # wins); every shard is local to the port, so no answer is partial
    allow_partial_results: bool = False
    # queries slower than this many seconds go to the slow-query log
    # (``metrics.SLOW_QUERY_LOG``); None disables
    slow_query_threshold_s: float | None = None


class TsCardinalitiesExec(ExecPlan):
    """Cardinality scan by shard-key prefix (reference TsCardExec): the
    records ``depth`` keys deep under ``prefix`` of every local shard's
    cardinality trie, merged by prefix, the largest first."""

    def __init__(self, prefix: Sequence[str], depth: int | None = None):
        super().__init__()
        self.prefix = tuple(prefix)
        self.depth = depth if depth is not None else len(self.prefix) + 1

    def args_str(self) -> str:
        return f"prefix={','.join(self.prefix)} depth={self.depth}"

    def do_execute(self, ctx: QueryContext) -> QueryResult:
        merged: dict[tuple, dict] = {}
        for sh in ctx.memstore.shards(ctx.dataset):
            for rec in sh.cardinality.scan(list(self.prefix), self.depth):
                slot = merged.setdefault(rec.prefix, {"prefix": list(rec.prefix), "ts_count": 0,
                                                      "active": 0, "children": 0})
                slot["ts_count"] += rec.ts_count
                slot["active"] += rec.active_ts_count
                slot["children"] = max(slot["children"], rec.children)
        return QueryResult(metadata=sorted(merged.values(), key=lambda r: -r["ts_count"]),
                           result_type="metadata")


class MetadataExec(ExecPlan):
    """Label values, label names and the label sets of the matching series
    over the local shards (reference MetadataExecPlan execs), at most
    ``limit`` of them where one is set."""

    def __init__(self, kind: str, filters, start_ms: int, end_ms: int,
                 label: str | None = None, limit=None):
        super().__init__()
        self.kind = kind
        self.filters = tuple(filters)
        self.start_ms = start_ms
        self.end_ms = end_ms
        self.label = label
        self.limit = limit

    def do_execute(self, ctx: QueryContext) -> QueryResult:
        ms, ds = ctx.memstore, ctx.dataset
        if self.kind == "label_values":
            meta = ms.label_values(ds, self.filters, self.label, self.start_ms, self.end_ms,
                                   self.limit)
        elif self.kind == "label_names":
            meta = ms.label_names(ds, self.filters, self.start_ms, self.end_ms)
        elif self.kind == "series":
            meta = [dict(t) for t in ms.series(ds, self.filters, self.start_ms, self.end_ms,
                                               self.limit)]
        else:
            raise QueryError(f"unknown metadata query {self.kind}")
        return QueryResult(metadata=meta, result_type="metadata")


_METADATA_KINDS = {L.LabelValues: "label_values", L.LabelNames: "label_names",
                   L.SeriesKeysByFilters: "series"}


class SingleClusterPlanner:
    """Plans against the shards of one memstore cluster."""

    _MAX_SHARDKEY_COMBOS = 64

    def __init__(self, memstore, dataset: str, shard_nums: Sequence[int] | None = None,
                 params: PlannerParams | None = None):
        self.memstore = memstore
        self.dataset = dataset
        self.params = params or PlannerParams()
        self._shards = shard_nums
        if self.params.peer_endpoints:
            raise NotImplementedError(
                "peer scatter (peer_endpoints) is not ported: it needs the server's transport, "
                "ROADMAP A6")

    def shards_for(self, filters) -> list[int]:
        """Shard fan-out for a selector (reference shardsFromFilters): when
        every shard-key column is pinned by equality filters, only the
        ``2^spread`` shards ingest can place those series on; else all owned
        shards."""
        owned = list(self._shards) if self._shards is not None else self.memstore.shard_nums(self.dataset)
        if not filters:
            return owned
        num_shards = self.params.num_shards or self.memstore.total_shards(self.dataset)
        if not num_shards:
            return owned
        cand = self._shards_from_filters(filters, num_shards)
        if cand is None:
            return owned
        owned_set = set(owned)
        return [s for s in cand if s in owned_set]

    def _shards_from_filters(self, filters, num_shards: int) -> list[int] | None:
        """Candidate shards from shard-key equality filters, or None when
        the filters don't pin every shard-key column (scan-all)."""
        options = self._options()
        skc = tuple(options.shard_key_columns)
        eq: dict[str, set[str]] = {}
        for f in filters:
            col = METRIC_TAG if f.column == PROM_METRIC_TAG else f.column
            if f.op == "=":
                eq.setdefault(col, set()).add(f.value)
            elif f.op == "in":
                eq.setdefault(col, set()).update(f.value)
            elif f.op == "=~" and isinstance(f.value, str) and _LITERAL_ALT.match(f.value):
                parts = f.value.split("|")
                if all(parts):
                    eq.setdefault(col, set()).update(parts)
        keysets = []
        for c in skc:
            vals = eq.get(c)
            if not vals:
                return None
            keysets.append(sorted(vals))
        n_combos = 1
        for ks in keysets:
            n_combos *= len(ks)
        if n_combos > self._MAX_SHARDKEY_COMBOS:
            return None
        shards: set[int] = set()
        for combo in itertools.product(*keysets):
            skh = shardkey_hash(dict(zip(skc, combo)), options)
            shards |= shard_group(skh, self.params.spread, num_shards)
        return sorted(shards)

    def _options(self):
        try:
            return self.memstore.dataset(self.dataset).options
        except KeyError:
            return DatasetOptions()

    def materialize(self, plan: L.LogicalPlan) -> ExecPlan:
        slices = self._wide_range_slices(plan)
        if slices is None:
            return self._materialize(plan)
        # an over-wide range: the raw selector span exceeds a staged block's
        # int32 ms offsets (staging.MAX_STAGE_SPAN_MS, ~24.8 days), so it is
        # cut into slices, each staged from its own base, and stitched
        return self._materialize_sliced(plan, slices)

    def _wide_range_slices(self, plan) -> list[tuple[int, int]] | None:
        """(delta_start_ms, delta_end_ms) trims cutting an over-wide range
        query into slices whose raw selector span each fits the staged
        int32 offsets, or None when the plan fits as it is (or has no range
        grid to slice along)."""
        raws = L.leaf_raw_series(plan)
        if not raws:
            return None
        raw_lo = min(r.start_ms for r in raws)
        raw_hi = max(r.end_ms for r in raws)
        span = raw_hi - raw_lo
        if span <= ST.MAX_STAGE_SPAN_MS:
            return None
        # the grid lives on the topmost periodic node (Aggregate and the
        # function wrappers carry no times themselves)
        node = plan
        while node is not None and not isinstance(getattr(node, "start_ms", None), int):
            node = getattr(node, "inner", None) or getattr(node, "vectors", None)
        start = getattr(node, "start_ms", None)
        end = getattr(node, "end_ms", None)
        step = getattr(node, "step_ms", None) or 0
        if not isinstance(start, int) or not isinstance(end, int) or step <= 0 or end <= start:
            return None
        # the window/lookback/offset margins around the grid ride along with
        # every slice
        margin = span - (end - start)
        per = ST.MAX_STAGE_SPAN_MS - margin
        if per < step:
            return None  # the window alone overflows: unsliceable
        k = int(per // step) + 1  # steps per slice: (k-1)*step <= per
        n = int((end - start) // step) + 1
        if k >= n:
            return None
        return [(a * step, (min(a + k, n) - 1 - (n - 1)) * step) for a in range(0, n, k)]

    def _materialize_sliced(self, plan, slices) -> ExecPlan:
        return StitchRvsExec([self._materialize(L.narrow_time(plan, ds, de))
                              for ds, de in slices])

    def _fanout(self, make_leaf, transformers, filters=None) -> ExecPlan:
        """One leaf per selected local shard, each with ``transformers``,
        under a ``DistConcatExec`` (one leaf alone; ``EmptyResultExec`` for
        none)."""
        leaves = []
        for s in self.shards_for(filters):
            leaf = make_leaf(s)
            leaf.transformers.extend(transformers)
            leaves.append(leaf)
        if not leaves:
            return EmptyResultExec()
        if len(leaves) == 1:
            return leaves[0]
        return DistConcatExec(leaves)

    def _materialize(self, p: L.LogicalPlan) -> ExecPlan:
        if isinstance(p, L.PeriodicSeries):
            mapper = PeriodicSamplesMapper(p.start_ms, p.end_ms, p.step_ms, None, None,
                                           p.lookback_ms, p.offset_ms, p.at_ms)
            return self._fanout(lambda s: SelectRawPartitionsExec(
                s, p.raw.filters, p.raw.start_ms, p.raw.end_ms, p.raw.column), [mapper],
                filters=p.raw.filters)
        if isinstance(p, L.PeriodicSeriesWithWindowing):
            mapper = PeriodicSamplesMapper(p.start_ms, p.end_ms, p.step_ms, p.function,
                                           p.window_ms, offset_ms=p.offset_ms, at_ms=p.at_ms,
                                           args=p.function_args)
            return self._fanout(lambda s: SelectRawPartitionsExec(
                s, p.raw.filters, p.raw.start_ms, p.raw.end_ms, p.raw.column), [mapper],
                filters=p.raw.filters)
        if isinstance(p, L.RawSeries):
            # a top-level m[w]: the raw samples, read on the host
            return self._fanout(lambda s: RawChunkExportExec(s, p.filters, p.start_ms, p.end_ms,
                                                             p.column), [], filters=p.filters)
        if isinstance(p, L.Aggregate):
            return self._materialize_aggregate(p)
        if isinstance(p, L.BinaryJoin):
            lhs, rhs = self._materialize(p.lhs), self._materialize(p.rhs)
            if p.op in ("and", "or", "unless"):
                return SetOperatorExec(lhs, rhs, p.op, p.on, p.ignoring)
            return BinaryJoinExec(lhs, rhs, p.op, p.cardinality, p.on, p.ignoring, p.include,
                                  p.return_bool)
        if isinstance(p, L.ScalarVectorBinaryOperation):
            vec = self._materialize(p.vector)
            sc = p.scalar
            if isinstance(sc, _SCALAR_PLANS):
                # evaluated at execution on the vector's own grid
                times = _plan_times(p.vector)
                if times is not None:
                    start, end, step = times
                    sexec = ScalarPlanExec(sc, start, step, int((end - start) // step) + 1)
                else:
                    sexec = ScalarPlanExec(sc, getattr(sc, "start_ms", 0),
                                           getattr(sc, "step_ms", 1) or 1, 1)
                return ScalarVectorOpExec(vec, sexec, p.op, p.scalar_is_lhs, p.return_bool)
            if isinstance(sc, L.ScalarVaryingDoublePlan):
                sexec = ScalarVaryingExec(self._materialize(sc.inner), sc.function)
                return ScalarVectorOpExec(vec, sexec, p.op, p.scalar_is_lhs, p.return_bool)
            raise QueryError(f"unsupported scalar operand {sc}")
        if isinstance(p, L.ApplyInstantFunction):
            if (p.function == "histogram_quantile" and len(p.args) == 1
                    and isinstance(p.args[0], (int, float))
                    and isinstance(p.inner, L.Aggregate) and p.inner.op == "sum"):
                # the canonical SRE chain histogram_quantile(q, sum by (le)
                # (rate(m_bucket[w]))): the interpolation fuses into the aggregate
                fused = self._try_fused_aggregate(p.inner, hist_quantile=float(p.args[0]))
                if fused is not None:
                    return fused
            return self._with(p.inner, InstantVectorFunctionMapper(p.function, p.args))
        if isinstance(p, L.ApplyMiscellaneousFunction):
            if p.function == "_filodb_chunkmeta_all":
                leaves = L.leaf_raw_series(p)
                if len(leaves) != 1:
                    raise QueryError("_filodb_chunkmeta_all needs exactly one selector, "
                                     f"got {len(leaves)}")
                raw = leaves[0]
                plans = [ChunkMetaExec(s, raw.filters, raw.start_ms, raw.end_ms)
                         for s in self.shards_for(raw.filters)]
                return plans[0] if len(plans) == 1 else DistConcatExec(plans)
            return self._with(p.inner, MiscellaneousFunctionMapper(p.function, p.str_args))
        if isinstance(p, L.ApplySortFunction):
            return self._with(p.inner, SortFunctionMapper(p.descending))
        if isinstance(p, L.ApplyAbsentFunction):
            nsteps = int((p.end_ms - p.start_ms) // p.step_ms) + 1 if p.step_ms else 1
            return self._with(p.inner, AbsentFunctionMapper(p.filters, p.start_ms,
                                                            p.step_ms or 1, nsteps))
        if isinstance(p, L.ApplyLimitFunction):
            return self._with(p.inner, LimitFunctionMapper(p.limit))
        if isinstance(p, _SCALAR_PLANS):
            nsteps = int((p.end_ms - p.start_ms) // p.step_ms) + 1 if p.step_ms else 1
            return ScalarPlanExec(p, p.start_ms, p.step_ms or 1, nsteps)
        if isinstance(p, L.ScalarVaryingDoublePlan):
            return ScalarVaryingExec(self._materialize(p.inner), p.function)
        if isinstance(p, L.SubqueryWithWindowing):
            return SubqueryWindowExec(self._materialize(p.inner), p.function, p.window_ms,
                                      p.sub_step_ms, p.start_ms, p.end_ms, p.step_ms,
                                      p.offset_ms, p.function_args)
        if isinstance(p, L.TopLevelSubquery):
            return self._materialize(p.inner)  # the inner grid at its own steps
        if isinstance(p, L.TsCardinalities):
            return TsCardinalitiesExec(p.shard_key_prefix, p.num_groups)
        if type(p) in _METADATA_KINDS:
            return MetadataExec(_METADATA_KINDS[type(p)], p.filters, p.start_ms, p.end_ms,
                                label=getattr(p, "label", None))
        raise NotImplementedError(f"{type(p).__name__} plans are not ported")

    def _with(self, inner: L.LogicalPlan, transformer) -> ExecPlan:
        """``inner``'s plan with ``transformer`` folded onto its result."""
        plan = self._materialize(inner)
        plan.transformers.append(transformer)
        return plan

    def _materialize_aggregate(self, p: L.Aggregate) -> ExecPlan:
        fused = self._try_fused_aggregate(p)
        return fused if fused is not None else self._materialize_aggregate_tree(p)

    def _try_fused_aggregate(self, p: L.Aggregate,
                             hist_quantile: float | None = None) -> FusedAggregateExec | None:
        """``op by (...) (range_fn(selector[w]))`` over the local shards as
        one FusedAggregateExec over one superblock (``hist_quantile`` fuses
        ``histogram_quantile(q, ...)`` on top); None for every shape the
        fused kernels do not model, which takes the tree. The tree of the
        same query is the exec's fallback, built at first use."""
        if not self.params.fused_aggregate:
            return None
        if p.op in FUSED_AGG_OPS:
            if p.params:
                return None
        elif p.op in FUSED_EPI_OPS:
            if len(p.params) != 1 or not isinstance(p.params[0], (int, float)):
                return None
            if p.op in ("topk", "bottomk") and (p.by or p.without):
                return None  # grouped: the tree's per-shard candidate filter
        else:
            return None
        inner = p.inner
        if isinstance(inner, L.PeriodicSeriesWithWindowing):
            if inner.function not in FUSED_FUNCS or inner.function_args:
                return None
            func, window = inner.function, inner.window_ms
        elif isinstance(inner, L.PeriodicSeries):
            func, window = None, inner.lookback_ms
        else:
            return None
        if inner.at_ms is not None:
            return None
        shards = self.shards_for(inner.raw.filters)
        if not shards:
            return None

        def fallback():
            tree = self._materialize_aggregate_tree(p)
            if hist_quantile is not None:
                tree.transformers.append(
                    InstantVectorFunctionMapper("histogram_quantile", (hist_quantile,)))
            return tree

        return FusedAggregateExec(
            shards, inner.raw.filters, inner.raw.start_ms, inner.raw.end_ms, inner.raw.column,
            p.op, p.by, p.without, func,
            inner.start_ms, inner.end_ms, inner.step_ms or 1, window,
            inner.offset_ms, hist_quantile=hist_quantile, params=tuple(p.params),
            fallback=fallback,
        )

    def _materialize_aggregate_tree(self, p: L.Aggregate) -> ExecPlan:
        """The reference tree of an aggregate: the mergeable ops' map phase
        pushed onto every shard subtree under a ``ReduceAggregateExec``;
        topk/bottomk's per-shard candidate filter and count_values'
        per-shard counts under their roots; the rest gathered by an
        ``AggregatePresentExec``."""
        inner = self._materialize(p.inner)
        shards = isinstance(inner, DistConcatExec) and not inner.transformers
        if p.op in _PARTIAL_COMPONENTS:
            children = inner.child_plans if shards else [inner]
            for child in children:
                child.transformers.append(AggregateMapReduce(p.op, p.by, p.without))
            return ReduceAggregateExec(children, p.op, p.by, p.without)
        if p.op in ("topk", "bottomk") and p.params and shards:
            k = max(int(p.params[0]), 1)
            for child in inner.child_plans:
                child.transformers.append(
                    TopkCandidateFilter(k, p.op == "bottomk", p.by, p.without))
        elif p.op == "count_values" and p.params and shards:
            for child in inner.child_plans:
                child.transformers.append(CountValuesMapReduce(str(p.params[0]), p.by,
                                                               p.without))
            return CountValuesMergeExec(inner.child_plans)
        return AggregatePresentExec([inner], p.op, p.params, p.by, p.without)


_SCALAR_PLANS = (L.ScalarFixedDoublePlan, L.ScalarTimeBasedPlan, L.ScalarBinaryOperation)


def _plan_times(p: L.LogicalPlan):
    """(start_ms, end_ms, step_ms) of the first node under ``p`` that has a
    step grid."""
    if hasattr(p, "start_ms") and hasattr(p, "step_ms") and hasattr(p, "end_ms"):
        return p.start_ms, p.end_ms, p.step_ms or 1
    for f in getattr(p, "__dataclass_fields__", {}):
        v = getattr(p, f)
        if isinstance(v, L.LogicalPlan):
            t = _plan_times(v)
            if t is not None:
                return t
    return None


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. A CUDA device with no card present raises:
    the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


class QueryEngine:
    """Top-level facade: PromQL string -> executed result on ``device``."""

    def __init__(self, memstore, dataset: str, params: PlannerParams | None = None,
                 shard_nums: Sequence[int] | None = None, device=None):
        self.memstore = memstore
        self.dataset = dataset
        self.device = resolve_device(device)
        self.planner = SingleClusterPlanner(memstore, dataset, shard_nums=shard_nums, params=params)

    def context(self) -> QueryContext:
        params = self.planner.params
        return QueryContext(self.memstore, self.dataset, self.device,
                            max_series=params.max_series, deadline_s=params.deadline_s)

    def query_range(self, promql: str, start_s: float, end_s: float, step_s: float,
                    allow_partial_results: bool | None = None, trace_id: str | None = None,
                    parent_span_id: str | None = None):
        """PromQL range query. ``allow_partial_results`` (None: the
        planner's default) is the request's partial-results stance; every
        shard is local, so the answer is never partial. ``trace_id`` and
        ``parent_span_id`` join the query's span tree (``res.trace``) to an
        upstream trace. ``res.phases`` holds the seconds of ``plan``
        (parse and materialize) and ``execute``."""

        def plan():
            return query_range_to_logical_plan(
                promql, start_s, end_s, step_s, self.planner.params.lookback_ms)

        res = self._run(promql, plan, allow_partial_results, trace_id, parent_span_id)
        if res.result_type == "matrix" or res.grids:
            res.result_type = "matrix"
        return res

    def _run(self, promql: str, plan, allow_partial_results, trace_id, parent_span_id):
        """Plan and execute one query under its root span; count it in
        ``filodb_queries_total`` and ``filodb_query_latency_seconds``, and
        in the slow-query log past the threshold."""
        from .. import metrics as M

        if allow_partial_results is not None and not isinstance(allow_partial_results, bool):
            raise TypeError("allow_partial_results must be a bool or None")
        t0 = time.perf_counter()
        with M.span("query", promql=promql) as root:
            if trace_id:
                root.trace_id = str(trace_id)
                root.parent_id = parent_span_id
            exec_plan = self.planner.materialize(plan())
            t1 = time.perf_counter()
            res = exec_plan.execute(self.context())
        t2 = time.perf_counter()
        res.trace = root
        res.phases = {"plan": t1 - t0, "execute": t2 - t1}
        M.REGISTRY.counter("filodb_queries", dataset=self.dataset).inc()
        M.REGISTRY.histogram("filodb_query_latency_seconds", dataset=self.dataset).observe(
            t2 - t0, exemplar={"trace_id": root.trace_id})
        thr = self.planner.params.slow_query_threshold_s
        if thr is not None and t2 - t0 >= thr:
            M.SLOW_QUERY_LOG.record(promql, t2 - t0, self.dataset, trace=root,
                                    stats=dataclasses.asdict(res.stats))
        return res

    def label_values(self, filters, label: str, start_ms: int, end_ms: int, limit=None):
        ep = self.planner.materialize(L.LabelValues(label, tuple(filters), start_ms, end_ms))
        if limit:
            ep.limit = int(limit)
        return ep.execute(self.context()).metadata

    def label_names(self, filters, start_ms: int, end_ms: int):
        ep = self.planner.materialize(L.LabelNames(tuple(filters), start_ms, end_ms))
        return ep.execute(self.context()).metadata

    def series(self, filters, start_ms: int, end_ms: int, limit=None):
        ep = self.planner.materialize(L.SeriesKeysByFilters(tuple(filters), start_ms, end_ms))
        if limit:
            ep.limit = int(limit)
        return ep.execute(self.context()).metadata

    def ts_cardinalities(self, prefix, depth: int | None = None):
        prefix = tuple(prefix)
        plan = L.TsCardinalities(prefix, depth if depth is not None else len(prefix) + 1)
        return self.planner.materialize(plan).execute(self.context()).metadata

    def query_instant(self, promql: str, time_s: float,
                      allow_partial_results: bool | None = None, trace_id: str | None = None,
                      parent_span_id: str | None = None):
        """PromQL instant query; the keywords as ``query_range`` takes them."""
        res = self._run(
            promql, lambda: query_to_logical_plan(promql, time_s,
                                                  self.planner.params.lookback_ms),
            allow_partial_results, trace_id, parent_span_id)
        if res.result_type == "matrix":
            res.result_type = "vector"
        return res
