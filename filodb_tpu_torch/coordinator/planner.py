"""Query planning and the engine facade (counterpart of
``filodb_tpu/coordinator/planner.py``; reference SingleClusterPlanner.scala).

The port plans one shape: ``op by (...) (func(selector[w] [offset d]))``
(or over a bare selector) with ``op`` in sum/count/avg/min/max and
``func`` in the JAX package's fused set ``FUSED_FUNCS``, which becomes a
``FusedAggregateExec``, and ``histogram_quantile(q, sum ... (...))`` of it,
whose interpolation fuses into the same node; and the fused epilogues
(``FUSED_EPI_OPS``): global ``topk``/``bottomk(k, ...)`` and ``quantile
[by (...)] (q, ...)``. As in the JAX package's fused planner, ``@``,
range-function arguments, grouped topk/bottomk and epilogue parameters
other than one number stay off it (the JAX package runs them on its
reference tree, ROADMAP A4). Every other plan raises
``NotImplementedError`` naming the missing piece.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Sequence

import torch

from ..core.schemas import DatasetOptions, METRIC_TAG, PROM_METRIC_TAG, shard_group, shardkey_hash
from ..memstore.index import _LITERAL_ALT
from ..query import logical as L
from ..query.exec.plans import (FUSED_AGG_OPS, FUSED_EPI_OPS, ExecPlan, FusedAggregateExec,
                                QueryContext)
from ..query.promql import query_range_to_logical_plan, query_to_logical_plan

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
    # single-dispatch cross-shard aggregates; the reference scatter tree the
    # JAX package runs with this off is not ported
    fused_aggregate: bool = True


class SingleClusterPlanner:
    """Plans against the shards of one memstore cluster."""

    _MAX_SHARDKEY_COMBOS = 64

    def __init__(self, memstore, dataset: str, shard_nums: Sequence[int] | None = None,
                 params: PlannerParams | None = None):
        self.memstore = memstore
        self.dataset = dataset
        self.params = params or PlannerParams()
        self._shards = shard_nums

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
        if isinstance(plan, L.Aggregate):
            return self._try_fused_aggregate(plan)
        if (isinstance(plan, L.ApplyInstantFunction) and plan.function == "histogram_quantile"
                and len(plan.args) == 1 and isinstance(plan.args[0], (int, float))
                and isinstance(plan.inner, L.Aggregate) and plan.inner.op == "sum"):
            # the canonical SRE chain histogram_quantile(q, sum by (le)
            # (rate(m_bucket[w]))): the interpolation fuses into the aggregate
            return self._try_fused_aggregate(plan.inner, hist_quantile=float(plan.args[0]))
        raise NotImplementedError(
            f"{type(plan).__name__} plans are not ported: the port runs "
            "aggregations over range functions or selectors only")

    def _try_fused_aggregate(self, p: L.Aggregate,
                             hist_quantile: float | None = None) -> FusedAggregateExec:
        """``op by (...) (range_fn(selector[w]))`` with every shard local
        becomes one FusedAggregateExec over one superblock; ``hist_quantile``
        fuses ``histogram_quantile(q, ...)`` on top (native histograms)."""
        if not self.params.fused_aggregate:
            raise NotImplementedError("the reference scatter tree (fused_aggregate=False) is not ported")
        tree = "the JAX package's reference tree (ROADMAP A4), which is not ported"
        if p.op in FUSED_AGG_OPS:
            if p.params:
                raise NotImplementedError(f"aggregation parameters {p.params!r} are not ported")
        elif p.op in FUSED_EPI_OPS:
            if len(p.params) != 1 or not isinstance(p.params[0], (int, float)):
                raise NotImplementedError(
                    f"{p.op} with parameters {p.params!r} runs on {tree}")
            if p.op in ("topk", "bottomk") and (p.by or p.without):
                raise NotImplementedError(f"grouped {p.op} runs on {tree}")
        else:
            raise NotImplementedError(f"aggregation {p.op!r} is not ported")
        inner = p.inner
        if isinstance(inner, L.PeriodicSeriesWithWindowing):
            if inner.function not in FUSED_FUNCS:
                raise NotImplementedError(f"range function {inner.function!r} is not ported")
            if inner.function_args:
                raise NotImplementedError(f"range-function arguments run on {tree}")
            func, window = inner.function, inner.window_ms
        elif isinstance(inner, L.PeriodicSeries):
            func, window = None, inner.lookback_ms
        else:
            raise NotImplementedError(f"aggregation over {type(inner).__name__} is not ported")
        if inner.at_ms is not None:
            raise NotImplementedError(f"the @ modifier runs on {tree}")
        return FusedAggregateExec(
            self.shards_for(inner.raw.filters), inner.raw.filters,
            inner.raw.start_ms, inner.raw.end_ms, inner.raw.column,
            p.op, p.by, p.without, func,
            inner.start_ms, inner.end_ms, inner.step_ms or 1, window,
            inner.offset_ms, hist_quantile=hist_quantile, params=tuple(p.params),
        )


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

    def query_range(self, promql: str, start_s: float, end_s: float, step_s: float):
        plan = query_range_to_logical_plan(
            promql, start_s, end_s, step_s, self.planner.params.lookback_ms)
        res = self.planner.materialize(plan).execute(self.context())
        res.result_type = "matrix"
        return res

    def query_instant(self, promql: str, time_s: float):
        plan = query_to_logical_plan(promql, time_s, self.planner.params.lookback_ms)
        res = self.planner.materialize(plan).execute(self.context())
        res.result_type = "vector"
        return res
