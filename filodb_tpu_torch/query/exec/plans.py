"""ExecPlan tree (counterpart of ``filodb_tpu/query/exec/plans.py``;
reference query/exec/ExecPlan.scala).

The port runs one exec node: ``FusedAggregateExec``, the single-dispatch
cross-shard aggregate ``op by (...) (func(selector[w]))``. It stages every
matching series of its shards into one superblock on the device and runs
window stats -> finish -> segment aggregate; only the [G, J] group partials
come back. Shapes outside it raise ``NotImplementedError``: the reference
tree it would fall back to is not ported.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

from ...core.filters import ColumnFilter
from ...core.schemas import ColumnType
from ...ops import aggregations as AGG
from ...ops import staging as ST
from ...ops.kernels import RangeParams
from ..rangevector import Grid, QueryResult, QueryStats


class QueryError(ValueError):
    pass


@dataclass
class QueryContext:
    """Per-query execution context (reference QueryContext/QuerySession)."""

    memstore: Any  # TimeSeriesMemStore
    dataset: str
    device: Any  # torch device the superblock and kernels run on
    max_series: int = 1_000_000
    max_samples: int = 500_000_000
    deadline_s: float = 60.0
    stats: QueryStats = field(default_factory=QueryStats)
    # path annotations: which exec path and kernel variant served the query
    obs: dict = field(default_factory=dict)
    _start_time: float = field(default_factory=time.monotonic)

    def check_deadline(self) -> None:
        elapsed = time.monotonic() - self._start_time
        if elapsed > self.deadline_s:
            raise QueryError(f"query exceeded deadline: {elapsed:.1f}s > {self.deadline_s:.1f}s")


class ExecPlan:
    """Base: leaf plans implement do_execute."""

    def execute(self, ctx: QueryContext) -> QueryResult:
        ctx.check_deadline()
        res = self.do_execute(ctx)
        res.stats = ctx.stats
        return res

    def do_execute(self, ctx: QueryContext) -> QueryResult:
        raise NotImplementedError


# Counter staging is function-driven (the reference corrects counters only
# inside rate-family range functions, never on the read path):
#   corrected — reset-corrected minus baseline; only these functions read it
_CORRECTED_FNS = frozenset({"rate", "increase", "irate"})
#   shifted — raw minus per-series baseline (no correction): shift-invariant
#   functions get exact f32 math even on 1e15-magnitude counters
_SHIFTED_FNS = frozenset({
    "delta", "deriv",
    "stddev_over_time", "stdvar_over_time", "z_score",
    "median_absolute_deviation_over_time",
})
#   everything else (plain selector/last, min/max/sum/avg_over_time, the
#   value-independent count/present_over_time) stages raw values


def _stage_mode_for_function(func: str | None) -> str:
    """Staging mode for a counter column given the range function that will
    read it (default: raw selector read)."""
    if func in _CORRECTED_FNS:
        return "corrected"
    if func in _SHIFTED_FNS:
        return "shifted"
    return "raw"


_DROP_NAME_KEEP = {"last_over_time", "timestamp"}  # functions that keep _metric_

# aggregation ops the fused path computes as one segment reduce
FUSED_AGG_OPS = frozenset({"sum", "count", "avg", "min", "max"})


@dataclass
class SuperblockEntry:
    """A superblock on the device plus what serving it needs."""

    block: ST.StagedBlock
    labels: list
    is_counter: bool
    is_delta: bool


class FusedAggregateExec(ExecPlan):
    """``op by (...) (func(selector[w]))`` over local shards as ONE
    superblock and ONE window-stats launch; only [G, J] reaches the host."""

    def __init__(self, shard_nums, filters, raw_start_ms: int, raw_end_ms: int,
                 column, op: str, by, without, function,
                 start_ms: int, end_ms: int, step_ms: int, window_ms: int,
                 offset_ms: int = 0):
        self.shard_nums = list(shard_nums)
        self.filters: tuple[ColumnFilter, ...] = tuple(filters)
        self.raw_start_ms = raw_start_ms
        self.raw_end_ms = raw_end_ms
        self.column = column
        self.op = op
        self.by = by
        self.without = without
        self.function = function  # None = plain selector (lookback last)
        self.start_ms = start_ms
        self.end_ms = end_ms
        self.step_ms = step_ms
        self.window_ms = window_ms
        self.offset_ms = offset_ms

    def num_steps(self) -> int:
        return int((self.end_ms - self.start_ms) // self.step_ms) + 1

    def superblock(self, ctx: QueryContext) -> SuperblockEntry | None:
        """Stage the selection of every shard and concatenate it into one
        superblock on ``ctx.device`` (None for an empty selection)."""
        return self._build_superblock(ctx, _stage_mode_for_function(self.function))

    def _build_superblock(self, ctx: QueryContext, stage_mode: str) -> SuperblockEntry | None:
        if self.raw_end_ms - self.raw_start_ms > ST.MAX_STAGE_SPAN_MS:
            raise NotImplementedError(
                "selector span wider than int32 ms offsets: time slicing is not ported")
        blocks, labels = [], []
        schema_name = None
        is_counter = is_delta = False
        total = 0
        for s in self.shard_nums:
            ctx.check_deadline()
            shard = ctx.memstore.shard(ctx.dataset, s)
            pids = shard.lookup_partitions(self.filters, self.raw_start_ms, self.raw_end_ms)
            if not len(pids):
                continue
            if len(pids) > ctx.max_series:
                raise QueryError(f"query selects {len(pids)} series > limit {ctx.max_series}")
            total += len(pids)
            parts = [shard.partition(int(p)) for p in pids]
            names = {p.schema.name for p in parts}
            if len(names) > 1 or (schema_name is not None and names != {schema_name}):
                raise NotImplementedError("mixed schemas in one selection are not ported")
            schema_name = parts[0].schema.name
            schema = parts[0].schema
            col_name = self.column or schema.value_column
            try:
                col = schema.column(col_name)
            except KeyError:
                col_name = schema.value_column
                col = schema.column(col_name)
            if col.ctype == ColumnType.HISTOGRAM:
                raise NotImplementedError("histogram schemas are not ported")
            is_counter, is_delta = col.is_counter, col.is_delta
            mode = stage_mode if is_counter and not is_delta else "raw"
            blocks.append(ST.stage_from_shard(
                shard, pids, col_name, self.raw_start_ms, self.raw_end_ms, mode))
            labels.extend(dict(p.tags) for p in parts)
        if not blocks:
            return None
        samples = int(sum(int(b.lens.sum()) for b in blocks))
        ctx.stats.bump(series_scanned=total, samples_scanned=samples)
        if ctx.stats.samples_scanned > ctx.max_samples:
            raise QueryError(
                f"query would scan {ctx.stats.samples_scanned} samples > limit {ctx.max_samples}")
        block = ST.concat_blocks(blocks).to_device(ctx.device)
        ctx.stats.bump(bytes_staged=block.nbytes())
        return SuperblockEntry(block, labels, is_counter, is_delta)

    def do_execute(self, ctx: QueryContext) -> QueryResult:
        func = self.function or "last"
        got = self.superblock(ctx)
        if got is None:
            return QueryResult()
        ctx.obs["path"] = "fused"
        ctx.obs["variant"] = AGG.FUSED_VARIANT
        nsteps = self.num_steps()
        params = RangeParams(self.start_ms - self.offset_ms, self.step_ms, nsteps, self.window_ms)
        strip = self.function is not None and self.function not in _DROP_NAME_KEEP
        gids, G, group_labels = AGG.group_ids_memo(
            got.block, got.labels, self.by, self.without, strip_metric=strip)
        out = AGG.fused_range_aggregate(
            func, self.op, got.block, gids, G, params,
            is_counter=got.is_counter, is_delta=got.is_delta)
        return QueryResult(grids=[Grid(group_labels, self.start_ms, self.step_ms, nsteps, out)])
