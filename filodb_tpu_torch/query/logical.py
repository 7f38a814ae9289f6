"""LogicalPlan ADT (reference L4: query/LogicalPlan.scala — RawSeries:233,
PeriodicSeries:419, PeriodicSeriesWithWindowing:554, Aggregate:620,
BinaryJoin:652, ScalarVectorBinaryOperation:689, ApplyInstantFunction:714,
subqueries :476/:523, metadata plans :282-343, scalar plans :816-928).

All times are absolute epoch **milliseconds**; windows/offsets are ms spans.
Plans are immutable dataclasses; planners rewrite them structurally.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Sequence

from ..core.filters import ColumnFilter


@dataclass(frozen=True)
class LogicalPlan:
    pass


@dataclass(frozen=True)
class RawSeries(LogicalPlan):
    """Select raw chunks for matching series over [start-lookback, end]."""

    filters: tuple[ColumnFilter, ...]
    start_ms: int
    end_ms: int
    offset_ms: int = 0
    column: Optional[str] = None  # explicit column (::min downsample rewrites)


@dataclass(frozen=True)
class PeriodicSeries(LogicalPlan):
    """Instant-vector evaluation on a regular step grid: the value at each
    step is the series' latest sample within the staleness lookback."""

    raw: RawSeries
    start_ms: int
    end_ms: int
    step_ms: int
    lookback_ms: int = 300_000
    offset_ms: int = 0
    at_ms: Optional[int] = None


@dataclass(frozen=True)
class PeriodicSeriesWithWindowing(LogicalPlan):
    """Range-function evaluation: func over (t-window, t] per step."""

    raw: RawSeries
    function: str
    window_ms: int
    start_ms: int
    end_ms: int
    step_ms: int
    offset_ms: int = 0
    at_ms: Optional[int] = None
    function_args: tuple[float, ...] = ()


@dataclass(frozen=True)
class SubqueryWithWindowing(LogicalPlan):
    """func(<expr>[window:step]) — inner expr evaluated on the subquery step
    grid, then the range function applied over its results."""

    inner: LogicalPlan
    function: str
    window_ms: int
    sub_step_ms: int
    start_ms: int
    end_ms: int
    step_ms: int
    offset_ms: int = 0
    function_args: tuple[float, ...] = ()


@dataclass(frozen=True)
class TopLevelSubquery(LogicalPlan):
    inner: LogicalPlan
    start_ms: int
    end_ms: int
    step_ms: int
    offset_ms: int = 0


@dataclass(frozen=True)
class Aggregate(LogicalPlan):
    op: str  # sum|min|max|count|avg|stddev|stdvar|topk|bottomk|quantile|count_values|group
    inner: LogicalPlan
    params: tuple = ()  # k for topk, q for quantile, label for count_values
    by: Optional[tuple[str, ...]] = None
    without: Optional[tuple[str, ...]] = None


@dataclass(frozen=True)
class PartialAggregate(LogicalPlan):
    """Map phase of an aggregation WITHOUT the present phase: the executor
    returns per-group mergeable components (``__comp__``-labeled grids —
    (sum,count) for avg, (sum,sumsq,count) for stddev, sketch counts for
    quantile) instead of finished values. Federation ships this to peers so
    O(groups) components cross the wire, not O(series) raw rows, and the
    coordinator's reduce phase merges peer partials exactly like local
    shard partials (reference RowAggregator.scala:28,114 mergeable
    aggregate items, AggrOverRangeVectors.scala:224)."""

    op: str  # any op in exec.plans._PARTIAL_COMPONENTS, or "quantile"
    inner: LogicalPlan
    params: tuple = ()
    by: Optional[tuple[str, ...]] = None
    without: Optional[tuple[str, ...]] = None


@dataclass(frozen=True)
class BinaryJoin(LogicalPlan):
    lhs: LogicalPlan
    op: str
    rhs: LogicalPlan
    cardinality: str = "one-to-one"  # one-to-one|one-to-many|many-to-one|many-to-many
    on: Optional[tuple[str, ...]] = None
    ignoring: tuple[str, ...] = ()
    include: tuple[str, ...] = ()  # group_left/right extra labels
    return_bool: bool = False


@dataclass(frozen=True)
class ScalarVectorBinaryOperation(LogicalPlan):
    op: str
    scalar: "LogicalPlan"  # ScalarPlan subtree
    vector: LogicalPlan
    scalar_is_lhs: bool
    return_bool: bool = False


@dataclass(frozen=True)
class ApplyInstantFunction(LogicalPlan):
    inner: LogicalPlan
    function: str
    args: tuple = ()  # floats or scalar plans


@dataclass(frozen=True)
class ApplyMiscellaneousFunction(LogicalPlan):
    inner: LogicalPlan
    function: str  # label_replace|label_join|sort|sort_desc|...
    str_args: tuple[str, ...] = ()


@dataclass(frozen=True)
class ApplySortFunction(LogicalPlan):
    inner: LogicalPlan
    descending: bool = False


@dataclass(frozen=True)
class ApplyAbsentFunction(LogicalPlan):
    inner: LogicalPlan
    filters: tuple[ColumnFilter, ...]
    start_ms: int = 0
    end_ms: int = 0
    step_ms: int = 0


@dataclass(frozen=True)
class ApplyLimitFunction(LogicalPlan):
    inner: LogicalPlan
    limit: int


# -- scalar plans -----------------------------------------------------------


@dataclass(frozen=True)
class ScalarFixedDoublePlan(LogicalPlan):
    value: float
    start_ms: int = 0
    end_ms: int = 0
    step_ms: int = 0


@dataclass(frozen=True)
class ScalarTimeBasedPlan(LogicalPlan):
    function: str  # time|hour|minute|month|year|day_of_month|day_of_week|day_of_year|days_in_month
    start_ms: int = 0
    end_ms: int = 0
    step_ms: int = 0


@dataclass(frozen=True)
class ScalarVaryingDoublePlan(LogicalPlan):
    """scalar(vector) / vector(scalar) wrapper plans."""

    inner: LogicalPlan
    function: str  # scalar|vector


@dataclass(frozen=True)
class ScalarBinaryOperation(LogicalPlan):
    op: str
    lhs: "LogicalPlan | float"
    rhs: "LogicalPlan | float"
    start_ms: int = 0
    end_ms: int = 0
    step_ms: int = 0


# -- metadata plans ---------------------------------------------------------


@dataclass(frozen=True)
class LabelValues(LogicalPlan):
    label: str
    filters: tuple[ColumnFilter, ...]
    start_ms: int
    end_ms: int


@dataclass(frozen=True)
class LabelNames(LogicalPlan):
    filters: tuple[ColumnFilter, ...]
    start_ms: int
    end_ms: int


@dataclass(frozen=True)
class SeriesKeysByFilters(LogicalPlan):
    filters: tuple[ColumnFilter, ...]
    start_ms: int
    end_ms: int


@dataclass(frozen=True)
class TsCardinalities(LogicalPlan):
    shard_key_prefix: tuple[str, ...]
    num_groups: int = 2


# -- helpers ----------------------------------------------------------------


def leaf_raw_series(plan: LogicalPlan) -> list[RawSeries]:
    """All RawSeries leaves of a plan tree."""
    out: list[RawSeries] = []

    def walk(p):
        if isinstance(p, RawSeries):
            out.append(p)
            return
        for f in getattr(p, "__dataclass_fields__", {}):
            v = getattr(p, f)
            if isinstance(v, LogicalPlan):
                walk(v)
    walk(plan)
    return out


def shift_time(plan: LogicalPlan, delta_ms: int) -> LogicalPlan:
    """Shift every absolute time in the tree (used by HA/failover planners)."""
    if not isinstance(plan, LogicalPlan):
        return plan
    kw = {}
    for f in plan.__dataclass_fields__:
        v = getattr(plan, f)
        if f in ("start_ms", "end_ms") and isinstance(v, int):
            kw[f] = v + delta_ms
        elif isinstance(v, LogicalPlan):
            kw[f] = shift_time(v, delta_ms)
    return replace(plan, **kw) if kw else plan


def narrow_time(plan: LogicalPlan, delta_start_ms: int,
                delta_end_ms: int) -> LogicalPlan:
    """Trim the evaluation range: ``start_ms += delta_start_ms`` and
    ``end_ms += delta_end_ms`` at EVERY node. Derived ranges (raw
    selectors, subquery inners) are the top-level range plus fixed
    window/lookback/offset margins, so one uniform trim preserves every
    per-node relationship. ``at_ms`` pins stay absolute. Used by the
    planner's over-wide-range time slicing (staged ts offsets are int32
    ms — ops/staging.MAX_STAGE_SPAN_MS)."""
    if not isinstance(plan, LogicalPlan):
        return plan
    kw = {}
    for f in plan.__dataclass_fields__:
        v = getattr(plan, f)
        if f == "start_ms" and isinstance(v, int):
            kw[f] = v + delta_start_ms
        elif f == "end_ms" and isinstance(v, int):
            kw[f] = v + delta_end_ms
        elif isinstance(v, LogicalPlan):
            kw[f] = narrow_time(v, delta_start_ms, delta_end_ms)
    return replace(plan, **kw) if kw else plan
