"""ExecPlan tree (counterpart of ``filodb_tpu/query/exec/plans.py``;
reference query/exec/ExecPlan.scala).

The reference tree's first part: ``SelectRawPartitionsExec`` leaves (one
per shard; a shard's staged selection, on the query's device, through the
shard's staging cache) carrying a ``PeriodicSamplesMapper``
(``transformers``), under ``DistConcatExec`` (the shards' grids side by
side) and ``StitchRvsExec`` (time slices of a selection wider than the
int32 span, stitched by labels), with ``EmptyResultExec`` where no shard
is selected: unaggregated range functions and selectors.

The fused aggregate: ``FusedAggregateExec``, the single-dispatch
cross-shard aggregate ``op by (...) (func(selector[w]))``. It stages every
matching series of its shards into one superblock on the device and runs
the rung its grid class and function pick (``aggregations.grid_variant``):
the regular kernel for a shared regular grid, else window stats -> finish
-> segment aggregate, or the general range kernel for what window stats
cannot express; only the [G, J] group partials come back. A native-histogram
selection stages a ``[ΣS, T, B]`` superblock (per-shard bucket schemes
unified first) and runs the histogram rung: per-bucket sums [G, J, B], or
with ``histogram_quantile(q, sum ...)`` fused on top, the [G, J]
quantiles. Classic-histogram suffixes (``m_bucket``, ``m_sum``,
``m_count``, ``le=`` selections) resolve onto the native histogram. The
fused epilogues (``FUSED_EPI_OPS``: global topk/bottomk, quantile by
(...)) run the rung in its store mode to the per-series ``[J, S]`` grid
and one order-statistics launch; only ``[k, J]`` (rebuilt into the
winners' rows by ``_present_topk``) or ``[G, J]`` comes back.
``histogram_quantile(q, sum by (le, ...) (...))`` over classic ``le``
series folds the by-(le, ...) partials with one standalone-quantile launch
per bucket scheme. A selection of several schemas, and a shape the fused
kernels do not model (``_unsupported_shape``: a histogram op other than
``sum``, a function outside ``FUSED_HIST_FUNCS``, partitions of one shard
on different bucket schemes), falls back to the aggregate tree
(``fallback``, built lazily by the planner), decided before any scan
stats or staging, on a build and on a cache hit.

The reference tree's aggregate part: ``AggregateMapReduce`` on each shard
leaf reduces its grid on the device into the mergeable ``[G, J]``
components of ``_PARTIAL_COMPONENTS`` (one launch of the segment
aggregate, ``ops.segment_agg``); only those reach the host, where
``ReduceAggregateExec`` merges them by group labels and presents the op in
f32 numpy, as in the JAX package. ``AggregatePresentExec`` answers the
non-mergeable ops over any subtree on the device: topk/bottomk by (...)
through one ``order_stats.segment_topk`` launch (after each shard's
``TopkCandidateFilter``), quantile through ``order_stats.segment_quantile``,
limitk, and the mergeable ops over a join; count_values counts on the host
(``CountValuesMapReduce`` per shard, ``CountValuesMergeExec``). Over
native histograms the map phase is ``sum`` only (``_partial_hist``: one
segment-aggregate launch over a leaf's ``[n, J, B]`` grid seen as J * B
steps), the ``hist`` component merged and presented on the host in f32
with bucket schemes unified there, as in the JAX package.

Superblocks are cached on the memstore (``staging.SuperblockCache``) keyed
by their member shards' version vector, and per-shard blocks flow through
each shard's staging cache (``staged_block_for``). A warm query is served
from the cache with no staging; ingest disjoint from the staged range
re-stamps the entry; a uniform live-edge append extends it; anything else
restages. A tree leaf's block is the device copy its shard's staging-cache
entry keeps beside the host block (made once at stage time, counted in the
entry's bytes, dropped with the entry or its repair), so a warm leaf
uploads nothing.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field, replace
from typing import Any

import numpy as np
import torch

from ...core.filters import ColumnFilter
from ...core.histograms import _LE_TOL, remap_buckets, same_scheme, unify_schemes
from ...core.schemas import METRIC_TAG, ColumnType
from ...memstore.memstore import member_locks
from ...memstore.shard import StageEntry
from ...metrics import record_superblock_event
from ...ops import aggregations as AGG
from ...ops import staging as ST
from ...ops.hist_kernels import FUSED_HIST_FUNCS
from ...ops.kernels import RangeParams, pad_steps
from ...singleflight import memo_on
from ..rangevector import Grid, QueryResult, QueryStats, RawGrid
from ...ops import order_stats as OS
from ...ops import segment_agg as SA
from . import transformers as TR
from .transformers import (  # noqa: F401 (QueryError and _DROP_NAME_KEEP are re-exported)
    _DROP_NAME_KEEP,
    PeriodicSamplesMapper,
    QueryError,
    _strip_metric,
    classic_histogram_quantile,
    classic_pivot,
    grid_grouping,
    grid_hist,
    grid_members,
    grid_values,
)


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
    # the cross-query batcher the fused dispatches go through (None, or one
    # whose window is 0: every launch runs solo) and the cost model's
    # prediction of this query, which feeds its adaptive window
    dispatch_scheduler: Any = None
    predicted_cost_s: float = 0.0
    # the query's root span (``metrics.span``; its ``promql`` tag keys the
    # scheduler's recurrence ring), set by ``QueryEngine``
    trace_root: Any = None
    # a standing refresh or a pre-warm: its fused dispatches stay out of
    # the recurrence ring
    standing_refresh: bool = False
    # ``pin(cache, key)``: a standing refresh pins the superblock cache key
    # its fused exec resolves to against eviction
    superblock_pin_sink: Any = None
    _start_time: float = field(default_factory=time.monotonic)

    def check_deadline(self) -> None:
        elapsed = time.monotonic() - self._start_time
        if elapsed > self.deadline_s:
            raise QueryError(f"query exceeded deadline: {elapsed:.1f}s > {self.deadline_s:.1f}s")

    def remaining_deadline_s(self) -> float:
        """Seconds left before the query's deadline (at least 1 ms)."""
        return max(self.deadline_s - (time.monotonic() - self._start_time), 0.001)


class ExecPlan:
    """Base: leaf plans implement do_execute; transformers fold after it."""

    def __init__(self):
        self.transformers: list = []

    def execute(self, ctx: QueryContext) -> QueryResult:
        ctx.check_deadline()
        res = self.do_execute(ctx)
        for tr in self.transformers:
            res = apply_transformer(tr, res, ctx)
        res.stats = ctx.stats
        return res

    def do_execute(self, ctx: QueryContext) -> QueryResult:
        raise NotImplementedError

    def children(self) -> list:
        return []

    def args_str(self) -> str:
        return ""


def apply_transformer(tr, res: QueryResult, ctx: QueryContext) -> QueryResult:
    if isinstance(tr, PeriodicSamplesMapper):
        return QueryResult(grids=tr.apply_raw(res.raw_grids, stats=ctx.stats), stats=res.stats)
    if isinstance(tr, TR.InstantVectorFunctionMapper):
        # a host histogram grid feeds the instant kernel on the query's device
        return QueryResult(grids=tr.apply(res.grids, ctx.device), stats=res.stats,
                           result_type=res.result_type)
    if isinstance(tr, GRID_TRANSFORMERS):
        return QueryResult(grids=tr.apply(res.grids), stats=res.stats,
                           result_type=res.result_type)
    raise NotImplementedError(f"transformer {type(tr).__name__} is not ported")


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
#   diff — f64-exact adjacent differences: functions of the difference
#   sequence, where no f32 shift of the values keeps both tiny adjacent
#   changes and a 1e9-magnitude reset cliff
_DIFF_FNS = frozenset({"changes", "resets", "idelta"})
#   everything else (plain selector/last, min/max/sum/avg_over_time, the
#   value-independent count/present_over_time) stages raw values


def _stage_mode_for_function(func: str | None) -> str:
    """Staging mode for a counter column given the range function that will
    read it (default: raw selector read)."""
    if func in _CORRECTED_FNS:
        return "corrected"
    if func in _SHIFTED_FNS:
        return "shifted"
    if func in _DIFF_FNS:
        return "diff"
    return "raw"


def _counter_stage_mode(transformers) -> str:
    """The staging mode of a counter column from the range function the
    leaf's PeriodicSamplesMapper applies (default: raw selector read)."""
    for tr in transformers:
        if isinstance(tr, PeriodicSamplesMapper):
            return _stage_mode_for_function(tr.function)
    return "raw"

# aggregation ops the fused path computes as one segment reduce
FUSED_AGG_OPS = frozenset({"sum", "count", "avg", "min", "max"})

# aggregation ops the fused path computes as an epilogue over the rung's
# per-series grid (aggregations.fused_topk / fused_quantile): only [k, J]
# or [G, J] reaches the host
FUSED_EPI_OPS = frozenset({"topk", "bottomk", "quantile"})


def staged_block_for(ctx: QueryContext, shard, ids, cache_key, col_name: str,
                     start_ms: int, end_ms: int, stage_mode: str,
                     device=None) -> ST.StagedBlock:
    """A shard's host-staged block of a selection, through the shard's
    staging cache: serve a clean hit, repair a dirty one by appending
    (``staging.append_to_block``: live-edge panels pay only the tail), else
    stage afresh and insert under the effect-log check. With ``device``
    (a tree leaf) it returns the block's device copy instead, which the
    entry keeps (``device_copy_for``).

    The key's layout ``(filters, start_ms, end_ms, ...)`` is load-bearing:
    the shard's ``_invalidate_stage_range`` reads k[1]/k[2] as the staged
    range."""
    with shard._lock:
        hit = shard.stage_cache.get(cache_key)
        version_at_stage = shard.version
        claimed = False
        if hit is not None and hit.repairing:
            # another thread is mid-repair: its pre-repair block would miss
            # acknowledged samples, so restage
            hit = None
        elif hit is not None and hit.dirty:
            dirty_lo = hit.dirty_lo
            hit.dirty = False
            hit.dirty_lo = hit.dirty_hi = None  # the repair consumes the dirt
            hit.repairing = True
            claimed = True
    if hit is not None and claimed:
        repaired = None
        try:
            repaired = ST.append_to_block(shard, hit.block, ids, col_name, end_ms, stage_mode,
                                          dirty_lo=dirty_lo)
        finally:
            with shard._lock:
                hit.repairing = False
                if repaired is not None:
                    hit.block = repaired  # its device copy, if any, went stale
                    hit.dev_block = None
                    hit.nbytes = ST.staged_nbytes(repaired)
                elif shard.stage_cache.get(cache_key) is hit:
                    del shard.stage_cache[cache_key]  # never leave a stale entry
        if repaired is None:
            hit = None
        else:
            ctx.stats.bump(cache_extends=1)
    if hit is not None:
        if not claimed:
            ctx.stats.bump(cache_hits=1)
        block = hit.block
        return block if device is None else device_copy_for(shard, cache_key, block, device)
    block = ST.stage_from_shard(shard, ids, col_name, start_ms, end_ms, stage_mode)
    nbytes = ST.staged_nbytes(block)
    ctx.stats.bump(bytes_staged=nbytes, cache_misses=1)
    block.keep_mirrors()  # the append repair writes the mirrors
    dev = ST.device_copy(block, device) if device is not None else None
    if dev is not None:
        nbytes += ST.staged_nbytes(dev)
    # an ingest that landed mid-stage ran its invalidation before this entry
    # existed: cache it only when the effect log proves every bump since
    # version_at_stage disjoint from the staged range
    with shard._lock:
        drop_reason = None
        if shard.version != version_at_stage:
            drop_reason = shard._ingest_effects_since_locked(version_at_stage, start_ms, end_ms)
        if drop_reason is None:
            shard.stage_cache.pop(cache_key, None)  # a racing same-key stage
            used = sum(e.nbytes for e in shard.stage_cache.values())
            while shard.stage_cache and used + nbytes > shard.config.stage_cache_bytes:
                used -= shard.stage_cache.pop(next(iter(shard.stage_cache))).nbytes
            shard.stage_cache[cache_key] = StageEntry(block, nbytes, dev_block=dev)
    _count_sidecar(shard, cache_key, dev)
    return block if dev is None else dev


_MEMSTORE_ATTR_LOCK = threading.Lock()


def _memstore_attr(memstore, name: str, make):
    """The memstore's ``name`` attribute, made by ``make()`` on first use
    under a lock: concurrent first queries share one superblock cache."""
    value = getattr(memstore, name, None)
    if value is None:
        with _MEMSTORE_ATTR_LOCK:
            value = getattr(memstore, name, None)
            if value is None:
                value = make()
                setattr(memstore, name, value)
    return value


def device_copy_for(shard, cache_key, block: ST.StagedBlock, device) -> ST.StagedBlock:
    """The device copy of a shard's cached host block: the one its entry
    keeps when it was made from this very block on this device, else a new
    copy (``staging.device_copy``), kept on the entry and counted in its
    bytes while the entry still holds ``block``."""
    device = torch.device(device)
    with shard._lock:
        entry = shard.stage_cache.get(cache_key)
        dev = entry.dev_block if entry is not None and entry.block is block else None
    # "cuda" names the current card, whose tensors say "cuda:0"
    if dev is not None and dev.ts.device.type == device.type and device.index in (
            None, dev.ts.device.index):
        return dev
    dev = ST.device_copy(block, device)
    with shard._lock:
        entry = shard.stage_cache.get(cache_key)
        if entry is not None and entry.block is block:
            if entry.dev_block is not None:
                entry.nbytes -= ST.staged_nbytes(entry.dev_block)
            entry.dev_block = dev
            entry.nbytes += ST.staged_nbytes(dev)
    _count_sidecar(shard, cache_key, dev)
    return dev


def _count_sidecar(shard, cache_key, dev: ST.StagedBlock | None) -> None:
    """Count a device copy's deferred sidecar in its entry's bytes once
    ``staging.sidecar`` builds it (the masked rung's first read)."""
    if dev is None or not dev.mgrid_deferred:
        return

    def grown(b, nbytes):
        with shard._lock:
            entry = shard.stage_cache.get(cache_key)
            if entry is not None and entry.dev_block is b:
                entry.nbytes += nbytes

    dev.grow_hooks.append(grown)


def _histogram_suffix_rewrite(filters):
    """``m_sum`` / ``m_count`` / ``m_bucket`` -> the base histogram metric
    and the column or bucket they select. Returns (rewritten filters or
    None, column or None, le or None)."""
    metric = None
    for f in filters:
        if f.column == METRIC_TAG and f.op == "=":
            metric = f.value
    if metric is None:
        return None, None, None
    for suffix, col in (("_sum", "sum"), ("_count", "count"), ("_bucket", None)):
        if metric.endswith(suffix):
            base = metric[: -len(suffix)]
            le = None
            out = []
            for f in filters:
                if f.column == METRIC_TAG and f.op == "=":
                    out.append(ColumnFilter(METRIC_TAG, "=", base))
                elif suffix == "_bucket" and f.column == "le" and f.op == "=":
                    le = float("inf") if f.value in ("+Inf", "Inf") else float(f.value)
                else:
                    out.append(f)
            return tuple(out), col, le
    return None, None, None


def _unify_hist_blocks(blocks, block_les):
    """Put per-shard histogram blocks on one bucket scheme: the union of the
    shards' ``le`` bounds, a missing bound taking the nearest lower bound's
    count (``core.histograms.remap_buckets``). Returns (blocks, union les);
    a block already on the union scheme passes through untouched."""
    vals_in = [b.vals for b in blocks]
    vals_out, union, changed = unify_schemes(vals_in, block_les)
    if not changed:
        return blocks, union
    out = []
    for b, v_in, v_out, les in zip(blocks, vals_in, vals_out, block_les):
        if v_out is v_in:  # already on the union scheme
            out.append(b)
            continue
        # remapping touches only the bucket axis: the time grid survives
        out.append(ST.StagedBlock(
            b.ts, v_out, b.lens, b.base_ms, remap_buckets(b.baseline, les, union),
            b.n_series, list(b.part_refs), regular_ts=b.regular_ts,
        ))
    return out, union


def _uniform_scheme(parts, les) -> bool:
    """True when every partition of a shard carries the same bucket scheme
    (``same_scheme``): one [S, T, B] block has one ``le`` vector."""
    if les is None:
        return False
    return all(p.bucket_les is not None and (p.bucket_les is les or same_scheme(p.bucket_les, les))
               for p in parts[1:])


def _slice_bucket(block, les, bucket_le: float):
    """``m_bucket{le=...}``: one bucket of a staged [S, T, B] block (on the
    host or the device) as a scalar counter block. Returns (block, le
    label), or None when the scheme has no such bound (within
    ``_LE_TOL``)."""
    if les is None:
        return None
    les64 = np.asarray(les, dtype=np.float64)
    if np.isinf(bucket_le):
        b_idx = len(les64) - 1
    else:
        hits = np.nonzero(np.abs(les64 - bucket_le) < _LE_TOL)[0]
        b_idx = int(hits[0]) if len(hits) else -1
    if b_idx < 0:
        return None
    vals = block.vals[..., b_idx]
    vals = vals.contiguous() if isinstance(vals, torch.Tensor) else np.ascontiguousarray(vals)
    sliced = ST.StagedBlock(
        block.ts, vals, block.lens, block.base_ms, block.baseline[..., b_idx],
        block.n_series, block.part_refs, raw=vals, regular_ts=block.regular_ts,
        nominal_ts=block.nominal_ts, ts_dev=block.ts_dev, maxdev_ms=block.maxdev_ms,
    )
    le_str = "+Inf" if np.isinf(les64[b_idx]) else f"{les64[b_idx]:g}"
    return sliced, le_str


class SelectRawPartitionsExec(ExecPlan):
    """reference MultiSchemaPartitionsExec:26 + SelectRawPartitionsExec:161:
    partition lookup in one shard, grouping by schema, then each schema's
    selection staged through the shard's staging cache as a block on the
    query's device. Produces one ``RawGrid`` per schema found."""

    def __init__(self, shard_num: int, filters, start_ms: int, end_ms: int, column=None):
        super().__init__()
        self.shard_num = shard_num
        self.filters = tuple(filters)
        self.start_ms = start_ms
        self.end_ms = end_ms
        self.column = column

    def args_str(self) -> str:
        fs = ",".join(f"{f.column}{f.op}{f.value}" for f in self.filters)
        return f"shard={self.shard_num} filters=[{fs}] range=[{self.start_ms},{self.end_ms}]"

    def do_execute(self, ctx: QueryContext) -> QueryResult:
        shard = ctx.memstore.shard(ctx.dataset, self.shard_num)
        pids = shard.lookup_partitions(self.filters, self.start_ms, self.end_ms)
        column_override = hist_bucket_le = None
        if not len(pids):
            # classic-histogram suffix rewrite (reference MultiSchemaPartitionsExec
            # :49-80): m_sum / m_count select the histogram schema's sum/count
            # columns; m_bucket{le=...} one bucket of the native histogram
            rewritten, column_override, hist_bucket_le = _histogram_suffix_rewrite(self.filters)
            if rewritten is not None:
                pids = shard.lookup_partitions(rewritten, self.start_ms, self.end_ms)
        if len(pids) > ctx.max_series:
            raise QueryError(f"query selects {len(pids)} series > limit {ctx.max_series}")
        if shard.odp_store is not None and len(pids):
            # evicted chunks come back from the column store before staging
            shard.odp_page_in(pids, self.start_ms, self.end_ms)
        by_schema: dict[str, list] = {}
        for pid in pids:
            part = shard.partition(int(pid))
            by_schema.setdefault(part.schema.name, []).append((int(pid), part))
        res = QueryResult()
        for schema_name, members in by_schema.items():
            ctx.check_deadline()
            ids = [pid for pid, _ in members]
            parts = [part for _, part in members]
            schema = parts[0].schema
            col_name = self.column or column_override or schema.value_column
            try:
                col = schema.column(col_name)
            except KeyError:
                col_name = schema.value_column
                col = schema.column(col_name)
            is_hist = col.ctype == ColumnType.HISTOGRAM
            is_counter, is_delta = col.is_counter, col.is_delta
            stage_mode = (_counter_stage_mode(self.transformers)
                          if is_counter and not is_delta and not is_hist else "raw")
            cache_key = (self.filters, self.start_ms, self.end_ms, col_name, schema_name,
                         stage_mode)
            block = staged_block_for(ctx, shard, ids, cache_key, col_name, self.start_ms,
                                     self.end_ms, stage_mode, device=ctx.device)
            ctx.stats.bump(series_scanned=len(ids),
                           samples_scanned=int(np.asarray(block.host_block.lens).sum()))
            if ctx.stats.samples_scanned > ctx.max_samples:
                raise QueryError(f"query would scan {ctx.stats.samples_scanned} samples > "
                                 f"limit {ctx.max_samples}")
            les = parts[0].bucket_les if is_hist else None
            # a cached block holds the same partitions, whose tags never change
            labels = memo_on(block, "labels_memo", None, lambda: [dict(p.tags) for p in parts])
            if is_hist and hist_bucket_le is not None and les is not None:
                sliced = _slice_bucket(block, les, hist_bucket_le)  # m_bucket{le=...}
                if sliced is None:
                    continue  # no such bucket
                block, le_str = sliced
                labels = [dict(l, le=le_str) for l in labels]
                is_hist, is_counter = False, True
            res.raw_grids.append(RawGrid(block, labels, schema_name, col_name, is_counter,
                                         is_delta, is_hist, les if is_hist else None))
        return res


class EmptyResultExec(ExecPlan):
    def do_execute(self, ctx: QueryContext) -> QueryResult:
        return QueryResult()


class ChunkMetaExec(ExecPlan):
    """``_filodb_chunkmeta_all`` (reference SelectChunkInfosExec): one shard's
    matching series with their sealed chunks in the range; ``encodedBytes``
    is a chunk's encoded size, 0 until it is encoded (at seal with
    ``encode_on_seal``, else at flush), as in the JAX package."""

    def __init__(self, shard_num: int, filters, start_ms: int, end_ms: int):
        super().__init__()
        self.shard_num = shard_num
        self.filters = tuple(filters)
        self.start_ms = start_ms
        self.end_ms = end_ms

    def do_execute(self, ctx: QueryContext) -> QueryResult:
        shard = ctx.memstore.shard(ctx.dataset, self.shard_num)
        out = []
        for pid in shard.lookup_partitions(self.filters, self.start_ms, self.end_ms):
            part = shard.partition(int(pid))
            out.append({
                "labels": dict(part.tags),
                "schema": part.schema.name,
                "numChunks": len(part.chunks),
                "bufferedSamples": part.num_samples() - sum(c.n for c in part.chunks),
                "chunks": [{"startTime": c.start_ts, "endTime": c.end_ts, "numRows": c.n,
                            "encodedBytes": c.nbytes_encoded}
                           for c in part.chunks_in_range(self.start_ms, self.end_ms)],
            })
        return QueryResult(metadata=out, result_type="metadata")


class RawChunkExportExec(ExecPlan):
    """A top-level range selector ``m[w]`` (reference SelectRawPartitionsExec
    without periodic mapping): one shard's matching series with their
    samples in the range, on the host."""

    def __init__(self, shard_num: int, filters, start_ms: int, end_ms: int, column=None):
        super().__init__()
        self.shard_num = shard_num
        self.filters = tuple(filters)
        self.start_ms = start_ms
        self.end_ms = end_ms
        self.column = column

    def args_str(self) -> str:
        return f"shard={self.shard_num} range=[{self.start_ms},{self.end_ms}]"

    def do_execute(self, ctx: QueryContext) -> QueryResult:
        shard = ctx.memstore.shard(ctx.dataset, self.shard_num)
        raw = []
        for pid in shard.lookup_partitions(self.filters, self.start_ms, self.end_ms):
            part = shard.partition(int(pid))
            ts, vals = part.samples_in_range(self.start_ms, self.end_ms,
                                             self.column or part.schema.value_column)
            if len(ts):
                raw.append((dict(part.tags), ts, vals))
        return QueryResult(raw=raw)


class NonLeafExecPlan(ExecPlan):
    """A node over child plans, which run in order, one after the other
    (the JAX package's remote children and partial results are not
    ported)."""

    def __init__(self, child_plans):
        super().__init__()
        self.child_plans = list(child_plans)

    def children(self) -> list:
        return self.child_plans

    @staticmethod
    def _annotate_child_error(child: ExecPlan, e: Exception) -> Exception:
        """The child's identity appended to its error's message, the type kept."""
        note = f"{type(child).__name__}({child.args_str()})"
        msg = str(e.args[0]) if e.args else str(e)
        if note not in msg:
            e.args = (f"{msg} [child {note}]",) + tuple(e.args[1:])
        return e

    def execute_children(self, ctx: QueryContext) -> list[QueryResult]:
        results = []
        for c in self.child_plans:
            try:
                results.append(c.execute(ctx))
            except QueryError as e:
                raise self._annotate_child_error(c, e)
        return results


class DistConcatExec(NonLeafExecPlan):
    """Concatenate child results (reference DistConcatExec): grids, staged
    selections, raw exports and metadata records side by side."""

    def do_execute(self, ctx: QueryContext) -> QueryResult:
        out = QueryResult()
        for r in self.execute_children(ctx):
            out.grids.extend(r.grids)
            out.raw_grids.extend(r.raw_grids)
            if r.raw:
                out.raw = (out.raw or []) + r.raw
            if r.metadata is not None:
                out.metadata = (out.metadata or []) + r.metadata
                out.result_type = r.result_type
        return out


class StitchRvsExec(NonLeafExecPlan):
    """Merge results of time-split children: the same series over disjoint
    step ranges, matched by labels (reference StitchRvsExec:177)."""

    def do_execute(self, ctx: QueryContext) -> QueryResult:
        results = [r for r in self.execute_children(ctx) if r.grids]
        if not results:
            return QueryResult()
        key_to_row: dict[tuple, dict] = {}
        step = results[0].grids[0].step_ms
        starts = [g.start_ms for r in results for g in r.grids]
        ends = [g.start_ms + (g.num_steps - 1) * g.step_ms for r in results for g in r.grids]
        start, end = min(starts), max(ends)
        nsteps = int((end - start) // step) + 1
        for r in results:
            for g in r.grids:
                v = g.values_np()
                off = int((g.start_ms - start) // step)
                for i, lbls in enumerate(g.labels):
                    key = tuple(sorted(lbls.items()))
                    row = key_to_row.setdefault(
                        key, {"labels": lbls, "vals": np.full(nsteps, np.nan, np.float32)})
                    seg = row["vals"][off: off + g.num_steps]
                    row["vals"][off: off + g.num_steps] = np.where(np.isnan(seg), v[i], seg)
        labels = [r["labels"] for r in key_to_row.values()]
        vals = (np.stack([r["vals"] for r in key_to_row.values()]) if key_to_row
                else np.zeros((0, nsteps), np.float32))
        return QueryResult(grids=[Grid(labels, start, step, nsteps, vals)])


@dataclass
class SuperblockEntry:
    """A superblock on the device plus what serving it needs: the scan
    accounting a hit repeats (``samples``, ``series``, the per-shard
    ``max_shard_series`` the series limit checks), what an extension needs
    (``col_name``, ``stage_mode``; None for a bucket sliced by ``le=``,
    which never extends) and a histogram's unified bounds (``les``, and
    ``les_dev`` on the device for the folded quantile)."""

    block: ST.StagedBlock
    labels: list
    is_counter: bool
    is_delta: bool
    samples: int = 0
    max_shard_series: int = 0
    series: int = 0
    col_name: str | None = None
    stage_mode: str | None = "raw"
    is_hist: bool = False
    les: Any = None
    les_dev: Any = None


class FusedAggregateExec(ExecPlan):
    """``op by (...) (func(selector[w]))`` over local shards as ONE
    superblock and ONE kernel launch (regular, window stats or general);
    only [G, J] reaches the host. Over native histograms: one launch of the histogram
    range kernel, with ``hist_quantile`` (the planner recognized
    ``histogram_quantile(q, sum ...)``) folded into that same launch. The
    epilogue ops (``FUSED_EPI_OPS``, their k or q in ``params``): the rung
    in its store mode, then one order-statistics launch. A selection of
    several schemas runs ``fallback()`` instead (the planner's aggregate
    tree of the same query, built at first use)."""

    def __init__(self, shard_nums, filters, raw_start_ms: int, raw_end_ms: int,
                 column, op: str, by, without, function,
                 start_ms: int, end_ms: int, step_ms: int, window_ms: int,
                 offset_ms: int = 0, hist_quantile: float | None = None, params=(),
                 fallback=None):
        super().__init__()
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
        self.hist_quantile = hist_quantile  # fused histogram_quantile(q, ...)
        self.params = tuple(params)  # an epilogue op's k or q
        self._fallback_factory = fallback
        self._fallback: ExecPlan | None = None

    @property
    def fallback(self) -> ExecPlan:
        if self._fallback is None:
            if self._fallback_factory is None:
                raise NotImplementedError("this fused aggregate has no tree to fall back to")
            self._fallback = self._fallback_factory()
        return self._fallback

    def _fall(self, ctx: QueryContext, reason: str) -> QueryResult:
        """Answer from the aggregate tree (the JAX package's reasons: a
        selection of several schemas, ``mixed_schemas``, or a shape of
        ``_unsupported_shape``)."""
        ctx.obs["path"] = "fallback"
        ctx.obs["fallback"] = reason
        return self.fallback.execute(ctx)

    def num_steps(self) -> int:
        return int((self.end_ms - self.start_ms) // self.step_ms) + 1

    def _versions(self, ctx: QueryContext) -> tuple:
        return tuple(ctx.memstore.shard(ctx.dataset, s).version for s in self.shard_nums)

    def _unsupported_shape(self, is_hist: bool) -> str | None:
        """The reason the tree must answer a shape the fused kernels do not
        model on the resolved schema, or None (the JAX package's reasons),
        decided before any stats bump or staging: over histograms only
        ``sum`` of ``FUSED_HIST_FUNCS`` (``hist_op``, ``hist_func``).
        ``histogram_quantile`` over a scalar selection reads classic ``le``
        bucket series: a grouping that drops ``le`` leaves none
        (``hist_quantile_scalar``), and the tree raises the JAX package's
        QueryError (``classic_histogram_quantile``)."""
        if is_hist:
            if self.op != "sum" or self.params:
                return "hist_op"
            if (self.function or "last") not in FUSED_HIST_FUNCS:
                return "hist_func"
        elif self.hist_quantile is not None and not self._keeps_le():
            return "hist_quantile_scalar"
        return None

    def _keeps_le(self) -> bool:
        """Whether the grouping keeps an ``le`` label on its groups."""
        if self.by is not None:
            return "le" in self.by
        return bool(self.without) and "le" not in self.without

    def _serve_hit(self, ctx: QueryContext, hit: SuperblockEntry) -> SuperblockEntry | str:
        """Limits and stats for a cached superblock: limits are per request,
        so a hit never serves a query the build would have rejected. A
        shape the fused kernels do not model on the block's schema returns
        its fallback reason instead, as the build does."""
        reason = self._unsupported_shape(hit.is_hist)
        if reason is not None:
            return reason
        if hit.max_shard_series > ctx.max_series:
            raise QueryError(
                f"query selects {hit.max_shard_series} series > limit {ctx.max_series}")
        ctx.stats.bump(series_scanned=hit.series or hit.block.n_series,
                       samples_scanned=hit.samples)
        if ctx.stats.samples_scanned > ctx.max_samples:
            raise QueryError(
                f"query would scan {ctx.stats.samples_scanned} samples > limit {ctx.max_samples}")
        return hit

    def superblock(self, ctx: QueryContext) -> SuperblockEntry | None:
        """The selection of every shard as one superblock on ``ctx.device``,
        from the superblock cache kept on the memstore, refreshed or rebuilt
        on a miss (None for an empty selection; the reason, a string, for a
        selection the tree must answer)."""
        if self.raw_end_ms - self.raw_start_ms > ST.MAX_STAGE_SPAN_MS:
            # the planner slices such a range (StitchRvsExec) before any exec
            # is built; an exec assembled outside it cannot stage it
            raise QueryError("selector span wider than int32 ms offsets: plan it through "
                             "the planner, which slices it in time")
        stage_mode = _stage_mode_for_function(self.function)
        cache = _memstore_attr(ctx.memstore, "_superblock_cache", ST.SuperblockCache)
        # for a gauge or delta column every function stages raw: the schema
        # hint learned on the first build keys those under one entry
        hints = _memstore_attr(ctx.memstore, "_fused_mode_hints", dict)
        hint_key = (ctx.dataset, self.filters, self.column)
        hint = hints.get(hint_key)
        key_mode = stage_mode
        if hint is not None and not (hint[0] and not hint[1]):
            key_mode = "raw"
        sb_key = self._superblock_key(ctx, key_mode)
        if ctx.superblock_pin_sink is not None:
            # a standing refresh pins the entry its delta path extends in
            # place, so ad-hoc eviction cannot churn it
            ctx.superblock_pin_sink(cache, sb_key)
        hit = cache.get(sb_key, self._versions(ctx))
        if hit is not None:
            ctx.stats.bump(cache_hits=1)
            return self._serve_hit(ctx, hit)
        with cache.build_lock(sb_key):
            versions = self._versions(ctx)
            hit = cache.get(sb_key, versions)
            if hit is not None:
                ctx.stats.bump(cache_hits=1)
                return self._serve_hit(ctx, hit)
            refreshed = self._refresh_superblock(ctx, cache, sb_key, versions)
            if refreshed is not None:
                return refreshed
            return self._build_superblock(ctx, stage_mode, cache, versions, hints, hint_key)

    def _superblock_key(self, ctx: QueryContext, stage_mode: str) -> tuple:
        """The superblock cache's key of this selection staged in ``stage_mode``."""
        return (ctx.dataset, tuple(self.shard_nums), self.filters, self.raw_start_ms,
                self.raw_end_ms, self.column, stage_mode, str(ctx.device))

    def _refresh_superblock(self, ctx: QueryContext, cache, sb_key, versions: tuple):
        """Maintenance of a version-stale cached superblock (under the key's
        build lock), cheapest first:

        - every member shard's effects since the entry was stamped were
          disjoint from the staged range: re-stamp it and serve it as is;
        - only overlapping interval effects (live-edge appends), with the
          row set unchanged: extend it (``_extend_superblock``);
        - anything else (a new series, a truncated effect log, a failed
          precondition): None, and the caller rebuilds."""
        stale = cache.peek(sb_key)
        if stale is None:
            return None
        old_versions, entry, _ = stale
        if len(old_versions) != len(versions):
            return None
        overlap = False
        for s, ov in zip(self.shard_nums, old_versions):
            reason = ctx.memstore.shard(ctx.dataset, s).ingest_effects_since(
                ov, self.raw_start_ms, self.raw_end_ms)
            if reason == "overlap":
                overlap = True
            elif reason is not None:
                # full_clear / log_truncated: the entry can never be
                # revalidated or extended; drop it now, or it holds device
                # and mirror bytes until an eviction
                cache.drop(sb_key)
                record_superblock_event("restage")
                return None
        if not overlap:
            if cache.revalidate(sb_key, old_versions, versions):
                record_superblock_event("revalidate")
                cache.note(sb_key, "revalidate")
                ctx.stats.bump(cache_hits=1)
                return self._serve_hit(ctx, entry)
            return None
        if entry.stage_mode is None:  # a bucket sliced by le=: nothing to append onto
            record_superblock_event("restage")
            cache.note(sb_key, "restage")
            return None
        return self._extend_superblock(ctx, cache, sb_key, entry, versions)

    def _extend_superblock(self, ctx: QueryContext, cache, sb_key, entry: SuperblockEntry,
                           versions: tuple):
        """Absorb overlapping live-edge appends into the cached superblock
        (``staging.extend_superblock``), then commit at the versions read
        after the extension, classifying what landed meanwhile: nothing in
        range commits at the new vector; overlaps only commit at the
        pre-extension vector (the extension is consistent but may miss the
        racing samples, so the next query extends again); full effects drop
        the entry.

        The row-set proof (fresh lookups equal the entry's part refs, in
        order) and the tail reads run holding the member shards' locks, so
        a routed batch (``TimeSeriesMemStore.ingest_routed``) is read whole
        or not at all."""
        shards = [ctx.memstore.shard(ctx.dataset, s) for s in self.shard_nums]
        rewritten = _histogram_suffix_rewrite(self.filters)[0]
        t0 = time.perf_counter()
        with member_locks(shards):
            refs = []
            for s, shard in zip(self.shard_nums, shards):
                pids = shard.lookup_partitions(self.filters, self.raw_start_ms, self.raw_end_ms)
                if not len(pids) and rewritten is not None:
                    pids = shard.lookup_partitions(rewritten, self.raw_start_ms,
                                                   self.raw_end_ms)
                refs.extend((s, int(p)) for p in pids)
            if refs != list(entry.block.part_refs):
                record_superblock_event("restage")
                return None
            proof_s = time.perf_counter() - t0
            try:
                nb = ST.extend_superblock(ctx.memstore, ctx.dataset, entry.block,
                                          entry.col_name, self.raw_end_ms, entry.stage_mode,
                                          les=entry.les if entry.is_hist else None)
            except Exception:
                cache.drop(sb_key)  # mirrors possibly torn mid-write
                record_superblock_event("extend_abort")
                return None
        if nb is None:
            record_superblock_event("restage")
            cache.note(sb_key, "restage")
            return None
        if nb is not entry.block:
            ST.LAST_EXTENSION["proof_s"] = proof_s
        versions_now = self._versions(ctx)
        commit_versions = versions_now
        if versions_now != versions:
            for s, ov in zip(self.shard_nums, versions):
                reason = ctx.memstore.shard(ctx.dataset, s).ingest_effects_since(
                    ov, self.raw_start_ms, self.raw_end_ms)
                if reason == "overlap":
                    commit_versions = versions
                elif reason is not None:
                    cache.drop(sb_key)
                    record_superblock_event("extend_abort")
                    return None
        if nb is entry.block:
            # nothing new was readable in range: the entry is valid as is
            stale = cache.peek(sb_key)
            if stale is not None and stale[1] is entry:
                cache.revalidate(sb_key, stale[0], commit_versions)
            record_superblock_event("revalidate")
            cache.note(sb_key, "revalidate")
            ctx.stats.bump(cache_hits=1)
            return self._serve_hit(ctx, entry)
        new_entry = SuperblockEntry(
            nb, entry.labels, entry.is_counter, entry.is_delta, int(np.asarray(nb.h_lens).sum()),
            entry.max_shard_series, series=entry.series, col_name=entry.col_name,
            stage_mode=entry.stage_mode, is_hist=entry.is_hist, les=entry.les,
            les_dev=entry.les_dev,
        )
        cache.put(sb_key, commit_versions, new_entry, ST.staged_nbytes(nb))
        record_superblock_event("extend")
        cache.note(sb_key, "extend")
        ctx.stats.bump(cache_extends=1)
        return self._serve_hit(ctx, new_entry)

    def _build_superblock(self, ctx: QueryContext, stage_mode: str, cache, versions, hints,
                          hint_key) -> SuperblockEntry | str | None:
        rewritten, col_override, bucket_le = _histogram_suffix_rewrite(self.filters)
        blocks, labels, block_les = [], [], []
        schema_name = col_name = None
        is_counter = is_delta = is_hist = sliced_hist = False
        total = max_shard_series = dropped_samples = 0
        for s in self.shard_nums:
            ctx.check_deadline()
            shard = ctx.memstore.shard(ctx.dataset, s)
            pids = shard.lookup_partitions(self.filters, self.raw_start_ms, self.raw_end_ms)
            suffixed = False
            if not len(pids) and rewritten is not None:
                # classic-histogram suffix (m_sum / m_count / m_bucket): the
                # base histogram's columns
                pids = shard.lookup_partitions(rewritten, self.raw_start_ms, self.raw_end_ms)
                suffixed = len(pids) > 0
            if not len(pids):
                continue
            if len(pids) > ctx.max_series:
                raise QueryError(f"query selects {len(pids)} series > limit {ctx.max_series}")
            # accounting before any le= slice, as the JAX package counts it
            total += len(pids)
            max_shard_series = max(max_shard_series, len(pids))
            if shard.odp_store is not None and shard.odp_page_in(
                    pids, self.raw_start_ms, self.raw_end_ms):
                # the page-in bumped this shard's version: the build reads
                # the paged-in state, so it is stamped with the new version
                # (the JAX package's stays stale, and its next query builds
                # again)
                i = self.shard_nums.index(s)
                versions = versions[:i] + (shard.version,) + versions[i + 1:]
            parts = [shard.partition(int(p)) for p in pids]
            names = {p.schema.name for p in parts}
            if len(names) > 1 or (schema_name is not None and names != {schema_name}):
                return "mixed_schemas"
            schema_name = parts[0].schema.name
            schema = parts[0].schema
            col_name = self.column or (suffixed and col_override) or schema.value_column
            try:
                col = schema.column(col_name)
            except KeyError:
                col_name = schema.value_column
                col = schema.column(col_name)
            hist_col = col.ctype == ColumnType.HISTOGRAM
            # decided before staging: a le= slice lands scalar
            reason = self._unsupported_shape(hist_col and bucket_le is None)
            if reason is not None:
                return reason
            les = parts[0].bucket_les if hist_col else None
            if hist_col and not _uniform_scheme(parts, les):
                # partitions of one shard on different bucket schemes: one
                # [S, T, B] block has one le vector (the JAX package's
                # "hist_scheme", decided here before the shard is staged)
                return "hist_scheme"
            is_counter, is_delta = col.is_counter, col.is_delta
            # histogram columns always stage raw cumulative bucket counts
            mode = stage_mode if is_counter and not is_delta and not hist_col else "raw"
            cache_key = (self.filters, self.raw_start_ms, self.raw_end_ms, col_name,
                         schema_name, mode)
            block = staged_block_for(ctx, shard, pids, cache_key, col_name,
                                     self.raw_start_ms, self.raw_end_ms, mode)
            part_labels = [dict(p.tags) for p in parts]
            if hist_col and bucket_le is not None:
                # m_bucket{le=...}: one bucket as a scalar counter block
                sliced = _slice_bucket(block, les, bucket_le)
                if sliced is None:
                    # no such bound on this shard: no rows, but its samples
                    # were scanned
                    dropped_samples += int(np.asarray(block.lens).sum())
                    continue
                block, le_str = sliced
                part_labels = [dict(l, le=le_str) for l in part_labels]
                les, hist_col, sliced_hist = None, False, True
                is_counter, is_delta = True, False
            if blocks and hist_col != is_hist:
                return "mixed_schemas"  # scalar and histogram blocks cannot mix
            is_hist = hist_col
            blocks.append(block)
            block_les.append(les)
            labels.extend(part_labels)
        if schema_name is not None:
            if len(hints) >= 1024:
                hints.clear()  # bounded: a hint is one lookup to relearn
            # histogram columns (and their le= slices) stage raw, like gauges:
            # one superblock serves every range function over the selector
            hints[hint_key] = (is_counter and not is_hist and not sliced_hist, is_delta)
        if not blocks:
            return None
        samples = dropped_samples + int(sum(int(b.lens.sum()) for b in blocks))
        ctx.stats.bump(series_scanned=total, samples_scanned=samples, cache_misses=1)
        if ctx.stats.samples_scanned > ctx.max_samples:
            raise QueryError(
                f"query would scan {ctx.stats.samples_scanned} samples > limit {ctx.max_samples}")
        les = None
        if is_hist:
            blocks, les = _unify_hist_blocks(blocks, block_les)
        # host mirrors ride along, so live-edge ingest extends the superblock
        # instead of paying concatenation and a full upload per append
        block = ST.concat_blocks(blocks).to_device(ctx.device, keep_host=True)
        resolved_mode = stage_mode if is_counter and not is_delta and not is_hist else "raw"
        value = SuperblockEntry(
            block, labels, is_counter, is_delta, samples, max_shard_series, series=total,
            col_name=col_name, stage_mode=None if sliced_hist else resolved_mode,
            is_hist=is_hist, les=les,
            les_dev=(torch.as_tensor(np.asarray(les, np.float32)).to(ctx.device)
                     if les is not None else None),
        )
        # keyed by the resolved staging mode, the key every later query of
        # this selector computes once the hint is learned (the JAX package
        # keys the first build by the function's mode, so its second query
        # of a gauge or histogram selection builds again)
        sb_key = self._superblock_key(ctx, value.stage_mode or "raw")
        # cached only when no ingest landed during the build: the entry would
        # otherwise be unservable at its next lookup
        if self._versions(ctx) == versions:
            cache.put(sb_key, versions, value, ST.staged_nbytes(block))
        return value

    def _dispatch_fused(self, ctx: QueryContext, request):
        """Run one fused launch: through the context's dispatch scheduler
        when it batches and the rung has a lane mode
        (``aggregations.batch_variant_supported``), where concurrent
        queries over this superblock coalesce into one lane-mode launch;
        else ``request.run_single()``, exactly the launch of an engine
        without batching. The host wall of the launch (the group's shared
        launch when batched; no device sync) goes to
        ``ctx.stats.kernel_ns``."""
        sched = ctx.dispatch_scheduler
        if sched is not None:
            # the recurrence feed of standing-query promotion and pre-warm:
            # every fused dispatch counts, batching on or off
            self._observe_key(ctx, sched)
        request.predicted_cost_s = float(ctx.predicted_cost_s or 0.0)
        t0 = time.perf_counter()
        if (sched is not None and sched.enabled and AGG.batch_variant_supported(
                request.block, request.func, request.kind, request.is_delta)):
            request.timeout_s = ctx.remaining_deadline_s()
            ctx.obs["batched"] = True
            out = sched.dispatch(request)
            wall = request.exec_seconds
            if wall is None:  # a duplicate lane: its own request never ran
                wall = time.perf_counter() - t0
        else:
            out = request.run_single()
            wall = time.perf_counter() - t0
        ctx.stats.bump(kernel_ns=int(wall * 1e9))
        return out

    def _observe_key(self, ctx: QueryContext, sched) -> None:
        """Record this dispatch in the scheduler's recurrence ring (the JAX
        package's key): the dataset, the root span's PromQL and the grid
        shape, so a dashboard re-issuing one panel with a fresh ``end`` is
        one key; without a PromQL, the structural key. The descriptor holds
        what the standing promoter needs to register the query;
        ``end_lag_ms`` (wall clock less the grid end) tells a live-edge
        dashboard from a historical scan. A standing refresh or pre-warm,
        and a remote child's leg, record nothing."""
        if ctx.standing_refresh:
            return
        root = ctx.trace_root
        if root is not None and root.parent_id is not None:
            return
        promql = root.tags.get("promql") if root is not None else None
        span_ms = self.end_ms - self.start_ms
        if promql:
            key = (ctx.dataset, promql, self.step_ms, self.window_ms, span_ms)
        else:
            key = (ctx.dataset, self.op, self.function, self.filters, tuple(self.by or ()),
                   tuple(self.without or ()), self.step_ms, self.window_ms, span_ms)
        sched.observe_key(key, {
            "promql": promql, "dataset": ctx.dataset, "op": self.op,
            "function": self.function, "params": self.params,
            "hist_quantile": self.hist_quantile, "step_ms": self.step_ms,
            "window_ms": self.window_ms, "span_ms": span_ms,
            "end_lag_ms": time.time() * 1000.0 - float(self.end_ms),
        })

    def do_execute(self, ctx: QueryContext) -> QueryResult:
        from ..scheduler import FusedRequest

        func = self.function or "last"
        got = self.superblock(ctx)
        if isinstance(got, str):
            return self._fall(ctx, got)
        if got is None:
            return QueryResult()
        ctx.obs["path"] = "fused"
        nsteps = self.num_steps()
        params = RangeParams(self.start_ms - self.offset_ms, self.step_ms, nsteps, self.window_ms)
        strip = self.function is not None and self.function not in _DROP_NAME_KEEP
        j_pad = pad_steps(nsteps)

        def request(kind, epilogue, grouping, G, qv, run_single, **kw):
            return FusedRequest(block=got.block, func=func, kind=kind, epilogue=epilogue,
                                gids_dev=grouping, G=G, qv=qv, params=params, j_pad=j_pad,
                                is_counter=got.is_counter, is_delta=got.is_delta,
                                run_single=run_single, **kw)

        if self.op in ("topk", "bottomk"):
            # global: no label grouping, only [k, J] comes back
            k = max(int(self.params[0]), 1)
            vals, idx = self._dispatch_fused(ctx, request(
                "topk", ("topk", k, self.op == "bottomk"), AGG.zero_gids(got.block), 1, 0.0,
                lambda: AGG.fused_topk(func, got.block, k, self.op == "bottomk", params,
                                       is_counter=got.is_counter, is_delta=got.is_delta,
                                       obs=ctx.obs)))
            self._note_rung(ctx, got, func, params)
            return self._present_topk(vals.cpu().numpy(), idx.cpu().numpy(), got.labels,
                                      strip, nsteps)
        if self.op == "quantile":
            members, G, group_labels = AGG.group_members_memo(
                got.block, got.labels, self.by, self.without, strip_metric=strip)
            q = float(self.params[0])
            out = self._dispatch_fused(ctx, request(
                "quantile", ("quantile",), members, G, q,
                lambda: AGG.fused_quantile(func, got.block, members, q, params,
                                           is_counter=got.is_counter, is_delta=got.is_delta,
                                           obs=ctx.obs)))
            self._note_rung(ctx, got, func, params)
            return QueryResult(grids=[Grid(group_labels, self.start_ms, self.step_ms, nsteps,
                                           out)])
        gids, G, group_labels = AGG.group_ids_memo(
            got.block, got.labels, self.by, self.without, strip_metric=strip)
        if got.is_hist:
            hq = self.hist_quantile
            out = self._dispatch_fused(ctx, request(
                "hist", (), gids, G, float(hq or 0.0),
                lambda: AGG.fused_hist_range_aggregate(
                    func, got.block, gids, G, params, got.les_dev, q=hq,
                    is_delta=got.is_delta, obs=ctx.obs),
                les_dev=got.les_dev, hist_q=hq is not None))
            self._note_rung(ctx, got, func, params)
            if hq is not None:
                # the quantile ran on the card: [G, J] is all that comes back
                labels = [_strip_metric(l) for l in group_labels]
                return QueryResult(grids=[Grid(labels, self.start_ms, self.step_ms, nsteps, out)])
            placeholder = np.full((G, nsteps), np.nan, np.float32)
            return QueryResult(grids=[Grid(group_labels, self.start_ms, self.step_ms, nsteps,
                                           placeholder, hist=out, les=got.les)])
        out = self._dispatch_fused(ctx, request(
            "agg", ("agg", self.op), gids, G, 0.0,
            lambda: AGG.fused_range_aggregate(
                func, self.op, got.block, gids, G, params,
                is_counter=got.is_counter, is_delta=got.is_delta, obs=ctx.obs)))
        self._note_rung(ctx, got, func, params)
        if self.hist_quantile is not None:
            # classic buckets (le kept by the grouping, _unsupported_shape): the
            # [G', J] by-(le, ...) partials pivot into per-group cumulative
            # counts (the index tables memoized with the group ids), one
            # standalone-quantile launch per bucket scheme
            key = (tuple(self.by) if self.by else None,
                   tuple(self.without) if self.without else None, strip)
            pivot = memo_on(got.block, "classic_pivot_memo", key,
                            lambda: classic_pivot(group_labels, out.device))
            q_labels, q_vals = classic_histogram_quantile(self.hist_quantile, group_labels, out,
                                                          nsteps, pivot=pivot)
            return QueryResult(grids=[Grid([_strip_metric(l) for l in q_labels], self.start_ms,
                                           self.step_ms, nsteps, q_vals)])
        return QueryResult(grids=[Grid(group_labels, self.start_ms, self.step_ms, nsteps, out)])

    @staticmethod
    def _note_rung(ctx: QueryContext, got, func: str, params) -> None:
        """Count the dispatch's rung in the query's stats (and
        ``obs["variant"]``): the solo entry points set the variant; a
        batched lane did not run them on this thread."""
        if "variant" not in ctx.obs:
            ctx.obs["variant"] = (AGG.hist_variant(got.block, params) if got.is_hist else
                                  AGG.grid_variant(got.block, func, got.is_delta,
                                                   params.window_ms))
        ctx.stats.note_rung(ctx.obs["variant"])

    def _present_topk(self, vals, idx, labels, strip: bool, nsteps: int) -> QueryResult:
        """Prometheus topk/bottomk rows from the compact [k, J] winner set:
        each winning series, in series order, keeps its own labels (the
        metric stripped with ``strip``), with values at the steps it won and
        NaN elsewhere; a non-finite winner is dropped. Built on the host in
        O(k J) (a series wins a step at most once)."""
        finite = np.isfinite(vals)
        steps = np.nonzero(finite)[1]
        used, row_of = np.unique(idx[finite], return_inverse=True)
        v = np.full((len(used), nsteps), np.nan, np.float32)
        v[row_of, steps] = vals[finite]
        out_labels = [_strip_metric(labels[s]) if strip else labels[s] for s in used.tolist()]
        return QueryResult(grids=[Grid(out_labels, self.start_ms, self.step_ms, nsteps, v)])


# -- the reference tree's aggregates ------------------------------------------

# ops whose partial state merges across shards: op -> components
_PARTIAL_COMPONENTS = {
    "sum": ("sum",),
    "count": ("count",),
    "min": ("min",),
    "max": ("max",),
    "group": ("group",),
    "avg": ("sum", "count"),
    "stddev": ("sum", "sumsq", "count"),
    "stdvar": ("sum", "sumsq", "count"),
}


def _common_device(arrays):
    """The device of the arrays' tensors: the card where any is on it."""
    for a in arrays:
        if isinstance(a, torch.Tensor) and a.device.type != "cpu":
            return a.device
    return torch.device("cpu")


def stack_step_major(grids) -> torch.Tensor:
    """The grids' rows side by side as one contiguous step-major [J, N] f32
    tensor on their common device (J the widest grid's steps; a narrower
    grid NaN past its steps)."""
    dev = _common_device([g.values for g in grids])
    mats = [grid_values(g).to(dev) for g in grids]
    J = max(m.shape[1] for m in mats)
    if all(m.shape[1] == J for m in mats):
        return torch.cat([m.T for m in mats], dim=1)
    out = torch.full((J, sum(m.shape[0] for m in mats)), float("nan"), dtype=torch.float32,
                     device=dev)
    r = 0
    for m in mats:
        out[: m.shape[1], r: r + m.shape[0]] = m.T
        r += m.shape[0]
    return out


def _partial_aggregate(op: str, grids: list, by, without):
    """Leaf-side map phase: the grids' rows reduced by label group on their
    device into the op's components (one segment-aggregate launch). Returns
    (group_labels, components name -> [G, J] f32 numpy, grid meta); over
    native histograms ``_partial_hist``'s."""
    if not grids:
        return [], {}, None
    if any(g.hist is not None for g in grids):
        return _partial_hist(op, grids, by, without)
    meta = grids[0]
    if len(grids) == 1:
        # a single grid stays where it is (a leaf's step-major store grid is
        # read in place); only the [G, J] components reach the host
        vals = grid_values(meta)
        gids, G, group_labels = grid_grouping(meta, by, without, vals.device)
    else:
        vals = stack_step_major(grids).T
        labels = [l for g in grids for l in g.labels]
        gids_np, group_labels = AGG.group_ids_for(labels, list(by) if by else None,
                                                  list(without) if without else None)
        G = len(group_labels)
        gids = torch.from_numpy(gids_np.astype(np.int64)).to(vals.device)
    need = _PARTIAL_COMPONENTS[op]
    got = SA.segment_components(vals, gids, G, need)
    host = torch.stack([got[c] for c in need]).cpu().numpy()
    return group_labels, dict(zip(need, host)), meta


def _partial_hist(op: str, grids: list, by, without):
    """The map phase over native histogram grids (reference
    HistSumRowAggregator): only ``sum``, the JAX package's errors
    otherwise and for a scalar grid among them. Grids on different bucket
    schemes are unified on the host (``unify_schemes``, the grid meta then
    carrying the union bounds); the per-bucket group sum is one
    segment-aggregate launch over the [n, J, B] grid seen as J * B steps
    (a leaf's store-mode grid read in place). The ``sum`` component of
    the NaN placeholder values is NaN, as the JAX package computes it, and
    takes no launch. Returns (group_labels, {"sum": [G, J], "hist": [G, J,
    B]} f32 numpy, grid meta)."""
    if any(g.hist is None for g in grids):
        raise QueryError("cannot aggregate histogram and scalar series together")
    if op != "sum":
        raise QueryError(f"aggregation {op} not supported over native histograms (use sum)")
    meta = grids[0]
    if len(grids) == 1:
        h = grid_hist(meta)
        gids, G, group_labels = grid_grouping(meta, by, without, h.device)
    else:
        dev = _common_device([g.hist for g in grids])
        hists = [grid_hist(g, dev) for g in grids]
        les_list = [g.les for g in grids if g.les is not None]
        if len(les_list) == len(grids) and not all(same_scheme(l, les_list[0])
                                                   for l in les_list[1:]):
            unified, union, changed = unify_schemes([h.cpu().numpy() for h in hists], les_list)
            if changed:
                hists = [torch.from_numpy(u).to(dev) for u in unified]
                meta = replace(meta, les=union)
        h = torch.cat(hists)
        labels = [l for g in grids for l in g.labels]
        gids_np, group_labels = AGG.group_ids_for(labels, list(by) if by else None,
                                                  list(without) if without else None)
        G = len(group_labels)
        gids = torch.from_numpy(gids_np.astype(np.int64)).to(dev)
    n, J, B = h.shape
    sums = SA.segment_components(h.reshape(n, J * B), gids, G, ("sum",))["sum"]
    J_vals = max(g.num_steps for g in grids)
    comps = {"sum": np.full((G, J_vals), np.nan, np.float32),
             "hist": sums.reshape(G, J, B).cpu().numpy()}
    return group_labels, comps, meta


def _unify_hist_partials(partials):
    """Pre-pass of ``_merge_partials``: partials whose ``hist`` components
    lie on different bucket schemes are remapped onto the union bounds
    (``unify_schemes``, on the host), so that the merge adds aligned
    buckets; their metas carry the union."""
    hist_idx = [i for i, (_, comps, m) in enumerate(partials)
                if "hist" in comps and m is not None and m.les is not None]
    if len(hist_idx) <= 1:
        return partials
    unified, union, changed = unify_schemes([partials[i][1]["hist"] for i in hist_idx],
                                            [partials[i][2].les for i in hist_idx])
    if not changed:
        return partials
    out = list(partials)
    for i, h in zip(hist_idx, unified):
        gl, comps, m = partials[i]
        out[i] = (gl, dict(comps, hist=h), replace(m, les=union))
    return out


def _merge_partials(op: str, partials):
    """Reduce phase: merge shard partials by group label key (host f32;
    ``hist`` components as sums, after ``_unify_hist_partials``)."""
    key_to: dict[tuple, dict] = {}
    meta = None
    partials = _unify_hist_partials(partials)
    for group_labels, comps, m in partials:
        if m is not None:
            meta = m
        for gi, lbls in enumerate(group_labels):
            key = tuple(sorted(lbls.items()))
            slot = key_to.setdefault(key, {"labels": lbls, "comps": {}})
            for name, arr in comps.items():
                cur = slot["comps"].get(name)
                row = arr[gi]
                if cur is None:
                    slot["comps"][name] = row.copy()
                elif name in ("sum", "count", "sumsq", "hist"):
                    slot["comps"][name] = np.where(
                        np.isnan(cur), row, np.where(np.isnan(row), cur, cur + row))
                elif name == "min":
                    slot["comps"][name] = np.fmin(cur, row)
                elif name in ("max", "group"):
                    slot["comps"][name] = np.fmax(cur, row)
    return key_to, meta


def _present(op: str, key_to, meta) -> QueryResult:
    """The op's [G, J] from the merged components (host f32, as the JAX
    package computes it: stddev is sqrt(sumsq/count - mean^2), clamped at
    0); a group with a ``hist`` component keeps its [J, B] buckets beside
    NaN values, on the meta's bounds."""
    if meta is None:
        return QueryResult()
    labels, rows, hist_rows = [], [], []
    for slot in key_to.values():
        c = slot["comps"]
        if "hist" in c:
            hist_rows.append(c["hist"])
            v = np.full(c["hist"].shape[0], np.nan, np.float32)
        elif op in ("sum", "count", "min", "max", "group"):
            v = c[op]
        elif op == "avg":
            v = c["sum"] / c["count"]
        else:  # stddev, stdvar
            mean = c["sum"] / c["count"]
            var = np.maximum(c["sumsq"] / c["count"] - mean**2, 0.0)
            v = var if op == "stdvar" else np.sqrt(var)
        labels.append(slot["labels"])
        rows.append(v)
    vals = np.stack(rows) if rows else np.zeros((0, meta.num_steps), np.float32)
    hist = np.stack(hist_rows) if hist_rows else None
    return QueryResult(grids=[Grid(labels, meta.start_ms, meta.step_ms, meta.num_steps, vals,
                                   hist=hist, les=meta.les if hist is not None else None)])


@dataclass
class AggregateMapReduce:
    """The map phase as a transformer pushed onto shard leaves (reference
    AggregateMapReduce): the partial components as ``__comp__`` grids."""

    op: str
    by: tuple | None
    without: tuple | None

    def apply(self, grids: list) -> list:
        return partials_to_grids(*_partial_aggregate(self.op, grids, self.by, self.without))


# component names whose [G, J, B] payload rides the grid's ``hist`` field
_CUBE_COMPS = ("hist",)


def partials_to_grids(group_labels, comps, meta) -> list:
    """Per-group partial components as ``__comp__``-labelled host grids
    (a ``hist`` component in the grid's buckets, NaN values beside it)."""
    if meta is None:
        return []
    out = []
    for name, arr in comps.items():
        cube = name in _CUBE_COMPS
        out.append(Grid([dict(l, __comp__=name) for l in group_labels], meta.start_ms,
                        meta.step_ms, meta.num_steps,
                        np.full(arr.shape[:2], np.nan, np.float32) if cube else arr,
                        hist=arr if cube else None, les=meta.les if cube else None))
    return out


def collect_partials(result: QueryResult, default_op: str):
    """A child's ``__comp__`` grids back into (group_labels, comps, meta);
    rows without the label are final values of ``default_op``. The meta is
    a grid with bucket bounds where there is one."""
    meta = None
    comp_rows: dict[str, dict[tuple, np.ndarray]] = {}
    labels_by_key: dict[tuple, dict] = {}
    for g in result.grids:
        if g.les is not None or meta is None:
            meta = g
        v = g.values_np()
        h = g.hist_np()
        for i, l in enumerate(g.labels):
            comp = l.get("__comp__", default_op)
            base = {k: x for k, x in l.items() if k != "__comp__"}
            key = tuple(sorted(base.items()))
            labels_by_key[key] = base
            comp_rows.setdefault(comp, {})[key] = h[i] if comp in _CUBE_COMPS else v[i]
    if meta is None:
        return None
    keys = list(labels_by_key)
    comps = {}
    for comp, rows in comp_rows.items():
        proto = next(iter(rows.values()))
        comps[comp] = np.stack([rows.get(k, np.full(proto.shape, np.nan, np.float32))
                                for k in keys])
    return [labels_by_key[k] for k in keys], comps, meta


class ReduceAggregateExec(NonLeafExecPlan):
    """reference ReduceAggregateExec: merge the children's partials."""

    def __init__(self, child_plans, op: str, by=None, without=None):
        super().__init__(child_plans)
        self.op = op
        self.by = by
        self.without = without

    def args_str(self) -> str:
        return f"op={self.op} by={self.by} without={self.without}"

    def do_execute(self, ctx: QueryContext) -> QueryResult:
        partials = []
        for r in self.execute_children(ctx):
            p = collect_partials(r, self.op)
            if p is not None:
                partials.append(p)
        return _present(self.op, *_merge_partials(self.op, partials))


class CountValuesMergeExec(NonLeafExecPlan):
    """The root of a pushed-down count_values: the children's count rows
    summed by label set (shards own disjoint series), on the host."""

    def do_execute(self, ctx: QueryContext) -> QueryResult:
        grids = [g for r in self.execute_children(ctx) for g in r.grids]
        if not grids:
            return QueryResult()
        meta = grids[0]
        J = meta.num_steps
        merged: dict[tuple, np.ndarray] = {}
        keys: dict[tuple, dict] = {}
        for g in grids:
            vals = g.values_np()
            for i, lbls in enumerate(g.labels):
                key = tuple(sorted(lbls.items()))
                row = vals[i, :J]
                have = merged.get(key)
                if have is None:
                    merged[key] = np.array(row, np.float32)
                    keys[key] = lbls
                else:  # NaN-aware: a count plus an absence is the count
                    both = np.isfinite(have) & np.isfinite(row)
                    only_b = ~np.isfinite(have) & np.isfinite(row)
                    have[both] += row[both]
                    have[only_b] = row[only_b]
        labels = [keys[k] for k in merged]
        v = np.stack(list(merged.values())) if merged else np.zeros((0, J), np.float32)
        return QueryResult(grids=[Grid(labels, meta.start_ms, meta.step_ms, J, v)])


class AggregatePresentExec(NonLeafExecPlan):
    """The root of the non-mergeable ops over any subtree (reference
    AggregatePresentExec): the children's rows side by side on the device
    (step-major), then topk/bottomk by (...) (one ``segment_topk``
    launch), limitk, quantile (one ``segment_quantile`` launch), the
    mergeable ops (one segment-aggregate launch, merged and presented on
    the host) or count_values (on the host). topk/bottomk/limitk return
    each group's kept rows, groups in order and rows in series order."""

    def __init__(self, child_plans, op: str, params=(), by=None, without=None):
        super().__init__(child_plans)
        self.op = op
        self.params = params
        self.by = by
        self.without = without

    def args_str(self) -> str:
        return f"op={self.op} params={self.params} by={self.by} without={self.without}"

    def do_execute(self, ctx: QueryContext) -> QueryResult:
        grids = [g for r in self.execute_children(ctx) for g in r.grids]
        if not grids:
            return QueryResult()
        op = self.op
        if op in _PARTIAL_COMPONENTS:  # histogram buckets pass through (_partial_hist)
            return _present(op, *_merge_partials(op, [_partial_aggregate(op, grids, self.by,
                                                                         self.without)]))
        meta = grids[0]
        all_labels = [l for g in grids for l in g.labels]
        by = list(self.by) if self.by else None
        without = list(self.without) if self.without else None
        if op == "count_values":
            vals = TR.stack_values_np(grids)
            gids, group_labels = AGG.group_ids_for(all_labels, by, without)
            label = str(self.params[0])
            out_labels, out_rows = [], []
            for gi, gl in enumerate(group_labels):
                for valstr, row in AGG.count_values(vals[gids == gi]).items():
                    out_labels.append(dict(gl, **{label: valstr}))
                    out_rows.append(row[: meta.num_steps])
            v = (np.stack(out_rows).astype(np.float32) if out_rows
                 else np.zeros((0, meta.num_steps), np.float32))
            return QueryResult(grids=[Grid(out_labels, meta.start_ms, meta.step_ms,
                                           meta.num_steps, v)])
        if op not in ("topk", "bottomk", "limitk", "quantile"):
            raise QueryError(f"unsupported aggregation {op}")
        grid = stack_step_major(grids)  # [J, N]
        if len(grids) == 1:
            members, G, group_labels, _ = grid_members(meta, by, without, grid.device)
        else:
            gids_np, group_labels = AGG.group_ids_for(all_labels, by, without)
            G = len(group_labels)
            members = OS.segment_members(torch.from_numpy(gids_np.astype(np.int64)).to(
                grid.device), G)
        if op == "quantile":
            out = OS.segment_quantile(grid, members, float(self.params[0]))
            return QueryResult(grids=[Grid(group_labels, meta.start_ms, meta.step_ms,
                                           meta.num_steps, out)])
        k = max(int(self.params[0]), 1)
        perm = members.perm.long()
        if op == "limitk":
            starts = members.starts.long()
            sizes = starts[1:] - starts[:-1]
            gm = torch.repeat_interleave(torch.arange(G, device=grid.device), sizes)
            first = perm[torch.arange(perm.numel(), device=grid.device) - starts[gm] < k]
            kept = torch.zeros(grid.shape[1], dtype=torch.bool, device=grid.device)
            kept[first] = True
            out = grid
        else:
            out, _ = OS.segment_topk(grid, members, k, op == "bottomk")
            kept = torch.ones(grid.shape[1], dtype=torch.bool, device=grid.device)
        kept &= ~torch.isnan(out).all(dim=0)
        rows = perm[kept[perm]]  # groups in order, series order within a group
        rows_h = rows.cpu().numpy()
        return QueryResult(grids=[Grid([all_labels[i] for i in rows_h], meta.start_ms,
                                       meta.step_ms, meta.num_steps, out[:, rows].T)])


GRID_TRANSFORMERS = (AggregateMapReduce, TR.InstantVectorFunctionMapper,
                     TR.ScalarOperationMapper, TR.MiscellaneousFunctionMapper,
                     TR.SortFunctionMapper, TR.LimitFunctionMapper, TR.AbsentFunctionMapper,
                     TR.TopkCandidateFilter, TR.CountValuesMapReduce)
