"""One shard of the in-memory store (counterpart of
``filodb_tpu/memstore/shard.py``; reference L2: TimeSeriesShard.scala:268 —
ingest loop :939, partition creation :1193, lookup :2097).

A shard owns the partkey -> partition map and the tag index. ``version``
moves on every ingest, and every move records one entry in a bounded
effect log, so a reader holding an older version can prove that a staged
time range was left untouched. The shard's staging cache holds host-staged
blocks of selections; an ingest marks the entries it overlaps dirty, for
the next query to repair by appending (``staging.append_to_block``).

The shard counts its series by shard-key prefix (``cardinality``) and
answers the metadata queries from its index (label names and values, the
label sets of the matching series).

Not ported: headroom eviction, on-demand paging, cardinality quotas,
append listeners (standing queries) and the index's end-time lifecycle.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass
from typing import Sequence

import numpy as np

from ..core.filters import ColumnFilter
from ..core.records import RecordBatch, SeriesBatch
from .cardinality import CardinalityTracker
from .index import SetBasedPartKeyIndex
from .partition import DEFAULT_MAX_CHUNK_SIZE, TimeSeriesPartition


@dataclass
class StoreConfig:
    """Per-dataset store tuning (reference store/IngestionConfig.scala)."""

    max_chunk_size: int = DEFAULT_MAX_CHUNK_SIZE
    max_partitions: int = 1_000_000
    # staging-cache byte budget per shard
    stage_cache_bytes: int = 2 << 30


@dataclass
class StageEntry:
    """One staging-cache entry: a staged block plus a dirty flag set by
    in-range ingests since it was built. A dirty entry is repaired by
    appending (or restaged when that fails) at its next use; ``repairing``
    marks a repair in flight, so a concurrent same-key query restages
    instead of serving the pre-repair block. ``dirty_lo``/``dirty_hi`` are
    the union of the accepted-sample intervals (absolute ms, inclusive) of
    the ingests that dirtied the entry; the repair declines when
    ``dirty_lo`` reaches below the staged heads. ``dev_block`` is the
    block's copy on the device a tree leaf reads (``plans.device_copy_for``;
    None until one is made), counted in ``nbytes`` and dropped with a
    repair."""

    block: object
    nbytes: int
    dirty: bool = False
    repairing: bool = False
    dirty_lo: int | None = None
    dirty_hi: int | None = None
    dev_block: object = None


# how many per-version ingest effects a shard keeps: the proof window for
# the insert-time overlap check and superblock revalidation. A reader older
# than the window is treated as if everything changed.
EFFECT_LOG_MAX = 1024


class TimeSeriesShard:
    def __init__(self, dataset: str, shard_num: int, config: StoreConfig | None = None):
        self.dataset = dataset
        self.shard_num = shard_num
        self.config = config or StoreConfig()
        self.index = SetBasedPartKeyIndex()
        self.cardinality = CardinalityTracker()
        self.partitions: dict[int, TimeSeriesPartition] = {}
        self._by_partkey: dict[bytes, int] = {}
        self._next_part_id = 0
        self._lock = threading.RLock()
        self.version = 0
        # one (version, lo_ms, hi_ms, full) per version bump
        self._effects: deque = deque(maxlen=EFFECT_LOG_MAX)
        # cache key (filters, start_ms, end_ms, ...) -> StageEntry
        self.stage_cache: dict = {}

    # -- effect log ----------------------------------------------------------

    def _record_effect(self, lo, hi, full: bool) -> None:
        """Log this version bump's effect. ``full`` marks events that can
        change any cached block (a new series). Caller holds the lock and
        has bumped ``version``: every bump records exactly one effect, so
        the log's versions stay consecutive (truncation detection relies
        on it)."""
        self._effects.append((self.version, lo, hi, full))

    def ingest_effects_since(self, since_version: int, lo: int, hi: int):
        """What happened between ``since_version`` and now to the
        absolute-ms interval [lo, hi]: None when the log proves every bump
        since left it untouched; else ``"overlap"`` (an ingest's effect
        interval intersects it), ``"full_clear"`` (a new series: cached row
        sets may have changed) or ``"log_truncated"`` (the log no longer
        reaches back that far)."""
        with self._lock:
            return self._ingest_effects_since_locked(since_version, lo, hi)

    def _ingest_effects_interval_locked(self, since_version: int, lo, hi):
        """The one effect-log scan: ``(reason, eff_lo, eff_hi)``, with the
        union interval of the overlapping effects when reason is
        ``"overlap"``."""
        if self.version == since_version:
            return None, None, None
        if not self._effects or self._effects[0][0] > since_version + 1:
            return "log_truncated", None, None
        eff_lo = eff_hi = None
        for v, elo, ehi, full in self._effects:
            if v <= since_version:
                continue
            if full:
                return "full_clear", None, None
            if elo <= hi and ehi >= lo:
                eff_lo = elo if eff_lo is None else min(eff_lo, elo)
                eff_hi = ehi if eff_hi is None else max(eff_hi, ehi)
        if eff_lo is None:
            return None, None, None
        return "overlap", int(eff_lo), int(eff_hi)

    def _ingest_effects_since_locked(self, since_version: int, lo, hi):
        return self._ingest_effects_interval_locked(since_version, lo, hi)[0]

    # -- staging cache -------------------------------------------------------

    def _clear_stage_cache(self) -> None:
        """Drop every staging-cache entry (caller holds the lock)."""
        self.stage_cache.clear()

    def _invalidate_stage_range(self, min_ts, max_ts, new_series: bool, raw_lo=None) -> None:
        """Record the ingest's effect and dirty-mark (not drop) the cache
        entries it can affect. An entry staged for [start, end] stays valid
        unless the effect interval overlaps it or a new series appeared (it
        might match the entry's filters: a full clear). The effect interval
        of an append to an existing series starts at the series' previous
        newest sample: extending a gap series' span can pull it into a
        cached range it missed entirely. Entries accumulate the accepted-
        sample interval ``raw_lo``..``max_ts`` instead. Caller holds the
        lock."""
        if new_series or min_ts is None:
            self._record_effect(0, 0, True)
            self._clear_stage_cache()
            return
        self._record_effect(int(min_ts), int(max_ts), False)
        dlo = int(min_ts) if raw_lo is None else int(raw_lo)
        for k, entry in self.stage_cache.items():
            if k[1] <= max_ts and k[2] >= min_ts:  # k = (filters, start, end, ...)
                entry.dirty = True
                entry.dirty_lo = dlo if entry.dirty_lo is None else min(entry.dirty_lo, dlo)
                entry.dirty_hi = (int(max_ts) if entry.dirty_hi is None
                                  else max(entry.dirty_hi, int(max_ts)))

    def _prev_end_of(self, partkey) -> int | None:
        """Newest sample ts of an existing series (None for a new one)."""
        pid = self._by_partkey.get(partkey)
        if pid is None:
            return None
        return int(self.partitions[pid].latest_ts())

    # -- ingest --------------------------------------------------------------

    def ingest(self, batch: RecordBatch) -> int:
        """Ingest a columnar record batch as one version bump (reference
        ingest:939): records are grouped by series and appended in bulk.
        Returns the number of rows ingested."""
        n = 0
        with self._lock:
            np0 = len(self.partitions)
            min_ts = max_ts = raw_min = None
            for sb in batch.group_by_series():
                prev_end = self._prev_end_of(sb.partkey)
                n += self._ingest_series(sb)
                if len(sb.timestamps):
                    raw, hi = int(sb.timestamps.min()), int(sb.timestamps.max())
                    lo = raw if prev_end is None else min(raw, prev_end)
                    # rows at or below prev_end are dropped by the partition
                    # and change nothing: the entries' dirt counts accepted
                    # rows only
                    acc = raw if prev_end is None else max(raw, prev_end + 1)
                    raw_min = acc if raw_min is None else min(raw_min, acc)
                    min_ts = lo if min_ts is None else min(min_ts, lo)
                    max_ts = hi if max_ts is None else max(max_ts, hi)
            self.version += 1
            self._invalidate_stage_range(min_ts, max_ts, len(self.partitions) != np0,
                                         raw_lo=raw_min)
        return n

    def ingest_series(self, sb: SeriesBatch) -> int:
        """Append one series' samples, creating its partition on first
        sight, as one version bump. Returns the number of rows ingested."""
        with self._lock:
            self.version += 1
            np0 = len(self.partitions)
            prev_end = self._prev_end_of(sb.partkey)
            n = self._ingest_series(sb)
            if len(sb.timestamps):
                raw = int(sb.timestamps.min())
                lo = raw if prev_end is None else min(raw, prev_end)
                acc = raw if prev_end is None else max(raw, prev_end + 1)
                self._invalidate_stage_range(lo, int(sb.timestamps.max()),
                                             len(self.partitions) != np0, raw_lo=acc)
            else:
                self._record_effect(0, 0, True)
                self._clear_stage_cache()
        return n

    def _ingest_series(self, sb: SeriesBatch) -> int:
        pk = sb.partkey
        pid = self._by_partkey.get(pk)
        if pid is None:
            start = int(sb.timestamps.min()) if len(sb.timestamps) else 0
            pid = self._create_partition(sb, pk, start)
        ts = sb.timestamps
        values = sb.values
        if len(ts) > 1 and not (np.diff(ts) >= 0).all():
            order = np.argsort(ts, kind="stable")
            ts = ts[order]
            values = {k: v[order] for k, v in values.items()}
        return self.partitions[pid].ingest(ts, values)

    def _create_partition(self, sb: SeriesBatch, pk: bytes, start_ts: int) -> int:
        if len(self.partitions) >= self.config.max_partitions:
            raise MemoryError(f"shard {self.shard_num}: partition limit reached")
        self.cardinality.series_created(sb.tags)
        pid = self._next_part_id
        self._next_part_id += 1
        self.partitions[pid] = TimeSeriesPartition(
            pid, sb.tags, sb.schema, pk, max_chunk_size=self.config.max_chunk_size,
            bucket_les=sb.bucket_les,
        )
        self._by_partkey[pk] = pid
        self.index.add_partkey(pid, dict(sb.tags), start_ts=start_ts)
        return pid

    def lookup_partitions(self, filters: Sequence[ColumnFilter], start_ts: int,
                          end_ts: int, limit: int | None = None) -> np.ndarray:
        """reference lookupPartitions:2097 -> PartLookupResult."""
        return self.index.part_ids_from_filters(filters, start_ts, end_ts, limit)

    def partition(self, part_id: int) -> TimeSeriesPartition:
        return self.partitions[int(part_id)]

    def label_values(self, filters, label: str, start_ts: int, end_ts: int, limit=None):
        return self.index.label_values(filters, label, start_ts, end_ts, limit)

    def label_names(self, filters, start_ts: int, end_ts: int):
        return self.index.label_names(filters, start_ts, end_ts)

    def partkeys(self, filters, start_ts: int, end_ts: int, limit=None):
        return self.index.partkeys_from_filters(filters, start_ts, end_ts, limit)
